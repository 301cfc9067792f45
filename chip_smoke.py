"""Smoke test of the PyTorch/CUDA port (mpc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run with a nonzero exit:

1. device: a CUDA device must be present; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles the fan kernel (csrc/fused_psi.cu) from this checkout;
3. kernel check: the kernel against its plain PyTorch version on the card
   (``mpc_tpu_torch.kernels.check``; psi rtol 2e-5 / atol 1e-6, grad rtol
   2e-4 / atol 2e-5). First on drawn inputs inside the solver's box, E in
   {1, 37, 5120}, N=12, substeps=4, S=100, straight and circle roads,
   default and non-default vehicle parameters. Then on every fan input of
   the first closed-loop steps of the benchmark at batch 1024, at the shapes
   the main path gives the kernel: the PANOC candidate fans (5 x 1024, 24),
   whose L-BFGS candidates are not projected onto the box, and the init
   pairs (2 x 1024, 24). A lane beyond the bar is excused only where the
   plain version in float32 misses its own float64 value by the bar too;
   such lanes are counted, and must be under 1% of a phase's lanes;
4. timing: kernel and plain version on the first captured fan of each shape,
   E=5120 and E=2048 (CUDA events, median of 50 runs);
5. main path: mpc_tpu_torch.bench (batch 1024, N=12, 5 warm-up and 20
   timed closed-loop steps, then the batch-1 latency loop over 50 steps);
   the kernel's launch count must cover every PANOC iteration run, every
   state must be finite and the mean converged fraction must be >= 0.99.

It prints the kernel table as one JSON line before the last, and as the last
line {"ok": true, "device": {...}}. It imports nothing of JAX.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

PSI_TOL = dict(rtol=2e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
N_HORIZ, SUBSTEPS, TS, S = 12, 4, 0.05, 100
CAPTURE_STEPS = 3           # closed-loop steps whose fan inputs are checked
EXCUSED_MAX_SHARE = 0.01


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(tag, psi, grad, u, y0, cltab, pvec, args):
    """Hold kernel outputs against the plain version; fail on a lane the
    plain version meets the bar on and the kernel does not. ``args`` are the
    fan's ``(n_horiz, substeps, h, v_ref, weights)``."""
    from mpc_tpu_torch.kernels.check import compare_fan
    r = compare_fan(psi, grad, u, y0, cltab, pvec, *args, PSI_TOL, GRAD_TOL)
    why = (f", where the plain f32 version misses float64 by >= "
           f"{r['excused_plain_miss_min']:.3g}x the bar" if r["excused"] else "")
    print(f"kernel check {tag}: {r['lanes']} lanes, {r['beyond_bar']} beyond "
          f"the bar ({r['excused']} ill-conditioned{why}; {r['failed']} "
          f"failed); max abs err within the bar "
          f"{r['max_abs_err_within_bar']:.3e}, over all lanes psi "
          f"{r['max_abs_err_psi']:.3e} grad {r['max_abs_err_grad']:.3e}")
    if r["failed"] or r["excused"] > EXCUSED_MAX_SHARE * r["lanes"]:
        fail(f"{tag}: the kernel disagrees with its plain version: {r}")
    return r


def drawn_inputs(E, road, seed):
    import numpy as np
    import torch
    from mpc_tpu_torch.ops.road import circle_centerline, straight_centerline
    rng = np.random.default_rng(seed)
    # inside the solver's box, driving forward: drive d in [0, 1], steering
    # in [-0.32, 0.32] (max_steer); the main path's own inputs, which leave
    # the box, are checked after these
    u = np.empty((E, 2 * N_HORIZ), np.float32)
    u[:, 0::2] = rng.uniform(0.0, 1.0, (E, N_HORIZ))
    u[:, 1::2] = rng.uniform(-0.32, 0.32, (E, N_HORIZ))
    y0 = np.zeros((E, 6), np.float32)
    y0[:, 0] = rng.uniform(-0.1, 0.5, E)
    y0[:, 1] = rng.uniform(-0.1, 0.1, E)
    y0[:, 2] = rng.uniform(-0.3, 0.3, E)
    y0[:, 3] = rng.uniform(0.2, 1.0, E)
    # both roads pass through the origin heading along +x (the circle of
    # radius 5 about (0, 5) at its lowest point), where the lanes start
    cl = straight_centerline(S, device="cuda") if road == "straight" \
        else circle_centerline(S, device="cuda")
    return (torch.as_tensor(u, device="cuda"),
            torch.as_tensor(y0, device="cuda"), cl)


def capture_fan_inputs():
    """The inputs of every fan call in the first CAPTURE_STEPS closed-loop
    steps of the benchmark at batch 1024, as the main path gives them:
    ``{E: [(u, y0, cltab, pvec, args), ...]}``."""
    import torch
    from mpc_tpu_torch.bench import BATCH, ClosedLoop
    from mpc_tpu_torch.ops import fused_psi as fp
    wrapper = fp.fan_value_and_grad
    calls = {}

    def recording(u, y0, cltab, pvec, *args):
        calls.setdefault(u.shape[0], []).append(
            (u.clone(), y0.clone(), cltab.clone(), pvec.clone(), args))
        return wrapper(u, y0, cltab, pvec, *args)

    # the wrapper counts its launches on whatever fp.fan_value_and_grad
    # names; the capture's launches land here and are dropped
    recording.launches = 0
    fp.fan_value_and_grad = recording
    try:
        loop = ClosedLoop()
        ys, carry = loop.start(BATCH)
        with torch.no_grad():
            for _ in range(CAPTURE_STEPS):
                ys, carry, _ = loop.step(ys, carry)
        torch.cuda.synchronize()
    finally:
        fp.fan_value_and_grad = wrapper
    return calls


def median_ms(fn, n=50, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def main():
    if not os.path.isdir(os.path.join(HERE, "mpc_tpu_torch")):
        fail("mpc_tpu_torch/ is not beside chip_smoke.py: run it from a "
             "checkout of the repository")
    sys.path.insert(0, HERE)
    import torch

    # ---- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    from mpc_tpu_torch.bench import gpu_info, run
    info = gpu_info()
    kind = torch.cuda.get_device_name(0)
    print(info["nvidia_smi"])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # ---- 2. build ---------------------------------------------------------
    from mpc_tpu_torch.kernels import build as kbuild
    t0 = time.perf_counter()
    b = kbuild.build("fused_psi")
    kbuild.load_fused_psi()
    print(f"build: fused_psi {'compiled' if b['built'] else 'cached'} in "
          f"{time.perf_counter() - t0:.2f} s -> "
          f"{os.path.relpath(b['path'], HERE)}")
    for line in b["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  nvcc: {line.strip()}")

    # ---- 3. kernel against its plain version ------------------------------
    from mpc_tpu_torch.models.params import VehicleParams
    from mpc_tpu_torch.ops import fused_psi as fp
    fan_args = (N_HORIZ, SUBSTEPS, TS / SUBSTEPS, 1.0,
                fp.DEFAULT_VEHICLE_WEIGHTS)
    cases = [(E, road, VehicleParams()) for E in (1, 37, 5120)
             for road in ("straight", "circle")]
    cases.append((37, "circle", VehicleParams(mass=0.25, cm1=0.4)))
    reports = []
    for i, (E, road, p) in enumerate(cases):
        u, y0, cl = drawn_inputs(E, road, seed=i)
        cltab, pvec = fp.fan_params(cl, p)
        psi, grad = fp.fan_value_and_grad(u, y0, cltab, pvec, *fan_args)
        torch.cuda.synchronize()
        tag = f"E={E} {road} {'default p' if p == VehicleParams() else 'p*'}"
        reports.append(check(tag, psi, grad, u, y0, cltab, pvec, fan_args))

    t0 = time.perf_counter()
    captured = capture_fan_inputs()
    print(f"captured the fan inputs of {CAPTURE_STEPS} closed-loop steps at "
          f"batch 1024 in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{len(v)} calls at E={E}"
                      for E, v in sorted(captured.items())))
    if sorted(captured) != [2048, 5120]:
        fail(f"the main path gave the fan the shapes {sorted(captured)}, "
             f"expected E=2048 (init pairs) and E=5120 (candidate fans)")
    for E, calls in sorted(captured.items()):
        us, y0s, psis, grads = [], [], [], []
        for u, y0, cltab, pvec, args in calls:
            if args != calls[0][4] or not torch.equal(cltab, calls[0][2]) \
                    or not torch.equal(pvec, calls[0][3]):
                fail("the captured fan calls differ in road or parameters")
            psi, grad = fp.fan_value_and_grad(u, y0, cltab, pvec, *args)
            torch.cuda.synchronize()
            us.append(u)
            y0s.append(y0)
            psis.append(psi)
            grads.append(grad)
        reports.append(check(
            f"main path E={E} ({len(calls)} calls)", torch.cat(psis),
            torch.cat(grads), torch.cat(us), torch.cat(y0s), *calls[0][2:]))
    lanes = sum(r["lanes"] for r in reports)
    excused = sum(r["excused"] for r in reports)
    max_err = max(r["max_abs_err_within_bar"] for r in reports)
    print(f"kernel check: {lanes} lanes, {excused} ill-conditioned lanes "
          f"excused, max abs err over the rest {max_err:.3e}")

    # ---- 4. timing ----------------------------------------------------------
    timing = {}
    for E in (5120, 2048):
        u, y0, cltab, pvec, rest = captured[E][0]
        args = (u, y0, cltab, pvec, *rest)
        ms_plain = median_ms(lambda: fp.fan_value_and_grad_reference(*args))
        ms_kernel = median_ms(lambda: fp.fan_value_and_grad(*args))
        ms_plain2 = median_ms(lambda: fp.fan_value_and_grad_reference(*args))
        ms_kernel2 = median_ms(lambda: fp.fan_value_and_grad(*args))
        timing[E] = (min(ms_kernel, ms_kernel2), min(ms_plain, ms_plain2))
        print(f"timing E={E}: kernel {ms_kernel:.4f} / {ms_kernel2:.4f} ms, "
              f"plain {ms_plain:.4f} / {ms_plain2:.4f} ms "
              f"(median of 50, CUDA events; {info['nvidia_smi']})")

    # ---- 5. main path -------------------------------------------------------
    fp.fan_value_and_grad.launches = 0
    r = run()
    launches = fp.fan_value_and_grad.launches
    r["device"] = kind
    r["power_limit"] = info["power_limit"]
    r["fan_kernel_launches"] = launches
    print(json.dumps({"bench": r}))
    print(f"main path: {r['solves_per_s']:.1f} solves/s, step p50 "
          f"{r['p50_step_latency_s'] * 1e3:.2f} ms p99 "
          f"{r['p99_step_latency_s'] * 1e3:.2f} ms, converged "
          f"{r['mean_converged_fraction']:.4f}, inner iters mean "
          f"{r['inner_iters_mean']:.2f} max {r['inner_iters_max']}, "
          f"batch-1 p50 {r['single_solve_p50_s'] * 1e3:.2f} ms p99 "
          f"{r['single_solve_p99_s'] * 1e3:.2f} ms, fan launches {launches}")
    if launches < max(1, r["panoc_iterations_run"]):
        fail(f"the main path launched the fan kernel {launches} times for "
             f"{r['panoc_iterations_run']} PANOC iterations")
    if not r["states_finite"]:
        fail("non-finite plant state in the closed loop")
    if not r["mean_converged_fraction"] >= 0.99:
        fail(f"mean converged fraction {r['mean_converged_fraction']} < 0.99")

    print(json.dumps({"kernels": [{
        "name": "fused_psi_fan",
        "route": "cuda",
        "source": "mpc_tpu_torch/csrc/fused_psi.cu",
        "replaces": "mpc_tpu/ops/fused_psi.py:321",
        "launches": launches,
        "max_abs_err": max_err,
        "lanes_checked": lanes,
        "lanes_excused": excused,
        "ms": timing[5120][0],
        "plain_ms": timing[5120][1],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
