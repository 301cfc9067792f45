"""Where a closed-loop step's time goes on the card: device-busy time, the
fan kernel's share of it, device kernels per step, and the device's idle
share. Same controllers, roads and initial states as ``mpc_tpu_torch.bench``.

    python -m mpc_tpu_torch.profile_step [headline|config1|ss_n40|ilqr_n40|etc]

For the cell's batch (and its batch-1 loop's, where it has one): the cell's
warm-up steps, then 3 steps (1 for ss_n40, whose step runs some 1,500
device kernels per PANOC iteration over hundreds of iterations) run twice
from the same state. For ilqr_n40, whose inner iteration issues some 45,000
kernels and whose step runs tens of them, the profiled unit is 2 AL-iLQR
inner iterations from the warm carry (``solve.prepare_inner``), not a step.
For etc it is the cell's 12 timed steps: its lanes re-solve together, on
the step where their plans expire (one step in 12), and replay between.
The first time they are timed on the host clock, with a synchronise after
each and no profiler. The second time they run under ``torch.profiler``.
They are deterministic, so both runs do the same work; the script checks
that their iteration counts agree. So the idle share, ``1 - busy / wall``,
takes busy from the profiled run and wall from the unprofiled run of the
same work in the same process.

Busy is the union of the device intervals (kernels, copies, sets) in the
profiler's trace. The trace is written to ``build/profile/`` in the checkout.
Prints one JSON line per batch, then the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from mpc_tpu_torch.bench import CELLS, ClosedLoop, gpu_info
from mpc_tpu_torch.config import IlqrConfig

N_PROFILED = {"headline": 3, "config1": 3, "ss_n40": 1, "ilqr_n40": 2,
              "etc": 12}
FAN_KERNEL = "fused_psi_fan"   # K1-K3: instances of fused_psi_fan_phased
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "build", "profile")


def _clone(ys, carry):
    return ys.clone(), type(carry)(*(t.clone() for t in carry))


def _run_steps(loop, ys, carry):
    """The cell's profiled steps; per step the wall time (s) and the slowest
    lane's iteration count."""
    walls, iters = [], []
    for _ in range(N_PROFILED[loop.cell.name]):
        t0 = time.perf_counter()
        ys, carry, out = loop.step(ys, carry)
        iters.append(int(out.result.inner_iterations.max()))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls, iters


def _run_inner_iterations(iterate, st):
    """Masked AL-iLQR inner iterations from ``st``; per iteration the wall
    time (s) and 1."""
    walls = []
    for _ in range(N_PROFILED["ilqr_n40"]):
        t0 = time.perf_counter()
        st = iterate(st)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls, [1] * len(walls)


def _device_intervals(trace_path):
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    return [(e["ts"], e["ts"] + e["dur"], e["cat"], e["name"])
            for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for a, b in sorted((a, b) for a, b, _, _ in intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


@torch.no_grad()
def profile_batch(loop: ClosedLoop, batch: int) -> dict:
    from mpc_tpu_torch.ops import fused_psi as fp
    wrappers = (fp.fan_value_and_grad, fp.kin_fan_value_and_grad,
                fp.al_fan_value_and_grad)
    ys, carry = loop.start(batch)
    for _ in range(loop.cell.n_warmup):
        ys, carry, _ = loop.step(ys, carry)
    torch.cuda.synchronize()

    has_fan = not isinstance(loop.cell.solver_cfg, IlqrConfig)
    if has_fan:
        def work():
            return _run_steps(loop, *_clone(ys, carry))
    else:
        # the inner problem of the next step's first outer iteration: the
        # warm carry's multipliers and penalties (cold lanes at sigma_0)
        sigma = torch.where(carry.sigma > 0, carry.sigma,
                            torch.full_like(carry.sigma,
                                            loop.cell.alm_cfg.sigma_0))
        st, iterate, _, _ = loop.ctrl.solve.prepare_inner(
            {"y0": ys, "p": loop.params, "centerline": loop.centerline},
            carry.U, carry.lam, sigma)

        def work():
            return _run_inner_iterations(iterate, st)

    walls, iters = work()
    launches0 = sum(w.launches for w in wrappers)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_walls, prof_iters = work()
    launches = sum(w.launches for w in wrappers) - launches0
    if prof_iters != iters:
        raise RuntimeError(f"the profiled steps did other work than the "
                           f"timed ones: iterations {prof_iters} vs {iters}")

    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR,
                        f"trace_{loop.cell.name}_batch{batch}.json")
    prof.export_chrome_trace(path)
    dev = _device_intervals(path)
    kernels = [iv for iv in dev if iv[2] == "kernel"]
    fan = [iv for iv in kernels if FAN_KERNEL in iv[3]]
    if not kernels or has_fan != bool(fan):
        raise RuntimeError(f"the profiler's trace holds {len(kernels)} "
                           f"device kernels, {len(fan)} of them the fan "
                           f"kernel, on a path {'with' if has_fan else 'without'}"
                           f" one")
    busy_ms = _union_us(dev) / 1e3
    fan_ms = sum(b - a for a, b, _, _ in fan) / 1e3
    wall_ms = sum(walls) * 1e3
    r = {
        "cell": loop.cell.name, "batch": batch,
        "unit": "step" if has_fan else "inner iteration",
        "units": len(iters), "slowest_lane_iters": iters,
        "wall_ms": wall_ms, "wall_ms_under_profiler": sum(prof_walls) * 1e3,
        "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
        "device_kernels": len(kernels),
        "device_kernels_per_iteration": len(kernels) / sum(iters),
        "trace": os.path.relpath(path, ROOT),
    }
    if has_fan:
        r.update({
            "fan_kernel_ms": fan_ms, "fan_share_of_busy": fan_ms / busy_ms,
            "fan_launches": launches, "fan_kernels_in_trace": len(fan),
            "fan_us_per_launch": fan_ms * 1e3 / len(fan)})
    return r


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    name = argv[0] if argv else "headline"
    if name not in CELLS or len(argv) > 1:
        raise SystemExit(f"usage: python -m mpc_tpu_torch.profile_step "
                         f"[{'|'.join(CELLS)}]")
    info = gpu_info()
    loop = ClosedLoop(CELLS[name])
    batches = (loop.cell.batch,) if loop.cell.batch1_steps is None \
        else (loop.cell.batch, 1)
    for batch in batches:
        r = profile_batch(loop, batch)
        r["device"] = info["name"]
        r["power_limit"] = info["power_limit"]
        print(json.dumps({"profile": r}), flush=True)
    print(info["nvidia_smi"])


if __name__ == "__main__":
    main()
