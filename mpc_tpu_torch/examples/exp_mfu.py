"""Roofline of the port's two hot per-iteration functions on the card (port
of examples/exp_mfu.py): operations and bytes from their shapes
(``mpc_tpu_torch/utils/roofline.py``, in place of XLA's
``cost_analysis()``, which PyTorch lacks), beside the measured time, for

1. PANOC's candidate fan on the headline's shape, kernel K1
   (``fan_value_and_grad``) at E = 1024 lanes x 5 candidates, N = 12:
   candidates U(-0.3, 1.0), speeds U(0.3, 1.0) (``default_rng(0)``), the
   100-point straight road; its time CUDA events around a CUDA graph of
   200 launches over the count (``roofline.launch_ms``);
2. the AL-iLQR inner iteration's phases at config 2's shape (batch 256,
   N=40), those ``profile_config2_phases`` times (its inputs, the solver's
   own ``IlqrPhases``): the rollout, the Gauss-Newton derivatives, the
   sequential Riccati backward pass (the solver's default) and the 6-step
   forward fan; their time the median host-clock call, beside the
   device-busy time of one call from ``torch.profiler``.

Each row: the time, the operations and bytes of one call, the achieved
FLOP/s and bytes/s, the bound (the larger of operations over 67 TFLOP/s
float32 and bytes over 3.35 TB/s: NVIDIA's data sheet for the H100 SXM at
700 W, printed beside the card's own name and power limit) and which term
binds, and the share of the bound the call reaches. Then the iteration's
roll-up (derivatives, sequential backward, fan). A share above 100% is a
fault of the count, and the script then exits non-zero. On the CPU
(``--device cpu``) the times are the host's and no rate or share is given.

    python -m mpc_tpu_torch.examples.exp_mfu [--reps 10] [--record]
        [--device D]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from mpc_tpu_torch.examples import add_device_arg, start
from mpc_tpu_torch.examples import profile_config2_phases as phases
from mpc_tpu_torch.models.params import VehicleParams
from mpc_tpu_torch.ops import fused_psi as fp
from mpc_tpu_torch.ops.road import straight_centerline
from mpc_tpu_torch.utils import roofline
from mpc_tpu_torch.utils.perfdb import device_label

FAN_BATCH, FAN_K, FAN_N, SUBSTEPS, TS = 1024, 5, 12, 4, 0.05
ILQR_B = 256
#: the iLQR rows: (row name, phase of profile_config2_phases, its count)
ILQR_ROWS = (
    ("ilqr_rollout_b256_n40", "rollout", roofline.ilqr_rollout),
    ("ilqr_gn_derivatives_b256_n40", "derivatives",
     roofline.ilqr_derivatives),
    ("ilqr_riccati_seq_b256_n40", "backward_sequential",
     roofline.ilqr_riccati_sequential),
    ("ilqr_forward_fan6_b256_n40", "forward_fan6",
     roofline.ilqr_forward_fan),
)
#: the rows the iteration's roll-up adds
ITERATION = ILQR_ROWS[1:]


def fan_inputs(device):
    """The headline's candidate fan (examples/exp_mfu.py:96-117): E = 5120
    candidates, each lane's 5 sharing its y0."""
    rng = np.random.default_rng(0)
    n = 2 * FAN_N
    cands = rng.uniform(-0.3, 1.0, (FAN_BATCH, FAN_K, n)).astype(np.float32)
    y0s = np.zeros((FAN_BATCH, 6), np.float32)
    y0s[:, 3] = rng.uniform(0.3, 1.0, FAN_BATCH)
    u = torch.as_tensor(cands.reshape(-1, n), device=device)
    y0 = torch.as_tensor(np.repeat(y0s, FAN_K, axis=0), device=device)
    cltab, pvec = fp.fan_params(straight_centerline(100, device=device),
                                VehicleParams())
    return u, y0, cltab, pvec


def row(name: str, ms: float, device_ms, kernels, count: roofline.Count,
        on_card: bool, bound_by=None) -> dict:
    """One row: the JAX script's keys where they fit, then the bound."""
    bound_ms, by = count.bound()
    r = {"kernel": name, "wall_ms": round(ms, 4),
         "device_ms": None if device_ms is None else round(device_ms, 4),
         "device_kernels": kernels,
         "operations": count.ops, "bytes": count.bytes,
         "gflops_per_call": round(count.ops / 1e9, 6),
         "gbytes_per_call": round(count.bytes / 1e9, 6),
         "arith_intensity_flop_per_byte": round(count.ops / count.bytes, 2),
         "bound_ms": bound_ms, "bound_by": bound_by or by}
    if on_card:
        s = ms / 1e3
        r.update({
            "achieved_tflops": count.ops / s / 1e12,
            "achieved_gbs": count.bytes / s / 1e9,
            "pct_of_f32_peak": 100.0 * count.ops / s
            / roofline.PEAK_F32_FLOPS,
            "pct_of_hbm_peak": 100.0 * count.bytes / s
            / roofline.PEAK_BYTES_PER_S,
            "pct_of_bound": 100.0 * bound_ms / ms,
            "device_pct_of_bound": None if device_ms is None
            else 100.0 * bound_ms / device_ms})
    return r


def fan_row(dev: torch.device, reps: int) -> dict:
    u, y0, cltab, pvec = fan_inputs(dev)
    args = (u, y0, cltab, pvec, FAN_N, SUBSTEPS, TS / SUBSTEPS, 1.0)
    psi, grad = fp.fan_value_and_grad(*args)
    bound_ms, by, nbytes, ops, _ = roofline.fan_bound(
        "pacejka", False, u.shape[0], FAN_N, SUBSTEPS, cltab.shape[-2],
        [u, y0, cltab, pvec], [psi, grad])
    count = roofline.Count(ops, nbytes)
    if dev.type == "cuda":
        ms = roofline.launch_ms(lambda: fp.fan_value_and_grad(*args))
        return row("panoc_cand_fan_b1024_n12", ms, ms, 1, count, True, by)
    ms = phases.host_ms(lambda: fp.fan_value_and_grad(*args), dev, reps)
    return row("panoc_cand_fan_b1024_n12", ms, None, None, count, False, by)


@torch.no_grad()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--record", action="store_true")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = start(args.device)
    on_card = dev.type == "cuda"
    print(f"peaks: {roofline.PEAK_F32_FLOPS / 1e12:g} TFLOP/s float32, "
          f"{roofline.PEAK_BYTES_PER_S / 1e12:g} TB/s (H100 SXM data sheet, "
          f"700 W)" + (f"; this card: {device_label(dev)}"
                       if on_card else "; not measured on the CPU"),
          flush=True)

    rows = [fan_row(dev, args.reps)]
    print(json.dumps(rows[-1]), flush=True)
    s = phases.setup(phases.draw_inputs(ILQR_B), dev)
    fns = phases.calls(s)
    measured = phases.measure({p: fns[p] for _, p, _ in ILQR_ROWS}, dev,
                              args.reps)
    for name, phase, count in ILQR_ROWS:
        m = measured[phase]
        rows.append(row(name, m["ms"], m["device_ms"], m["kernels"],
                        count(ILQR_B, phases.N), on_card))
        print(json.dumps(rows[-1]), flush=True)

    it = [r for r in rows if r["kernel"] in {n for n, _, _ in ITERATION}]
    ops = sum(r["operations"] for r in it)
    nbytes = sum(r["bytes"] for r in it)
    wall = sum(r["wall_ms"] for r in it)
    bound_ms, by = roofline.bound(ops, nbytes)
    rollup = {"ilqr_iteration_gflops": round(ops / 1e9, 6),
              "ilqr_iteration_wall_ms": round(wall, 3),
              "ilqr_iteration_device_ms": round(sum(
                  r["device_ms"] for r in it), 3) if on_card else None,
              "ilqr_iteration_bound_ms": bound_ms,
              "ilqr_iteration_bound_by": by,
              "ilqr_iteration_pct_of_bound": 100.0 * bound_ms / wall
              if on_card else None}
    print(json.dumps(rollup), flush=True)

    over = [r["kernel"] for r in rows
            if (r.get("pct_of_bound") or 0) > 100.0
            or (r.get("device_pct_of_bound") or 0) > 100.0]
    if over:
        print(f"exp_mfu: FAIL: above 100% of the bound, a fault of the "
              f"count: {over}", file=sys.stderr, flush=True)
        raise SystemExit(1)

    if args.record:
        from mpc_tpu_torch.utils import perfdb
        rec = {"config": "12: MFU / roofline of the hot functions "
                         "(operations and bytes from the shapes, "
                         "utils/roofline.py, and measured time)",
               "source": "python -m mpc_tpu_torch.examples.exp_mfu --record",
               "peaks": "67 TFLOP/s float32, 3.35 TB/s (H100 SXM data "
                        "sheet, 700 W)"}
        for r in rows:
            rec[r["kernel"]] = (
                f"{r['wall_ms']} ms (device {r['device_ms']} ms), "
                f"{r['operations']} operations, {r['bytes']} bytes, bound "
                f"{r['bound_ms']:.6f} ms by {r['bound_by']}, "
                f"{r.get('pct_of_bound')}% of it")
        rec.update(rollup)
        perfdb.record("12", rec)
    return {"rows": rows, **rollup}


if __name__ == "__main__":
    main()
