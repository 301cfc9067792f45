"""Phase-level profile of one AL-iLQR inner iteration at config 2's shape
(port of examples/profile_config2_phases.py:133-196): batch 256, N=40, the
Pacejka OCP with the bounded state constraints on the 100-point lane-change
Bezier road.

The phases are the solver's own (``IlqrPhases``, ``iterate.phases`` of
``solve.prepare_inner``, mpc_tpu_torch/solver/ilqr.py), so the profile times
the code the solver runs, not a copy of it: the clamped rollout, the
Gauss-Newton derivatives (one forward-mode pass over every lane and stage),
the Riccati backward pass (the LQT solve, sequential and parallel scan)
and the line-search forward fan (6 step sizes folded into the lane axis).
Inputs as the JAX script's: y0 = [cl0_x, cl0_y + U(-0.02, 0.02), 0,
U(0.2, 0.8), 0, 0] lane by lane and inputs U(-0.1, 0.1) + [1, 0]
(``default_rng(0)``), multipliers 0, penalties 1e3, regularisation 1e-3;
as there, the derivatives and the fan take the drawn inputs unclamped,
and the fan the parallel pass's gains. Beyond the JAX script's phases, the
iteration's pick of the step size (``accept``) and one whole ``iterate``
from the prepared state.

Per phase: the median of ``--reps`` calls after a warm-up call, each
timed by the host clock to ``torch.cuda.synchronize()``; then, once every
phase has been timed so, the same calls under ``torch.profiler`` (the
card's activity only): the device-busy ms and the device kernels of one
call. ``iteration_sum_ms`` adds the
derivatives, the sequential backward (the solver's default, as
examples/exp_mfu.py's roll-up takes it; the JAX script adds its parallel
one) and the fan. The JAX script's ``forward_fan6_u8_ms`` and
``forward_fan6_u40_ms`` rows are one row here, ``forward_fan6_ms``: their
``unroll`` only steers XLA.

    python -m mpc_tpu_torch.examples.profile_config2_phases [--batch 256]
        [--reps 10] [--record] [--record-key 9-phases] [--device D]

Prints the device, then one JSON line with the JAX script's keys and the
device numbers beside them (``<phase>_device_ms``, ``<phase>_kernels``);
on the CPU (``--device cpu``) the device numbers are null: not measured.
``--record`` stores the row through ``utils/perfdb.record``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import NamedTuple

import numpy as np
import torch

from mpc_tpu_torch.bench import ILQR_N40, lane_change_road
from mpc_tpu_torch.config import IlqrConfig
from mpc_tpu_torch.control.mpc import build_vehicle_ilqr_controller
from mpc_tpu_torch.examples import add_device_arg, start, sync
from mpc_tpu_torch.models.params import VehicleParams
from mpc_tpu_torch.profile_step import device_time

N = 40
SD, ID = 6, 2
#: the phases, in the order they run and are printed
PHASES = ("rollout", "derivatives", "backward_sequential",
          "backward_parallel", "forward_fan6", "accept", "iterate")


class Inputs(NamedTuple):
    """The drawn problem: road (S, 2), y0 (B, 6), us (B, N, 2), lam and
    sigma (B, N, 6), reg (B,), numpy float32 but the road."""
    road: np.ndarray
    y0: np.ndarray
    us: np.ndarray
    lam: np.ndarray
    sigma: np.ndarray
    reg: np.ndarray


def draw_inputs(batch: int, n_horiz: int = N) -> Inputs:
    """The JAX script's inputs (examples/profile_config2_phases.py:141-
    151), drawn with ``default_rng(0)`` in its order."""
    cl = lane_change_road().numpy()
    rng = np.random.default_rng(0)
    y0 = np.stack([np.array(
        [float(cl[0, 0]), float(cl[0, 1]) + rng.uniform(-0.02, 0.02),
         0.0, rng.uniform(0.2, 0.8), 0, 0], np.float32)
        for _ in range(batch)])
    us = rng.uniform(-0.1, 0.1, (batch, n_horiz, ID)).astype(np.float32)
    us[..., 0] += 1.0
    return Inputs(cl, y0, us,
                  np.zeros((batch, n_horiz, SD), np.float32),
                  np.full((batch, n_horiz, SD), 1e3, np.float32),
                  np.full((batch,), 1e-3, np.float32))


class Setup(NamedTuple):
    phases: object        # the solver's IlqrPhases
    state: object         # the prepared inner state
    iterate: object
    cond: object          # the per-lane loop condition
    args: dict            # the phases' tensors: us, xs, derivs, gains


def setup(inputs: Inputs, device, n_horiz: int = N) -> Setup:
    """ilqr_n40's controller on ``device`` and the inner problem of
    ``inputs``: its phases, its prepared state, and the tensors each phase
    takes (``xs`` from the rollout, the derivatives at (xs, us), the
    parallel pass's gains)."""
    ctrl = build_vehicle_ilqr_controller(
        n_horiz=n_horiz, bound_state_constraints=True,
        alm_cfg=ILQR_N40.alm_cfg,
        ilqr_cfg=IlqrConfig(max_iter=ILQR_N40.solver_cfg.max_iter),
        device=device)
    t = {k: torch.as_tensor(v, device=device)
         for k, v in inputs._asdict().items()}
    B = t["y0"].shape[0]
    param = {"y0": t["y0"], "p": VehicleParams(), "centerline": t["road"]}
    st, iterate, cond, _ = ctrl.solve.prepare_inner(
        param, t["us"].reshape(B, -1), t["lam"].reshape(B, -1),
        t["sigma"].reshape(B, -1))
    ph = iterate.phases
    xs, _ = ph.rollout(t["us"])
    derivs = ph.derivatives(xs, t["us"])
    Ks, kos, _ = ph.lqt_solve(derivs, t["reg"], parallel=True)
    # the iteration's own chain from the prepared state, for accept
    st_derivs = ph.derivatives(st.xs, st.us)
    st_Ks, st_kos, gnorm = ph.lqt_solve(st_derivs, st.reg)
    fan = ph.forward(st.xs, st.us, st_Ks, st_kos)
    return Setup(ph, st, iterate, cond, dict(
        us=t["us"], reg=t["reg"], xs=xs, derivs=derivs, Ks=Ks, kos=kos,
        gnorm=gnorm, fan=fan))


def calls(s: Setup) -> dict:
    """Each phase as a call without arguments, by name (``PHASES``)."""
    ph, a = s.phases, s.args
    return {
        "rollout": lambda: ph.rollout(a["us"]),
        "derivatives": lambda: ph.derivatives(a["xs"], a["us"]),
        "backward_sequential": lambda: ph.lqt_solve(a["derivs"], a["reg"],
                                                    parallel=False),
        "backward_parallel": lambda: ph.lqt_solve(a["derivs"], a["reg"],
                                                  parallel=True),
        "forward_fan6": lambda: ph.forward(a["xs"], a["us"], a["Ks"],
                                           a["kos"]),
        "accept": lambda: ph.accept(s.state, a["gnorm"], *a["fan"]),
        "iterate": lambda: s.iterate(s.state),
    }


def host_ms(fn, dev: torch.device, reps: int) -> float:
    """The median host-clock time of ``reps`` calls after one warm-up
    call, each ended by a sync."""
    fn()
    sync(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def device_ms(fn, dev: torch.device, reps: int) -> tuple:
    """``(device-busy ms, device kernels)`` of one call: ``reps`` calls
    under ``torch.profiler`` (the card's activity only), its device time
    and kernels (``profile_step.device_time``) over ``reps``."""
    from torch.profiler import ProfilerActivity, profile
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync(dev)
    busy_ms, kernels = device_time(prof)
    return busy_ms / reps, kernels / reps


def measure(fns: dict, dev: torch.device, reps: int) -> dict:
    """``{name: {"ms", "device_ms", "kernels"}}`` of one call of each of
    ``fns`` (by name), the device numbers None off the card. Every host
    time is taken before the first profiled call, so that no profiler's
    leftovers reach a host time."""
    out = {name: {"ms": host_ms(fn, dev, reps), "device_ms": None,
                  "kernels": None} for name, fn in fns.items()}
    if dev.type == "cuda":
        for name, fn in fns.items():
            out[name]["device_ms"], out[name]["kernels"] = device_ms(
                fn, dev, reps)
    return out


@torch.no_grad()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--record", action="store_true")
    ap.add_argument("--record-key", default="9-phases")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = start(args.device)
    B = args.batch

    s = setup(draw_inputs(B), dev)
    measured = measure(calls(s), dev, args.reps)
    row = {"exp": "phases", "batch": B, "n_horiz": N, "reps": args.reps}
    for name in PHASES:
        m = measured[name]
        row[f"{name}_ms"] = round(m["ms"], 3)
        row[f"{name}_device_ms"] = None if m["device_ms"] is None \
            else round(m["device_ms"], 3)
        row[f"{name}_kernels"] = m["kernels"]
    row["iteration_sum_ms"] = round(
        row["derivatives_ms"] + row["backward_sequential_ms"]
        + row["forward_fan6_ms"], 3)
    print(json.dumps(row), flush=True)

    if args.record:
        from mpc_tpu_torch.utils import perfdb
        rec = {"config": f"{args.record_key}: config #2 inner-iteration "
                         f"phase profile (batch {B}, N={N})",
               "source": "python -m mpc_tpu_torch.examples."
                         "profile_config2_phases --record"}
        rec.update({k: v for k, v in row.items()
                    if k.endswith(("_ms", "_kernels"))})
        perfdb.record(args.record_key, rec)
    return row


if __name__ == "__main__":
    main()
