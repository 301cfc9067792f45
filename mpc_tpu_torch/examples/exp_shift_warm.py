"""Shifted against verbatim warm starts (the RTI rotation trick), port of
examples/exp_shift_warm.py.

The headline's controller (Pacejka, N=12, ``AlmConfig(eps=1e-4)``,
``PanocConfig(lbfgs_memory=12, max_iter=300)``) runs a closed loop of 20
steps at batch 64 on each road (straight and circle, 100 points), once as
built, which warm-starts each solve from the previous plan verbatim, and
once with ``warm_prep`` rotating the plan one stage forward and repeating
its last stage. The shift is applied on every step: the vehicle OCP has
no general constraints, so the cold-start sentinel (every carried penalty
<= 0) holds on every lane and gating on it would never shift; rotating the
cold [1, 0] tile changes nothing. Initial states as the JAX script's:
[cl0_x, cl0_y + U(-0.05, 0.05), heading of cl1 - cl0, U(0.3, 1.0), 0, 0]
(``default_rng(0)``). Its fan is kernel K1 on the card.

    python -m mpc_tpu_torch.examples.exp_shift_warm [--roads straight circle]
        [--batch 64] [--n-sim 20] [--record] [--device D]

Prints the device, then per road and start one JSON line with the JAX
script's keys (``exp``, ``batch``, ``n_sim``, ``mean_total_inner_iters``,
``mean_failures``, ``mean_converged_fraction``) and the run's K1 launches
and wall seconds. ``main`` returns the rows by name.
"""

from __future__ import annotations

import argparse
import copy
import json
import time

import numpy as np
import torch

from mpc_tpu_torch.config import AlmConfig, PanocConfig
from mpc_tpu_torch.control.mpc import build_vehicle_controller
from mpc_tpu_torch.examples import add_device_arg, start, sync
from mpc_tpu_torch.models.bicycle import pacejka_dynamics
from mpc_tpu_torch.models.integrators import discretize
from mpc_tpu_torch.models.params import VehicleParams
from mpc_tpu_torch.ops import fused_psi as fp
from mpc_tpu_torch.ops.road import circle_centerline, straight_centerline

ROADS = {"straight": straight_centerline, "circle": circle_centerline}


def initial_states(cl: np.ndarray, batch: int) -> np.ndarray:
    """The JAX script's initial states (examples/exp_shift_warm.py:37-45)."""
    rng = np.random.default_rng(0)
    y0s = np.zeros((batch, 6), np.float32)
    y0s[:, 0] = cl[0, 0]
    y0s[:, 1] = cl[0, 1] + rng.uniform(-0.05, 0.05, batch)
    d0 = cl[1] - cl[0]
    y0s[:, 2] = np.arctan2(np.float32(d0[1]), np.float32(d0[0]))
    y0s[:, 3] = rng.uniform(0.3, 1.0, batch)
    return y0s


def shift(z: torch.Tensor, param, cold: torch.Tensor) -> torch.Tensor:
    """Rotate each lane's input plan one stage forward and repeat its last
    stage, on every lane (see the module's docstring)."""
    del param, cold
    u = z.reshape(z.shape[0], -1, 2)
    return torch.cat([u[:, 1:], u[:, -1:]], dim=1).reshape(z.shape[0], -1)


def run(name: str, ctrl, cl: torch.Tensor, dev: torch.device,
        n_sim: int = 20, batch: int = 64) -> dict:
    """The closed loop of ``n_sim`` steps at ``batch`` lanes: the row of
    the JAX script's keys, with the run's K1 launches and wall seconds."""
    params = VehicleParams()
    f_d = discretize(pacejka_dynamics)
    ys = torch.as_tensor(initial_states(cl.cpu().numpy(), batch),
                         device=dev)
    carry = ctrl.init_carry(batch)
    convs = []
    launches0 = fp.fan_value_and_grad.launches
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_sim):
        out = ctrl.step(carry, {"y0": ys, "p": params, "centerline": cl})
        ys, carry = f_d(ys, out.u0, params), out.carry
        convs.append(out.result.converged.float().mean())
    sync(dev)
    wall = time.perf_counter() - t0
    row = {"exp": name, "batch": batch, "n_sim": n_sim,
           "mean_total_inner_iters": round(float(
               carry.tot_it.float().mean()), 1),
           "mean_failures": round(float(carry.failures.float().mean()), 3),
           "mean_converged_fraction": round(float(
               torch.stack(convs).mean()), 4),
           "k1_launches": fp.fan_value_and_grad.launches - launches0,
           "wall_s": round(wall, 3),
           "states_finite": bool(torch.isfinite(ys).all())}
    print(json.dumps(row), flush=True)
    return row


def controllers(dev: torch.device) -> dict:
    """The headline's controller as built (``verbatim``) and with the
    shift as its ``warm_prep`` (``shifted``)."""
    base = build_vehicle_controller(
        n_horiz=12, alm_cfg=AlmConfig(eps=1e-4),
        panoc_cfg=PanocConfig(lbfgs_memory=12, max_iter=300), device=dev)
    shifted = copy.copy(base)
    shifted.warm_prep = shift
    return {"verbatim": base, "shifted": shifted}


@torch.no_grad()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--roads", nargs="*", default=list(ROADS),
                    choices=list(ROADS))
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n-sim", type=int, default=20)
    ap.add_argument("--record", action="store_true")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = start(args.device)

    rows = {}
    for road in args.roads:
        cl = ROADS[road](100, device=dev)
        for kind, ctrl in controllers(dev).items():
            name = f"{road}_{kind}"
            rows[name] = run(name, ctrl, cl, dev, args.n_sim, args.batch)

    if args.record and rows:
        from mpc_tpu_torch.utils import perfdb
        rec = {"config": "11: shifted vs verbatim warm start "
                         f"(RTI rotation trick, N=12, {args.n_sim} steps)",
               "source": "python -m mpc_tpu_torch.examples.exp_shift_warm "
                         "--record"}
        for name, row in rows.items():
            rec[name] = (f"{row['mean_total_inner_iters']} mean inner iters, "
                         f"{row['mean_failures']} failures, conv "
                         f"{row['mean_converged_fraction']}, "
                         f"{row['k1_launches']} K1 launches")
        perfdb.record("11", rec)
    return rows


if __name__ == "__main__":
    main()
