"""Closed-loop vehicle MPC demo, the reference's primary entry point (port of
examples/vehicle_mpc.py:34-91; reference main.py:62-177).

400 steps, horizon 12, a straight (or circular) 100-point centerline,
v_ref = 1.0, the plant stepped by the prediction model. The JAX script's
``vmap`` of its compiled closed loop over many initial states is one
batched closed loop here (``sim/closedloop.py:run_closed_loop``), whose
fan is kernel K1 on the card.

    python -m mpc_tpu_torch.examples.vehicle_mpc [--circle] [--batch B]
        [--n-sim 400] [--n-horiz 12] [--plot out.png] [--device D]

Prints the device, then as the JAX script: for one car the reference's
``tot_it failures`` line and ``{"n_sim", "wall_s", "final_state",
"mean_speed"}``; with ``--batch B``, B cars whose initial speeds are drawn
from U(0.3, 1.0) (``default_rng(0)``), ``{"batch", "n_sim", "wall_s",
"solves_per_s", "converged_fraction"}``.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from mpc_tpu_torch.config import AlmConfig, PanocConfig
from mpc_tpu_torch.control.mpc import build_vehicle_controller
from mpc_tpu_torch.examples import add_device_arg, start, sync
from mpc_tpu_torch.models.bicycle import pacejka_dynamics
from mpc_tpu_torch.models.integrators import discretize
from mpc_tpu_torch.models.params import VehicleParams
from mpc_tpu_torch.ops.road import circle_centerline, straight_centerline
from mpc_tpu_torch.sim.closedloop import run_closed_loop


def initial_states(batch: int, circle: bool) -> np.ndarray:
    """The reference's initial state (main.py:72-79) as a batch of one, or
    ``batch`` copies with the speed drawn from U(0.3, 1.0)
    (examples/vehicle_mpc.py:55-63)."""
    y0 = np.array([5.0, 5.0, math.pi / 2, 0.5, 0.0, 0.0] if circle
                  else [0.0, 0.0, 0.0, 0.5, 0.0, 0.0], np.float32)
    if not batch:
        return y0[None]
    rng = np.random.default_rng(0)
    y0s = np.tile(y0, (batch, 1))
    y0s[:, 3] = rng.uniform(0.3, 1.0, batch)
    return y0s


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--circle", action="store_true")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--n-sim", type=int, default=400)
    ap.add_argument("--n-horiz", type=int, default=12)
    ap.add_argument("--plot", type=str, default="")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = start(args.device)

    ctrl = build_vehicle_controller(
        n_horiz=args.n_horiz, alm_cfg=AlmConfig(eps=1e-4),
        panoc_cfg=PanocConfig(lbfgs_memory=args.n_horiz, max_iter=300),
        device=dev)
    params = VehicleParams()
    f_d = discretize(pacejka_dynamics)
    road = circle_centerline if args.circle else straight_centerline
    cl = road(100, device=dev)
    y0 = torch.as_tensor(initial_states(args.batch, args.circle), device=dev)

    sync(dev)
    t0 = time.perf_counter()
    out = run_closed_loop(ctrl, f_d, y0, {"p": params, "centerline": cl},
                          args.n_sim, params)
    sync(dev)
    dt = time.perf_counter() - t0
    ys = out.ys.cpu().numpy()                   # (B, n_sim, 6)
    conv = out.converged.cpu().numpy()
    extra = {"tot_it": int(out.carry.tot_it.sum()),
             "failures": int(out.carry.failures.sum()),
             "converged_fraction": float(conv.mean()),
             "final_states": ys[:, -1]}

    if args.batch:
        result = {"batch": args.batch, "n_sim": args.n_sim,
                  "wall_s": round(dt, 3),
                  "solves_per_s": round(args.batch * args.n_sim / dt, 1),
                  "converged_fraction": float(conv.mean())}
        print(json.dumps(result))
        return dict(extra, **result)

    # the reference prints tot_it and failures at the end (main.py:154)
    print(extra["tot_it"], extra["failures"])
    result = {"n_sim": args.n_sim, "wall_s": round(dt, 3),
              "final_state": [round(float(v), 4) for v in ys[0, -1]],
              "mean_speed": round(float(ys[0, :, 3].mean()), 4)}
    print(json.dumps(result))
    if args.plot:
        from mpc_tpu_torch.viz.plots import plot_closed_loop
        plot_closed_loop(cl, ys[0], "vehicle closed loop", args.plot)
        print("saved", args.plot)
    return dict(extra, **result)


if __name__ == "__main__":
    main()
