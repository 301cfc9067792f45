"""Hanging-chain MPC demo (port of examples/hanging_chain.py:31-95; the
reference's alpaqa_example.py flow).

Disturb the chain for 3 steps, simulate it uncontrolled, then run the
constrained MPC closed loop and report the free end and the floor
violations with and without MPC. The chain's OCP runs the plain fan: no
kernel.

    python -m mpc_tpu_torch.examples.hanging_chain [--n-sim 180]
        [--plot out.png] [--device D]

Prints the device, the reference's ``tot_it failures`` line and
``{"n_sim", "wall_s", "free_end_final", "max_floor_violation_mpc",
"max_floor_violation_uncontrolled"}``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from mpc_tpu_torch.config import PanocConfig
from mpc_tpu_torch.control.chain_mpc import (build_chain_controller,
                                             floor_coefficients, g_constr)
from mpc_tpu_torch.examples import add_device_arg, start, sync
from mpc_tpu_torch.models.chain import (ChainSpec, chain_dynamics,
                                        chain_state_to_pos)
from mpc_tpu_torch.models.integrators import discretize, rollout
from mpc_tpu_torch.models.params import ChainParams
from mpc_tpu_torch.sim.closedloop import run_closed_loop


def floor_violation(spec: ChainSpec, coeff: torch.Tensor, lb: float,
                    ys: np.ndarray) -> float:
    """The largest amount by which a ball of the states ``ys`` (T, sd) lies
    below the floor g(x) + lb."""
    n, d = spec.n_balls, spec.dim
    y1 = torch.as_tensor(ys[:, : n * d].reshape(-1, n, d))
    gx = g_constr(coeff.cpu(), y1[..., 0])
    return float(((gx + lb) - y1[..., 1]).max())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-sim", type=int, default=180)
    ap.add_argument("--plot", type=str, default="")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = start(args.device)

    spec = ChainSpec(n_balls=6, dim=2)
    params = ChainParams()
    f_d = discretize(chain_dynamics(spec))

    # disturb (alpaqa_example.py:158-161)
    y = spec.initial_state(1, device=dev)
    push = torch.tensor([[-0.5, 0.5]], device=dev)
    for _ in range(3):
        y = f_d(y, push, params)

    # uncontrolled simulation (alpaqa_example.py:165-167)
    y_free = rollout(f_d, y, torch.zeros((1, args.n_sim, 2), device=dev),
                     params)[0].cpu().numpy()

    ctrl = build_chain_controller(
        spec, n_horiz=12, panoc_cfg=PanocConfig(lbfgs_memory=12, max_iter=250),
        device=dev)
    coeff, lb = floor_coefficients(device=dev)

    sync(dev)
    t0 = time.perf_counter()
    out = run_closed_loop(ctrl, f_d, y, {"p": params, "constr": coeff},
                          args.n_sim, params)
    sync(dev)
    dt = time.perf_counter() - t0

    ys = out.ys[0].cpu().numpy()
    tot_it, failures = int(out.carry.tot_it[0]), int(out.carry.failures[0])
    print(tot_it, failures)
    viol_mpc = floor_violation(spec, coeff, lb, ys)
    viol_free = floor_violation(spec, coeff, lb, y_free)
    result = {"n_sim": args.n_sim, "wall_s": round(dt, 3),
              "free_end_final": [round(float(v), 4) for v in ys[-1, -2:]],
              "max_floor_violation_mpc": round(viol_mpc, 4),
              "max_floor_violation_uncontrolled": round(viol_free, 4)}
    print(json.dumps(result))

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots()
        for traj, label in ((y_free, "without MPC"), (ys, "with MPC")):
            xs, yy, _ = chain_state_to_pos(spec, torch.as_tensor(traj[-1:]))
            ax.plot(xs[0].numpy(), yy[0].numpy(), "-o", label=label)
        xs_f = torch.linspace(-0.25, 1.25, 200)
        ax.plot(xs_f.numpy(), (g_constr(coeff.cpu(), xs_f) + lb).numpy(),
                "g--", label="floor")
        ax.legend()
        fig.savefig(args.plot, dpi=100)
        plt.close(fig)
        print("saved", args.plot)
    return dict(result, tot_it=tot_it, failures=failures,
                converged_fraction=float(out.converged.float().mean()),
                max_floor_violation_mpc_unrounded=viol_mpc, ys=ys,
                U=out.carry.U[0].cpu().numpy())


if __name__ == "__main__":
    main()
