"""Randomized scenario suite end to end, BASELINE.json config 5 (port of
examples/scenario_suite.py:33-69).

Generates the scenarios (roads, initial states, obstacles) with the native
C++ generator, rolls them through the batched MPC closed loop, one road per
lane, in checkpointed segments (``sim/scenarios.py:
run_scenario_suite_resumable``), and reports aggregate metrics. Its fan is
kernel K1 at a road stride ("K1 roads") on the card: E = 5 x batch lanes a
candidate fan, 2 x batch an init pair.

    python -m mpc_tpu_torch.examples.scenario_suite [--batch 2048]
        [--n-sim 50] [--segment 10] [--checkpoint ck.npz] [--seed 0]
        [--device D]

A run that finds ``--checkpoint`` resumes from it. Prints the device,
whether the native generator loads, then ``{"batch", "n_sim",
"generation_s", "rollout_s", "solves_per_s", "converged_fraction",
"nan_scenarios", "mean_final_speed"}``; ``converged_fraction`` is null
when the checkpoint was already at ``--n-sim``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from mpc_tpu_torch.config import AlmConfig, PanocConfig
from mpc_tpu_torch.control.mpc import build_vehicle_controller
from mpc_tpu_torch.examples import add_device_arg, start, sync
from mpc_tpu_torch.io.native_scenarios import (generate_scenarios,
                                               native_available)
from mpc_tpu_torch.models.bicycle import pacejka_dynamics
from mpc_tpu_torch.models.integrators import discretize
from mpc_tpu_torch.models.params import VehicleParams
from mpc_tpu_torch.sim.scenarios import run_scenario_suite_resumable


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--n-sim", type=int, default=50)
    ap.add_argument("--segment", type=int, default=10)
    ap.add_argument("--checkpoint", type=str, default="")
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = start(args.device)

    print(f"native generator: {native_available()}")
    t0 = time.perf_counter()
    sc = generate_scenarios(seed=args.seed, batch=args.batch, size=100,
                            device=dev)
    sync(dev)
    t_gen = time.perf_counter() - t0

    ctrl = build_vehicle_controller(
        n_horiz=12, alm_cfg=AlmConfig(eps=1e-4),
        panoc_cfg=PanocConfig(lbfgs_memory=12, max_iter=60), device=dev)
    f_d = discretize(pacejka_dynamics)

    t0 = time.perf_counter()
    state, conv = run_scenario_suite_resumable(
        ctrl, f_d, sc, VehicleParams(), args.n_sim, segment=args.segment,
        checkpoint_path=args.checkpoint or None)
    sync(dev)
    dt = time.perf_counter() - t0

    ys = state["ys"].cpu().numpy()
    result = {
        "batch": args.batch, "n_sim": args.n_sim,
        "generation_s": round(t_gen, 3),
        "rollout_s": round(dt, 3),
        "solves_per_s": round(args.batch * args.n_sim / dt, 1),
        "converged_fraction": round(float(conv.mean()), 4)
        if conv is not None else None,
        "nan_scenarios": int(np.isnan(ys).any(axis=1).sum()),
        "mean_final_speed": round(float(np.abs(ys[:, 3]).mean()), 4),
    }
    print(json.dumps(result))
    return dict(result, final_states=ys, converged=conv)


if __name__ == "__main__":
    main()
