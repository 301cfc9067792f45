"""Game-theoretic lane-change decision demo (port of
examples/lane_change_game.py:24-58; reference game_theory.py:352-395).

Runs the three reference fixtures through the decision rollout and prints
the first lane-change time of each, the analogue of the reference's
"Changing lanes at:" prints. No kernel: batched torch ops.

    python -m mpc_tpu_torch.examples.lane_change_game [--plot out.png]
        [--device D]

Prints the device, then ``{"test_1": {"first_change_t",
"n_change_steps"}, "test_2": ..., "test_3": ...}``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from mpc_tpu_torch.decision.game_theory import (decision_rollout,
                                                scenario_1, scenario_2,
                                                scenario_3)
from mpc_tpu_torch.examples import add_device_arg, start

DT, N_STEPS = 0.1, 50


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--plot", type=str, default="")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = start(args.device)

    results, curves = {}, {}
    for name, fixture in (("test_1", scenario_1), ("test_2", scenario_2),
                          ("test_3", scenario_3)):
        ego, cars = fixture(device=dev)
        payoffs, change = decision_rollout(ego, cars, n_steps=N_STEPS, dt=DT)
        payoffs = payoffs[0].cpu().numpy()
        change = change[0].cpu().numpy()
        t_change = float(np.argmax(change) * DT) if change.any() else None
        results[name] = {"first_change_t": t_change,
                         "n_change_steps": int(change.sum())}
        curves[name] = payoffs

    print(json.dumps(results))

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        t = np.arange(N_STEPS) * DT
        fig, axes = plt.subplots(3, 1, figsize=(8, 9), sharex=True)
        for ax, (name, p) in zip(axes, curves.items()):
            ax.plot(t, p[:, 0], label="lane 1")
            ax.plot(t, p[:, 1], label="lane 2")
            ax.set_title(name)
            ax.grid(True)
            ax.legend()
        fig.savefig(args.plot, dpi=100)
        plt.close(fig)
        print("saved", args.plot)
    return dict(results, payoffs=curves)


if __name__ == "__main__":
    main()
