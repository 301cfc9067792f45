"""The port's lane-change decision demo (mpc_tpu_torch/examples/
lane_change_game.py) against the JAX package's examples/
lane_change_game.py, both run as a user runs them (``main()``, the JAX
script loaded from its path, its stdout captured): each of the three
reference fixtures' first change time and number of change steps exactly
equal, the decisions being the layer's output (ROADMAP, "How to judge a
fault"); the payoff curves within 1e-4 relative.
"""

import importlib.util
import json
import os
import sys
from unittest import mock

import numpy as np
import torch

from mpc_tpu_torch.examples import lane_change_game

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_jax_example(name, argv, patch=None):
    """Run the JAX package's ``examples/<name>.py`` ``main()`` with
    ``argv``; returns its printed lines. ``patch(module)`` may wrap the
    module's names before the run."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lines = []
    mod.print = lambda *a, **k: lines.append(" ".join(map(str, a)))
    if patch is not None:
        patch(mod)
    with mock.patch.object(sys, "argv", [name, *argv]):
        mod.main()
    return lines


def test_lane_change_game_matches_the_jax_script(tmp_path):
    payoffs = []

    def keep_payoffs(mod):
        rollout = mod.decision_rollout

        def decision_rollout(*args, **kwargs):
            out = rollout(*args, **kwargs)
            payoffs.append(np.asarray(out[0]))
            return out
        mod.decision_rollout = decision_rollout

    ref = json.loads(run_jax_example("lane_change_game", [],
                                     keep_payoffs)[0])
    plot = tmp_path / "game.png"
    got = lane_change_game.main(["--device", "cpu", "--plot", str(plot)])
    assert set(ref) == {"test_1", "test_2", "test_3"}
    for name, r in ref.items():
        assert got[name] == r, name
    assert any(r["first_change_t"] is not None for r in ref.values())
    for name, p in zip(ref, payoffs):
        np.testing.assert_allclose(got["payoffs"][name], p, rtol=1e-4,
                                   err_msg=name)
    assert plot.stat().st_size > 0
