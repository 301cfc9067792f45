"""The port's closed-loop vehicle demo (mpc_tpu_torch/examples/
vehicle_mpc.py) against the JAX package's examples/vehicle_mpc.py, both
run as a user runs them (``main()``, the JAX script loaded from its path,
its stdout captured), at ``--n-sim 3 --n-horiz 4``: the reference's
``tot_it failures`` line equal, the JSON keys equal, the final state within
1e-3 (tests/test_torch_closedloop.py's band). Then the port's batched run:
a lane of ``--batch 4`` that starts where the batch-1 run starts ends
within 1e-5 of it, so batching the lanes changes no lane's closed loop.
"""

import importlib.util
import json
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from mpc_tpu_torch.examples import vehicle_mpc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--n-sim", "3", "--n-horiz", "4"]


def run_jax_example(name, argv):
    """Run the JAX package's ``examples/<name>.py`` ``main()`` with
    ``argv``; returns its printed lines."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lines = []
    mod.print = lambda *a, **k: lines.append(" ".join(map(str, a)))
    with mock.patch.object(sys, "argv", [name, *argv]):
        mod.main()
    return lines


@pytest.fixture(scope="module")
def batch1():
    return vehicle_mpc.main(ARGV + ["--device", "cpu"])


def test_vehicle_mpc_matches_the_jax_script(batch1):
    lines = run_jax_example("vehicle_mpc", ARGV)
    tot_it, failures = map(int, lines[0].split())
    ref = json.loads(lines[1])
    assert (batch1["tot_it"], batch1["failures"]) == (tot_it, failures)
    assert set(ref) <= set(batch1)
    assert batch1["n_sim"] == ref["n_sim"] == 3
    np.testing.assert_allclose(batch1["final_state"], ref["final_state"],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(batch1["final_states"][0],
                               ref["final_state"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(batch1["mean_speed"], ref["mean_speed"],
                               rtol=0, atol=1e-3)


def test_a_batched_lane_equals_the_single_run(batch1, monkeypatch, capsys):
    draw = vehicle_mpc.initial_states

    def with_reference_lane(batch, circle):
        y0s = draw(batch, circle)
        y0s[1] = draw(0, circle)[0]
        return y0s

    monkeypatch.setattr(vehicle_mpc, "initial_states", with_reference_lane)
    got = vehicle_mpc.main(ARGV + ["--batch", "4", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert set(printed) == {"batch", "n_sim", "wall_s", "solves_per_s",
                            "converged_fraction"}
    assert got["batch"] == 4 and got["converged_fraction"] == 1.0
    assert got["final_states"].shape == (4, 6)
    np.testing.assert_allclose(got["final_states"][1],
                               batch1["final_states"][0], rtol=0, atol=1e-5)



def jax_circle_spread(n_sim: int = 100, draws: int = 15, seed: int = 0):
    """The JAX package's ``--circle`` closed loop from the script's initial
    state and from that state moved by one ulp in one component per draw:
    failures and the most inner iterations of a step, per run."""
    import jax.numpy as jnp

    from mpc_tpu.config import AlmConfig, PanocConfig
    from mpc_tpu.control.mpc import build_vehicle_controller
    from mpc_tpu.models.bicycle import pacejka_dynamics
    from mpc_tpu.models.integrators import discretize
    from mpc_tpu.models.params import VehicleParams
    from mpc_tpu.ops.road import circle_centerline
    from mpc_tpu.sim.closedloop import run_closed_loop_jit

    ctrl = build_vehicle_controller(
        n_horiz=12, alm_cfg=AlmConfig(eps=1e-4),
        panoc_cfg=PanocConfig(lbfgs_memory=12, max_iter=300))
    params = VehicleParams()
    run = run_closed_loop_jit(ctrl, discretize(pacejka_dynamics), n_sim)
    y0 = vehicle_mpc.initial_states(0, True)[0]
    rng = np.random.default_rng(seed)
    ys = [y0]
    for _ in range(draws):
        moved = y0.copy()
        i = rng.integers(0, y0.size)
        moved[i] = np.nextafter(moved[i], np.float32(
            np.inf if rng.random() < 0.5 else -np.inf))
        ys.append(moved)
    out = jax.jit(jax.vmap(lambda y: run(y, {"p": params, "centerline":
                                             circle_centerline(100)},
                                         params)))(jnp.asarray(np.stack(ys)))
    return {"failures": np.asarray(out.carry.failures).tolist(),
            "max_inner": np.asarray(out.inner_iters).max(axis=1).tolist()}


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(jax_circle_spread()))
