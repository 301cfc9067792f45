"""Parity of the port's small modules with the JAX package's: the simple
controllers (mpc_tpu_torch/control/simple.py: Adam single shooting, the
fixed-target variant, the straight-line controller), ``input_to_matrix``,
the timing utilities (mpc_tpu_torch/utils/timing.py) and the plots
(mpc_tpu_torch/viz/plots.py, under matplotlib's Agg backend, on tensors).

Tolerance: the Adam controllers' inputs within 1e-4 of JAX's after 100
steps (float32 rounding of the gradient and of the bias correction), their
costs within 1e-4 relative; the rest exact or to float32 rounding.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.control import mpc as jmpc
from mpc_tpu.control import simple as jsimple
from mpc_tpu.models.bicycle import pacejka_dynamics, simplified_dynamics
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.road import straight_centerline
from mpc_tpu.utils import timing as jtiming
from mpc_tpu_torch.control import mpc as tmpc
from mpc_tpu_torch.control import simple as tsimple
from mpc_tpu_torch.models import bicycle as tbicycle
from mpc_tpu_torch.models.params import VehicleParams as TVehicleParams
from mpc_tpu_torch.ops.road import straight_centerline as tstraight
from mpc_tpu_torch.utils import timing as ttiming
from mpc_tpu_torch.viz import plots as tplots

torch.set_num_threads(1)

PARAMS, TPARAMS = VehicleParams(), TVehicleParams()


def _jpacejka(x, u, t):
    return pacejka_dynamics(x, u, PARAMS, clip=True)


def _tpacejka(x, u, t):
    return tbicycle.pacejka_dynamics(x, u, TPARAMS, clip=True)


def test_simple_mpc_matches_jax():
    x0 = np.array([[0.0, 0.0, 0.0, 0.3, 0.0, 0.0],
                   [0.0, 0.3, 0.0, 0.5, 0.0, 0.0]], np.float32)
    kw = dict(n_horiz=4, dt=0.1, target_velocity=1.0, iters=100)
    got = tsimple.simple_mpc(_tpacejka, torch.as_tensor(x0), tstraight(100),
                             **kw)
    for b in range(2):
        want = jsimple.simple_mpc(_jpacejka, jnp.asarray(x0[b]),
                                  straight_centerline(100), **kw)
        np.testing.assert_allclose(got.u_seq[b].numpy(),
                                   np.asarray(want.u_seq), rtol=0, atol=1e-4)
        np.testing.assert_allclose(float(got.cost[b]), float(want.cost),
                                   rtol=1e-4)
    # drive forward to speed up; steer right towards the line
    assert float(got.u0[0, 0]) > 0.1 and float(got.u0[1, 1]) < 0.0


def test_simple_mpc_initial_matches_jax():
    def jsim(x, u, t):
        return simplified_dynamics(x, u, PARAMS, clip=True)

    def tsim(x, u, t):
        return tbicycle.simplified_dynamics(x, u, TPARAMS, clip=True)

    x0 = np.zeros((1, 4), np.float32)
    target = np.array([0.2, 0.0, 0.0, 0.0], np.float32)
    kw = dict(n_horiz=3, dt=0.1, iters=100)
    got = tsimple.simple_mpc_initial(tsim, torch.as_tensor(x0),
                                     torch.as_tensor(target), **kw)
    want = jsimple.simple_mpc_initial(jsim, jnp.asarray(x0[0]),
                                      jnp.asarray(target), **kw)
    np.testing.assert_allclose(got.u_seq[0].numpy(), np.asarray(want.u_seq),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(got.cost[0]), float(want.cost),
                               rtol=1e-4)


def test_straight_line_controller_matches_jax():
    states = np.array([[0.5, 0.1, 0.0, 0.5, 0.0, 0.0],
                       [2.33, -0.04, 0.2, 0.5, 0.0, 0.0]], np.float32)
    got = tsimple.straight_line_controller(torch.as_tensor(states),
                                           tstraight(100))
    for b in range(2):
        want = jsimple.straight_line_controller(jnp.asarray(states[b]),
                                                straight_centerline(100))
        np.testing.assert_array_equal(got.u[b].numpy(), np.asarray(want.u))
        assert int(got.nearest_index[b]) == int(want.nearest_index)
        np.testing.assert_array_equal(got.nearest_point[b].numpy(),
                                      np.asarray(want.nearest_point))
        for g, w in zip(got.errors, want.errors):
            np.testing.assert_allclose(float(g[b]), float(w), rtol=1e-5,
                                       atol=1e-7)


def test_input_to_matrix_matches_jax():
    u = np.arange(24, dtype=np.float32).reshape(2, 12)
    got = tmpc.input_to_matrix(torch.as_tensor(u))
    assert got.shape == (2, 2, 6)
    for b in range(2):
        np.testing.assert_array_equal(
            got[b].numpy(), np.asarray(jmpc.input_to_matrix(
                jnp.asarray(u[b]))))


def test_percentile_summary_and_step_metrics_match_jax():
    samples = [0.3, 0.1, 0.25, 0.7, 0.05]
    assert ttiming.percentile_summary(samples) == \
        jtiming.percentile_summary(samples)
    tm, jm = ttiming.StepMetrics(), jtiming.StepMetrics()
    for lat, it, conv in ((0.2, [3, 4], [True, True]),
                          (0.4, [10, 2], [False, True])):
        tm.record(lat, torch.tensor(it), torch.tensor(conv))
        jm.record(lat, jnp.asarray(it), jnp.asarray(conv))
    assert tm.summary() == jm.summary()
    assert tm.summary()["failures"] == 1 and tm.summary()["solves"] == 4


def test_timers_and_profile_trace(tmp_path):
    out = {}
    with ttiming.device_timer(out, "t"):
        x = torch.ones(100).sum()
    assert out["t"] >= 0.0
    val, sec = ttiming.timed(lambda a: a * 2, x)
    assert float(val) == 200.0 and sec >= 0.0
    with ttiming.profile_trace(str(tmp_path / "prof")):
        torch.ones(10).cumsum(0)
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0


def _traj(n=20):
    t = torch.linspace(0, 1, n)
    y = 0.1 * torch.sin(2 * np.pi * t)
    u = torch.stack([torch.ones(n), 0.1 * torch.ones(n)])
    return t, t, y, torch.zeros(n), torch.ones(n), torch.zeros(n), \
        torch.zeros(n), u


@pytest.mark.parametrize("plot", ["results", "trajectory", "closed_loop"])
def test_plots_take_tensors(tmp_path, plot):
    pytest.importorskip("matplotlib")
    t, x, y, phi, vx, vy, om, u = _traj()
    path = str(tmp_path / f"{plot}.png")
    if plot == "results":
        got = tplots.plot_results(t, x, y, phi, vx, vy, om, u, "t", path)
    elif plot == "trajectory":
        got = tplots.plot_trajectory(x, y, phi, u, "t", path)
    else:
        got = tplots.plot_closed_loop(tstraight(10),
                                      torch.stack([x, y], 1)[:10],
                                      save_path=path)
    assert got == path and os.path.getsize(path) > 0
    c = tplots.car_corners(TPARAMS, 0.0, 0.0, 0.3)
    assert c.shape == (5, 2)
    np.testing.assert_allclose(c[0], c[4])
