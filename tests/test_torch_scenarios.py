"""Parity of the port's scenario suites (mpc_tpu_torch/sim/scenarios.py) with
the JAX package's ``run_scenario_suite`` and ``run_scenario_suite_two_tier``
on one JAX ``random_scenarios`` batch (JAX -> numpy -> the port, so no
native library is needed): every lane on its own road.

Converged flags and straggler counts per step must be equal; plant states
within a band (ROADMAP, "How to judge a fault"). The cheap tier is capped
low enough (8 iterations, as tests/test_scenarios.py:88-110) that
stragglers occur and the full tier rescues them.
"""

import functools

import jax
import numpy as np
import torch

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.control.mpc import build_vehicle_controller
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.sim import scenarios as jsc
from mpc_tpu_torch import config as tconfig
from mpc_tpu_torch.control import mpc as tmpc
from mpc_tpu_torch.convert import scenario_batch_from_numpy
from mpc_tpu_torch.models import bicycle as tbicycle
from mpc_tpu_torch.models import integrators as tintegrators
from mpc_tpu_torch.models.params import VehicleParams as TVehicleParams
from mpc_tpu_torch.sim import scenarios as tsc

torch.set_num_threads(1)

B, N_HORIZ, N_SIM, EPS = 8, 8, 4, 1e-4
CHEAP_ITERS, FULL_ITERS, PAD = 8, 120, 8
# The solves stop at a criterion of EPS and f32 reassociation moves each a
# little, so the applied inputs agree closely and the states they move a
# little less: on an arc road whose lane needs 70-80 PANOC iterations a
# step (81 in the port, 71 in JAX) the inputs differ by 6.4e-4 and the yaw
# rate, which integrates them, by 5.5e-3 after 4 steps (measured). A wrong
# road or a wrong lane's state moves them by orders of magnitude more.
INPUT_BAND = dict(rtol=0, atol=1e-3)
STATE_BAND = dict(rtol=0, atol=1e-2)


@functools.lru_cache(maxsize=None)
def _scenarios():
    sc = jsc.random_scenarios(jax.random.PRNGKey(3), batch=B, size=100)
    return sc, scenario_batch_from_numpy(*(np.asarray(a) for a in sc))


def _controllers(port, max_iters):
    out = []
    for it in max_iters:
        if port:
            out.append(tmpc.build_vehicle_controller(
                n_horiz=N_HORIZ, alm_cfg=tconfig.AlmConfig(eps=EPS),
                panoc_cfg=tconfig.PanocConfig(lbfgs_memory=N_HORIZ,
                                              max_iter=it), device="cpu"))
        else:
            out.append(build_vehicle_controller(
                n_horiz=N_HORIZ, alm_cfg=AlmConfig(eps=EPS),
                panoc_cfg=PanocConfig(lbfgs_memory=N_HORIZ, max_iter=it)))
    return out


def test_scenario_batch_carries_every_road_kind():
    # the JAX batch the parity tests run: straight, arc and lane-change
    # roads (a lane-change road is a Bezier whose start heading is 0 and
    # end heading 0; an arc bends one way throughout; a straight does not)
    _, sc = _scenarios()
    d = torch.diff(sc.centerline, dim=1)
    heading = torch.atan2(d[..., 1], d[..., 0])
    turn = torch.diff(heading, dim=1)
    straight = turn.abs().amax(dim=1) < 1e-4
    arc = (turn.abs().amin(dim=1) > 1e-4) & ~straight
    assert bool(straight.any()) and bool(arc.any()) \
        and bool((~straight & ~arc).any())


def test_suite_matches_jax():
    jsc_, sc = _scenarios()
    (jctrl,) = _controllers(False, (FULL_ITERS,))
    (tctrl,) = _controllers(True, (FULL_ITERS,))
    ref = jsc.run_scenario_suite(jctrl, discretize(pacejka_dynamics), jsc_,
                                 VehicleParams(), N_SIM)
    out = tsc.run_scenario_suite(
        tctrl, tintegrators.discretize(tbicycle.pacejka_dynamics), sc,
        TVehicleParams(), N_SIM)
    assert out.ys.shape == (B, N_SIM, 6)
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_allclose(out.us.numpy(), np.asarray(ref.us),
                               **INPUT_BAND)
    np.testing.assert_allclose(out.ys.numpy(), np.asarray(ref.ys),
                               **STATE_BAND)
    ref_sum = jsc.suite_summary(ref, jsc_)
    got_sum = tsc.suite_summary(out, sc)
    assert got_sum.keys() == ref_sum.keys()
    for k in ("scenarios", "steps", "total_solves", "converged_fraction",
              "nan_scenarios"):
        assert got_sum[k] == ref_sum[k], k


def test_two_tier_suite_matches_jax():
    jsc_, sc = _scenarios()
    jfull, jcheap = _controllers(False, (FULL_ITERS, CHEAP_ITERS))
    tfull, tcheap = _controllers(True, (FULL_ITERS, CHEAP_ITERS))
    ref_state, ref_conv = jsc.run_scenario_suite_two_tier(
        jfull, jcheap, discretize(pacejka_dynamics), jsc_, VehicleParams(),
        N_SIM, straggler_pad=PAD)
    state, conv = tsc.run_scenario_suite_two_tier(
        tfull, tcheap, tintegrators.discretize(tbicycle.pacejka_dynamics),
        sc, TVehicleParams(), N_SIM, straggler_pad=PAD)
    st, ref_st = state["stats"], ref_state["stats"]
    # the cheap tier alone is not enough, and the straggler tier rescues
    assert sum(st["n_stragglers"]) > 0
    assert conv.shape == (B, N_SIM) and conv.mean() > 0.95
    assert st["n_stragglers"] == ref_st["n_stragglers"]
    np.testing.assert_array_equal(conv, ref_conv)
    assert set(ref_st) <= set(st)
    assert all(len(st[k]) == N_SIM for k in st)
    np.testing.assert_allclose(state["ys"].numpy(),
                               np.asarray(ref_state["ys"]), **STATE_BAND)
    for k in ("tot_it", "failures"):
        assert getattr(state["carries"], k).shape == (B,)
    np.testing.assert_array_equal(state["carries"].failures.numpy(),
                                  np.asarray(ref_state["carries"].failures))


def test_random_scenarios_draws_the_three_kinds_reproducibly():
    def draw(seed):
        return tsc.random_scenarios(
            64, size=50, n_obstacles=3,
            generator=torch.Generator().manual_seed(seed))

    sc = draw(7)
    assert sc.y0.shape == (64, 6) and sc.centerline.shape == (64, 50, 2)
    assert sc.obstacles.shape == (64, 3, 4)
    assert bool(torch.isfinite(sc.centerline).all())
    assert bool((sc.y0[:, 3] >= 0.2).all() and (sc.y0[:, 3] <= 1.0).all())
    steps = torch.linalg.vector_norm(torch.diff(sc.centerline, dim=1), dim=2)
    assert float(steps.min()) > 1e-6
    # the car starts within 5 cm across the road's first point
    d = torch.linalg.vector_norm(sc.y0[:, :2] - sc.centerline[:, 0], dim=1)
    assert float(d.max()) <= 0.05 + 1e-6
    # arcs and lane changes start at the origin heading +x; straights at a
    # random offset
    at_origin = sc.centerline[:, 0].abs().amax(dim=1) < 1e-6
    assert 0 < int(at_origin.sum()) < 64
    assert torch.equal(draw(7).centerline, sc.centerline)
    assert not torch.equal(draw(8).centerline, sc.centerline)
