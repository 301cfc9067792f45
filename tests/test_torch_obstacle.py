"""Parity of the port's plain vehicle OCP (``build_vehicle_ocp`` with
``window``, ``errors_fn`` or the obstacle field; mpc_tpu_torch/control/
mpc.py) and of the obstacle term in the suites and in AL-iLQR with the JAX
package's.

- The OCP's cost and gradient against JAX's on drawn inputs: cost within
  1e-5 relative, gradient within 1e-4 of the lane's largest entry (float32
  rounding of two frameworks' transcendental functions).
- A closed loop with the obstacle term against JAX's controller, the port
  stepped from JAX's state and carry each step: converged flags equal,
  first inputs within 2e-3 and the cost of the returned inputs within
  1e-3 relative (ROADMAP, "How to judge a fault": the solves stop at a
  float32 criterion, so their iteration counts move with rounding).
- The suites pass each lane's obstacles (the straggler tier's gathered
  with their roads), and the suite with obstacles runs as the JAX package's
  own test does (tests/test_obstacle_avoidance.py:82-100).

AL-iLQR with the term: tests/test_torch_obstacle_ilqr.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.control import mpc as jmpc
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops import road as jroad
from mpc_tpu.sim.scenarios import random_scenarios
from mpc_tpu_torch import config as tconfig
from mpc_tpu_torch.control import mpc as tmpc
from mpc_tpu_torch.convert import carry_from_numpy, scenario_batch_from_numpy
from mpc_tpu_torch.models import bicycle as tbicycle
from mpc_tpu_torch.models import integrators as tintegrators
from mpc_tpu_torch.models.params import VehicleParams as TVehicleParams
from mpc_tpu_torch.ops import road as troad
from mpc_tpu_torch.sim import scenarios as tsc

torch.set_num_threads(1)

PARAMS = VehicleParams()
FIELD = {"a_f": 1.0, "sigma_x": 0.2}
OBSTACLE = np.array([[1.0, 0.05, 0.0, 0.0]], np.float32)
CL = np.array(jroad.straight_centerline(100))
Y0 = np.array([[0.0, 0.0, 0.0, 0.5, 0.0, 0.0],
               [0.1, 0.04, 0.05, 0.7, 0.0, 0.0],
               [0.3, -0.03, -0.1, 0.9, 0.0, 0.0]], np.float32)


def _drawn(seed, B, n_horiz):
    rng = np.random.default_rng(seed)
    u = np.empty((B, 2 * n_horiz), np.float32)
    u[:, 0::2] = rng.uniform(-0.2, 1.0, (B, n_horiz))
    u[:, 1::2] = rng.uniform(-0.3, 0.3, (B, n_horiz))
    y0 = np.zeros((B, 6), np.float32)
    y0[:, 0] = rng.uniform(0.0, 0.8, B)
    y0[:, 1] = rng.uniform(-0.1, 0.1, B)
    y0[:, 3] = rng.uniform(0.3, 1.0, B)
    obs = rng.uniform(0.3, 1.5, (B, 2, 4)).astype(np.float32)
    obs[..., 1] = rng.uniform(-0.1, 0.1, (B, 2))
    return u, y0, obs


@pytest.mark.parametrize("option", ["window", "errors_fn", "obstacles",
                                    "obstacles_per_lane"])
def test_plain_ocp_cost_and_gradient_match_jax(option):
    B, N = 6, 6
    kw = {"window": dict(window=16),
          "errors_fn": dict(errors_fn=(jroad.compute_errors_diagnostic,
                                       troad.compute_errors_diagnostic)),
          "obstacles": dict(obstacle_weight=2.0,
                            obstacle_field_kwargs=FIELD),
          "obstacles_per_lane": dict(obstacle_weight=2.0,
                                     obstacle_field_kwargs=FIELD)}[option]
    jkw = {k: v[0] if k == "errors_fn" else v for k, v in kw.items()}
    tkw = {k: v[1] if k == "errors_fn" else v for k, v in kw.items()}
    jprob = jmpc.build_vehicle_ocp(N, **jkw)
    tprob = tmpc.build_vehicle_ocp(N, device="cpu", **tkw)
    assert tprob.cost_multi is None and tprob.al_multi is None
    assert tprob.uses_obstacles == jprob.uses_obstacles
    u, y0, obs = _drawn(1, B, N)
    if option == "obstacles":
        obs = obs[0]
    per_lane = option == "obstacles_per_lane"

    def jparam(y, o):
        p = {"y0": y, "p": PARAMS, "centerline": jnp.asarray(CL)}
        if jprob.uses_obstacles:
            p["obstacles"] = o
        return p

    jval, jgrad = jax.vmap(
        lambda uu, y, o: jax.value_and_grad(jprob.cost)(uu, jparam(y, o)),
        in_axes=(0, 0, 0 if per_lane else None))(
            jnp.asarray(u), jnp.asarray(y0), jnp.asarray(obs))
    param = {"y0": torch.as_tensor(y0), "p": TVehicleParams(),
             "centerline": torch.as_tensor(CL)}
    if tprob.uses_obstacles:
        param["obstacles"] = torch.as_tensor(obs)
    if tprob.param_prep is not None:
        param = tprob.param_prep(param)
    ut = torch.as_tensor(u).requires_grad_(True)
    val = tprob.cost(ut, param)
    (grad,) = torch.autograd.grad(val.sum(), ut)
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(jval),
                               rtol=1e-5)
    jgrad = np.asarray(jgrad)
    scale = np.abs(jgrad).max(axis=1, keepdims=True)
    assert np.all(np.abs(grad.numpy() - jgrad) <= 1e-4 * scale)


def test_the_options_choose_the_plain_ocp_at_build_time():
    dense = tmpc.build_vehicle_ocp(6, bound_state_constraints=True,
                                   device="cpu")
    assert dense.cost_multi is not None and dense.al_multi is not None
    for kw in (dict(window=8), dict(errors_fn=troad.compute_errors_ocp),
               dict(obstacle_weight=1.0)):
        prob = tmpc.build_vehicle_ocp(6, bound_state_constraints=True,
                                      device="cpu", **kw)
        assert prob.cost_multi is None and prob.al_multi is None
        assert prob.cost_constraints is not None
        assert prob.uses_obstacles == ("obstacle_weight" in kw)


@functools.lru_cache(maxsize=None)
def _obstacle_controllers():
    kw = dict(n_horiz=8, obstacle_weight=2.0, obstacle_field_kwargs=FIELD)
    jctrl = jmpc.build_vehicle_controller(
        alm_cfg=AlmConfig(eps=1e-4),
        panoc_cfg=PanocConfig(lbfgs_memory=8, max_iter=200), **kw)
    f_d = discretize(pacejka_dynamics)
    static = {"p": PARAMS, "centerline": jnp.asarray(CL),
              "obstacles": jnp.asarray(OBSTACLE)}

    @jax.jit
    def jstep(ys, carries):
        def one(y, carry):
            out = jctrl.step(carry, dict(static, y0=y))
            return f_d(y, out.u0, PARAMS), out.carry, out.u0, out.result
        return jax.vmap(one)(ys, carries)

    tctrl = tmpc.build_vehicle_controller(
        alm_cfg=tconfig.AlmConfig(eps=1e-4),
        panoc_cfg=tconfig.PanocConfig(lbfgs_memory=8, max_iter=200),
        device="cpu", **kw)
    return jctrl, jstep, tctrl


def test_obstacle_closed_loop_matches_jax():
    jctrl, jstep, tctrl = _obstacle_controllers()
    jcost = jax.jit(jax.vmap(lambda U, y: jctrl.problem.cost(U, {
        "y0": y, "p": PARAMS, "centerline": jnp.asarray(CL),
        "obstacles": jnp.asarray(OBSTACLE)})))
    ys = jnp.asarray(Y0)
    carries = jax.vmap(lambda _: jctrl.init_carry())(jnp.arange(len(Y0)))
    static = {"p": TVehicleParams(), "centerline": torch.as_tensor(CL),
              "obstacles": torch.as_tensor(OBSTACLE)}
    for k in range(4):
        t_carry = carry_from_numpy(
            {f: np.asarray(v) for f, v in carries._asdict().items()})
        with torch.no_grad():
            out = tctrl.step(t_carry, dict(static,
                                           y0=torch.as_tensor(np.array(ys))))
        y_prev = ys
        ys, carries, u0, res = jstep(ys, carries)
        np.testing.assert_array_equal(out.result.converged.numpy(),
                                      np.asarray(res.converged))
        np.testing.assert_allclose(out.u0.numpy(), np.asarray(u0), rtol=0,
                                   atol=2e-3, err_msg=f"step {k}")
        np.testing.assert_allclose(
            np.asarray(jcost(jnp.asarray(out.carry.U.numpy()), y_prev)),
            np.asarray(jcost(carries.U, y_prev)), rtol=1e-3,
            err_msg=f"step {k}")


class _Spy:
    """A controller that records the obstacles of every step's
    parameters."""

    def __init__(self, ctrl):
        self.ctrl, self.problem, self.seen = ctrl, ctrl.problem, []

    def init_carry(self, *a, **kw):
        return self.ctrl.init_carry(*a, **kw)

    def step(self, carry, param):
        self.seen.append((param["centerline"], param.get("obstacles")))
        return self.ctrl.step(carry, param)


def _port_suite_controller(max_iter, obstacle_weight=1.0):
    return tmpc.build_vehicle_controller(
        n_horiz=8, alm_cfg=tconfig.AlmConfig(eps=1e-3),
        panoc_cfg=tconfig.PanocConfig(lbfgs_memory=8, max_iter=max_iter),
        obstacle_weight=obstacle_weight, obstacle_field_kwargs=FIELD,
        device="cpu")


def _scenarios(B):
    sc = random_scenarios(jax.random.PRNGKey(5), batch=B, size=100)
    return scenario_batch_from_numpy(*(np.asarray(a) for a in sc))


def test_suite_with_obstacles_end_to_end():
    # tests/test_obstacle_avoidance.py:82-100 on the port
    ctrl = _Spy(_port_suite_controller(60))
    assert ctrl.problem.uses_obstacles
    sc = _scenarios(8)
    f_d = tintegrators.discretize(tbicycle.pacejka_dynamics)
    out = tsc.run_scenario_suite(ctrl, f_d, sc, TVehicleParams(), 10)
    summary = tsc.suite_summary(out, sc)
    assert summary["nan_scenarios"] == 0
    assert summary["converged_fraction"] > 0.5
    assert summary["mean_final_speed"] > 0.1
    assert all(o is sc.obstacles for _, o in ctrl.seen)
    # a controller without the term is given no obstacles
    plain = _Spy(_port_suite_controller(60, obstacle_weight=0.0))
    tsc.run_scenario_suite(plain, f_d, sc, TVehicleParams(), 1)
    assert plain.seen[0][1] is None


def test_two_tier_and_resumable_suites_pass_each_lanes_obstacles(tmp_path):
    sc = _scenarios(8)
    f_d = tintegrators.discretize(tbicycle.pacejka_dynamics)
    full, cheap = _Spy(_port_suite_controller(60)), \
        _Spy(_port_suite_controller(2))
    _, conv = tsc.run_scenario_suite_two_tier(full, cheap, f_d, sc,
                                              TVehicleParams(), 2,
                                              straggler_pad=4)
    assert conv.shape == (8, 2) and len(full.seen) >= 1
    for cl, obs in full.seen:
        # the stragglers' obstacles travel with their roads
        idx = [int(np.flatnonzero((sc.centerline == c).all(-1).all(-1))[0])
               for c in cl]
        torch.testing.assert_close(obs, sc.obstacles[idx])
    res = _Spy(_port_suite_controller(60))
    tsc.run_scenario_suite_resumable(res, f_d, sc, TVehicleParams(), 2,
                                     segment=2,
                                     checkpoint_path=str(tmp_path / "c.npz"))
    assert all(o is sc.obstacles for _, o in res.seen)
