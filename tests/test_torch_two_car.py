"""Parity of the port's two-car game (mpc_tpu_torch/sim/two_car.py) with the
JAX package's: the best response on the reference test's fixtures and on a
random batch, and the closed loop over scenario pairs, whose lane decisions
must equal the JAX ones step by step (ROADMAP, "How to judge a fault").

The port solves both cars in one controller step over 2B lanes, each lane
on its own lane's road; the JAX package calls its controller once per car
on a shared road each, and ``vmap``-s over pairs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.control.mpc import build_vehicle_controller
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.sim import two_car as jtc
from mpc_tpu_torch import config as tconfig
from mpc_tpu_torch.control import mpc as tmpc
from mpc_tpu_torch.models import bicycle as tbicycle
from mpc_tpu_torch.models import integrators as tintegrators
from mpc_tpu_torch.models.params import VehicleParams as TVehicleParams
from mpc_tpu_torch.sim import two_car as ttc

torch.set_num_threads(1)

# the controller of tests/test_two_car.py:19-25
N_HORIZ, EPS, MAX_ITER = 8, 1e-3, 80
WEIGHTS = (0.5, 100.0, 100.0, 0.5, 0.1, 0.01)


def _pair(y_a, y_b, la, lb):
    as_t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float32 if dt == torch.float32 else np.int32))[None]
    return (as_t(y_a), as_t(y_b), as_t(la, torch.int32),
            as_t(lb, torch.int32))


@pytest.mark.parametrize("case", ["slow_leader", "occupied_target"])
def test_best_response_on_the_reference_fixtures(case):
    # tests/test_two_car.py:28-50: a fast car behind a slow one in lane 1
    # overtakes; equal speeds with the other car ahead in lane 2 stay
    if case == "slow_leader":
        y_a = [0.0, 0.0, 0.0, 1.0, 0.0, 0.0]
        y_b = [0.12, 0.0, 0.0, 0.1, 0.0, 0.0]
        lanes, expect = (1, 1), (2, 1)
    else:
        y_a = [0.0, 0.0, 0.0, 0.5, 0.0, 0.0]
        y_b = [0.1, jtc.LANE_OFFSET, 0.0, 0.5, 0.0, 0.0]
        lanes, expect = (1, 2), (1, 2)
    ref = jtc._best_response_pair(jnp.asarray(y_a), jnp.asarray(y_b),
                                  *(jnp.asarray(x, jnp.int32) for x in lanes))
    got = ttc._best_response_pair(*_pair(y_a, y_b, *lanes))
    assert tuple(int(x) for x in ref) == expect
    assert tuple(int(x[0]) for x in got) == expect


def test_best_response_matches_jax_on_a_random_batch():
    B = 256
    rng = np.random.default_rng(4)
    y_a = np.zeros((B, 6), np.float32)
    y_b = np.zeros((B, 6), np.float32)
    for y in (y_a, y_b):
        y[:, 0] = rng.uniform(0.0, 0.4, B)
        y[:, 1] = rng.uniform(-0.05, 0.4, B)
        y[:, 3] = rng.uniform(0.0, 1.0, B)
        y[:, 4] = rng.uniform(-0.05, 0.05, B)
    la = rng.integers(1, 3, B).astype(np.int32)
    lb = rng.integers(1, 3, B).astype(np.int32)
    with jax.disable_jit():
        ref = jax.vmap(jtc._best_response_pair)(
            *(jnp.asarray(a) for a in (y_a, y_b, la, lb)))
    got = ttc._best_response_pair(*(torch.as_tensor(a)
                                    for a in (y_a, y_b, la, lb)))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert len({tuple(x) for x in np.stack([got[0].numpy(),
                                            got[1].numpy()], 1)}) > 1


def _pairs(B):
    # the pairs of tests/test_two_car.py:92-99
    rng = np.random.default_rng(0)
    y0a = np.zeros((B, 6), np.float32)
    y0a[:, 3] = rng.uniform(0.5, 1.0, B)
    y0b = np.zeros((B, 6), np.float32)
    y0b[:, 0] = rng.uniform(0.1, 0.4, B)
    y0b[:, 3] = rng.uniform(0.1, 0.3, B)
    return y0a, y0b


def _port_game(n_sim):
    ctrl = tmpc.build_vehicle_controller(
        n_horiz=N_HORIZ, alm_cfg=tconfig.AlmConfig(eps=EPS),
        panoc_cfg=tconfig.PanocConfig(lbfgs_memory=N_HORIZ,
                                      max_iter=MAX_ITER),
        weights=WEIGHTS, device="cpu")
    return ctrl, ttc.make_two_car_game(
        ctrl, tintegrators.discretize(tbicycle.pacejka_dynamics),
        TVehicleParams(), n_sim=n_sim)


def test_two_car_closed_loop_matches_jax():
    # B = 4 pairs, n_sim = 6, both cars starting in lane 1 (the overtake of
    # the bench's config 4) and in lanes 1 and 2 (the game's default)
    B, n_sim = 4, 6
    y0a, y0b = _pairs(B)
    ctrl = build_vehicle_controller(
        n_horiz=N_HORIZ, alm_cfg=AlmConfig(eps=EPS),
        panoc_cfg=PanocConfig(lbfgs_memory=N_HORIZ, max_iter=MAX_ITER),
        weights=WEIGHTS)
    run = jtc.make_two_car_game(ctrl, discretize(pacejka_dynamics),
                                VehicleParams(), n_sim=n_sim)
    ref = jax.jit(jax.vmap(run, in_axes=(0, 0, None, None)),
                  static_argnums=(2, 3))
    _, game = _port_game(n_sim)
    for lanes in ((1, 1), (1, 2)):
        r = ref(jnp.asarray(y0a), jnp.asarray(y0b), *lanes)
        out = game(torch.as_tensor(y0a), torch.as_tensor(y0b), *lanes)
        assert out.ys_a.shape == (B, n_sim, 6)
        np.testing.assert_array_equal(out.lanes_a.numpy(),
                                      np.asarray(r.lanes_a))
        np.testing.assert_array_equal(out.lanes_b.numpy(),
                                      np.asarray(r.lanes_b))
        # the solves stop at a criterion of EPS = 1e-3, so the inputs, and
        # the states they move, agree to that order: within 3 EPS over the
        # loop (measured 1.3e-3 from lanes (1, 1), 2.6e-3 from (1, 2))
        for got, want in ((out.ys_a, r.ys_a), (out.ys_b, r.ys_b)):
            assert bool(torch.isfinite(got).all())
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=3 * EPS)
        for got, want in ((out.state.carry_a, r.state.carry_a),
                          (out.state.carry_b, r.state.carry_b)):
            np.testing.assert_array_equal(got.failures.numpy(),
                                          np.asarray(want.failures))
        if lanes == (1, 1):
            # the overtake: some car A decides to change lane
            assert bool((out.lanes_a == 2).any())


def test_one_step_over_both_cars_equals_two_calls():
    # the port's joint step over 2B lanes against one call per car, each on
    # its own lane's road
    B = 3
    y0a, y0b = _pairs(B)
    ctrl, _ = _port_game(1)
    p = TVehicleParams()
    lanes_cl = ttc._lane_centerline()
    y = torch.as_tensor(np.concatenate([y0a, y0b]))
    road = torch.tensor([1] * B + [0] * B)
    joint = ctrl.step(ctrl.init_carry(2 * B),
                      {"y0": y, "p": p, "centerline": lanes_cl[road]})
    for car, lane in ((slice(0, B), 1), (slice(B, 2 * B), 0)):
        one = ctrl.step(ctrl.init_carry(B), {"y0": y[car], "p": p,
                                             "centerline": lanes_cl[lane]})
        np.testing.assert_array_equal(joint.result.converged[car].numpy(),
                                      one.result.converged.numpy())
        np.testing.assert_array_equal(
            joint.result.inner_iterations[car].numpy(),
            one.result.inner_iterations.numpy())
        np.testing.assert_allclose(joint.u0[car].numpy(), one.u0.numpy(),
                                   rtol=0, atol=1e-6)
