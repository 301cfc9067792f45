"""Per-lane roads in the port (mpc_tpu_torch/ops/{road,costs,fused_psi}.py):
one centerline per lane, (B, S, 2), held against the JAX package's plain
path, which ``vmap``-s over the roads (the path ``run_scenario_suite`` takes).

The roads are of the three kinds of ``random_scenarios`` (straight, arc,
lane change), a different one on each lane. The fan lanes of one scenario
are its K candidates, adjacent, on its road (road stride K). The CUDA
kernel's per-lane form is held against the plain version in
tests/test_torch_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.control.mpc import build_vehicle_ocp
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.bezier import bezier_centerline, lane_change_control_points
from mpc_tpu.ops.costs import vehicle_stage_cost
from mpc_tpu.ops.road import (circle_centerline, compute_errors_ocp,
                              find_nearest_point_ocp, straight_centerline)
from mpc_tpu.sim.scenarios import random_scenarios
from mpc_tpu_torch.control.mpc import STATE_CONSTRAINT_OFFSETS
from mpc_tpu_torch.models.params import VehicleParams as TVehicleParams
from mpc_tpu_torch.ops import costs as tcosts
from mpc_tpu_torch.ops import fused_psi as tfp
from mpc_tpu_torch.ops import road as troad
from mpc_tpu_torch.ops.costs import DEFAULT_VEHICLE_WEIGHTS

torch.set_num_threads(1)

PARAMS = VehicleParams()
# the bar of tests/test_torch_fused_psi.py:30-31
PSI_TOL = dict(rtol=2e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
N_HORIZ, S = 6, 60


@functools.lru_cache(maxsize=None)
def _roads(B):
    """B roads, one per lane, cycling straight, arc and lane change, each
    starting at the origin heading along +x; and the kinds of a JAX
    ``random_scenarios`` batch after them."""
    fixed = [np.asarray(straight_centerline(S)),
             np.asarray(circle_centerline(S)),
             np.asarray(bezier_centerline(
                 lane_change_control_points(5.0).control_points * 0.01,
                 size=S))]
    drawn = np.asarray(random_scenarios(jax.random.PRNGKey(3), 6,
                                        size=S).centerline)
    pool = fixed + list(drawn)
    return np.stack([pool[b % len(pool)] for b in range(B)]).astype(
        np.float32)


def _states(seed, B):
    rng = np.random.default_rng(seed)
    y0 = np.zeros((B, 6), np.float32)
    y0[:, 0] = rng.uniform(-0.1, 0.4, B)
    y0[:, 1] = rng.uniform(-0.1, 0.1, B)
    y0[:, 2] = rng.uniform(-0.3, 0.3, B)
    y0[:, 3] = rng.uniform(0.2, 1.0, B)
    return y0


def _cands(seed, B, K):
    rng = np.random.default_rng(seed)
    u = np.empty((B, K, 2 * N_HORIZ), np.float32)
    u[..., 0::2] = rng.uniform(0.0, 1.0, (B, K, N_HORIZ))
    u[..., 1::2] = rng.uniform(-0.32, 0.32, (B, K, N_HORIZ))
    return u


@functools.lru_cache(maxsize=None)
def _jax_plain_fan():
    """JAX's plain path: ``value_and_grad(problem.cost)`` per candidate,
    vmapped over candidates and then over scenarios with their roads."""
    problem = build_vehicle_ocp(n_horiz=N_HORIZ)

    def ref(u, y, cl):
        return jax.value_and_grad(problem.cost)(
            u, {"y0": y, "p": PARAMS, "centerline": cl})

    return jax.jit(jax.vmap(jax.vmap(ref, in_axes=(0, None, None))))


def _port_fan(cands, y0, roads):
    cltab, pvec = tfp.fan_params(torch.as_tensor(roads), TVehicleParams())
    multi = tfp.make_vehicle_cost_multi(N_HORIZ)
    psi, grad = multi(torch.as_tensor(cands), torch.as_tensor(y0), cltab,
                      pvec)
    return psi.numpy(), grad.numpy()


def test_nearest_point_and_errors_match_jax_per_road():
    B = 9
    roads = _roads(B)
    rng = np.random.default_rng(0)
    # positions near each road, heading anywhere
    pos = roads[np.arange(B), rng.integers(0, S, B)] \
        + rng.uniform(-0.2, 0.2, (B, 2)).astype(np.float32)
    heading = rng.uniform(-3.0, 3.0, B).astype(np.float32)
    ref_np = jax.vmap(find_nearest_point_ocp)(jnp.asarray(pos),
                                              jnp.asarray(roads))
    ref_err = jax.vmap(compute_errors_ocp)(jnp.asarray(pos),
                                           jnp.asarray(heading),
                                           jnp.asarray(roads))
    got_np = troad.find_nearest_point_ocp(torch.as_tensor(pos),
                                          torch.as_tensor(roads))
    got_err = troad.compute_errors_ocp(torch.as_tensor(pos),
                                       torch.as_tensor(heading),
                                       torch.as_tensor(roads))
    for got, ref in zip(got_np, ref_np):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for got, ref in zip(got_err, ref_err):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-7)


def test_nearest_point_rejects_a_road_count_other_than_the_lanes():
    roads = torch.as_tensor(_roads(3))
    with pytest.raises(ValueError, match="3 roads for 2 lanes"):
        troad.find_nearest_point_ocp(torch.zeros((2, 2)), roads)


def test_stage_cost_matches_jax_per_road():
    B = 9
    roads = _roads(B)
    y = _states(1, B)
    y[:, 4] = np.random.default_rng(2).uniform(-0.1, 0.1, B)
    u = np.random.default_rng(3).uniform(-0.3, 1.0, (B, 2)).astype(
        np.float32)
    ref = jax.vmap(lambda x, u_, cl: vehicle_stage_cost(x, u_, cl, 1.0))(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(roads))
    got = tcosts.vehicle_stage_cost(torch.as_tensor(y), torch.as_tensor(u),
                                    torch.as_tensor(roads), 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-6,
                               atol=1e-7)


@pytest.mark.parametrize("K", [5, 2])
def test_plain_fan_per_lane_matches_jax_plain_path(K):
    B = 7
    roads = _roads(B)
    cands, y0 = _cands(10 + K, B, K), _states(11 + K, B)
    ref_psi, ref_grad = _jax_plain_fan()(jnp.asarray(cands),
                                         jnp.asarray(y0), jnp.asarray(roads))
    psi, grad = _port_fan(cands, y0, roads)
    np.testing.assert_allclose(psi, np.asarray(ref_psi), **PSI_TOL)
    np.testing.assert_allclose(grad, np.asarray(ref_grad), **GRAD_TOL)


@pytest.mark.parametrize("K", [5, 2])
def test_phased_transcription_per_lane_matches_autograd_and_jax(K):
    # the algorithm of the per-lane kernel (csrc/fused_psi.cu at road
    # stride K) against the plain version's autograd and JAX's plain path
    B = 7
    roads = _roads(B)
    cands, y0 = _cands(20 + K, B, K), _states(21 + K, B)
    u = torch.as_tensor(cands.reshape(B * K, -1))
    y0e = torch.as_tensor(np.repeat(y0, K, axis=0))
    cltab, pvec = tfp.fan_params(torch.as_tensor(roads), TVehicleParams())
    args = (cltab, pvec, N_HORIZ, 4, 0.0125, 1.0, DEFAULT_VEHICLE_WEIGHTS)
    psi_ref, grad_ref = tfp.fan_value_and_grad_reference(u, y0e, *args)
    psi, grad = tfp._fan_phased_transcription(u, y0e, *args)
    np.testing.assert_allclose(psi.numpy(), psi_ref.numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(grad.numpy(), grad_ref.numpy(), rtol=2e-5,
                               atol=2e-6)
    jpsi, jgrad = _jax_plain_fan()(jnp.asarray(cands), jnp.asarray(y0),
                                   jnp.asarray(roads))
    np.testing.assert_allclose(psi.numpy(), np.asarray(jpsi).reshape(-1),
                               **PSI_TOL)
    np.testing.assert_allclose(grad.numpy(),
                               np.asarray(jgrad).reshape(B * K, -1),
                               **GRAD_TOL)


@pytest.mark.parametrize("road", [0, 1, 2])
def test_copies_of_one_road_give_the_shared_road_bits(road):
    B, K = 4, 5
    cl = torch.as_tensor(_roads(3)[road])
    cands, y0 = _cands(30, B, K), _states(31, B)
    multi = tfp.make_vehicle_cost_multi(N_HORIZ)
    out = []
    for c in (cl, cl.expand(B, -1, -1)):
        cltab, pvec = tfp.fan_params(c, TVehicleParams())
        out.append(multi(torch.as_tensor(cands), torch.as_tensor(y0), cltab,
                         pvec))
    (psi_s, grad_s), (psi_l, grad_l) = out
    assert torch.equal(psi_s, psi_l)
    assert torch.equal(grad_s, grad_l)


def test_make_cltab_of_a_stack_is_each_roads_table():
    roads = torch.as_tensor(_roads(4))
    stack = tfp.make_cltab(roads)
    assert stack.shape == (4, S - 1, 6)
    for b in range(4):
        assert torch.equal(stack[b], tfp.make_cltab(roads[b]))


def test_k2_and_k3_raise_on_per_lane_roads():
    E, n = 4, 3
    cltab, pvec = tfp.fan_params(torch.as_tensor(_roads(2)),
                                 TVehicleParams())
    u = torch.zeros((E, 2 * n))
    with pytest.raises(NotImplementedError, match="K1 only"):
        tfp.kin_fan_value_and_grad(u, torch.zeros((E, 4)), cltab, pvec, n,
                                   4, 0.0125, 1.0)
    m = 6 * n
    al = (torch.zeros((E, m)), torch.ones((E, m)),
          torch.tensor(STATE_CONSTRAINT_OFFSETS),
          torch.full((m,), -float("inf")), torch.zeros((m,)))
    with pytest.raises(NotImplementedError, match="K1 only"):
        tfp.al_fan_value_and_grad(u, torch.zeros((E, 6)), cltab, pvec, *al,
                                  n, 4, 0.0125, 1.0)
    # the kinematic cost_multi hands the wrapper its roads, which raises
    multi = tfp.make_vehicle_cost_multi(n, model="simplified")
    with pytest.raises(NotImplementedError):
        multi(torch.zeros((2, 2, 2 * n)), torch.zeros((2, 4)), cltab, pvec)


def test_fan_checks_the_road_stack_against_the_lanes():
    E, n = 10, 3
    cltab, pvec = tfp.fan_params(torch.as_tensor(_roads(2)),
                                 TVehicleParams())
    u, y0 = torch.zeros((E, 2 * n)), torch.zeros((E, 6))
    args = (n, 4, 0.0125, 1.0)
    # the stride is the lanes per road: 10 lanes on 2 roads read 5 each
    assert tfp.road_stride(cltab, E) == 5
    assert tfp.road_stride(cltab[0], E) == 0
    psi, grad = tfp.fan_value_and_grad(u, y0, cltab, pvec, *args)
    assert psi.shape == (E,) and grad.shape == (E, 2 * n)
    three, _ = tfp.fan_params(torch.as_tensor(_roads(3)), TVehicleParams())
    with pytest.raises(ValueError, match="10 lanes on 3 roads"):
        tfp.fan_value_and_grad(u, y0, three, pvec, *args)
    with pytest.raises(ValueError, match=r"\(S-1, 6\) or \(R, S-1, 6\)"):
        tfp.fan_value_and_grad(u, y0, cltab[..., :4].contiguous(), pvec,
                               *args)
