"""Parity of the port's decision layer (mpc_tpu_torch/decision/
game_theory.py) with the JAX package's, on the reference's three fixtures
and on random batches with masked cars: payoffs to rtol 1e-6 and lane
decisions exactly equal.

The JAX side runs op by op (``jax.disable_jit``), where each operation
rounds on its own as in torch. Even so the two libraries' log and
division differ by an ulp here and there, and a payoff is a sum of terms
of order 1 that can cancel to near 0, so the bar is rtol 1e-6 plus an
absolute 5e-7 (4 ulp at a payoff of 2-4; measured: at most 2.4e-7 over
the 4096 lanes of the payoff line and 1.2e-7 on 2048 random lanes).
Compiled, XLA fuses the payoff's sums and moves a payoff by up to 4.7e-5
from the JAX package's own op-by-op value on the payoff line's inputs
(-3.6410837); ``test_compiled_reference_spread`` holds the port within
that spread of the compiled reference, decisions equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.decision import game_theory as jgt
from mpc_tpu_torch.bench import payoff_inputs
from mpc_tpu_torch.convert import cars_from_numpy, ego_from_numpy
from mpc_tpu_torch.decision import game_theory as tgt

torch.set_num_threads(1)

PAYOFF_TOL = dict(rtol=1e-6, atol=5e-7)


def _port(ego, cars):
    """The port's Ego and Cars of JAX ones (scalar or batched)."""
    return (ego_from_numpy(*(np.asarray(a) for a in ego)),
            cars_from_numpy(*(np.asarray(a) for a in cars)))


def _random_batch(seed, B=64, M=4):
    """JAX egos (B,) and cars (B, M), some cars masked out, some lanes
    equal, speeds from standstill up."""
    rng = np.random.default_rng(seed)
    egos = jgt.Ego(x=jnp.asarray(rng.uniform(-20, 20, B), jnp.float32),
                   v=jnp.asarray(rng.uniform(0.5, 25, B), jnp.float32),
                   lane=jnp.asarray(rng.integers(1, 3, B), jnp.int32))
    v = rng.uniform(0, 25, (B, M))
    v[rng.random((B, M)) < 0.1] = 0.0
    cars = jgt.Cars(x=jnp.asarray(rng.uniform(-60, 80, (B, M)), jnp.float32),
                    v=jnp.asarray(v, jnp.float32),
                    lane=jnp.asarray(rng.integers(1, 3, (B, M)), jnp.int32),
                    mask=jnp.asarray(rng.random((B, M)) < 0.75))
    return egos, cars


@pytest.mark.parametrize("fixture", ["scenario_1", "scenario_2",
                                     "scenario_3"])
def test_decision_rollout_matches_jax_on_the_reference_fixtures(fixture):
    ego, cars = getattr(jgt, fixture)()
    with jax.disable_jit():
        ref_p, ref_change = jgt.decision_rollout(ego, cars, n_steps=50,
                                                 dt=0.1)
    tego, tcars = getattr(tgt, fixture)()
    p, change = tgt.decision_rollout(tego, tcars, n_steps=50, dt=0.1)
    assert p.shape == (1, 50, 2) and change.shape == (1, 50)
    np.testing.assert_allclose(p[0].numpy(), np.asarray(ref_p), **PAYOFF_TOL)
    np.testing.assert_array_equal(change[0].numpy(), np.asarray(ref_change))
    assert bool(change.any())     # the ego eventually prefers lane 2


@pytest.mark.parametrize("seed", [0, 1])
def test_lane_payoffs_match_jax_on_a_random_batch(seed):
    egos, cars = _random_batch(seed)
    with jax.disable_jit():
        ref = np.asarray(jgt.lane_payoffs_batched(egos, cars))
    got = tgt.lane_payoffs(*_port(egos, cars)).numpy()
    np.testing.assert_allclose(got, ref, **PAYOFF_TOL)
    np.testing.assert_array_equal(got[:, 1] > got[:, 0], ref[:, 1] > ref[:, 0])
    assert tgt.lane_payoffs_batched is tgt.lane_payoffs


@pytest.mark.parametrize("target", [1, 2])
def test_payoff_terms_match_jax(target):
    egos, cars = _random_batch(2)
    tegos, tcars = _port(egos, cars)
    B = egos.x.shape[0]
    tt = torch.full((B,), target, dtype=torch.int32)
    with jax.disable_jit():
        for name in ("safety_payoff", "velocity_payoff", "comfort_payoff"):
            ref = np.asarray(jax.vmap(lambda e, c: getattr(jgt, name)(
                e, c, jnp.asarray(target, jnp.int32)))(egos, cars))
            got = getattr(tgt, name)(tegos, tcars, tt).numpy()
            np.testing.assert_allclose(got, ref, err_msg=name,
                                       **PAYOFF_TOL)
        ref_sd = np.asarray(jax.vmap(lambda e, c: jgt.safety_distance(
            e, c.x, c.v, c.lane, jnp.asarray(target, jnp.int32)))(egos,
                                                                  cars))
    got_sd = tgt.safety_distance(tegos, tcars.x, tcars.v, tcars.lane,
                                 tt).numpy()
    np.testing.assert_allclose(got_sd, ref_sd, **PAYOFF_TOL)


def test_iterated_best_response_matches_jax():
    egos, cars = _random_batch(3, B=32)
    with jax.disable_jit():
        ref_lanes, ref_hist = jgt.iterated_best_response(egos, cars,
                                                         n_rounds=4)
    lanes, hist = tgt.iterated_best_response(*_port(egos, cars), n_rounds=4)
    np.testing.assert_array_equal(lanes.numpy(), np.asarray(ref_lanes))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(ref_hist).T)
    assert lanes.dtype == torch.int32


def test_mask_excludes_inactive_cars():
    ego, cars = tgt.scenario_1()
    empty = cars._replace(mask=torch.zeros_like(cars.mask))
    np.testing.assert_allclose(tgt.lane_payoffs(ego, empty).numpy(),
                               [[1.0, 1.0]], atol=1e-6)


def test_payoff_line_inputs_match_jax_and_decide_alike():
    # the bench's payoff line (examples/bench_suite.py:281-304) at a tenth
    # of its batch: the same draws, the same decisions
    B = 410
    egos, cars = payoff_inputs(B, 4)
    rng = np.random.default_rng(1)
    jegos = jgt.Ego(x=jnp.asarray(rng.uniform(-10, 10, B), jnp.float32),
                    v=jnp.asarray(rng.uniform(5, 20, B), jnp.float32),
                    lane=jnp.ones((B,), jnp.int32))
    jcars = jgt.Cars(
        x=jnp.asarray(rng.uniform(-50, 80, (B, 4)), jnp.float32),
        v=jnp.asarray(rng.uniform(0, 20, (B, 4)), jnp.float32),
        lane=jnp.asarray(rng.integers(1, 3, (B, 4)), jnp.int32),
        mask=jnp.ones((B, 4), bool))
    np.testing.assert_array_equal(egos.x.numpy(), np.asarray(jegos.x))
    np.testing.assert_array_equal(cars.lane.numpy(), np.asarray(jcars.lane))
    with jax.disable_jit():
        ref = np.asarray(jgt.lane_payoffs_batched(jegos, jcars))
    got = tgt.lane_payoffs(egos, cars).numpy()
    np.testing.assert_allclose(got, ref, **PAYOFF_TOL)
    np.testing.assert_array_equal(got[:, 1] > got[:, 0], ref[:, 1] > ref[:, 0])


def test_compiled_reference_spread():
    # the compiled reference (XLA fuses the payoff's sums) against its own
    # op-by-op values and against the port: the same decisions, payoffs
    # apart by at most 5e-5
    egos, cars = payoff_inputs(4096, 4)
    jegos = jgt.Ego(*(jnp.asarray(f.numpy()) for f in egos))
    jcars = jgt.Cars(*(jnp.asarray(f.numpy()) for f in cars))
    compiled = np.asarray(jax.jit(jgt.lane_payoffs_batched)(jegos, jcars))
    with jax.disable_jit():
        eager = np.asarray(jgt.lane_payoffs_batched(jegos, jcars))
    got = tgt.lane_payoffs(egos, cars).numpy()
    np.testing.assert_allclose(eager, compiled, rtol=0, atol=5e-5)
    np.testing.assert_allclose(got, compiled, rtol=0, atol=5e-5)
    np.testing.assert_array_equal(got[:, 1] > got[:, 0],
                                  compiled[:, 1] > compiled[:, 0])
