"""Parity of the port's potential fields (mpc_tpu_torch/ops/potential_field.py)
with the JAX package's (mpc_tpu/ops/potential_field.py): every function's
values, and the gradients of the obstacle terms, on points and obstacle sets
drawn from a seed, shared by the lanes and one set per lane.

Tolerance: float32 values within 1e-5 relative (1e-6 absolute); gradients
within 1e-4 relative (1e-5 absolute), the two frameworks rounding the
transcendental functions differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.ops import potential_field as jpf
from mpc_tpu_torch.ops import potential_field as tpf

torch.set_num_threads(1)

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _points(seed, B):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-0.5, 3.0, B), rng.uniform(-0.5, 0.5, B),
                     rng.uniform(-0.4, 0.4, B), rng.uniform(0.1, 1.2, B)],
                    axis=1).astype(np.float32)


def _obstacles(seed, shape):
    rng = np.random.default_rng(seed + 1)
    return np.stack([rng.uniform(0.0, 3.0, shape), rng.uniform(-0.3, 0.3, shape),
                     rng.uniform(-0.2, 0.2, shape), rng.uniform(0.0, 0.5, shape)],
                    axis=-1).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("kw", [{}, dict(a_f=10.0, sigma_x=0.2, sigma_y=0.1)])
def test_obstacle_field_matches_jax(per_lane, kw):
    B, K = 9, 3
    pts = _points(0, B)
    obs = _obstacles(0, (B, K) if per_lane else (K,))
    got = tpf.obstacle_field(*(_t(pts[:, i]) for i in range(4)),
                             *(_t(obs[..., i]) for i in range(4)), **kw)
    ax = 0 if per_lane else None
    want = jax.vmap(lambda p, o: jpf.obstacle_field(
        *p, *(o[..., i] for i in range(4)), **kw), in_axes=(0, ax))(
            jnp.asarray(pts), jnp.asarray(obs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)


def test_lane_boundary_and_total_field_match_jax():
    ys = np.linspace(-1.0, 7.5, 41).astype(np.float32)
    np.testing.assert_allclose(tpf.lane_potential(_t(ys)).numpy(),
                               np.asarray(jpf.lane_potential(jnp.asarray(ys))),
                               **VAL)
    # both walls and the free band between them are hit
    bp = tpf.boundary_potential(_t(ys)).numpy()
    np.testing.assert_allclose(
        bp, np.asarray(jpf.boundary_potential(jnp.asarray(ys))), **VAL)
    assert (bp == 0).any() and (bp[ys >= 6.0] > 0).all() \
        and (bp[ys < 1.0] > 0).all()
    pts = _points(3, 12) * np.float32([3.0, 8.0, 1.0, 10.0])
    obs = _obstacles(3, (2,)) * np.float32([5.0, 10.0, 1.0, 10.0])
    got = tpf.total_field(*(_t(pts[:, i]) for i in range(4)),
                          *(_t(obs[:, i]) for i in range(4)))
    want = jax.vmap(lambda p: jpf.total_field(
        *p, *(jnp.asarray(obs[:, i]) for i in range(4))))(jnp.asarray(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)


def test_field_grid_matches_jax():
    xs = np.linspace(0.0, 20.0, 17).astype(np.float32)
    ys = np.linspace(0.0, 7.0, 11).astype(np.float32)
    obs = np.array([[10.0, 1.75, 0.0, 5.0], [14.0, 5.25, 0.1, 8.0]],
                   np.float32)
    got = tpf.field_grid(_t(xs), _t(ys), 0.05, 10.0,
                         *(_t(obs[:, i]) for i in range(4)))
    want = jpf.field_grid(jnp.asarray(xs), jnp.asarray(ys), 0.05, 10.0,
                          *(jnp.asarray(obs[:, i]) for i in range(4)))
    assert got.shape == (len(ys), len(xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)


def test_safe_distances_match_jax():
    rng = np.random.default_rng(4)
    ego = rng.uniform(-5, 5, (6, 4)).astype(np.float32)
    obs = rng.uniform(-5, 5, (6, 4)).astype(np.float32)
    got = tpf.safe_distances(_t(ego), _t(obs))
    want = jax.vmap(jpf.safe_distances)(jnp.asarray(ego), jnp.asarray(obs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **VAL)


@pytest.mark.parametrize("per_lane", [False, True])
def test_obstacle_stage_cost_and_gradient_match_jax(per_lane):
    B, K = 7, 2
    pts = _points(5, B)
    x = np.concatenate([pts, np.zeros((B, 2), np.float32)], axis=1)
    x[:, 4] = 0.02
    obs = _obstacles(5, (B, K) if per_lane else (K,))
    kw = dict(weight=1.5, a_f=1.0, sigma_x=0.2)
    xt = _t(x).requires_grad_(True)
    val = tpf.obstacle_stage_cost(xt, _t(obs), **kw)
    (grad,) = torch.autograd.grad(val.sum(), xt)
    fn = jax.value_and_grad(
        lambda xx, o: jpf.obstacle_stage_cost(xx, o, **kw))
    jval, jgrad = jax.vmap(fn, in_axes=(0, 0 if per_lane else None))(
        jnp.asarray(x), jnp.asarray(obs))
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(jval), **VAL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), **GRAD)
    # the risk only moves the pose: no gradient on the speed's side states
    assert float(grad[:, 4:].abs().max()) == 0.0


def test_obstacle_stage_cost_refuses_a_wrong_number_of_sets():
    with pytest.raises(ValueError, match="obstacle sets"):
        tpf.obstacle_stage_cost(torch.zeros((3, 6)), torch.zeros((2, 1, 4)))
