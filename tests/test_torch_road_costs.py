"""Parity of the port's road geometry and stage cost
(mpc_tpu_torch/ops/road.py, ops/costs.py) with the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mpc_tpu.ops import road as jroad
from mpc_tpu.ops.costs import vehicle_stage_cost
from mpc_tpu_torch.ops import road as troad
from mpc_tpu_torch.ops.costs import vehicle_stage_cost as tvehicle_stage_cost

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def test_wrap_to_pi_negative_angles():
    a = np.array([-10.0, -7.0, -np.pi - 0.1, -np.pi, -3.0, -1e-3, 0.0, 1.0,
                  np.pi, 4.0, 9.5, -25.0], np.float32)
    got = troad.wrap_to_pi(torch.as_tensor(a)).numpy()
    np.testing.assert_allclose(got, np.asarray(jroad.wrap_to_pi(jnp.asarray(a))),
                               rtol=0, atol=1e-6)
    assert np.all(got >= -np.pi - 1e-6) and np.all(got < np.pi)


def test_centerlines_match_jax():
    np.testing.assert_array_equal(troad.straight_centerline(100).numpy(),
                                  np.asarray(jroad.straight_centerline(100)))
    for size in (40, 100):
        np.testing.assert_allclose(troad.circle_centerline(size).numpy(),
                                   np.asarray(jroad.circle_centerline(size)),
                                   rtol=0, atol=1e-6)


def test_nearest_index_matches_jax_with_tie_and_last_point():
    cl = np.array(jroad.straight_centerline(20))
    pos = np.array([
        [0.35, 0.01],       # generic
        [0.05, 0.0],        # exact tie between points 1 (0.0) and 2 (0.1)
        [5.0, 0.0],         # beyond the end: last point must never win
        [1.8, 0.0],         # exactly on the last point (index 19): 18 wins
        [-3.0, 2.0],        # before the start: prev clamps at 0
    ], np.float32)
    got = troad.find_nearest_point_ocp(torch.as_tensor(pos),
                                       torch.as_tensor(cl))
    ref = jax.vmap(jroad.find_nearest_point_ocp, in_axes=(0, None))(
        jnp.asarray(pos), jnp.asarray(cl))
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(ref.index))
    assert got.index[1] == 1 and got.index[2] == 18 and got.index[3] == 18
    for a, b in ((got.nearest, ref.nearest), (got.previous, ref.previous),
                 (got.next, ref.next)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    # exact ties in float32 (integer coordinates): the first index wins
    cl_int = np.array([[0, 0], [2, 0], [4, 0], [6, 0], [8, 0]], np.float32)
    pos_tie = np.array([[1, 0], [3, 1], [5, -2], [9, 0]], np.float32)
    got = troad.find_nearest_point_ocp(torch.as_tensor(pos_tie),
                                       torch.as_tensor(cl_int))
    ref = jax.vmap(jroad.find_nearest_point_ocp, in_axes=(0, None))(
        jnp.asarray(pos_tie), jnp.asarray(cl_int))
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(ref.index))
    np.testing.assert_array_equal(got.index.numpy(), [0, 1, 2, 3])


def test_errors_and_stage_cost_match_jax():
    rng = np.random.default_rng(0)
    B = 16
    cl = np.array(jroad.circle_centerline(100))
    x = np.zeros((B, 6), np.float32)
    th = rng.uniform(0, 2 * np.pi, B)
    x[:, 0] = 5.0 * np.cos(th) + rng.uniform(-0.3, 0.3, B)
    x[:, 1] = 5.0 * np.sin(th) + 5.0 + rng.uniform(-0.3, 0.3, B)
    x[:, 2] = rng.uniform(-4.0, 4.0, B)
    x[:, 3] = rng.uniform(0.1, 1.5, B)
    x[:, 4] = rng.uniform(-0.2, 0.2, B)
    u = np.stack([rng.uniform(-1, 1, B), rng.uniform(-0.3, 0.3, B)],
                 axis=1).astype(np.float32)
    xt, ut, clt = (torch.as_tensor(a) for a in (x, u, cl))

    err = troad.compute_errors_ocp(xt[:, :2], xt[:, 2], clt)
    ref = jax.vmap(jroad.compute_errors_ocp, in_axes=(0, 0, None))(
        jnp.asarray(x[:, :2]), jnp.asarray(x[:, 2]), jnp.asarray(cl))
    for a, b in zip(err, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)

    for sd in (6, 4):
        c_t = tvehicle_stage_cost(xt[:, :sd], ut, clt, 1.0)
        c_j = jax.vmap(lambda a, b: vehicle_stage_cost(a, b, jnp.asarray(cl),
                                                       1.0))(
            jnp.asarray(x[:, :sd]), jnp.asarray(u))
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), **TOL)
