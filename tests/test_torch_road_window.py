"""Parity of the port's windowed and diagnostic road searches
(mpc_tpu_torch/ops/road.py) with the JAX package's (mpc_tpu/ops/road.py):
``compute_errors_ocp_windowed`` against the dense ``compute_errors_ocp`` and
against the JAX function, with the window's start clipped at both ends of
the road; ``find_nearest_point``, ``compute_errors_diagnostic`` and ``Road``.

Tolerance: the selected indices equal, the errors within 1e-5 relative
(1e-6 absolute) of JAX's (float32 atan2 and division), and bit for bit the
dense search's where the nearest point lies in the window.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.ops import road as jroad
from mpc_tpu_torch.ops import road as troad

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _circle():
    return troad.circle_centerline(100)


def _poses(seed, cl, idx):
    """Positions near the road points ``idx`` and headings, (B, 2), (B,)."""
    rng = np.random.default_rng(seed)
    pts = cl.numpy()[idx]
    pos = pts + rng.uniform(-0.05, 0.05, pts.shape).astype(np.float32)
    heading = rng.uniform(-np.pi, np.pi, len(idx)).astype(np.float32)
    return torch.as_tensor(pos), torch.as_tensor(heading)


def _jax_windowed(pos, heading, cl, center, window, per_lane=False):
    fn = jax.vmap(lambda p, h, c, k: jroad.compute_errors_ocp_windowed(
        p, h, c, k, window), in_axes=(0, 0, 0 if per_lane else None, 0))
    return fn(jnp.asarray(pos.numpy()), jnp.asarray(heading.numpy()),
              jnp.asarray(cl.numpy()), jnp.asarray(center.numpy()))


def _assert_errors(got, want, **tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **(tol or TOL))


@pytest.mark.parametrize("window", [8, 32, 100])
def test_window_equals_dense_search_inside_the_window(window):
    cl = _circle()
    idx = np.array([0, 1, 5, 40, 77, 95, 98])
    pos, heading = _poses(0, cl, idx)
    center, _ = troad.find_nearest_point(pos, cl)
    got = troad.compute_errors_ocp_windowed(pos, heading, cl, center, window)
    _assert_errors(got, troad.compute_errors_ocp(pos, heading, cl),
                   rtol=0, atol=0)


@pytest.mark.parametrize("case", ["start", "middle", "end"])
def test_window_matches_jax_with_the_start_clipped(case):
    # the anchor near index 0 clips the start at 0, near the end at
    # size - window; the last point is never selected
    cl = _circle()
    idx = {"start": np.array([0, 0, 1, 2, 3]),
           "middle": np.array([30, 44, 50, 61, 70]),
           "end": np.array([99, 98, 97, 96, 90])}[case]
    pos, heading = _poses(1, cl, idx)
    center = torch.as_tensor(idx)
    got = troad.compute_errors_ocp_windowed(pos, heading, cl, center, 16)
    _assert_errors(got, _jax_windowed(pos, heading, cl, center, 16))


def test_window_on_per_lane_roads_matches_jax():
    rng = np.random.default_rng(2)
    cls = torch.stack([troad.circle_centerline(60, radius=r)
                       for r in (3.0, 4.0, 5.0, 6.0)])
    idx = np.array([3, 20, 41, 58])
    pos = torch.stack([cls[b, i] for b, i in enumerate(idx)]) \
        + torch.as_tensor(rng.uniform(-0.05, 0.05, (4, 2)).astype(np.float32))
    heading = torch.as_tensor(rng.uniform(-1, 1, 4).astype(np.float32))
    center = torch.as_tensor(idx)
    got = troad.compute_errors_ocp_windowed(pos, heading, cls, center, 12)
    _assert_errors(got, _jax_windowed(pos, heading, cls, center, 12,
                                      per_lane=True))


def test_window_larger_than_the_road_raises():
    cl = troad.straight_centerline(10)
    with pytest.raises(ValueError, match="window"):
        troad.compute_errors_ocp_windowed(torch.zeros((1, 2)), torch.zeros(1),
                                          cl, torch.zeros(1, dtype=torch.long),
                                          11)


def test_find_nearest_point_matches_jax_including_the_last_point():
    cl = troad.straight_centerline(100)
    pos = torch.tensor([[9.85, 0.01], [0.52, -0.02], [-0.4, 0.0]])
    idx, pt = troad.find_nearest_point(pos, cl)
    jidx, jpt = jax.vmap(jroad.find_nearest_point, in_axes=(0, None))(
        jnp.asarray(pos.numpy()), jnp.asarray(cl.numpy()))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jpt))
    assert int(idx[0]) == 99      # the OCP search never picks it


@pytest.mark.parametrize("road", ["circle", "straight"])
def test_diagnostic_errors_match_jax(road):
    cl = _circle() if road == "circle" else troad.straight_centerline(100)
    # index 0 wraps the previous point to the last, the end clamps the next
    idx = np.array([0, 1, 33, 98, 99])
    pos, heading = _poses(4, cl, idx)
    got = troad.compute_errors_diagnostic(pos, heading, cl)
    want = jroad.compute_errors_diag_batched(
        jnp.asarray(pos.numpy()), jnp.asarray(heading.numpy()),
        jnp.asarray(cl.numpy()))
    finite = np.isfinite(np.asarray(want.cte))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy()[finite], np.asarray(w)[finite],
                                   **TOL)
        # where JAX divides by a zero-length segment, so does the port
        np.testing.assert_array_equal(np.isfinite(g.numpy()),
                                      np.isfinite(np.asarray(w)))


def test_road_class_matches_jax():
    pos, heading = _poses(5, _circle(), np.array([10, 60]))
    road, jr = troad.Road(), jroad.Road()
    # the two frameworks' float32 cos and sin differ by an ulp at a few
    # of the circle's points
    np.testing.assert_allclose(road.centerline.numpy(),
                               np.asarray(jr.centerline), rtol=0, atol=1e-6)
    idx, pt = road.find_nearest_point(pos)
    for b in range(2):
        jidx, jpt = jr.find_nearest_point(np.asarray(pos[b]))
        assert int(idx[b]) == int(jidx)
        jerr = jr.compute_errors(np.asarray(pos[b]), float(heading[b]))
        for g, w in zip(road.compute_errors(pos, heading), jerr):
            np.testing.assert_allclose(float(g[b]), float(w), **TOL)
