"""Parity of the port's Bezier lane-change paths (mpc_tpu_torch/ops/bezier.py)
with ``mpc_tpu.ops.bezier``: the Bernstein basis, single and batched curves,
the lane-change control points and family, and the sampled centerline that
the constrained N=40 benchmark path drives on."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.ops import bezier as jb
from mpc_tpu_torch.ops import bezier as tb

torch.set_num_threads(1)

ATOL = 1e-6


def test_bernstein_basis_matches_jax():
    t = np.random.default_rng(0).uniform(0.0, 1.0, 33).astype(np.float32)
    np.testing.assert_allclose(tb.bernstein_basis(torch.as_tensor(t)).numpy(),
                               np.asarray(jb.bernstein_basis(jnp.asarray(t))),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("batched", [False, True])
def test_bezier_curve_matches_jax(batched):
    rng = np.random.default_rng(1)
    shape = (3, 2, 6) if batched else (2, 6)
    pts = rng.uniform(-2.0, 2.0, shape).astype(np.float32)
    t = np.linspace(0.0, 1.0, 17, dtype=np.float32)
    got = tb.bezier_curve(torch.as_tensor(t), torch.as_tensor(pts))
    ref = jb.bezier_curve(jnp.asarray(t), jnp.asarray(pts))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("i", [1.0, 3.0, 5.0, 10.0])
def test_lane_change_control_points_match_jax(i):
    got = tb.lane_change_control_points(i)
    ref = jb.lane_change_control_points(i)
    # the control points reach about 190 m: atol 1e-6 of that scale
    np.testing.assert_allclose(got.control_points.numpy(),
                               np.asarray(ref.control_points), rtol=1e-6,
                               atol=ATOL)
    np.testing.assert_allclose(float(got.tca), float(ref.tca), rtol=1e-6)


def test_lane_change_family_matches_jax():
    curves, tca = tb.lane_change_family(n=10, num_samples=50)
    ref_curves, ref_tca = jb.lane_change_family(n=10, num_samples=50)
    assert tuple(curves.shape) == ref_curves.shape == (10, 50, 2)
    np.testing.assert_allclose(curves.numpy(), np.asarray(ref_curves),
                               rtol=1e-6, atol=ATOL)
    np.testing.assert_allclose(tca.numpy(), np.asarray(ref_tca), rtol=1e-6)


def test_bezier_centerline_matches_jax():
    # the road of the constrained N=40 path (examples/exp_ms.py:97-98)
    pts = tb.lane_change_control_points(5.0).control_points * 0.01
    got = tb.bezier_centerline(pts, size=100)
    ref = jb.bezier_centerline(
        jb.lane_change_control_points(5.0).control_points * 0.01, size=100)
    assert tuple(got.shape) == (100, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(got[0].numpy(), [0.0, 0.0])
