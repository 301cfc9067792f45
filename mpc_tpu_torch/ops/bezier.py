"""Quintic Bezier lane-change paths (port of mpc_tpu/ops/bezier.py).

The curve is one contraction of a Bernstein basis matrix with the control
points, for any number of samples and any batch of control-point sets. The
lane-change family's geometry (lane width, car size, maximum heading,
speeds, initial gap) keeps the reference's constants. Everything is float32,
as in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# Default lane-change constants (mpc_tpu/ops/bezier.py:22-29).
H_LANE = 3.75
CAR_L, CAR_W = 4.2, 1.8
THETA_MAX = 3.2 / 180.0 * math.pi
SEG_L = 3.0
LF = 1.0
V0, V1 = 20.0, 10.0
D1 = 50.0

# Binomial coefficients C(5, i) for the quintic Bernstein basis.
_BINOM5 = (1.0, 5.0, 10.0, 10.0, 5.0, 1.0)


def bernstein_basis(t: torch.Tensor, degree: int = 5) -> torch.Tensor:
    """Bernstein basis ``B[k, i] = C(n, i) (1 - t_k)^(n - i) t_k^i``,
    shape (T, n+1)."""
    i = torch.arange(degree + 1, dtype=t.dtype, device=t.device)
    binom = torch.tensor(_BINOM5, dtype=t.dtype, device=t.device)
    t = t[:, None]
    return binom * (1.0 - t) ** (degree - i) * t ** i


def bezier_curve(t: torch.Tensor, control_points: torch.Tensor) -> torch.Tensor:
    """Quintic Bezier at parameters ``t`` (T,); ``control_points`` (2, 6) or
    batched (..., 2, 6). Returns (..., T, 2) curve points."""
    basis = bernstein_basis(t)                                 # (T, 6)
    return torch.einsum("ti,...ci->...tc", basis, control_points)


class LaneChangePath(NamedTuple):
    control_points: torch.Tensor   # (2, 6), or (n, 2, 6) for a family
    tca: torch.Tensor              # time to collision avoidance


def lane_change_control_points(i, h: float = H_LANE, l: float = SEG_L,
                               lf: float = LF, w: float = CAR_W,
                               theta: float = THETA_MAX, v0: float = V0,
                               v1: float = V1, d1: float = D1,
                               device=None) -> LaneChangePath:
    """Control points of the i-th member of the lane-change family
    (mpc_tpu/ops/bezier.py:62-81). ``i`` may be a number or a (n,) tensor:
    a tensor gives the whole family at once, control points (n, 2, 6)."""
    i = torch.as_tensor(i, dtype=torch.float32, device=device)
    f32 = dict(dtype=torch.float32, device=i.device)
    li = lf + l
    di = li * torch.cos(torch.atan2(torch.tensor(w, **f32),
                                    torch.tensor(2.0 * lf, **f32)) - theta)
    tc1 = d1 / (v0 - v1)
    px2 = v0 * tc1 - di
    px5 = 2.0 * px2
    px1 = px2 / i
    px4 = px5 - (px5 - px2) / i

    zero = torch.zeros_like(i)
    px = torch.stack(torch.broadcast_tensors(zero, px1, px2, px2, px4, px5),
                     dim=-1)
    py = torch.stack([zero] * 3 + [torch.full_like(i, h)] * 3, dim=-1)
    tca = (px2 / (v0 - v1)).expand(i.shape)
    return LaneChangePath(torch.stack([px, py], dim=-2), tca)


def _linspace01(num: int, device=None) -> torch.Tensor:
    """``jnp.linspace(0, 1, num)`` in float32, bit for bit: ``k / (num-1)``
    with the end point exact (torch.linspace rounds differently)."""
    if num == 1:
        return torch.zeros((1,), dtype=torch.float32, device=device)
    t = torch.arange(num, dtype=torch.float32, device=device) / (num - 1)
    t[-1] = 1.0
    return t


def lane_change_family(n: int = 10, num_samples: int = 500, device=None):
    """All n lane-change paths at once: curve points (n, T, 2) and tca (n,)
    (mpc_tpu/ops/bezier.py:84-90)."""
    idx = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    paths = lane_change_control_points(idx)
    curves = bezier_curve(_linspace01(num_samples, device),
                          paths.control_points)
    return curves, paths.tca


def bezier_centerline(control_points: torch.Tensor,
                      size: int = 100) -> torch.Tensor:
    """A Bezier path sampled as an MPC road centerline (size, 2)
    (mpc_tpu/ops/bezier.py:93-96)."""
    return bezier_curve(_linspace01(size, control_points.device),
                        control_points)
