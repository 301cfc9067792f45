"""Road geometry: centerlines, nearest-point lookup, OCP tracking errors
(port of mpc_tpu/ops/road.py).

Positions are lane-batched ``(B, 2)``; a centerline ``(S, 2)`` is shared by
every lane. Semantics kept from the reference:

- the OCP nearest-point search scans candidates ``0 .. S-2`` (the last point
  is never selected), clamps the previous point at index 0, and takes the
  first index on a tie (``torch.argmin`` returns the first minimum);
- the selected points are constants for the gradient (straight-through).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def wrap_to_pi(angle: torch.Tensor) -> torch.Tensor:
    """Wrap an angle to [-pi, pi) with a floored mod, as ``jnp.mod`` does
    (mpc_tpu/ops/road.py:41-43). ``torch.fmod`` would truncate instead and
    leave negative angles below -pi."""
    return torch.remainder(angle + math.pi, 2.0 * math.pi) - math.pi


def straight_centerline(size: int = 100, device=None) -> torch.Tensor:
    """Straight road: points ``[i/10 - 0.1, 0]``."""
    i = torch.arange(size, dtype=torch.float32, device=device)
    return torch.stack([i / 10.0 - 0.1, torch.zeros_like(i)], dim=1)


def circle_centerline(size: int = 100, radius: float = 5.0,
                      center=(0.0, 0.0), y_offset: float = 5.0,
                      device=None) -> torch.Tensor:
    """Circular road of ``size`` points, first and last both at theta = 0."""
    # theta_i = i * (2pi / (size-1)) in float32 with the end point exact,
    # which reproduces jnp.linspace bit for bit (torch.linspace does not)
    theta = torch.arange(size, dtype=torch.float32, device=device)
    if size > 1:
        theta = theta * (2.0 * math.pi / (size - 1))
        theta[-1] = 2.0 * math.pi
    x = radius * torch.cos(theta) + center[0]
    y = radius * torch.sin(theta) + center[1] + y_offset
    return torch.stack([x, y], dim=1)


class NearestPoint(NamedTuple):
    index: torch.Tensor      # (B,) int64
    nearest: torch.Tensor    # (B, 2)
    previous: torch.Tensor   # (B, 2)
    next: torch.Tensor       # (B, 2)


def find_nearest_point_ocp(pos: torch.Tensor,
                           centerline: torch.Tensor) -> NearestPoint:
    """Nearest centerline point with OCP semantics
    (mpc_tpu/ops/road.py:76-85): candidates ``0..S-2``, previous clamped at 0."""
    size = centerline.shape[0]
    cand = centerline[: size - 1]                               # (S-1, 2)
    d2 = ((cand[None, :, :] - pos[:, None, :]) ** 2).sum(dim=2)  # (B, S-1)
    idx = torch.argmin(d2, dim=1)
    prev_idx = torch.clamp(idx - 1, min=0)
    return NearestPoint(idx, centerline[idx], centerline[prev_idx],
                        centerline[idx + 1])


class RoadErrors(NamedTuple):
    cte: torch.Tensor
    heading_error: torch.Tensor
    pos_error: torch.Tensor


def _cross2(a, b):
    return a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]


def compute_errors_ocp(pos: torch.Tensor, heading: torch.Tensor,
                       centerline: torch.Tensor) -> RoadErrors:
    """OCP-side errors, unnormalised cross products
    (mpc_tpu/ops/road.py:109-122). The points are gathered from the
    centerline by index, so no gradient flows through the selection."""
    np_ = find_nearest_point_ocp(pos, centerline.detach())
    cte = _cross2(pos - np_.previous, np_.nearest - np_.previous)
    desired = torch.atan2(np_.next[:, 1] - np_.nearest[:, 1],
                          np_.next[:, 0] - np_.nearest[:, 0])
    heading_error = wrap_to_pi(desired - heading)
    pos_error = _cross2(pos - np_.nearest, np_.next - np_.nearest)
    return RoadErrors(cte, heading_error, pos_error)
