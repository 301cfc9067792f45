"""Road geometry: centerlines, nearest-point lookup, OCP tracking errors
(port of mpc_tpu/ops/road.py).

Positions are lane-batched ``(B, 2)``; a centerline is either ``(S, 2)``,
shared by every lane, or ``(B, S, 2)``, one road per lane (the JAX package
``vmap``-s its callers over such roads). Semantics kept from the reference:

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
    (mpc_tpu/ops/road.py:76-85): candidates ``0..S-2``, previous clamped at 0.
    A (B, S, 2) centerline gives lane b the points of its own road b."""
    if centerline.dim() == 3 and centerline.shape[0] != pos.shape[0]:
        raise ValueError(f"find_nearest_point_ocp: {centerline.shape[0]} "
                         f"roads for {pos.shape[0]} lanes")
    size = centerline.shape[-2]
    cand = centerline[..., : size - 1, :]              # ([B,] S-1, 2)
    d2 = ((cand - pos[:, None, :]) ** 2).sum(dim=2)    # (B, S-1)
    idx = torch.argmin(d2, dim=1)
    prev_idx = torch.clamp(idx - 1, min=0)
    if centerline.dim() == 2:
        return NearestPoint(idx, centerline[idx], centerline[prev_idx],
                            centerline[idx + 1])
    lanes = torch.arange(pos.shape[0], device=pos.device)
    return NearestPoint(idx, centerline[lanes, idx],
                        centerline[lanes, prev_idx], centerline[lanes, idx + 1])


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
    return _errors(pos, heading, np_.nearest, np_.previous, np_.next)


def find_nearest_point(pos: torch.Tensor, centerline: torch.Tensor):
    """Diagnostic nearest point over the whole centerline, last point
    included (mpc_tpu/ops/road.py:88-92): ``(index (B,), point (B, 2))``."""
    d2 = ((centerline - pos[:, None, :]) ** 2).sum(dim=-1)
    idx = torch.argmin(d2, dim=1)
    return idx, _gather(centerline, idx)


def _gather(centerline: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Points ``idx`` (B, ...) of a shared (S, 2) or per-lane (B, S, 2)
    centerline."""
    if centerline.dim() == 2:
        return centerline[idx]
    lanes = torch.arange(idx.shape[0], device=idx.device)
    return centerline[lanes.reshape((-1,) + (1,) * (idx.dim() - 1)), idx]


def _errors(pos, heading, nearest, prev, nxt) -> RoadErrors:
    cte = _cross2(pos - prev, nearest - prev)
    desired = torch.atan2(nxt[:, 1] - nearest[:, 1], nxt[:, 0] - nearest[:, 0])
    return RoadErrors(cte, wrap_to_pi(desired - heading),
                      _cross2(pos - nearest, nxt - nearest))


def compute_errors_ocp_windowed(pos: torch.Tensor, heading: torch.Tensor,
                                centerline: torch.Tensor,
                                center_idx: torch.Tensor,
                                window: int) -> RoadErrors:
    """OCP errors with the nearest point searched in a window of
    ``window`` points (mpc_tpu/ops/road.py:125-154): a quarter behind and
    three quarters ahead of ``center_idx`` (B,), each lane's nearest point
    to its solve's initial state. The window's start is clipped into the
    road and the last point is never selected, so the errors equal
    :func:`compute_errors_ocp`'s whenever the true nearest point lies in the
    window. The selected points are constants for the gradient."""
    centerline = centerline.detach()
    size = centerline.shape[-2]
    if not 0 < window <= size:
        raise ValueError(f"window {window} outside 1..{size}, the "
                         "centerline's points")
    start = torch.clamp(center_idx - window // 4, 0, size - window)
    gidx = start[:, None] + torch.arange(window, device=pos.device)
    d2 = ((_gather(centerline, gidx) - pos[:, None, :]) ** 2).sum(dim=2)
    d2 = torch.where(gidx <= size - 2, d2, torch.full_like(d2, float("inf")))
    idx = start + torch.argmin(d2, dim=1)
    return _errors(pos, heading, _gather(centerline, idx),
                   _gather(centerline, torch.clamp(idx - 1, min=0)),
                   _gather(centerline, idx + 1))


def compute_errors_diagnostic(pos: torch.Tensor, heading: torch.Tensor,
                              centerline: torch.Tensor) -> RoadErrors:
    """Diagnostic errors (mpc_tpu/ops/road.py:157-174): the nearest point
    over the whole road, the previous point wrapping to the last at index 0
    and the next clamped at the end, cross products normalised by the
    segments' lengths."""
    size = centerline.shape[-2]
    idx, nearest = find_nearest_point(pos, centerline)
    prev = _gather(centerline, torch.remainder(idx - 1, size))
    nxt = _gather(centerline, torch.clamp(idx + 1, max=size - 1))
    w, w_next = nearest - prev, nxt - nearest
    cte = _cross2(pos - prev, w) / torch.linalg.vector_norm(w, dim=1)
    desired = torch.atan2(nxt[:, 1] - nearest[:, 1], nxt[:, 0] - nearest[:, 0])
    pos_error = _cross2(pos - nearest, w_next) \
        / torch.linalg.vector_norm(w_next, dim=1)
    return RoadErrors(cte, wrap_to_pi(desired - heading), pos_error)


#: the reference's ``vmap``-ed errors over positions and headings with a
#: shared centerline (mpc_tpu/ops/road.py:179-180): the same functions here
compute_errors_ocp_batched = compute_errors_ocp
compute_errors_diag_batched = compute_errors_diagnostic


class Road:
    """The reference's ``Road`` (mpc_tpu/ops/road.py:182-199): a centerline,
    by default the 100-point circle of radius 5 about (0, 5), and its
    diagnostic lookups over a batch of positions (B, 2)."""

    def __init__(self, center=None, device=None):
        if center is None:
            self.centerline = circle_centerline(device=device)
        else:
            self.centerline = torch.as_tensor(center, dtype=torch.float32,
                                              device=device)

    def find_nearest_point(self, vehicle_position: torch.Tensor):
        return find_nearest_point(vehicle_position, self.centerline)

    def compute_errors(self, vehicle_position: torch.Tensor,
                       vehicle_heading: torch.Tensor) -> RoadErrors:
        return compute_errors_diagnostic(vehicle_position, vehicle_heading,
                                         self.centerline)
