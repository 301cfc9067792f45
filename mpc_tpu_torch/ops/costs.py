"""Stage costs: the vehicle's tracking cost and its residual form, and the
hanging chain's cost (port of mpc_tpu/ops/costs.py)."""

from __future__ import annotations

import numpy as np
import torch

from mpc_tpu_torch.ops.road import compute_errors_ocp

# c = [v, cte, pos_err, heading_err, steer, drive]
DEFAULT_VEHICLE_WEIGHTS = (0.5, 1.0, 1.0, 0.5, 0.1, 0.01)


def vehicle_stage_cost(x: torch.Tensor, u: torch.Tensor,
                       centerline: torch.Tensor, target_v: float,
                       c=DEFAULT_VEHICLE_WEIGHTS,
                       errors_fn=compute_errors_ocp) -> torch.Tensor:
    """Per-lane stage cost ``(B,)`` of states ``x`` (B, sd) after inputs
    ``u`` (B, 2):

      L = c0 (|v| - v_ref)^2 + c1 cte^2 + c2 pos_err^2 + c3 head_err^2
          + c4 delta^2 + c5 d^2

    Speed is ``sqrt(vx^2 + vy^2)`` for the 6-state Pacejka model and ``|v|``
    for the 4-state kinematic model. ``centerline`` is (S, 2), shared, or
    (B, S, 2), one road per lane. ``errors_fn(pos (B, 2), heading (B,),
    centerline) -> RoadErrors`` gives the road errors
    (mpc_tpu/ops/costs.py:20-46).
    """
    err = errors_fn(x[:, :2], x[:, 2], centerline)
    if x.shape[1] >= 5:
        speed = torch.sqrt(x[:, 3] ** 2 + x[:, 4] ** 2)
    else:
        speed = torch.abs(x[:, 3])
    return (c[0] * (speed - target_v) ** 2
            + c[1] * err.cte ** 2
            + c[2] * err.pos_error ** 2
            + c[3] * err.heading_error ** 2
            + c[4] * u[:, 1] ** 2
            + c[5] * u[:, 0] ** 2)


def vehicle_stage_residuals(x: torch.Tensor, u: torch.Tensor,
                            centerline: torch.Tensor, target_v: float,
                            c=DEFAULT_VEHICLE_WEIGHTS) -> torch.Tensor:
    """Residual form ``(B, 6)`` of :func:`vehicle_stage_cost`
    (mpc_tpu/ops/costs.py:49-79): ``vehicle_stage_cost == sum(res**2)``.

    The Gauss-Newton iLQR backward pass takes its curvature from the
    residuals' Jacobian. As in the reference, the speed residual's
    derivative is NaN at zero speed (the derivative of ``sqrt`` at 0).
    """
    err = compute_errors_ocp(x[:, :2], x[:, 2], centerline)
    if x.shape[1] >= 5:
        speed = torch.sqrt(x[:, 3] ** 2 + x[:, 4] ** 2)
    else:
        speed = torch.abs(x[:, 3])
    # the weights' square roots in float32, as jnp.sqrt takes them; Python
    # floats, so that no tensor is copied to the card per call
    w = [float(np.sqrt(np.float32(ci))) for ci in c]
    return torch.stack([
        w[0] * (speed - target_v),
        w[1] * err.cte,
        w[2] * err.pos_error,
        w[3] * err.heading_error,
        w[4] * u[:, 1],
        w[5] * u[:, 0],
    ], dim=1)


def chain_stage_cost(y: torch.Tensor, u: torch.Tensor, n_balls: int,
                     dim: int, x_end: torch.Tensor, alpha: float = 25.0,
                     beta: float = 1.0, gamma: float = 0.01) -> torch.Tensor:
    """Hanging-chain stage cost (B,) of states ``y`` (B, state_dim) after
    inputs ``u`` (B, dim) (mpc_tpu/ops/costs.py:80-92):

      L = alpha ||y3 - x_end||^2 + beta sum_i ||vel_i||^2 + gamma ||u||^2
    """
    nd = n_balls * dim
    y2 = y[:, nd: 2 * nd]
    y3 = y[:, 2 * nd:]
    return (alpha * ((y3 - x_end) ** 2).sum(dim=1)
            + beta * (y2 ** 2).sum(dim=1)
            + gamma * (u ** 2).sum(dim=1))
