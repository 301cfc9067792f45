"""Vehicle tracking stage cost (port of mpc_tpu/ops/costs.py:20-46)."""

from __future__ import annotations

import torch

from mpc_tpu_torch.ops.road import compute_errors_ocp

# c = [v, cte, pos_err, heading_err, steer, drive]
DEFAULT_VEHICLE_WEIGHTS = (0.5, 1.0, 1.0, 0.5, 0.1, 0.01)


def vehicle_stage_cost(x: torch.Tensor, u: torch.Tensor,
                       centerline: torch.Tensor, target_v: float,
                       c=DEFAULT_VEHICLE_WEIGHTS) -> torch.Tensor:
    """Per-lane stage cost ``(B,)`` of states ``x`` (B, sd) after inputs
    ``u`` (B, 2):

      L = c0 (|v| - v_ref)^2 + c1 cte^2 + c2 pos_err^2 + c3 head_err^2
          + c4 delta^2 + c5 d^2

    Speed is ``sqrt(vx^2 + vy^2)`` for the 6-state Pacejka model and ``|v|``
    for the 4-state kinematic model.
    """
    err = compute_errors_ocp(x[:, :2], x[:, 2], centerline)
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
