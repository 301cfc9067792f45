"""Driving potential fields: obstacle risk, lane keeping, road boundaries
(port of mpc_tpu/ops/potential_field.py).

Batch-native: a point's arguments are (B,) tensors, one point per lane, and
an obstacle set is (K,), shared by every lane, or (B, K), one set per lane;
the obstacle field sums over the last axis. Field definitions (the
reference's dpf_test.py, as the JAX package keeps them):

- ``obstacle_field``: a rotated anisotropic Gaussian per obstacle, scaled by
  exp(-alpha (x - x_obs)) with alpha = (v - v_obs) / 5;
- ``lane_potential``: 0.5 a (y - y_target)^2;
- ``boundary_potential``: b (y - y_bound)^2 outside [y_right, y_left];
- ``safe_distances``: the kinematic safe gaps.
"""

from __future__ import annotations

import torch

# the reference module's constants (mpc_tpu/ops/potential_field.py:24-26)
Y_TARGET, Y_BOUND_RIGHT, Y_BOUND_LEFT = 1.75, 1.0, 6.0
X_0, Y_0, A_X_MAX, A_Y_MAX = 5.0, 3.0, 3.0, 1.0


def _rotate(x, y, theta):
    c, s = torch.cos(theta), torch.sin(theta)
    return c * x - s * y, s * x + c * y


def obstacle_field(x, y, phi, v, obs_x, obs_y, obs_phi, obs_v,
                   a_f: float = 1000.0, b: float = 1.0,
                   sigma_x: float = 2.0, sigma_y: float = 0.5):
    """Risk at points (B,) summed over obstacles (K,) or (B, K)
    (mpc_tpu/ops/potential_field.py:34-50): each obstacle and the point are
    rotated by the relative heading, and the field decays or steepens
    along the road with the relative speed."""
    x, y, phi, v = (t[..., None] for t in (x, y, phi, v))
    theta = phi - obs_phi
    oxr, oyr = _rotate(obs_x, obs_y, theta)
    xr, yr = _rotate(x, y, theta)
    alpha = (v - obs_v) / 5.0
    expo = ((xr - oxr) ** 2 / (2 * sigma_x ** 2)
            + (yr - oyr) ** 2 / (2 * sigma_y ** 2)) ** b
    return (a_f * torch.exp(-expo) * torch.exp(-alpha * (xr - oxr))).sum(-1)


def lane_potential(y, y_target: float = Y_TARGET, a: float = 0.5):
    """Quadratic lane-keeping well (mpc_tpu/ops/potential_field.py:53-55)."""
    return a * (y - y_target) ** 2


def boundary_potential(y, y_right: float = Y_BOUND_RIGHT,
                       y_left: float = Y_BOUND_LEFT, b: float = 100.0):
    """One-sided quadratic walls outside the road
    (mpc_tpu/ops/potential_field.py:58-62)."""
    zero = torch.zeros_like(y)
    return torch.where(y >= y_left, b * (y - y_left) ** 2,
                       torch.where(y <= y_right, b * (y - y_right) ** 2,
                                   zero))


def total_field(x, y, phi, v, obs_x, obs_y, obs_phi, obs_v,
                y_target: float = Y_TARGET):
    """Obstacle + lane + boundary, the quantity the reference draws
    (mpc_tpu/ops/potential_field.py:65-71)."""
    return (obstacle_field(x, y, phi, v, obs_x, obs_y, obs_phi, obs_v)
            + lane_potential(y, y_target)
            + boundary_potential(y))


def field_grid(xs, ys, phi, v, obs_x, obs_y, obs_phi, obs_v):
    """The total field on the grid ``xs`` x ``ys``, (len(ys), len(xs))
    (mpc_tpu/ops/potential_field.py:74-79): one lane per grid point, the
    obstacles shared."""
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    full = torch.full_like(gx.reshape(-1), 1.0)
    out = total_field(gx.reshape(-1), gy.reshape(-1), full * phi, full * v,
                      obs_x, obs_y, obs_phi, obs_v)
    return out.reshape(gx.shape)


def safe_distances(ego_state, obs_state):
    """Kinematic longitudinal and lateral safe gaps of states (B, 4)
    ``[x, y, vx, vy]`` (mpc_tpu/ops/potential_field.py:82-89)."""
    x_s = X_0 / 2 + (ego_state[:, 2] - obs_state[:, 2]) ** 2 / (2 * A_X_MAX)
    y_s = Y_0 / 2 + (ego_state[:, 3] - obs_state[:, 3]) ** 2 / (2 * A_Y_MAX)
    return x_s, y_s


def obstacle_stage_cost(x_state, obstacles, weight: float = 1.0,
                        a_f: float = 10.0, sigma_x: float = 0.2,
                        sigma_y: float = 0.1):
    """The obstacle-avoidance term of the vehicle stage cost, (B,)
    (mpc_tpu/ops/potential_field.py:92-107): the risk field at each lane's
    pose ``x_state`` (B, state_dim) ``[x, y, phi, v, ...]`` against
    ``obstacles`` (K, 4), shared, or (B, K, 4), one set per lane, rows
    ``[x, y, phi, v]``; the defaults are rescaled to the 1:43 car's world
    as in the JAX package."""
    if obstacles.dim() == 3 and obstacles.shape[0] != x_state.shape[0]:
        raise ValueError(f"obstacle_stage_cost: {obstacles.shape[0]} "
                         f"obstacle sets for {x_state.shape[0]} lanes")
    return weight * obstacle_field(
        x_state[:, 0], x_state[:, 1], x_state[:, 2], x_state[:, 3],
        obstacles[..., 0], obstacles[..., 1], obstacles[..., 2],
        obstacles[..., 3], a_f=a_f, sigma_x=sigma_x, sigma_y=sigma_y)
