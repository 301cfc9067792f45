"""Bicycle vehicle models on lane-batched tensors
(port of mpc_tpu/models/bicycle.py).

States are ``(B, 6)`` ``[x, y, phi, vx, vy, omega]`` for the Pacejka
single-track model and ``(B, 4)`` ``[x, y, phi, v]`` for the kinematic
bicycle; inputs are ``(B, 2)`` ``[d, delta]``. As in the reference, the ODEs
do not clip their inputs unless ``clip=True``.
"""

from __future__ import annotations

import torch

from mpc_tpu_torch.models.params import VehicleParams


def clip_inputs(u: torch.Tensor, p: VehicleParams) -> torch.Tensor:
    """Clip ``[d, delta]`` to the box limits (mpc_tpu/models/bicycle.py:36-40)."""
    lim = torch.tensor([float(p.max_drive), float(p.max_steer)],
                       dtype=u.dtype, device=u.device)
    return torch.clamp(u, -lim, lim)


def pacejka_dynamics(x: torch.Tensor, u: torch.Tensor, p: VehicleParams,
                     clip: bool = False) -> torch.Tensor:
    """Dynamic single-track model with Pacejka lateral tyre forces
    (mpc_tpu/models/bicycle.py:43-80)."""
    if clip:
        u = clip_inputs(u, p)
    d, delta = u[:, 0], u[:, 1]
    phi, vx, vy, omega = x[:, 2], x[:, 3], x[:, 4], x[:, 5]

    lf, lr = p.axis_front, p.axis_rear
    m, iz = p.mass, p.inertia

    af = -torch.atan2(omega * lf + vy, vx) + delta
    ar = torch.atan2(omega * lr - vy, vx)

    frx = (p.cm1 - p.cm2 * vx) * d - p.cr0 * torch.sign(vx) - p.cr2 * vx * vx
    ffy = p.df * torch.sin(p.cf * torch.atan(p.bf * af))
    fry = p.dr * torch.sin(p.cr * torch.atan(p.br * ar))

    cos_phi, sin_phi = torch.cos(phi), torch.sin(phi)
    cos_d, sin_d = torch.cos(delta), torch.sin(delta)

    return torch.stack([
        vx * cos_phi - vy * sin_phi,
        vx * sin_phi + vy * cos_phi,
        omega,
        (frx - ffy * sin_d + m * vy * omega) / m,
        (fry + ffy * cos_d - m * vx * omega) / m,
        (ffy * lf * cos_d - fry * lr) / iz,
    ], dim=1)


def simplified_dynamics(x: torch.Tensor, u: torch.Tensor, p: VehicleParams,
                        clip: bool = False) -> torch.Tensor:
    """Kinematic bicycle (mpc_tpu/models/bicycle.py:83-104)."""
    if clip:
        u = clip_inputs(u, p)
    d, delta = u[:, 0], u[:, 1]
    phi, v = x[:, 2], x[:, 3]

    lf, lr = p.axis_front, p.axis_rear
    a, mu = p.acceleration, p.friction

    beta = torch.atan2(lf * torch.tan(delta),
                       torch.full_like(delta, lf + lr))
    return torch.stack([
        v * torch.cos(phi + beta),
        v * torch.sin(phi + beta),
        v * torch.sin(beta) / lr,
        a * d - mu * v,
    ], dim=1)
