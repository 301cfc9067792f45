"""Hanging-chain MPC: the OCP and its controller, lane-batched (port of
mpc_tpu/control/chain_mpc.py; the reference's alpaqa demo).

A quadratic tracking cost and, per ball and stage, a cubic floor
constraint with a one-sided box D = [lb, +inf): unlike the vehicle OCP it
runs the ALM general path's multiplier loop. With
g_c(c, x) = c0 x^3 + c1 x^2 + c2 x, each ball's height must satisfy
y - g_c(c, x) >= lb, where the coefficients encode the floor
c (x - a)^3 + d (x - a) + b.
"""

from __future__ import annotations

from typing import Optional

import torch

from mpc_tpu_torch.config import AlmConfig, PanocConfig
from mpc_tpu_torch.control.mpc import MpcController, resolve_device
from mpc_tpu_torch.models.chain import ChainSpec, chain_dynamics
from mpc_tpu_torch.models.integrators import discretize
from mpc_tpu_torch.ops.costs import chain_stage_cost
from mpc_tpu_torch.solver.alm import make_alm_solver
from mpc_tpu_torch.solver.problem import Box, Problem, build_ocp_problem

# the floor c (x - a)^3 + d (x - a) + b (mpc_tpu/control/chain_mpc.py:127)
FLOOR_A, FLOOR_B, FLOOR_C, FLOOR_D = 0.6, -1.4, 5.0, 2.2


def floor_coefficients(a: float = FLOOR_A, c: float = FLOOR_C,
                       d: float = FLOOR_D, device=None):
    """The floor's monomial coefficients ``[c0, c1, c2]`` (float32) and the
    constraint's lower bound (mpc_tpu/control/chain_mpc.py:130-136)."""
    coeff = torch.tensor([c, -3.0 * a * c, 3.0 * a * a * c + d],
                         dtype=torch.float32, device=device)
    lb = FLOOR_B - c * a ** 3 - d * a
    return coeff, lb


def g_constr(coeff: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The cubic floor polynomial, elementwise in ``x``."""
    return coeff[0] * x ** 3 + coeff[1] * x ** 2 + coeff[2] * x


def build_chain_ocp(spec: ChainSpec = ChainSpec(), n_horiz: int = 12,
                    ts: float = 0.05, device=None) -> Problem:
    """The chain OCP (mpc_tpu/control/chain_mpc.py:144-168): n = dim * N
    inputs in the box |u| <= 1, m = (n_balls + 1) * N floor constraints in
    D = [lb, +inf). ``param`` holds ``y0`` (B, state_dim), ``p``
    (ChainParams) and ``constr``, the floor's coefficients (3,).
    ``device=None`` is the card (``control.mpc.resolve_device``)."""
    device = resolve_device(device)
    f_d = discretize(chain_dynamics(spec), ts=ts)
    n, d = spec.n_balls, spec.dim
    x_end = spec.x_end(device)

    def stage_cost(y, u, param):
        return chain_stage_cost(y, u, n, d, x_end)

    def stage_constraints(y, u, param):
        coeff = param["constr"]
        y1 = y[:, : n * d].reshape(-1, n, d)
        ball_c = y1[..., d - 1] - g_constr(coeff, y1[..., 0])
        free_end = y[:, -1] - g_constr(coeff, y[:, 2 * n * d])
        return torch.cat([ball_c, free_end[:, None]], dim=1)

    m = (n + 1) * n_horiz
    _, lb = floor_coefficients()
    ones = torch.ones((d * n_horiz,), device=device)
    D = Box(torch.full((m,), lb, dtype=torch.float32, device=device),
            torch.full((m,), float("inf"), device=device))
    return build_ocp_problem(f_d, stage_cost, n_horiz, spec.state_dim, d,
                             Box(-ones, ones), stage_constraints, n + 1, D)


def build_chain_controller(spec: ChainSpec = ChainSpec(), n_horiz: int = 12,
                           ts: float = 0.05,
                           alm_cfg: Optional[AlmConfig] = None,
                           panoc_cfg: Optional[PanocConfig] = None,
                           device=None) -> MpcController:
    """The chain's MPC controller with the reference's solver settings
    (mpc_tpu/control/chain_mpc.py:171-189): ``AlmConfig(eps=1e-4,
    delta=1e-4, sigma_0=1e5, max_iter=12, eps_0=1e-2)``,
    ``PanocConfig(lbfgs_memory=N, max_iter=250)``, warm start U = 0.
    ``device=None`` is the card."""
    device = resolve_device(device)
    problem = build_chain_ocp(spec, n_horiz, ts, device=device)
    if alm_cfg is None:
        alm_cfg = AlmConfig(eps=1e-4, delta=1e-4, sigma_0=1e5, max_iter=12,
                            eps_0=1e-2)
    if panoc_cfg is None:
        panoc_cfg = PanocConfig(lbfgs_memory=n_horiz, max_iter=250)
    solve = make_alm_solver(problem, alm_cfg, panoc_cfg)
    return MpcController(problem=problem, solve=solve, n_horiz=n_horiz,
                         input_dim=spec.dim,
                         warm_start_input=(0.0,) * spec.dim, device=device)
