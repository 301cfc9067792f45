"""Augmented-Lagrangian (ALM) solver: the unconstrained fast path
(port of mpc_tpu/solver/alm.py:87-133).

When the general-constraint box D is unbounded (the vehicle OCP leaves it
so), the augmented-Lagrangian term vanishes and the reference reduces, at
build time, to one full-tolerance PANOC solve. That is the path ported here.
The general path (outer multiplier/penalty loop and the fused AL kernel K3)
comes with a later slice of the port.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from mpc_tpu_torch.config import AlmConfig, PanocConfig
from mpc_tpu_torch.solver.panoc import make_panoc_solver
from mpc_tpu_torch.solver.problem import Problem, value_and_grad


class AlmResult(NamedTuple):
    u: torch.Tensor                           # (B, n)
    lam: torch.Tensor                         # (B, m)
    psi: torch.Tensor                         # (B,)
    converged: torch.Tensor                   # (B,) bool
    outer_iterations: torch.Tensor            # (B,) int32
    inner_iterations: torch.Tensor            # (B,) int32
    constraint_violation: torch.Tensor        # (B,)
    inner_convergence_failures: torch.Tensor  # (B,) int32
    sigma: torch.Tensor                       # (B, m) warm-start carry
    gamma: torch.Tensor                       # (B,) warm-start carry
    trace: Any = None
    inner_trace: Any = None


def make_alm_solver(problem: Problem, alm_cfg: AlmConfig = AlmConfig(),
                    panoc_cfg: PanocConfig = PanocConfig()) -> Callable:
    """Build ``solve(param, u0, lam0, tol=None, sigma0=None, gamma0=None)
    -> AlmResult`` over a batch of lanes.

    Raises ``NotImplementedError`` for a problem with bounded general
    constraints: that path is not ported yet.
    """
    has_general = problem.constraints is not None and problem.m > 0 \
        and problem.D.is_bounded
    if has_general:
        raise NotImplementedError(
            "mpc_tpu_torch: the ALM general-constraint path (bounded D, "
            "fused AL kernel K3) is not ported yet; see ROADMAP.md, slice 3")

    def psi_vg(u, args):
        return value_and_grad(problem.cost, u, args)

    panoc = make_panoc_solver(psi_vg, problem.C, panoc_cfg,
                              psi_vg_multi=problem.cost_multi)

    def solve(param, u0, lam0, tol=None, sigma0=None, gamma0=None):
        # ``tol`` overrides the configured tolerance per call; +inf makes a
        # lane converge at iteration 0.
        if tol is None:
            tol = alm_cfg.eps
        if problem.param_prep is not None:
            param = problem.param_prep(param)
        res = panoc(u0, tol, param, gamma_init=gamma0)
        B = u0.shape[0]
        sigma = sigma0 if sigma0 is not None else \
            torch.zeros((B, problem.m), dtype=u0.dtype, device=u0.device)
        return AlmResult(
            u=res.u, lam=lam0, psi=res.psi, converged=res.converged,
            outer_iterations=torch.ones((B,), dtype=torch.int32,
                                        device=u0.device),
            inner_iterations=res.iterations,
            constraint_violation=torch.zeros((B,), dtype=u0.dtype,
                                             device=u0.device),
            inner_convergence_failures=(~res.converged).to(torch.int32),
            sigma=sigma, gamma=res.gamma, inner_trace=res.trace)

    return solve
