"""Optimal-control / NLP problem containers (port of mpc_tpu/solver/problem.py).

Problem form (alpaqa's NLP class)::

    minimize    f(u; p)
    subject to  u in C          (decision-variable box)
                g(u; p) in D    (general-constraint box)

Every callable is lane-batched: ``cost(u (B, n), param) -> (B,)``. Lanes are
independent, so the gradient of the lane sum is the stack of per-lane
gradients (:func:`value_and_grad`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch


class Box(NamedTuple):
    """Closed interval box; +-inf entries disable a side."""
    lower: torch.Tensor
    upper: torch.Tensor

    @staticmethod
    def unbounded(n: int, device=None) -> "Box":
        inf = torch.full((n,), float("inf"), dtype=torch.float32,
                         device=device)
        return Box(-inf, inf)

    @property
    def is_bounded(self) -> bool:
        """Any finite bound? (Checked once, when a solver is built.)"""
        return bool(torch.isfinite(self.lower).any()
                    or torch.isfinite(self.upper).any())


def project(x: torch.Tensor, box: Box) -> torch.Tensor:
    """Euclidean projection onto a box = clip (min(max(x, lo), hi))."""
    return torch.clamp(x, min=box.lower, max=box.upper)


def project_difference(x: torch.Tensor, box: Box) -> torch.Tensor:
    """``x - Pi_box(x)``: signed distance components to the box."""
    return x - project(x, box)


@dataclasses.dataclass(frozen=True)
class Problem:
    """A box-constrained NLP with general constraints, lane-batched.

    ``cost_multi(cands (B, K, n), param) -> (psi (B, K), grad (B, K, n))``,
    when present, evaluates the PANOC candidate fan in one call (the fused
    kernel path, ops/fused_psi.py). ``al_multi(cands (B, K, n), param,
    lam (B, m), sigma (B, m)) -> (psi (B, K), grad (B, K, n))`` is its
    augmented-Lagrangian variant for the general-constraint path
    (mpc_tpu/solver/problem.py:75-77). ``param_prep(param) -> param``
    derives solve-constant data from the parameters once per solve.
    """
    cost: Callable[[torch.Tensor, Any], torch.Tensor]
    constraints: Optional[Callable[[torch.Tensor, Any], torch.Tensor]]
    C: Box
    D: Box
    n: int
    m: int
    cost_multi: Optional[Callable] = None
    al_multi: Optional[Callable] = None
    param_prep: Optional[Callable] = None


def value_and_grad(fn: Callable, u: torch.Tensor, param: Any):
    """``(fn(u, param) (B,), d sum(fn) / du (B, n))`` by autograd."""
    with torch.enable_grad():
        u_ = u.detach().requires_grad_(True)
        psi = fn(u_, param)
        (grad,) = torch.autograd.grad(psi.sum(), u_)
    return psi.detach(), grad


def build_ocp_problem(f_d: Callable, stage_cost: Callable, n_horiz: int,
                      state_dim: int, input_dim: int, C: Box,
                      stage_constraints: Optional[Callable] = None,
                      n_stage_constraints: int = 0,
                      D: Optional[Box] = None) -> Problem:
    """Single-shooting OCP (mpc_tpu/solver/problem.py:87-155).

    Decision variable: the flat input sequence ``[u_0; u_1; ...]`` (B, n).
    ``param`` is a dict with ``y0`` (B, state_dim), ``p`` and whatever the
    stage cost reads (e.g. ``centerline``). The stage cost and constraints see
    the state *after* each input. The rollout is a Python loop over stages.
    """
    n = input_dim * n_horiz
    m = n_stage_constraints * n_horiz

    def rollout(u_flat, param):
        x = param["y0"]
        for k in range(n_horiz):
            u_k = u_flat[:, k * input_dim:(k + 1) * input_dim]
            x = f_d(x, u_k, param["p"])
            yield x, u_k

    def cost(u_flat, param):
        tot = None
        for x, u_k in rollout(u_flat, param):
            c = stage_cost(x, u_k, param)
            tot = c if tot is None else tot + c
        return tot

    constraints = None
    if stage_constraints is not None:
        def constraints(u_flat, param):
            return torch.cat([stage_constraints(x, u_k, param)
                              for x, u_k in rollout(u_flat, param)], dim=1)

    if D is None:
        D = Box.unbounded(m, device=C.lower.device)
    return Problem(cost=cost, constraints=constraints, C=C, D=D, n=n, m=m)
