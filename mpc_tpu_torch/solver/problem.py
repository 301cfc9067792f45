"""Optimal-control / NLP problem containers (port of mpc_tpu/solver/problem.py).

Problem form (alpaqa's NLP class)::

    minimize    f(u; p)
    subject to  u in C          (decision-variable box)
                g(u; p) in D    (general-constraint box)

Every callable is lane-batched: ``cost(u (B, n), param) -> (B,)``. Lanes are
independent, so the gradient of the lane sum is the stack of per-lane
gradients (:func:`value_and_grad`).

The parameters of a problem are a dict (``y0``, ``p``, the road, ...) whose
entries are either one per lane, with a leading lane axis, or shared by
every lane. ``LANE_NDIM`` says which: an entry is per lane when its key is
listed there and it has that many dimensions (a centerline is (S, 2),
shared, or (B, S, 2), one road per lane), and shared otherwise. A
parameter that is a bare tensor is per lane. :func:`fold_lanes` repeats the
per-lane entries, which is how an evaluation over K points per lane (the
PANOC candidate fan, the stages of a horizon) runs as one call over B*K
lanes, as ``jax.vmap`` over the points runs it in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

#: the port's parameter convention: the number of dimensions of each entry
#: that is one per lane (y0 (B, state_dim), a road per lane (B, S, 2), an
#: obstacle set per lane (B, K, 4), the windowed search's anchor (B,))
LANE_NDIM = {"y0": 2, "centerline": 3, "obstacles": 3, "window_center": 1}


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
    kernel path, ops/fused_psi.py); without it the fan is the plain cost
    over B*K lanes. ``al_multi(cands (B, K, n), param,
    lam (B, m), sigma (B, m)) -> (psi (B, K), grad (B, K, n))`` is its
    augmented-Lagrangian variant for the general-constraint path
    (mpc_tpu/solver/problem.py:75-77). ``param_prep(param) -> param``
    derives solve-constant data from the parameters once per solve.
    ``cost_constraints(u, param) -> (cost (B,), constraints (B, m))`` gives
    both from one rollout (the ALM general path's objective); without it
    they come from ``cost`` and ``constraints``. ``uses_obstacles`` marks a
    cost that reads ``param["obstacles"]``, so that the scenario suites pass
    each lane's obstacles (mpc_tpu/solver/problem.py:78-80).
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
    cost_constraints: Optional[Callable] = None
    uses_obstacles: bool = False


def fold_lanes(tree: Any, k: int) -> Any:
    """Repeat each lane's row ``k`` times in a row, (B, ...) -> (B*k, ...),
    in every per-lane tensor of ``tree`` (a tensor, a dict of parameters
    under ``LANE_NDIM``, or a tuple or list of such); shared entries and
    non-tensors are returned as they are."""
    if torch.is_tensor(tree):
        return tree[:, None].expand(tree.shape[0], k, *tree.shape[1:]) \
            .reshape(tree.shape[0] * k, *tree.shape[1:])
    if isinstance(tree, dict):
        return {key: fold_lanes(v, k)
                if torch.is_tensor(v) and v.dim() == LANE_NDIM.get(key)
                else v for key, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(fold_lanes(t, k) for t in tree)
    return tree


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
    the state *after* each input. The rollout is a Python loop over stages;
    ``cost_constraints`` takes the cost and the constraints from one of them.
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

    constraints = cost_constraints = None
    if stage_constraints is not None:
        def constraints(u_flat, param):
            return torch.cat([stage_constraints(x, u_k, param)
                              for x, u_k in rollout(u_flat, param)], dim=1)

        def cost_constraints(u_flat, param):
            tot, g = None, []
            for x, u_k in rollout(u_flat, param):
                c = stage_cost(x, u_k, param)
                tot = c if tot is None else tot + c
                g.append(stage_constraints(x, u_k, param))
            return tot, torch.cat(g, dim=1)

    if D is None:
        D = Box.unbounded(m, device=C.lower.device)
    return Problem(cost=cost, constraints=constraints, C=C, D=D, n=n, m=m,
                   cost_constraints=cost_constraints)
