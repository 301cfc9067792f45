"""Simple baseline controllers, lane-batched (port of
mpc_tpu/control/simple.py; the reference's controllers without alpaqa).

- ``simple_mpc``: single-shooting MPC by Adam on a forward-Euler rollout
  cost, the gradient from autograd (the JAX package's ``jax.grad``; the
  reference used scipy with finite differences). As in the JAX package the
  cost is the intended position-error cost and the speed term tracks
  ``target_velocity``.
- ``simple_mpc_initial``: the fixed-target variant.
- ``straight_line_controller``: the constant input [1, 0] with the road
  errors returned.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from mpc_tpu_torch.ops.road import (RoadErrors, compute_errors_diagnostic,
                                    find_nearest_point)


class SimpleMpcResult(NamedTuple):
    u0: torch.Tensor      # (B, 2)
    u_seq: torch.Tensor   # (B, n_horiz, 2)
    cost: torch.Tensor    # (B,)


def _euler_rollout_cost(model: Callable, x0, us, dt, cost_stage):
    x, tot = x0, None
    for k in range(us.shape[1]):
        x = x + model(x, us[:, k], None) * dt
        c = cost_stage(x, us[:, k])
        tot = c if tot is None else tot + c
    return tot


def _adam(cost: Callable, x0: torch.Tensor, n_horiz: int, iters: int,
          lr: float) -> SimpleMpcResult:
    """``iters`` Adam steps from zero inputs on ``cost(us (B, N, 2)) ->
    (B,)``, with the JAX package's moments and bias correction
    (mpc_tpu/control/simple.py:67-76)."""
    us = torch.zeros((x0.shape[0], n_horiz, 2), dtype=x0.dtype,
                     device=x0.device)
    m, v = torch.zeros_like(us), torch.zeros_like(us)
    for t in range(1, iters + 1):
        with torch.enable_grad():
            us_ = us.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(cost(us_).sum(), us_)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = m / (1 - 0.9 ** t)
        vh = v / (1 - 0.999 ** t)
        us = us - lr * mh / (torch.sqrt(vh) + 1e-8)
    with torch.no_grad():
        return SimpleMpcResult(u0=us[:, 0], u_seq=us, cost=cost(us))


def simple_mpc(model: Callable, x0: torch.Tensor, centerline: torch.Tensor,
               n_horiz: int = 2, dt: float = 0.1,
               target_velocity: float = 1.0, iters: int = 200,
               lr: float = 0.05) -> SimpleMpcResult:
    """Single-shooting MPC from ``x0`` (B, state_dim) by Adam on the
    forward-Euler rollout of ``model(x, u, t)``; stage cost
    100 cte^2 + 10 heading^2 + 10 (v - target_velocity)^2 with the
    diagnostic road errors (mpc_tpu/control/simple.py:45-81)."""
    def stage(x, u):
        err = compute_errors_diagnostic(x[:, :2], x[:, 2], centerline)
        v = torch.sqrt(x[:, 3] ** 2 + x[:, 4] ** 2) if x.shape[1] >= 5 \
            else x[:, 3]
        return (100.0 * err.cte ** 2 + 10.0 * err.heading_error ** 2
                + 10.0 * (v - target_velocity) ** 2)

    return _adam(lambda us: _euler_rollout_cost(model, x0, us, dt, stage),
                 x0, n_horiz, iters, lr)


def simple_mpc_initial(model: Callable, x0: torch.Tensor,
                       target_state: torch.Tensor, n_horiz: int = 2,
                       dt: float = 0.1, iters: int = 200,
                       lr: float = 0.05) -> SimpleMpcResult:
    """The fixed-target variant: stage cost ``||x - target_state||^2``
    (mpc_tpu/control/simple.py:84-113)."""
    def stage(x, u):
        return ((x - target_state) ** 2).sum(dim=1)

    return _adam(lambda us: _euler_rollout_cost(model, x0, us, dt, stage),
                 x0, n_horiz, iters, lr)


class StraightLineOut(NamedTuple):
    u: torch.Tensor               # (B, 2)
    nearest_index: torch.Tensor   # (B,)
    nearest_point: torch.Tensor   # (B, 2)
    errors: RoadErrors


def straight_line_controller(current_state: torch.Tensor,
                             centerline: torch.Tensor) -> StraightLineOut:
    """Full drive and zero steering for states (B, state_dim), with the
    nearest road point and the road errors (mpc_tpu/control/simple.py:
    123-132)."""
    pos = current_state[:, :2]
    idx, pt = find_nearest_point(pos, centerline)
    errs = compute_errors_diagnostic(pos, current_state[:, 2], centerline)
    u = torch.tensor([1.0, 0.0], dtype=current_state.dtype,
                     device=current_state.device)
    return StraightLineOut(u=u.expand(current_state.shape[0], 2).clone(),
                           nearest_index=idx, nearest_point=pt, errors=errs)
