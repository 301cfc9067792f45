"""Closed-loop simulation (port of mpc_tpu/sim/closedloop.py:34-58).

As in the reference, the plant model is the prediction model: each step the
plant is advanced with the same ``f_d`` from the first optimal input.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from mpc_tpu_torch.control.mpc import MpcCarry, MpcController


class ClosedLoopOut(NamedTuple):
    ys: torch.Tensor           # (B, n_sim, state_dim) plant states after each step
    us: torch.Tensor           # (B, n_sim, input_dim) applied inputs
    carry: MpcCarry            # final warm-start state
    inner_iters: torch.Tensor  # (B, n_sim) inner iterations per step
    converged: torch.Tensor    # (B, n_sim) convergence flags per step


@torch.no_grad()
def run_closed_loop(controller: MpcController, f_d: Callable,
                    y0: torch.Tensor, static_param: Any, n_sim: int,
                    plant_params) -> ClosedLoopOut:
    """Run ``n_sim`` MPC steps for a batch of lanes ``y0`` (B, state_dim).

    ``static_param`` is the parameter dict without ``y0`` (e.g.
    ``{"p": params, "centerline": cl}``); the plant state is inserted as
    ``y0`` each step.
    """
    carry = controller.init_carry(y0.shape[0], device=y0.device,
                                  dtype=y0.dtype)
    y = y0
    ys, us, iters, conv = [], [], [], []
    for _ in range(n_sim):
        out = controller.step(carry, dict(static_param, y0=y))
        y = f_d(y, out.u0, plant_params)
        carry = out.carry
        ys.append(y)
        us.append(out.u0)
        iters.append(out.result.inner_iterations)
        conv.append(out.result.converged)
    return ClosedLoopOut(ys=torch.stack(ys, dim=1), us=torch.stack(us, dim=1),
                         carry=carry, inner_iters=torch.stack(iters, dim=1),
                         converged=torch.stack(conv, dim=1))
