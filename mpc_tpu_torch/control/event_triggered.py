"""Event-triggered MPC, batch-native (port of
mpc_tpu/control/event_triggered.py:31-120).

Re-solve a lane's OCP only when its plant deviates from the last predicted
trajectory by at least a threshold, or when its stored input sequence runs
out; otherwise replay the stored open-loop input. Lanes that do not trigger
pass the solver ``tol = +inf``, its lane-skip sentinel: they exit at
iteration 0, so a batch where few lanes trigger costs only the triggered
lanes' iterations, with fixed shapes throughout.

As in the reference, the carry keeps no ALM penalties or PANOC step size:
every solve starts with ``sigma0 = None`` and ``gamma0 = None``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from mpc_tpu_torch.control.mpc import MpcController
from mpc_tpu_torch.solver.alm import AlmResult


class EtcCarry(NamedTuple):
    U: torch.Tensor           # (B, n) stored input sequence
    lam: torch.Tensor         # (B, m) multipliers
    xs_pred: torch.Tensor     # (B, N, state_dim) prediction of the last solve
    k: torch.Tensor           # (B,) int32 steps since the last solve
    tot_solves: torch.Tensor  # (B,) int32
    tot_it: torch.Tensor      # (B,) int32


class EtcStepOut(NamedTuple):
    carry: EtcCarry
    u0: torch.Tensor                # (B, input_dim) applied input
    triggered: torch.Tensor         # (B,) bool
    prediction_error: torch.Tensor  # (B,)
    result: AlmResult               # the solve's statistics, for observers


@dataclasses.dataclass(frozen=True)
class EventTriggeredController:
    """Wraps an :class:`MpcController` with a trigger rule: re-solve when
    ``||y - xs_pred[k-1]||_2 >= threshold`` or after ``n_horiz`` replayed
    inputs; ``eps`` is the solver tolerance of a triggered lane."""
    base: MpcController
    f_d: Callable
    threshold: float
    eps: float

    @property
    def n_horiz(self) -> int:
        return self.base.n_horiz

    def init_carry(self, batch: int, state_dim: int = 6, device=None,
                   dtype=torch.float32) -> EtcCarry:
        """Every lane solves on its first step (``k = n_horiz``)."""
        mc = self.base.init_carry(batch, device=device, dtype=dtype)
        device = mc.U.device
        return EtcCarry(
            U=mc.U, lam=mc.lam,
            xs_pred=torch.full((batch, self.n_horiz, state_dim),
                               float("inf"), dtype=dtype, device=device),
            k=torch.full((batch,), self.n_horiz, dtype=torch.int32,
                         device=device),
            tot_solves=torch.zeros((batch,), dtype=torch.int32,
                                   device=device),
            tot_it=torch.zeros((batch,), dtype=torch.int32, device=device))

    def step(self, carry: EtcCarry, param: Any) -> EtcStepOut:
        y = param["y0"]
        B = y.shape[0]
        N, n_in = self.n_horiz, self.base.input_dim
        lanes = torch.arange(B, device=y.device)

        k = torch.clamp(carry.k, max=N - 1)
        # xs_pred[j] is the state after inputs 0..j, so after k applied
        # inputs the plant should sit at xs_pred[k-1]
        pred = carry.xs_pred[lanes, torch.clamp(carry.k - 1, 0, N - 1).long()]
        pred_err = torch.linalg.vector_norm(y - pred, dim=1)
        expired = carry.k >= N
        # >= so that threshold = 0 is every-step MPC even when the plant
        # reproduces the prediction exactly
        triggered = (pred_err >= self.threshold) | expired

        # warm start: the stored sequence shifted by k applied inputs (the
        # reference's jnp.roll), a per-lane gather
        n = carry.U.shape[1]
        idx = (torch.arange(n, device=y.device)[None]
               + (k * n_in).long()[:, None]) % n
        U_shifted = torch.gather(carry.U, 1, idx)
        tol = torch.where(triggered,
                          torch.full_like(pred_err, self.eps),
                          torch.full_like(pred_err, float("inf")))
        res = self.base.solve(param, U_shifted, carry.lam, tol)

        U_new = torch.where(triggered[:, None], res.u, carry.U)
        lam_new = torch.where(triggered[:, None], res.lam, carry.lam)
        k_new = torch.where(triggered, torch.zeros_like(k), k)
        u0 = torch.gather(U_new, 1, (k_new * n_in).long()[:, None]
                          + torch.arange(n_in, device=y.device)[None])

        # the prediction of a re-solved lane: U_new rolled out from y
        x, xs = y, []
        us = U_new.reshape(B, N, n_in)
        for j in range(N):
            x = self.f_d(x, us[:, j], param["p"])
            xs.append(x)
        xs_pred = torch.where(triggered[:, None, None], torch.stack(xs, 1),
                              carry.xs_pred)

        new_carry = EtcCarry(
            U=U_new, lam=lam_new, xs_pred=xs_pred, k=k_new + 1,
            tot_solves=carry.tot_solves + triggered.to(torch.int32),
            tot_it=carry.tot_it + res.inner_iterations)
        return EtcStepOut(new_carry, u0, triggered, pred_err, res)
