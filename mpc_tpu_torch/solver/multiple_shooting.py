"""Multiple-shooting OCP, lane-batched (port of
mpc_tpu/solver/multiple_shooting.py).

The horizon is split into M segments; the start states of segments 2..M
join the decision vector,

    z = [U (N * input_dim) ; X_1 .. X_{M-1} (state_dim each)],

every segment is rolled out from its own start, and defect equalities
``x_end(segment k) - X_{k+1} = 0`` (D = {0}) glue them, handled by the ALM
general path. The JAX package rolls the segments out side by side with
``jax.vmap``; here the M segments of each of the B lanes are folded into the
lane axis, B*M lanes of depth N/M, and the stage cost and constraints are
evaluated on all N stages of every lane in one call.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from mpc_tpu_torch.solver.problem import Box, Problem, fold_lanes


class MsLayout(NamedTuple):
    n_horiz: int
    n_segments: int
    seg_len: int
    state_dim: int
    input_dim: int

    @property
    def n_inputs(self) -> int:
        return self.n_horiz * self.input_dim

    @property
    def n_states(self) -> int:
        return (self.n_segments - 1) * self.state_dim

    @property
    def n(self) -> int:
        return self.n_inputs + self.n_states


def unpack_decision(z: torch.Tensor, lo: MsLayout):
    """Split z (B, n) into ``(us (B, N, input_dim), x_starts (B, M-1,
    state_dim))``."""
    B = z.shape[0]
    us = z[:, : lo.n_inputs].reshape(B, lo.n_horiz, lo.input_dim)
    xs = z[:, lo.n_inputs:].reshape(B, lo.n_segments - 1, lo.state_dim)
    return us, xs


def pack_decision(us: torch.Tensor, x_starts: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`unpack_decision`: (B, n)."""
    B = us.shape[0]
    return torch.cat([us.reshape(B, -1), x_starts.reshape(B, -1)], dim=1)


def build_ms_ocp_problem(f_d: Callable, stage_cost: Callable, n_horiz: int,
                         n_segments: int, state_dim: int, input_dim: int,
                         C_inputs: Box,
                         stage_constraints: Optional[Callable] = None,
                         n_stage_constraints: int = 0,
                         D_stage: Optional[Box] = None,
                         state_bound=None):
    """The multiple-shooting Problem and its layout, ``(Problem, MsLayout)``
    (mpc_tpu/solver/multiple_shooting.py:67-162).

    The conventions of ``build_ocp_problem``: the stage cost and constraints
    see the state after each input, ``param`` holds ``y0`` and ``p``. The
    defects follow the stage constraints in g and D. ``state_bound``
    (state_dim,), when given, boxes the segment start states
    ``|X_k| <= state_bound`` in C; by default they are free.
    """
    if n_horiz % n_segments:
        raise ValueError(f"horizon {n_horiz} not divisible by {n_segments}")
    lo = MsLayout(n_horiz, n_segments, n_horiz // n_segments, state_dim,
                  input_dim)
    M, L, N = n_segments, lo.seg_len, n_horiz

    def all_states(z, param):
        """States after each input (B, N, sd), the inputs (B, N, in), the
        segment end states (B, M, sd) and the start states (B, M-1, sd)."""
        B = z.shape[0]
        us, x_starts = unpack_decision(z, lo)
        x = torch.cat([param["y0"][:, None], x_starts], dim=1).reshape(
            B * M, state_dim)
        useg = us.reshape(B * M, L, input_dim)
        xs = []
        for j in range(L):
            x = f_d(x, useg[:, j], param["p"])
            xs.append(x)
        xs = torch.stack(xs, dim=1).reshape(B, N, state_dim)
        return xs, us, x.reshape(B, M, state_dim), x_starts

    def per_stage(fn, xs, us, param):
        """``fn`` on all N stages of every lane in one call, (B, N, ...)."""
        B = xs.shape[0]
        out = fn(xs.reshape(B * N, state_dim), us.reshape(B * N, input_dim),
                 fold_lanes(param, N))
        return out.reshape(B, N, *out.shape[1:])

    def cost(z, param):
        xs, us, _, _ = all_states(z, param)
        return per_stage(stage_cost, xs, us, param).sum(dim=1)

    def constraints_of(xs, us, x_ends, x_starts, param):
        B = xs.shape[0]
        defects = (x_ends[:, :-1] - x_starts).reshape(B, -1)
        if stage_constraints is None:
            return defects
        g = per_stage(stage_constraints, xs, us, param).reshape(B, -1)
        return torch.cat([g, defects], dim=1)

    def constraints(z, param):
        xs, us, x_ends, x_starts = all_states(z, param)
        return constraints_of(xs, us, x_ends, x_starts, param)

    def cost_constraints(z, param):
        xs, us, x_ends, x_starts = all_states(z, param)
        return (per_stage(stage_cost, xs, us, param).sum(dim=1),
                constraints_of(xs, us, x_ends, x_starts, param))

    device = C_inputs.lower.device
    n_defects = (M - 1) * state_dim
    m_stage = n_stage_constraints * n_horiz
    if state_bound is None:
        xb = torch.full((lo.n_states,), float("inf"), device=device)
    else:
        state_bound = torch.as_tensor(state_bound, dtype=torch.float32,
                                      device=device)
        if state_bound.shape != (state_dim,):
            raise ValueError(f"state_bound shape {tuple(state_bound.shape)} "
                             f"!= ({state_dim},)")
        xb = state_bound.repeat(M - 1)
    C = Box(lower=torch.cat([C_inputs.lower, -xb]),
            upper=torch.cat([C_inputs.upper, xb]))
    zeros = torch.zeros((n_defects,), device=device)
    if stage_constraints is not None:
        if D_stage is None:
            D_stage = Box.unbounded(m_stage, device=device)
        D = Box(lower=torch.cat([D_stage.lower, zeros]),
                upper=torch.cat([D_stage.upper, zeros]))
        m = m_stage + n_defects
    else:
        D, m = Box(lower=zeros, upper=zeros), n_defects
    prob = Problem(cost=cost, constraints=constraints, C=C, D=D, n=lo.n, m=m,
                   cost_constraints=cost_constraints)
    return prob, lo


def ms_warm_start(f_d: Callable, lo: MsLayout, y0: torch.Tensor,
                  us: torch.Tensor, p) -> torch.Tensor:
    """A feasible start (B, n): roll each lane's inputs ``us`` (B, N *
    input_dim) out from ``y0`` (B, state_dim) and place the true segment
    boundary states in the decision vector
    (mpc_tpu/solver/multiple_shooting.py:165-176)."""
    B = y0.shape[0]
    u = us.reshape(B, lo.n_horiz, lo.input_dim)
    x, starts = y0, [y0.new_zeros((B, 0, lo.state_dim))]
    for k in range((lo.n_segments - 1) * lo.seg_len):
        x = f_d(x, u[:, k], p)
        if (k + 1) % lo.seg_len == 0:
            starts.append(x[:, None])
    return pack_decision(u, torch.cat(starts, dim=1))
