"""Horizon-sharded parallel-scan Riccati: the LQT over a mesh's ``horizon``
axis (port of mpc_tpu/parallel/lqr_sharded.py).

``solver/lqr.py:lqt_solve_parallel`` scans the horizon on one device. Here
its two scans, the backward scan of value elements and the forward scan of
closed-loop affine maps, are split over the ranks of the horizon group in
the classic three phases:

  1. each rank scans its chunk of the stages (``solver/lqr.py``'s scans);
  2. one ``all_gather`` of the chunks' products (one element per rank and
     lane) and a scan over those P elements give each rank the carry from
     the chunks after it (backward) or before it (forward);
  3. one batched combine folds the carry into the local results, with the
     identity element on the last (backward) or first (forward) rank.

Sequences are padded with identity elements to a multiple of P, so the
horizon need not divide by it. The per-stage algebra (the cross-term
elimination, the gains) needs no collective and is ``solver/lqr.py``'s.
Each scan's results are gathered over the horizon group, so every horizon
rank returns the same ``LqtSolution``; lanes go over the scenario group.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mpc_tpu_torch.parallel.mesh import (HORIZON_AXIS, SCENARIO_AXIS,
                                         all_gather_rows, axis_size,
                                         scenario_slice)
from mpc_tpu_torch.parallel.sharding import gather_scenarios
from mpc_tpu_torch.solver.lqr import (LqtSolution, _Elem, _affine_prefix_scan,
                                      _combine, _eliminate_cross_terms,
                                      _gains, _mv, _no_cross, _solve,
                                      _suffix_scan, _t)


def _pack(e: _Elem) -> torch.Tensor:
    """An element's five fields as one (..., 3n^2 + 2n) tensor."""
    return torch.cat([e.A.flatten(-2), e.b, e.C.flatten(-2), e.eta,
                      e.J.flatten(-2)], dim=-1)


def _unpack(t: torch.Tensor, n: int) -> _Elem:
    A, b, C, eta, J = torch.split(t, [n * n, n, n * n, n, n * n], dim=-1)
    sq = lambda x: x.reshape(x.shape[:-1] + (n, n))     # noqa: E731
    return _Elem(sq(A), b, sq(C), eta, sq(J))


def _identity(like: torch.Tensor, k: int) -> _Elem:
    """k identity elements of ``_combine`` (A = I, the rest 0) per lane,
    shaped like the (L, *, n, n) tensor ``like``."""
    L, n = like.shape[0], like.shape[-1]
    I = torch.eye(n, dtype=like.dtype, device=like.device).expand(L, k, n, n)
    Z = torch.zeros((L, k, n, n), dtype=like.dtype, device=like.device)
    z = torch.zeros((L, k, n), dtype=like.dtype, device=like.device)
    return _Elem(A=I, b=z, C=Z, eta=z, J=Z)


def _gather_stages(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """The horizon group's chunks (L, chunk, ...) in rank order, joined along
    the stage axis and cut to ``n`` stages."""
    rows = all_gather_rows(t, group)                 # (P, L, chunk, ...)
    rows = rows.movedim(0, 1)
    return rows.reshape((rows.shape[0], -1) + tuple(rows.shape[3:]))[:, :n]


def _blocked_suffix_scan(local: _Elem, group, d: int, P: int) -> _Elem:
    """out[k] = e[k] (x) ... (x) e[last] over every rank's chunk; ``local``
    is this rank's chunk (L, chunk, ...)."""
    n = local.A.shape[-1]
    scan = _suffix_scan(local)
    T = all_gather_rows(_pack(_Elem(*(x[:, 0] for x in scan))), group)
    U = _suffix_scan(_unpack(T.movedim(0, 1), n))     # (L, P, ...)
    carry = _identity(local.A, 1) if d == P - 1 else \
        _Elem(*(x[:, d + 1:d + 2] for x in U))
    return _combine(scan, _Elem(*(c.expand_as(x)
                                  for c, x in zip(carry, scan))))


def _blocked_prefix_scan(F: torch.Tensor, f: torch.Tensor, group, d: int,
                         P: int):
    """Prefix compositions map_k o ... o map_0 over every rank's chunk of the
    affine maps x -> F x + f; ``F``, ``f`` are this rank's (L, chunk, ...)."""
    L, n = F.shape[0], F.shape[-1]
    Fl, fl = _affine_prefix_scan(F, f)
    T = all_gather_rows(torch.cat([Fl[:, -1].flatten(-2), fl[:, -1]], -1),
                        group).movedim(0, 1)          # (L, P, n^2 + n)
    VF, Vf = _affine_prefix_scan(T[..., : n * n].reshape(L, P, n, n),
                                 T[..., n * n:])
    if d == 0:
        CF = torch.eye(n, dtype=F.dtype, device=F.device).expand(L, 1, n, n)
        cf = torch.zeros((L, 1, n), dtype=F.dtype, device=F.device)
    else:
        CF, cf = VF[:, d - 1:d], Vf[:, d - 1:d]
    return Fl @ CF, _mv(Fl, cf.expand_as(fl)) + fl


def make_lqt_horizon_sharded(mesh, horizon_axis: str = HORIZON_AXIS,
                             scenario_axis: Optional[str] = SCENARIO_AXIS):
    """Build ``solve(x0, A, B, c, Q, q, R, r, QN, qN, P=None) ->
    LqtSolution`` with the Riccati scans sharded over ``horizon_axis``.

    The interface and results are ``solver/lqr.py:lqt_solve_parallel``'s
    (lane-batched, terminal terms per lane, (L, n, n) and (L, n)), to
    float32 rounding. Every rank passes the global inputs and gets the
    global solution. The lanes go over ``scenario_axis`` (None: every rank
    of the horizon group solves all the lanes it is given, the batched
    AL-iLQR's use, which splits the lanes itself); L must divide by it. N
    need not divide by the horizon axis (identity padding).
    """
    group = mesh.get_group(horizon_axis)
    Ph, d = axis_size(mesh, horizon_axis), mesh.get_local_rank(horizon_axis)

    def solve(x0, A, B, c, Q, q, R, r, QN, qN, P=None) -> LqtSolution:
        if scenario_axis is not None:
            rows = scenario_slice(mesh, A.shape[0])
            x0, A, B, c, Q, q, R, r, QN, qN, P = (
                None if t is None else t[rows]
                for t in (x0, A, B, c, Q, q, R, r, QN, qN, P))
        L, N, n = A.shape[:3]
        P = _no_cross(A, R, P)
        A_t, c_t, Q_t, q_t, Rinv_P, Rinv_r = _eliminate_cross_terms(
            A, B, c, Q, q, R, r, P)
        BRinvBt = B @ _solve(R, _t(B))
        zero_n = torch.zeros((L, 1, n, n), dtype=A.dtype, device=A.device)
        elems = _Elem(
            A=torch.cat([A_t, zero_n], 1),
            b=torch.cat([c_t, torch.zeros_like(c_t[:, :1])], 1),
            C=torch.cat([BRinvBt, zero_n], 1),
            eta=torch.cat([-q_t, -qN[:, None]], 1),
            J=torch.cat([Q_t, QN[:, None]], 1))
        # identities after the terminal element leave the suffix products
        # unchanged (e (x) id = e)
        n_e = Ph * math.ceil((N + 1) / Ph)
        if n_e > N + 1:
            elems = _Elem(*(torch.cat([x, i], 1) for x, i in
                            zip(elems, _identity(A, n_e - N - 1))))
        ch = n_e // Ph
        local = _Elem(*(x[:, d * ch:(d + 1) * ch] for x in elems))
        suffix = _blocked_suffix_scan(local, group, d, Ph)
        J = _gather_stages(suffix.J, group, N + 1)
        vs = _gather_stages(suffix.eta, group, N + 1)
        Ss = 0.5 * (J + _t(J))

        Ks, kffs = _gains(Ss[:, 1:], vs[:, 1:], A_t, B, c_t, R)
        Acl, bcl = A_t - B @ Ks, c_t - _mv(B, kffs)
        n_f = Ph * math.ceil(N / Ph)
        if n_f > N:
            Acl = torch.cat([Acl, _identity(A, n_f - N).A], 1)
            bcl = torch.cat([bcl, torch.zeros_like(bcl[:, :1]).expand(
                L, n_f - N, n)], 1)
        chf = n_f // Ph
        Fl, fl = _blocked_prefix_scan(Acl[:, d * chf:(d + 1) * chf],
                                      bcl[:, d * chf:(d + 1) * chf],
                                      group, d, Ph)
        Fs = _gather_stages(Fl, group, N)
        fs = _gather_stages(fl, group, N)

        xs = torch.cat([x0[:, None], _mv(Fs, x0[:, None]) + fs], 1)
        u_t = -_mv(Ks, xs[:, :-1]) - kffs
        us = u_t - _mv(Rinv_P, xs[:, :-1]) - Rinv_r
        sol = LqtSolution(xs=xs, us=us, Ks=Ks, kffs=kffs, Ss=Ss, vs=vs,
                          Ko=Ks + Rinv_P, ko=kffs + Rinv_r)
        if scenario_axis is None:
            return sol
        return LqtSolution(*(gather_scenarios(mesh, t) for t in sol))

    return solve
