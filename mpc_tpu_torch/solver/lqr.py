"""Time-varying LQR/LQT solves, sequential and parallel-scan Riccati,
lane-batched (port of mpc_tpu/solver/lqr.py).

Problem form (cross terms handled by completing the square):

    minimize  sum_{k=0}^{N-1} [ 1/2 x_k'Q_k x_k + q_k'x_k
                                + 1/2 u_k'R_k u_k + r_k'u_k + x_k'P_k'u_k ]
              + 1/2 x_N'Q_N x_N + q_N'x_N
    s.t.      x_{k+1} = A_k x_k + B_k u_k + c_k,   x_0 given.

Value function convention: V_k(x) = 1/2 x'S_k x - v_k'x + const.

Every operand carries a leading lane axis: A (L, N, n, n), B (L, N, n, m),
c (L, N, n), Q (L, N, n, n), q (L, N, n), R (L, N, m, m), r (L, N, m),
QN (L, n, n), qN (L, n), P (L, N, m, n), x0 (L, n).

The reference's ``lax.scan`` becomes a Python loop over the horizon; its
``jax.lax.associative_scan`` becomes a hand-written log-depth scan over the
horizon axis (Hillis-Steele: ceil(log2 N) rounds, each one batched combine
of every element with the one 2^j places on). Linear solves go through
``torch.linalg.solve_ex`` without error checks: like ``jnp.linalg.solve``
it returns non-finite values for a singular matrix instead of raising, and
it never waits for the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LqtSolution(NamedTuple):
    xs: torch.Tensor    # (L, N+1, n) optimal state trajectory
    us: torch.Tensor    # (L, N, m) optimal inputs
    Ks: torch.Tensor    # (L, N, m, n) feedback gains u~ = -K x - kff (tilde space)
    kffs: torch.Tensor  # (L, N, m) feedforward terms (tilde space)
    Ss: torch.Tensor    # (L, N+1, n, n) value Hessians
    vs: torch.Tensor    # (L, N+1, n) value linear terms (V = 1/2 x'Sx - v'x)
    Ko: torch.Tensor    # (L, N, m, n) original-space policy: u = -Ko x - ko
    ko: torch.Tensor    # (L, N, m)


def _solve(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``M^{-1} rhs`` over any leading axes, unchecked (see the module
    docstring)."""
    return torch.linalg.solve_ex(M, rhs, check_errors=False)[0]


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _t(M: torch.Tensor) -> torch.Tensor:
    return M.transpose(-1, -2)


def _eliminate_cross_terms(A, B, c, Q, q, R, r, P):
    """Substitute u = u~ - R^{-1}(P x + r): returns the cross-term-free
    (A~, c~, Q~, q~) in the u~ variables, and R^{-1}P, R^{-1}r
    (mpc_tpu/solver/lqr.py:48-58)."""
    Rinv_P = _solve(R, P)
    Rinv_r = _solve(R, r[..., None])[..., 0]
    A_t = A - B @ Rinv_P
    c_t = c - _mv(B, Rinv_r)
    Q_t = Q - _t(P) @ Rinv_P
    q_t = q - _mv(_t(Rinv_P), r)
    return A_t, c_t, Q_t, q_t, Rinv_P, Rinv_r


def _gains(S_next, v_next, A, B, c, R):
    """One-step LQR gain from the next-step value function (tilde space;
    mpc_tpu/solver/lqr.py:61-67)."""
    BtS = _t(B) @ S_next
    Quu = R + BtS @ B
    K = _solve(Quu, BtS @ A)
    kff = _solve(Quu, (_mv(BtS, c) - _mv(_t(B), v_next))[..., None])[..., 0]
    return K, kff


def _value_step(S_next, v_next, A, B, c, Q, q, K):
    """Backward Riccati step (tilde space; mpc_tpu/solver/lqr.py:70-81):
    v_k = -q + Acl'(v_next - S_next c)."""
    Acl = A - B @ K
    S = Q + _t(A) @ S_next @ Acl
    v = -q + _mv(_t(Acl), v_next - _mv(S_next, c))
    S = 0.5 * (S + _t(S))
    return S, v


def _no_cross(A, R, P):
    if P is not None:
        return P
    L, N, n = A.shape[:3]
    return torch.zeros((L, N, R.shape[-1], n), dtype=A.dtype, device=A.device)


def lqt_solve_sequential(x0, A, B, c, Q, q, R, r, QN, qN,
                         P=None) -> LqtSolution:
    """Classic O(N)-depth Riccati backward pass and closed-loop forward pass
    (mpc_tpu/solver/lqr.py:84-126), each a loop over the horizon."""
    N = A.shape[1]
    P = _no_cross(A, R, P)
    A_t, c_t, Q_t, q_t, Rinv_P, Rinv_r = _eliminate_cross_terms(
        A, B, c, Q, q, R, r, P)

    S, v = QN, -qN
    Ss, vs, Ks, kffs = [QN], [-qN], [], []
    for k in reversed(range(N)):
        K, kff = _gains(S, v, A_t[:, k], B[:, k], c_t[:, k], R[:, k])
        S, v = _value_step(S, v, A_t[:, k], B[:, k], c_t[:, k], Q_t[:, k],
                           q_t[:, k], K)
        Ss.append(S)
        vs.append(v)
        Ks.append(K)
        kffs.append(kff)
    Ss, vs = torch.stack(Ss[::-1], 1), torch.stack(vs[::-1], 1)
    Ks, kffs = torch.stack(Ks[::-1], 1), torch.stack(kffs[::-1], 1)

    x = x0
    xs, us = [x0], []
    for k in range(N):
        u_t = -_mv(Ks[:, k], x) - kffs[:, k]
        u = u_t - _mv(Rinv_P[:, k], x) - Rinv_r[:, k]
        x = _mv(A[:, k], x) + _mv(B[:, k], u) + c[:, k]
        xs.append(x)
        us.append(u)
    return LqtSolution(xs=torch.stack(xs, 1), us=torch.stack(us, 1), Ks=Ks,
                       kffs=kffs, Ss=Ss, vs=vs, Ko=Ks + Rinv_P,
                       ko=kffs + Rinv_r)


# ---------------------------------------------------------------------------
# Parallel-scan Riccati (associative value-function elements,
# mpc_tpu/solver/lqr.py:129-176)
# ---------------------------------------------------------------------------
# Element e = (A, b, C, eta, J) is the conditional cost-to-go of a horizon
# chunk [i, j); the combination is associative (arXiv:1905.13002 eqs.
# (45)-(49)) and the suffix products e_k (x) ... (x) e_N give
# V_k(x) = 1/2 x'J x - eta'x.


class _Elem(NamedTuple):
    A: torch.Tensor
    b: torch.Tensor
    C: torch.Tensor
    eta: torch.Tensor
    J: torch.Tensor


def _combine(ei: _Elem, ej: _Elem) -> _Elem:
    """Associative combination of adjacent elements; ``ei`` covers the
    earlier chunk. Over any leading axes."""
    n = ei.A.shape[-1]
    I = torch.eye(n, dtype=ei.A.dtype, device=ei.A.device)
    M1 = I + ei.C @ ej.J
    M2 = I + ej.J @ ei.C
    sol1 = _solve(M1, torch.cat(
        [ei.A, (ei.b + _mv(ei.C, ej.eta))[..., None], ei.C], dim=-1))
    s_A, s_b, s_C = sol1[..., :n], sol1[..., n], sol1[..., n + 1:]
    sol2 = _solve(M2, torch.cat(
        [(ej.eta - _mv(ej.J, ei.b))[..., None], ej.J @ ei.A], dim=-1))
    s_eta, s_JA = sol2[..., 0], sol2[..., 1:]
    return _Elem(
        A=ej.A @ s_A,
        b=_mv(ej.A, s_b) + ej.b,
        C=ej.A @ s_C @ _t(ej.A) + ej.C,
        eta=_mv(_t(ei.A), s_eta) + ei.eta,
        J=_t(ei.A) @ s_JA + ei.J,
    )


def _suffix_scan(e: _Elem) -> _Elem:
    """Inclusive suffix products along the horizon axis (axis 1):
    out[k] = e[k] (x) e[k+1] (x) ... (x) e[L-1]. The reference scans the
    reversed sequence with the order flipped
    (``associative_scan(lambda a, b: _combine(b, a), rev)``,
    mpc_tpu/solver/lqr.py:204-208), which is the same product. After the
    round with step d, out[k] covers k .. k+2d-1."""
    L = e.A.shape[1]
    d = 1
    while d < L:
        comb = _combine(_Elem(*(x[:, :L - d] for x in e)),
                        _Elem(*(x[:, d:] for x in e)))
        e = _Elem(*(torch.cat([y, x[:, L - d:]], dim=1)
                    for y, x in zip(comb, e)))
        d *= 2
    return e


def _affine_prefix_scan(F: torch.Tensor, f: torch.Tensor):
    """Inclusive prefix compositions of the affine maps x -> F_k x + f_k
    along axis 1 (the reference's ``comb_affine`` scan,
    mpc_tpu/solver/lqr.py:220-225): out[k] = map_k o ... o map_0."""
    N = F.shape[1]
    d = 1
    while d < N:
        F_new = F[:, d:] @ F[:, :N - d]
        f_new = _mv(F[:, d:], f[:, :N - d]) + f[:, d:]
        F = torch.cat([F[:, :d], F_new], dim=1)
        f = torch.cat([f[:, :d], f_new], dim=1)
        d *= 2
    return F, f


def lqt_solve_parallel(x0, A, B, c, Q, q, R, r, QN, qN,
                       P=None) -> LqtSolution:
    """O(log N)-depth LQT solve (mpc_tpu/solver/lqr.py:179-231): the same
    interface and results as :func:`lqt_solve_sequential` to float32
    rounding."""
    L, N, n = A.shape[:3]
    P = _no_cross(A, R, P)
    A_t, c_t, Q_t, q_t, Rinv_P, Rinv_r = _eliminate_cross_terms(
        A, B, c, Q, q, R, r, P)

    # Per-step elements: chunk [k, k+1) carries stage cost k, (J = Q,
    # eta = -q), with the control span C = B R^{-1} B'; the terminal
    # element has no dynamics.
    BRinvBt = B @ _solve(R, _t(B))
    zero_n = torch.zeros((L, 1, n, n), dtype=A.dtype, device=A.device)
    elems = _Elem(
        A=torch.cat([A_t, zero_n], 1),
        b=torch.cat([c_t, torch.zeros_like(c_t[:, :1])], 1),
        C=torch.cat([BRinvBt, zero_n], 1),
        eta=torch.cat([-q_t, -qN[:, None]], 1),
        J=torch.cat([Q_t, QN[:, None]], 1))
    suffix = _suffix_scan(elems)
    Ss = 0.5 * (suffix.J + _t(suffix.J))          # (L, N+1, n, n)
    vs = suffix.eta                                # (L, N+1, n)

    # Gains from the next-step value functions, all stages at once.
    Ks, kffs = _gains(Ss[:, 1:], vs[:, 1:], A_t, B, c_t, R)

    # Forward pass: x_{k+1} = (A - B K) x_k + (c - B kff), a composition of
    # affine maps.
    Fs, fs = _affine_prefix_scan(A_t - B @ Ks, c_t - _mv(B, kffs))
    xs = torch.cat([x0[:, None], _mv(Fs, x0[:, None]) + fs], 1)
    u_t = -_mv(Ks, xs[:, :-1]) - kffs
    us = u_t - _mv(Rinv_P, xs[:, :-1]) - Rinv_r
    return LqtSolution(xs=xs, us=us, Ks=Ks, kffs=kffs, Ss=Ss, vs=vs,
                       Ko=Ks + Rinv_P, ko=kffs + Rinv_r)
