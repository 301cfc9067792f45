"""PANOC inner solver with L-BFGS acceleration, lane-batched
(port of mpc_tpu/solver/panoc.py).

The reference solves one lane and is ``vmap``-ed; here every tensor carries a
leading lane axis B and each lane keeps its own L-BFGS ring, step size and
exit counters. The reference's ``lax.while_loop`` becomes a host loop over
chunks of masked iterations with one host sync per chunk (the all-lanes-done
test). Under ``jax.vmap`` a lane whose loop condition is False is frozen by
the batched while-loop itself, so the port computes ``active = cond(state)``
per lane and applies every body update, ``iters += 1`` included, only where
it holds.

The float32 safeguards of the reference are kept exactly: the QUB margin,
the trust-region cap ``tr_mult``, the stall and plateau exits and the
``crit_floor_mult`` stagnation acceptance.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from mpc_tpu_torch.config import PanocConfig
from mpc_tpu_torch.solver.problem import Box, project

#: masked iterations run between two all-lanes-done checks (host syncs)
_CHUNK = 4


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def _where(mask: torch.Tensor, a, b):
    """Per-lane select over (nested) NamedTuples of tensors."""
    if a is None:
        return None
    if isinstance(a, tuple):
        return type(a)(*(_where(mask, x, y) for x, y in zip(a, b)))
    return torch.where(_bcast(mask, a), a, b)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=-1)


# ---------------------------------------------------------------------------
# L-BFGS ring buffer, one per lane
# ---------------------------------------------------------------------------

class LbfgsState(NamedTuple):
    S: torch.Tensor       # (B, M, n) steps s_k
    Y: torch.Tensor       # (B, M, n) residual differences y_k
    rho: torch.Tensor     # (B, M)    1 / (s_k . y_k)
    valid: torch.Tensor   # (B, M)    bool
    head: torch.Tensor    # (B,)      next write slot (int64)


def lbfgs_init(batch: int, memory: int, n: int, device=None,
               dtype=torch.float32) -> LbfgsState:
    return LbfgsState(
        S=torch.zeros((batch, memory, n), dtype=dtype, device=device),
        Y=torch.zeros((batch, memory, n), dtype=dtype, device=device),
        rho=torch.zeros((batch, memory), dtype=dtype, device=device),
        valid=torch.zeros((batch, memory), dtype=torch.bool, device=device),
        head=torch.zeros((batch,), dtype=torch.int64, device=device),
    )


def lbfgs_flush(st: LbfgsState) -> LbfgsState:
    return st._replace(valid=torch.zeros_like(st.valid),
                       head=torch.zeros_like(st.head))


def lbfgs_push(st: LbfgsState, s: torch.Tensor, y: torch.Tensor,
               min_step=0.0) -> LbfgsState:
    """Insert each lane's curvature pair at its own head slot; a lane whose
    pair fails the curvature test (or whose step is below ``min_step``)
    keeps its ring unchanged (mpc_tpu/solver/panoc.py:66-86)."""
    sy = _dot(s, y)
    sn = torch.linalg.vector_norm(s, dim=-1)
    good = (sy > 1e-10 * sn * torch.linalg.vector_norm(y, dim=-1)) \
        & (sn > min_step)
    safe_sy = torch.where(good, sy, torch.ones_like(sy))
    lanes = torch.arange(s.shape[0], device=s.device)
    h = st.head
    S, Y, rho, valid = (st.S.clone(), st.Y.clone(), st.rho.clone(),
                        st.valid.clone())
    S[lanes, h] = torch.where(good[:, None], s, st.S[lanes, h])
    Y[lanes, h] = torch.where(good[:, None], y, st.Y[lanes, h])
    rho[lanes, h] = torch.where(good, 1.0 / safe_sy, st.rho[lanes, h])
    valid[lanes, h] = good | st.valid[lanes, h]
    head = torch.where(good, (h + 1) % st.S.shape[1], h)
    return LbfgsState(S, Y, rho, valid, head)


def lbfgs_direction(st: LbfgsState, q: torch.Tensor) -> torch.Tensor:
    """Two-loop recursion per lane: ``d = -H q`` (mpc_tpu/solver/panoc.py:89-110)."""
    M = st.S.shape[1]
    lanes = torch.arange(q.shape[0], device=q.device)
    alphas = []
    for j in range(M):                       # newest -> oldest
        i = (st.head - 1 - j) % M
        m = st.valid[lanes, i]
        s_i, y_i, rho_i = st.S[lanes, i], st.Y[lanes, i], st.rho[lanes, i]
        mf = m.to(q.dtype)
        a = torch.where(m, rho_i * _dot(s_i, q), torch.zeros_like(rho_i))
        q = q - (a * mf)[:, None] * y_i
        alphas.append((s_i, y_i, rho_i, m, mf, a))

    i0 = (st.head - 1) % M
    s0, y0 = st.S[lanes, i0], st.Y[lanes, i0]
    yy = _dot(y0, y0)
    sy = _dot(s0, y0)
    h0 = torch.where(st.valid[lanes, i0] & (yy > 0),
                     sy / torch.clamp(yy, min=1e-30), torch.ones_like(yy))
    q = q * h0[:, None]

    for s_i, y_i, rho_i, m, mf, a in reversed(alphas):   # oldest -> newest
        b = torch.where(m, rho_i * _dot(y_i, q), torch.zeros_like(rho_i))
        q = q + ((a - b) * mf)[:, None] * s_i
    return -q


# ---------------------------------------------------------------------------
# PANOC
# ---------------------------------------------------------------------------

class PanocTrace(NamedTuple):
    """Per-iterate history (``PanocConfig.trace=True``): (B, max_iter)
    buffers; entries past ``iterations`` stay NaN."""
    psi: torch.Tensor
    criterion: torch.Tensor
    gamma: torch.Tensor


class PanocResult(NamedTuple):
    u: torch.Tensor           # (B, n)
    psi: torch.Tensor         # (B,)
    converged: torch.Tensor   # (B,) bool
    iterations: torch.Tensor  # (B,) int32
    criterion: torch.Tensor   # (B,) final ||r||/gamma (ProjGradNorm2)
    gamma: torch.Tensor       # (B,) final step size, the warm-start carry
    trace: Any = None


class _State(NamedTuple):
    u: torch.Tensor
    psi: torch.Tensor
    grad: torch.Tensor
    gamma: torch.Tensor
    lbfgs: LbfgsState
    iters: torch.Tensor
    converged: torch.Tensor
    criterion: torch.Tensor
    stalled: torch.Tensor
    best_crit: torch.Tensor
    plateau: torch.Tensor
    trace: Any = None


def make_panoc_solver(psi_vg: Callable, C: Box, cfg: PanocConfig,
                      psi_vg_multi: Optional[Callable] = None,
                      progress_callback: Optional[Callable] = None
                      ) -> Callable:
    """Build ``solve(u0 (B, n), tol, args, gamma_init=None) -> PanocResult``.

    ``psi_vg(u (B, n), args) -> (psi (B,), grad (B, n))`` is the value and
    gradient of the smooth objective. ``psi_vg_multi(cands (B, K, n), args)
    -> (psi (B, K), grad (B, K, n))``, when given, evaluates the candidate
    fan in one call (the fused kernel); otherwise ``psi_vg`` is called once
    per candidate. ``progress_callback(iters, psi, criterion, gamma)`` is
    called on the host after every masked iteration with (B,) tensors.
    """
    if psi_vg_multi is not None:
        cand_vg = psi_vg_multi
    else:
        def cand_vg(cands, args):
            outs = [psi_vg(cands[:, k], args) for k in range(cands.shape[1])]
            return (torch.stack([o[0] for o in outs], dim=1),
                    torch.stack([o[1] for o in outs], dim=1))

    taus = tuple(float(t) for t in cfg.taus)

    def fbe(u_c, psi_c, grad_c, gamma):
        """Forward-backward envelope at each candidate; gamma is (B,)."""
        g = gamma[:, None, None]
        diff = project(u_c - g * grad_c, C) - u_c
        return psi_c + _dot(grad_c, diff) + _dot(diff, diff) / (2.0 * gamma[:, None])

    def cond(st: _State) -> torch.Tensor:
        return (~st.converged) & (st.iters < cfg.max_iter) \
            & (st.stalled < 3) & (st.plateau < cfg.plateau_iters)

    def solve(u0: torch.Tensor, tol, args, gamma_init=None) -> PanocResult:
        dtype, device = u0.dtype, u0.device
        B = u0.shape[0]
        lanes = torch.arange(B, device=device)
        eps_f = torch.finfo(dtype).eps
        tol = torch.as_tensor(tol, dtype=dtype, device=device)
        u0 = project(u0, C)

        # Initial step size from a finite-difference Lipschitz estimate;
        # both points go through the candidate-fan evaluator in one call.
        h = 1e-4 * (1.0 + torch.abs(u0))
        psis0, grads0 = cand_vg(torch.stack([u0, u0 + h], dim=1), args)
        psi0, g0, g_h = psis0[:, 0], grads0[:, 0], grads0[:, 1]
        L0 = torch.linalg.vector_norm(g_h - g0, dim=-1) / torch.clamp(
            torch.linalg.vector_norm(h, dim=-1), min=1e-30)
        L0 = torch.clamp(L0, 1e-8, 1e15)
        gamma0 = cfg.alpha / L0
        if gamma_init is not None:
            gamma_init = gamma_init.to(dtype)
            g_warm = torch.clamp(gamma_init, min=gamma0 / 64.0, max=gamma0)
            gamma0 = torch.where(gamma_init > 0, g_warm, gamma0)

        tr0 = None
        if cfg.trace:
            nanbuf = torch.full((B, cfg.max_iter), float("nan"), dtype=dtype,
                                device=device)
            tr0 = PanocTrace(nanbuf, nanbuf.clone(), nanbuf.clone())
        izero = torch.zeros((B,), dtype=torch.int32, device=device)
        inf = torch.full((B,), float("inf"), dtype=dtype, device=device)
        st = _State(
            u=u0, psi=psi0, grad=g0, gamma=gamma0,
            lbfgs=lbfgs_init(B, cfg.lbfgs_memory, u0.shape[1], device, dtype),
            iters=izero, converged=torch.zeros((B,), dtype=torch.bool,
                                               device=device),
            criterion=inf, stalled=izero, best_crit=inf, plateau=izero,
            trace=tr0)

        def body(st: _State) -> _State:
            u, psi_u, g_u, gamma = st.u, st.psi, st.grad, st.gamma
            gc = gamma[:, None]

            fw = u - gc * g_u
            u_hat = project(fw, C)
            r = u - u_hat
            rn2 = _dot(r, r)
            crit = torch.sqrt(rn2) / gamma
            conv_now = crit <= tol

            tr = st.trace
            if cfg.trace:
                k = torch.clamp(st.iters.long(), max=cfg.max_iter - 1)
                bufs = []
                for buf, val in zip(tr, (psi_u, crit, gamma)):
                    buf = buf.clone()
                    buf[lanes, k] = val
                    bufs.append(buf)
                tr = PanocTrace(*bufs)
            if progress_callback is not None:
                progress_callback(st.iters, psi_u, crit, gamma)

            # Structured step: quasi-Newton only on the free coordinates.
            free = (fw > C.lower) & (fw < C.upper)
            fmask = free.to(dtype)
            d_free = lbfgs_direction(st.lbfgs, r * fmask)
            # Trust-region cap against noise-poisoned curvature pairs.
            dn = torch.linalg.vector_norm(d_free, dim=-1)
            cap = cfg.tr_mult * torch.sqrt(rn2)
            d_free = d_free * torch.clamp(
                cap / torch.clamp(dn, min=1e-30), max=1.0)[:, None]
            d = torch.where(free, d_free, -r)
            # Candidate fan: x_hat (tau=0) plus the tau grid, one call.
            cands = torch.stack(
                [u_hat] + [u - (1.0 - t) * r + t * d for t in taus], dim=1)
            psis, grads = cand_vg(cands, args)
            psi_hat = psis[:, 0]

            # Quadratic upper bound with an f32 rounding margin.
            margin = 10.0 * eps_f * (torch.abs(psi_u) + torch.abs(psi_hat)) \
                + 1e-12
            qub_rhs = psi_u - _dot(g_u, r) + rn2 / (2.0 * gamma) + margin
            gamma_ok = (psi_hat <= qub_rhs) | (gamma <= cfg.gamma_min)

            # branch A: halve gamma, flush history, stay put
            st_shrink = st._replace(gamma=gamma * 0.5,
                                    lbfgs=lbfgs_flush(st.lbfgs))

            # branch B: take the best candidate by FBE
            phis = fbe(cands, psis, grads, gamma)
            phis = torch.where(torch.isnan(phis),
                               torch.full_like(phis, float("inf")), phis)
            best = torch.argmin(phis, dim=1)
            u_n, psi_n, g_n = cands[lanes, best], psis[lanes, best], \
                grads[lanes, best]

            r_n = u_n - project(u_n - gc * g_n, C)
            min_step = cfg.lbfgs_min_step_mult * eps_f \
                * (1.0 + torch.linalg.vector_norm(u, dim=-1))
            lb_n = lbfgs_push(st.lbfgs, (u_n - u) * fmask, (r_n - r) * fmask,
                              min_step=min_step)
            moved = (u_n != u).any(dim=-1)
            st_step = st._replace(
                u=u_n, psi=psi_n, grad=g_n, lbfgs=lb_n,
                stalled=torch.where(moved, torch.zeros_like(st.stalled),
                                    st.stalled + 1))

            improved = crit < st.best_crit * 0.999
            st_new = _where(gamma_ok, st_step, st_shrink)
            st_new = st_new._replace(
                iters=st.iters + 1,
                criterion=torch.minimum(st.criterion, crit),
                best_crit=torch.minimum(st.best_crit, crit),
                plateau=torch.where(improved, torch.zeros_like(st.plateau),
                                    st.plateau + 1),
                trace=tr)
            # a lane that converges now is frozen with its criterion
            st_done = st._replace(converged=torch.ones_like(st.converged),
                                  criterion=crit, trace=tr)
            return _where(conv_now, st_done, st_new)

        while bool(cond(st).any()):
            for _ in range(_CHUNK):
                active = cond(st)
                st = _where(active, body(st), st)

        # Final criterion refresh (covers the max_iter/stagnation exits) and
        # the f32-aware stagnation acceptance (mpc_tpu/solver/panoc.py:341-356).
        u_hat = project(st.u - st.gamma[:, None] * st.grad, C)
        crit = torch.linalg.vector_norm(st.u - u_hat, dim=-1) / st.gamma
        floor = cfg.crit_floor_mult * eps_f \
            * (1.0 + torch.linalg.vector_norm(st.u, dim=-1)) / st.gamma
        exhausted = (st.stalled >= 3) | (st.plateau >= cfg.plateau_iters)
        at_floor = exhausted & (crit <= floor)
        return PanocResult(
            u=st.u, psi=st.psi,
            converged=st.converged | (crit <= tol) | at_floor,
            iterations=st.iters, criterion=crit, gamma=st.gamma,
            trace=st.trace)

    return solve
