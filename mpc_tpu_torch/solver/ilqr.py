"""Iterative LQR and AL-iLQR, lane-batched (port of mpc_tpu/solver/ilqr.py).

The second solver family beside ALM+PANOC:

- backward pass: the time-varying LQT of the linearised problem
  (solver/lqr.py), sequential or parallel-scan Riccati;
- derivatives: one forward-mode pass over all lanes and stages at once
  (Gauss-Newton from the residual form of the stage cost), or the full
  Hessian by ``torch.func``;
- forward pass: the closed-loop rollout under a fan of line-search step
  sizes, the fan folded into the lane axis;
- state constraints: augmented-Lagrangian penalties folded into each stage
  cost (AL-iLQR), with the outer multiplier/penalty loop of
  solver/alm.py's semantics; the input box is clamped in the rollouts.

Every function takes a leading lane axis B: ``f_d(x (P, n), u (P, m), p)``,
``stage_cost(x_next, u, param) -> (P,)``, ``stage_residuals(x_next, u,
param) -> (P, k)``, where P is any number of points sharing ``param``'s
road and vehicle parameters. The reference's ``lax.while_loop`` under
``vmap`` becomes a host loop with one all-lanes-done check per masked
iteration; every body update, ``iters += 1`` included, is applied
only to lanes whose loop condition holds, as the batched while-loop freezes
the others. An iteration never waits for the card: selects are
``torch.where``, solves ``torch.linalg.solve_ex`` unchecked.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from mpc_tpu_torch.config import AlmConfig, IlqrConfig
from mpc_tpu_torch.solver.alm import AlmResult
from mpc_tpu_torch.solver.lqr import (lqt_solve_parallel,
                                      lqt_solve_sequential)
from mpc_tpu_torch.solver.panoc import _where, any_lane
from mpc_tpu_torch.solver.problem import Box, project

def _assert_stage_uniform(v, n_horiz: int, width: int, name: str) -> None:
    """The iLQR family folds boxes and bounds per stage from stage 0's row;
    per-stage values would be mis-applied silently, so they are rejected
    when the solver is built (mpc_tpu/solver/ilqr.py:87-97)."""
    arr = np.asarray(torch.as_tensor(v).detach().cpu()).reshape(
        n_horiz, width)
    if not (np.all(arr == arr[0]) or np.all(np.isnan(arr))):
        raise ValueError(
            f"{name}: the iLQR solver family requires stage-uniform bounds "
            f"(all {n_horiz} stages identical); got per-stage values. Use "
            f"the ALM+PANOC family (solver/alm.py) for per-stage boxes.")


class IlqrTrace(NamedTuple):
    """Per-iteration history (``IlqrConfig.trace=True``): (B, max_iter)
    buffers; entries past ``iterations`` stay NaN."""
    cost: torch.Tensor       # accepted cost after each iteration
    grad_norm: torch.Tensor  # max|ko| stationarity proxy
    reg: torch.Tensor        # regularisation entering the iteration
    alpha: torch.Tensor      # chosen step size (NaN if rejected)


class IlqrResult(NamedTuple):
    us: torch.Tensor          # (B, N * m) optimal input sequence
    xs: torch.Tensor          # (B, N+1, n) its trajectory
    cost: torch.Tensor        # (B,)
    converged: torch.Tensor   # (B,) bool
    iterations: torch.Tensor  # (B,) int32
    grad_norm: torch.Tensor   # (B,)
    trace: Any = None         # IlqrTrace when cfg.trace


class IlqrPhases(NamedTuple):
    """The phases of one inner iteration on the lanes of one ``prepare``,
    each callable alone; ``iterate(st)`` is ``where(cond(st), accept(st,
    gnorm, *forward(st.xs, st.us, Ks, kos)), st)`` with ``Ks, kos, gnorm =
    lqt_solve(derivatives(st.xs, st.us), st.reg)``."""
    #: ``us (B, N, m) -> (xs (B, N+1, n), cost (B,))``: the clamped rollout
    rollout: Callable
    #: ``(xs, us) -> (A, B, Q, q, R, r, P)``, each (B, N, ...)
    derivatives: Callable
    #: ``(derivatives' output, reg (B,), parallel=None) -> (Ks, kos,
    #: max|ko|)``: the Riccati backward pass
    lqt_solve: Callable
    #: ``(xs, us, Ks, kos) -> (xs (B, a, N+1, n), us (B, a, N, m), cost
    #: (B, a))``: the closed-loop rollout under each of the a step sizes
    forward: Callable
    #: ``(st, max|ko|, *forward's output) -> state``: the step size's pick
    accept: Callable


class _State(NamedTuple):
    us: torch.Tensor          # (B, N, m)
    xs: torch.Tensor          # (B, N+1, n)
    cost: torch.Tensor
    reg: torch.Tensor
    iters: torch.Tensor
    converged: torch.Tensor
    grad_norm: torch.Tensor
    trace: Any = None


def _fold(t: Optional[torch.Tensor], k: int) -> Optional[torch.Tensor]:
    """Repeat each lane's row ``k`` times in a row: (B, ...) -> (B*k, ...)."""
    if t is None:
        return None
    return t[:, None].expand(t.shape[0], k, *t.shape[1:]).reshape(
        t.shape[0] * k, *t.shape[1:])


def _nan_trace(B: int, max_iter: int, dtype, device) -> IlqrTrace:
    return IlqrTrace(*(torch.full((B, max_iter), float("nan"), dtype=dtype,
                                  device=device)
                       for _ in IlqrTrace._fields))


def _trace_set(buf: torch.Tensor, k: torch.Tensor,
               val: torch.Tensor) -> torch.Tensor:
    """``buf[lane, k[lane]] = val[lane]`` out of place (k is clamped into the
    buffer; lanes past the end are dropped by the caller's select)."""
    k = torch.clamp(k.long(), max=buf.shape[1] - 1)
    return buf.scatter(1, k[:, None], val[:, None].to(buf.dtype))


def make_ilqr_solver(f_d: Callable, stage_cost: Callable, n_horiz: int,
                     state_dim: int, input_dim: int,
                     u_box: Optional[Box] = None,
                     cfg: IlqrConfig = IlqrConfig(),
                     stage_residuals: Optional[Callable] = None,
                     lqt: Optional[Callable] = None,
                     group=None) -> Callable:
    """Build ``solve(us0 (B, N*m), param, al_args=None, skip=None) ->
    IlqrResult`` (mpc_tpu/solver/ilqr.py:145-358).

    ``param`` holds ``y0`` (B, n) and whatever ``f_d`` and the stage cost
    read (``p``, ``centerline``). ``al_args``, when given, is
    ``(lam, sigma, stage_al[, stage_al_res])`` with lam, sigma (B, N*n_c)
    and ``stage_al(x_next, u, param, lam_k, sigma_k) -> (P,)`` added to every
    stage cost, ``stage_al_res`` its residual form. ``skip`` (B,) bool marks
    lanes that exit converged before iteration 0 with their inputs as given.
    With ``stage_residuals`` and ``cfg.gauss_newton`` the backward pass takes
    Gauss-Newton curvature and the stage cost is ``sum(residuals**2)``.

    ``solve.prepare(us0, param, al_args=None, skip=None)`` returns
    ``(state, iterate, cond, result)``: the solve's initial state, one
    masked iteration, the per-lane loop condition and the state's
    ``IlqrResult``; ``solve`` is the loop ``while cond(state).any(): state =
    iterate(state)``. ``iterate.phases`` is the iteration's
    :class:`IlqrPhases`, each callable alone.

    The horizon-sharded solver (``parallel/ilqr_sharded.py``) passes its
    backward pass as ``lqt``, the LQT solve of :mod:`solver.lqr`'s
    interface that replaces the one ``cfg.parallel_backward`` chooses, and
    ``group``, the ranks that hold the same lanes, over which the
    all-lanes-done test is reduced (``solver/panoc.py:any_lane``).
    """
    if lqt is None:
        lqt = lqt_solve_parallel if cfg.parallel_backward else \
            lqt_solve_sequential
    if u_box is not None:
        _assert_stage_uniform(u_box.lower, n_horiz, input_dim, "u_box.lower")
        _assert_stage_uniform(u_box.upper, n_horiz, input_dim, "u_box.upper")
        lo, hi = u_box.lower[:input_dim], u_box.upper[:input_dim]
    alphas_host = torch.tensor(cfg.alphas, dtype=torch.float32)
    n_alpha = len(cfg.alphas)
    N, n, m = n_horiz, state_dim, input_dim

    def clamp(u):
        return u if u_box is None else torch.clamp(u, min=lo, max=hi)

    def prepare(us0: torch.Tensor, param: Any, al_args=None, skip=None):
        dtype, device = us0.dtype, us0.device
        Bsz = us0.shape[0]
        us0 = us0.reshape(Bsz, N, m)
        p, y0 = param["p"], param["y0"]

        lam = sigma = stage_al = stage_al_res = None
        if al_args is not None:
            lam, sigma, stage_al, *rest = al_args
            stage_al_res = rest[0] if rest else None
            lam = lam.reshape(Bsz, N, -1)
            sigma = sigma.reshape(Bsz, N, -1)
        use_gn = (cfg.gauss_newton and stage_residuals is not None
                  and (al_args is None or stage_al_res is not None))

        def residuals(xn, u, lam_k, sigma_k):
            r = stage_residuals(xn, u, param)
            if stage_al_res is not None:
                r = torch.cat([r, stage_al_res(xn, u, param, lam_k, sigma_k)],
                              dim=1)
            return r

        def stage_l(xn, u, lam_k, sigma_k):
            """The stage cost of points whose next state ``xn`` is known."""
            if use_gn:
                return (residuals(xn, u, lam_k, sigma_k) ** 2).sum(dim=1)
            l = stage_cost(xn, u, param)
            if al_args is not None:
                l = l + stage_al(xn, u, param, lam_k, sigma_k)
            return l

        def stage(t, k):
            return None if t is None else t[:, k]

        def rollout(us):
            x, xs, ls = y0, [y0], []
            for k in range(N):
                u = clamp(us[:, k])
                x = f_d(x, u, p)
                xs.append(x)
                ls.append(stage_l(x, u, stage(lam, k), stage(sigma, k)))
            return torch.stack(xs, 1), torch.stack(ls, 1).sum(dim=1)

        def derivatives(xs, us):
            """Per-stage (A, B, Q, q, R, r, P), (Bsz, N, ...), from one pass
            over all Bsz * N points."""
            P = Bsz * N
            X, U = xs[:, :-1].reshape(P, n), us.reshape(P, m)
            lamP = None if lam is None else lam.reshape(P, -1)
            sigP = None if sigma is None else sigma.reshape(P, -1)
            nt = n + m
            if use_gn:
                # Forward mode over replicated points: replica j of every
                # point carries the tangent e_j of (x, u), so one pass gives
                # the dynamics' and the residuals' Jacobians (jax.jacfwd
                # over (x, u)). The nearest-point index is an argmin: it
                # carries no tangent, as under jax.jacfwd.
                eye = torch.eye(nt, dtype=dtype, device=device)
                tang = eye[:, None].expand(nt, P, nt).reshape(nt * P, nt)

                def rep(t):
                    return None if t is None else \
                        t[None].expand(nt, *t.shape).reshape(nt * P,
                                                             *t.shape[1:])

                lamR, sigR = rep(lamP), rep(sigP)

                def fr(x, u):
                    xn = f_d(x, u, p)
                    return xn, residuals(xn, u, lamR, sigR)

                (_, r), (dxn, dr) = torch.func.jvp(
                    fr, (rep(X), rep(U)), (tang[:, :n], tang[:, n:]))
                Jf = dxn.reshape(nt, P, n).permute(1, 2, 0)   # (P, n, nt)
                Jr = dr.reshape(nt, P, -1).permute(1, 2, 0)   # (P, k, nt)
                r = r[:P]
                A, Bm = Jf[..., :n], Jf[..., n:]
                Jx, Ju = Jr[..., :n], Jr[..., n:]
                JxT, JuT = Jx.transpose(1, 2), Ju.transpose(1, 2)
                out = (A, Bm, 2.0 * JxT @ Jx, 2.0 * (JxT @ r[..., None])[..., 0],
                       2.0 * JuT @ Ju, 2.0 * (JuT @ r[..., None])[..., 0],
                       2.0 * JuT @ Jx)
            else:
                # The full second-order path, one point per vmap lane.
                def one(fn):
                    def g(x, u, lam_k, sigma_k):
                        return fn(x[None], u[None],
                                  None if lam_k is None else lam_k[None],
                                  None if sigma_k is None else sigma_k[None])
                    return g

                def f1(x, u, lam_k, sigma_k):
                    return f_d(x, u, p)[0]

                def l1(x, u, lam_k, sigma_k):
                    return stage_l(f_d(x, u, p), u, lam_k, sigma_k)[0]

                dims = (0, 0, None if lamP is None else 0,
                        None if sigP is None else 0)
                vm = torch.func.vmap
                A, Bm = vm(torch.func.jacfwd(one(f1), argnums=(0, 1)),
                           in_dims=dims)(X, U, lamP, sigP)
                lx, lu = vm(torch.func.grad(one(l1), argnums=(0, 1)),
                            in_dims=dims)(X, U, lamP, sigP)
                (lxx, lxu), (lux, luu) = vm(
                    torch.func.hessian(one(l1), argnums=(0, 1)),
                    in_dims=dims)(X, U, lamP, sigP)
                out = (A, Bm, lxx, lx, luu, lu, lux)
            return tuple(t.reshape(Bsz, N, *t.shape[1:]) for t in out)

        def lqt_solve(derivs, reg, parallel=None):
            """The LQT solve of the linearised problem from
            ``derivatives``' output: ``(Ks, kos, max|ko|)``. ``parallel``
            None is the solver's own solve; True or False the parallel or
            the sequential Riccati of solver/lqr.py."""
            A, Bm, Q, q, R, r, Pc = derivs
            Rr = R + reg[:, None, None, None] * torch.eye(
                m, dtype=dtype, device=device)
            zn = torch.zeros((Bsz, n), dtype=dtype, device=device)
            solve_lqt = lqt if parallel is None else \
                lqt_solve_parallel if parallel else lqt_solve_sequential
            sol = solve_lqt(zn, A, Bm, torch.zeros_like(q), Q, q, Rr, r,
                            torch.zeros_like(Q[:, 0]), zn, P=Pc)
            # deviation-space policy du = -Ko dx - ko; max|ko| is the
            # stationarity proxy
            return sol.Ko, sol.ko, sol.ko.abs().amax(dim=(1, 2))

        alphas = alphas_host.to(device=device, dtype=dtype)

        def forward(xs, us, Ks, kos):
            """The closed-loop rollout under every step size at once, the
            fan folded into the lane axis: (Bsz, n_alpha, ...)."""
            a = alphas.repeat(Bsz)[:, None]
            xs_r, us_r, Ks_r, kos_r = (_fold(t, n_alpha)
                                       for t in (xs, us, Ks, kos))
            lam_r, sig_r = _fold(lam, n_alpha), _fold(sigma, n_alpha)
            x = xs_r[:, 0]
            xs_n, us_n, ls = [x], [], []
            for k in range(N):
                dx = x - xs_r[:, k]
                u = clamp(us_r[:, k] - a * kos_r[:, k]
                          - (Ks_r[:, k] @ dx[..., None])[..., 0])
                x = f_d(x, u, p)
                xs_n.append(x)
                us_n.append(u)
                ls.append(stage_l(x, u, stage(lam_r, k), stage(sig_r, k)))
            return (torch.stack(xs_n, 1).reshape(Bsz, n_alpha, N + 1, n),
                    torch.stack(us_n, 1).reshape(Bsz, n_alpha, N, m),
                    torch.stack(ls, 1).sum(dim=1).reshape(Bsz, n_alpha))

        xs0, cost0 = rollout(us0)
        skip_ = torch.zeros((Bsz,), dtype=torch.bool, device=device) \
            if skip is None else skip.expand(Bsz)
        tr0 = _nan_trace(Bsz, cfg.max_iter, dtype, device) if cfg.trace \
            else None
        st0 = _State(
            us=torch.where(skip_[:, None, None], us0, clamp(us0)), xs=xs0,
            cost=cost0,
            reg=torch.full((Bsz,), cfg.reg_init, dtype=dtype, device=device),
            iters=torch.zeros((Bsz,), dtype=torch.int32, device=device),
            converged=skip_,
            grad_norm=torch.full((Bsz,), float("inf"), dtype=dtype,
                                 device=device),
            trace=tr0)
        lanes = torch.arange(Bsz, device=device)

        def cond(st: _State) -> torch.Tensor:
            return (~st.converged) & (st.iters < cfg.max_iter) \
                & (st.reg < cfg.reg_max)

        def accept(st: _State, gnorm, xs_f, us_f, costs) -> _State:
            """The line search's pick, the regularisation update and the
            exit tests: the state after the iteration, on every lane."""
            costs = torch.where(torch.isnan(costs),
                                torch.full_like(costs, float("inf")), costs)
            best = torch.argmin(costs, dim=1)     # the first minimum
            c_best = costs[lanes, best]
            improved = c_best < st.cost - 1e-12
            dcost = st.cost - c_best
            rel = torch.abs(dcost) / (torch.abs(st.cost) + 1e-12)
            # a stall (no candidate improves, the best matches the cost) is
            # convergence at a box-saturated optimum; every exit is gated on
            # a moderate regularisation (mpc_tpu/solver/ilqr.py:319-330)
            stalled = (~improved) & (rel < cfg.tol_stall)
            reg_ok = st.reg <= cfg.reg_conv_max
            conv = ((improved & (rel < cfg.tol_dcost))
                    | (gnorm <= cfg.tol_grad) | stalled) & reg_ok
            st_acc = st._replace(
                us=us_f[lanes, best], xs=xs_f[lanes, best], cost=c_best,
                reg=torch.clamp(st.reg * cfg.reg_down, min=cfg.reg_min),
                converged=conv, grad_norm=gnorm)
            st_rej = st._replace(reg=st.reg * cfg.reg_up, converged=conv,
                                 grad_norm=gnorm)
            st_new = _where(improved, st_acc, st_rej)
            if cfg.trace:
                tr, k = st.trace, st.iters
                st_new = st_new._replace(trace=IlqrTrace(
                    cost=_trace_set(tr.cost, k, st_new.cost),
                    grad_norm=_trace_set(tr.grad_norm, k, gnorm),
                    reg=_trace_set(tr.reg, k, st.reg),
                    alpha=_trace_set(tr.alpha, k, torch.where(
                        improved, alphas[best],
                        torch.full_like(c_best, float("nan"))))))
            return st_new._replace(iters=st.iters + 1)

        def body(st: _State) -> _State:
            Ks, kos, gnorm = lqt_solve(derivatives(st.xs, st.us), st.reg)
            return accept(st, gnorm, *forward(st.xs, st.us, Ks, kos))

        def iterate(st: _State) -> _State:
            return _where(cond(st), body(st), st)

        iterate.phases = IlqrPhases(rollout, derivatives, lqt_solve, forward,
                                    accept)

        def result(st: _State) -> IlqrResult:
            return IlqrResult(us=st.us.reshape(Bsz, N * m), xs=st.xs,
                              cost=st.cost, converged=st.converged,
                              iterations=st.iters, grad_norm=st.grad_norm,
                              trace=st.trace)

        return st0, iterate, cond, result

    def solve(us0: torch.Tensor, param: Any, al_args=None,
              skip=None) -> IlqrResult:
        st, iterate, cond, result = prepare(us0, param, al_args, skip)
        # one all-lanes-done check per iteration: an iteration issues tens of
        # thousands of kernels, so the check costs nothing beside it, while
        # an extra masked iteration would cost a whole one
        while any_lane(cond(st), group):
            st = iterate(st)
        return result(st)

    solve.prepare = prepare
    return solve


# ---------------------------------------------------------------------------
# AL-iLQR: the augmented-Lagrangian outer loop around the iLQR inner solver
# ---------------------------------------------------------------------------

class _OuterState(NamedTuple):
    u: torch.Tensor
    lam: torch.Tensor
    sigma: torch.Tensor
    e_prev: torch.Tensor
    psi: torch.Tensor
    outer: torch.Tensor
    inner_total: torch.Tensor
    failures: torch.Tensor
    converged: torch.Tensor
    violation: torch.Tensor
    inner_trace: Any = None   # IlqrTrace of the last inner solve


def _skip_lanes(tol, B: int, dtype, device) -> Optional[torch.Tensor]:
    """``tol > 1e30`` per lane: the lane-skip sentinel (the solver/alm.py
    contract, used by event-triggered MPC)."""
    if tol is None:
        return None
    return torch.as_tensor(tol, dtype=dtype, device=device).expand(B) > 1e30


def make_al_ilqr_solver(f_d: Callable, stage_cost: Callable, n_horiz: int,
                        state_dim: int, input_dim: int, u_box: Box,
                        stage_constraints: Optional[Callable] = None,
                        n_stage_constraints: int = 0,
                        D: Optional[Box] = None,
                        alm_cfg: Optional[AlmConfig] = None,
                        ilqr_cfg: IlqrConfig = IlqrConfig(),
                        stage_residuals: Optional[Callable] = None,
                        lqt: Optional[Callable] = None,
                        group=None) -> Callable:
    """Build ``solve(param, u0 (B, N*m), lam0 (B, M), tol=None, sigma0=None,
    gamma0=None) -> AlmResult`` (mpc_tpu/solver/ilqr.py:365-550), a
    drop-in for solver/alm.py's solver that ``MpcController`` drives
    unchanged. ``gamma`` is 0 on every lane (iLQR has no step size to
    carry).

    ``solve.prepare_inner(param, u0, lam, sigma)`` is the inner solver's
    ``prepare`` with the stage AL terms folded in (see
    :func:`make_ilqr_solver`). ``lqt`` and ``group`` are
    :func:`make_ilqr_solver`'s; the outer loop's test is reduced over
    ``group`` too.
    """
    if alm_cfg is None:
        alm_cfg = AlmConfig()
    has_general = stage_constraints is not None and n_stage_constraints > 0 \
        and D is not None and D.is_bounded
    nc = n_stage_constraints

    if not has_general:
        inner = make_ilqr_solver(f_d, stage_cost, n_horiz, state_dim,
                                 input_dim, u_box=u_box, cfg=ilqr_cfg,
                                 stage_residuals=stage_residuals, lqt=lqt,
                                 group=group)

        def solve(param, u0, lam0, tol=None, sigma0=None, gamma0=None):
            dtype, device = u0.dtype, u0.device
            B = u0.shape[0]
            res = inner(u0, param, skip=_skip_lanes(tol, B, dtype, device))
            sigma = sigma0 if sigma0 is not None else \
                torch.zeros((B, 0), dtype=dtype, device=device)
            zero = torch.zeros((B,), dtype=dtype, device=device)
            return AlmResult(
                u=res.us, lam=lam0, psi=res.cost, converged=res.converged,
                outer_iterations=(res.iterations > 0).to(torch.int32),
                inner_iterations=res.iterations,
                constraint_violation=zero,
                inner_convergence_failures=(~res.converged).to(torch.int32),
                sigma=sigma, gamma=zero, inner_trace=res.trace)

        solve.prepare_inner = lambda param, u0, lam, sigma: \
            inner.prepare(u0, param)
        return solve

    # Stage AL term: the shifted quadratic penalty of g(x_next) in D, one row
    # of (lam, sigma) per stage; stage 0's bounds serve every stage.
    _assert_stage_uniform(D.lower, n_horiz, nc, "D.lower")
    _assert_stage_uniform(D.upper, n_horiz, nc, "D.upper")
    D_lo = D.lower.reshape(n_horiz, nc)[0]
    D_hi = D.upper.reshape(n_horiz, nc)[0]
    m = nc * n_horiz
    sigma_cold = torch.as_tensor(alm_cfg.sigma_0, dtype=torch.float32,
                                 device=D.lower.device).expand(m)

    def stage_al(xn, u, param, lam_k, sigma_k):
        g = stage_constraints(xn, u, param)
        zeta = g + lam_k / sigma_k
        zhat = torch.clamp(zeta, min=D_lo, max=D_hi)
        return 0.5 * (sigma_k * (zeta - zhat) ** 2).sum(dim=1)

    def stage_al_res(xn, u, param, lam_k, sigma_k):
        # stage_al == sum(res**2); the clip is piecewise linear, so the GN
        # Jacobian is exact on its active and inactive pieces
        g = stage_constraints(xn, u, param)
        zeta = g + lam_k / sigma_k
        zhat = torch.clamp(zeta, min=D_lo, max=D_hi)
        return torch.sqrt(0.5 * sigma_k) * (zeta - zhat)

    inner = make_ilqr_solver(f_d, stage_cost, n_horiz, state_dim, input_dim,
                             u_box=u_box, cfg=ilqr_cfg,
                             stage_residuals=stage_residuals, lqt=lqt,
                             group=group)

    def constraints_from_traj(xs, us_flat, param):
        """g on the inner solve's accepted trajectory; stage k's constraint
        sees x_{k+1}."""
        B = xs.shape[0]
        g = stage_constraints(xs[:, 1:].reshape(B * n_horiz, state_dim),
                              us_flat.reshape(B * n_horiz, input_dim), param)
        return g.reshape(B, m)

    def solve(param, u0, lam0, tol=None, sigma0=None, gamma0=None):
        dtype, device = u0.dtype, u0.device
        B = u0.shape[0]
        skip = _skip_lanes(tol, B, dtype, device)
        if skip is None:
            skip = torch.zeros((B,), dtype=torch.bool, device=device)
        cold = sigma_cold.to(dtype).expand(B, m)
        if sigma0 is None:
            sigma_in = torch.zeros((B, m), dtype=dtype, device=device)
            sigma_init = cold
        else:
            # warm lanes (every carried penalty > 0) keep theirs, capped at
            # sigma_0; the others start from sigma_0
            sigma_in = sigma0.to(dtype)
            warm = (sigma_in > 0).all(dim=1)
            sigma_init = torch.where(
                warm[:, None],
                torch.minimum(torch.clamp(sigma_in, min=1e-12), cold), cold)
        izero = torch.zeros((B,), dtype=torch.int32, device=device)
        itr0 = _nan_trace(B, ilqr_cfg.max_iter, dtype, device) \
            if ilqr_cfg.trace else None
        st = _OuterState(
            u=u0, lam=lam0.to(dtype), sigma=sigma_init,
            e_prev=torch.full((B, m), float("inf"), dtype=dtype,
                              device=device),
            psi=torch.zeros((B,), dtype=dtype, device=device),
            outer=izero, inner_total=izero, failures=izero, converged=skip,
            violation=torch.full((B,), float("inf"), dtype=dtype,
                                 device=device),
            inner_trace=itr0)

        def cond(st):
            return (~st.converged) & (st.outer < alm_cfg.max_iter)

        while any_lane(active := cond(st), group):
            # lanes already done skip the inner solve; its result for them
            # is dropped by the select below
            res = inner(st.u, param,
                        al_args=(st.lam, st.sigma, stage_al, stage_al_res),
                        skip=~active)
            g = constraints_from_traj(res.xs, res.us, param)
            zeta = g + st.lam / st.sigma
            zhat = project(zeta, D)
            e = g - zhat
            viol = e.abs().amax(dim=1)
            lam_new = torch.clamp(st.sigma * (zeta - zhat), -alm_cfg.lam_max,
                                  alm_cfg.lam_max)
            need_more = (e.abs() > alm_cfg.delta) \
                & (e.abs() > alm_cfg.theta * st.e_prev.abs())
            sigma_new = torch.where(
                need_more,
                torch.clamp(st.sigma * alm_cfg.penalty_factor,
                            max=alm_cfg.sigma_max),
                st.sigma)
            done = res.converged & (viol <= alm_cfg.delta)
            st_new = _OuterState(
                u=res.us, lam=lam_new, sigma=sigma_new, e_prev=e.abs(),
                psi=res.cost, outer=st.outer + 1,
                inner_total=st.inner_total + res.iterations,
                failures=st.failures + (~res.converged).to(torch.int32),
                converged=done, violation=viol,
                inner_trace=res.trace if ilqr_cfg.trace else None)
            st = _where(active, st_new, st)

        # a skipped lane never solved: it hands back its raw incoming sigma,
        # so that a cold (sigma = 0) lane stays cold for its next solve
        return AlmResult(
            u=st.u, lam=st.lam, psi=st.psi, converged=st.converged,
            outer_iterations=st.outer, inner_iterations=st.inner_total,
            constraint_violation=st.violation,
            inner_convergence_failures=st.failures,
            sigma=torch.where(skip[:, None], sigma_in, st.sigma),
            gamma=torch.zeros((B,), dtype=dtype, device=device),
            inner_trace=st.inner_trace)

    def prepare_inner(param, u0, lam, sigma):
        return inner.prepare(u0, param,
                             al_args=(lam, sigma, stage_al, stage_al_res))

    solve.prepare_inner = prepare_inner
    return solve
