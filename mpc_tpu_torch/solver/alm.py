"""Augmented-Lagrangian (ALM) solver, lane-batched (port of
mpc_tpu/solver/alm.py).

General constraints ``g(u) in D`` are handled by a shifted-penalty
augmented Lagrangian; PANOC minimises each subproblem over the box C:

    zeta  = g(u) + lam / Sigma
    zhat  = Pi_D(zeta)
    psi   = f(u) + 1/2 sum_i Sigma_i (zeta_i - zhat_i)^2
    lam+  = Sigma * (zeta - zhat)            (multiplier update)
    e     = g(u) - zhat                      (constraint violation)

When D is unbounded (the vehicle OCP leaves it so unless the state
constraints are bounded) the AL term vanishes and the solver reduces, at
build time, to one full-tolerance PANOC solve (the fast path,
mpc_tpu/solver/alm.py:98-133).

The general path (mpc_tpu/solver/alm.py:135-311): the reference's
``lax.while_loop`` over outer iterations becomes a host loop with one
all-lanes-done check per outer iteration. Under ``jax.vmap`` a lane whose
loop condition is False is frozen, so every outer-body update here is
applied only where ``~converged & outer < max_iter`` holds; a lane that is
already done gets ``tol = +inf`` for the inner solve, whose result it
discards.
"""

from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple, Optional

import torch

from mpc_tpu_torch.config import AlmConfig, PanocConfig
from mpc_tpu_torch.solver.panoc import (PanocTrace, SolveStats, _where,
                                        any_lane, make_panoc_solver)
from mpc_tpu_torch.solver.problem import Problem, project, value_and_grad
from mpc_tpu_torch.utils.timing import span


class AlmTrace(NamedTuple):
    """Per-outer-iteration history (``AlmConfig.trace=True``): (B, max_iter)
    buffers; entries past ``outer_iterations`` stay NaN."""
    psi: torch.Tensor          # AL objective after each inner solve
    violation: torch.Tensor    # ||e||_inf
    eps_k: torch.Tensor        # inner tolerance used
    sigma_max: torch.Tensor    # max penalty
    inner_iters: torch.Tensor  # PANOC iterations spent


class AlmResult(NamedTuple):
    u: torch.Tensor                           # (B, n)
    lam: torch.Tensor                         # (B, m)
    psi: torch.Tensor                         # (B,)
    converged: torch.Tensor                   # (B,) bool
    outer_iterations: torch.Tensor            # (B,) int32
    inner_iterations: torch.Tensor            # (B,) int32, all outer iterations
    constraint_violation: torch.Tensor        # (B,) final ||e||_inf
    inner_convergence_failures: torch.Tensor  # (B,) int32
    sigma: torch.Tensor                       # (B, m) warm-start carry
    gamma: torch.Tensor                       # (B,) warm-start carry
    trace: Any = None                         # AlmTrace when alm_cfg.trace
    inner_trace: Any = None                   # PanocTrace of the last solve
    stats: Optional[SolveStats] = None        # trips, waits of every solve
    # each lane's last inner solve: its step size and the multipliers and
    # penalties it minimised under (``lam`` and ``sigma`` are the updated
    # ones, and the carry's ``gamma`` is reset to 0 on the general path)
    inner_gamma: Optional[torch.Tensor] = None    # (B,)
    inner_lam: Optional[torch.Tensor] = None      # (B, m)
    inner_sigma: Optional[torch.Tensor] = None    # (B, m)


class _OuterState(NamedTuple):
    u: torch.Tensor
    lam: torch.Tensor
    sigma: torch.Tensor
    gamma: torch.Tensor
    eps_k: torch.Tensor
    e_prev: torch.Tensor
    psi: torch.Tensor
    outer: torch.Tensor
    inner_total: torch.Tensor
    failures: torch.Tensor
    converged: torch.Tensor
    violation: torch.Tensor
    inner_gamma: torch.Tensor
    inner_lam: torch.Tensor
    inner_sigma: torch.Tensor
    trace: Any = None
    inner_trace: Any = None


def make_alm_solver(problem: Problem, alm_cfg: AlmConfig = AlmConfig(),
                    panoc_cfg: PanocConfig = PanocConfig(),
                    group=None) -> Callable:
    """Build ``solve(param, u0 (B, n), lam0 (B, m), tol=None, sigma0=None,
    gamma0=None) -> AlmResult`` over a batch of lanes. ``group`` is
    :func:`make_panoc_solver`'s (a sharded solve's model axis); the outer
    loop's all-lanes-done test is reduced over it too. ``solve.fan_graph``
    is PANOC's."""
    has_general = problem.constraints is not None and problem.m > 0 \
        and problem.D.is_bounded
    if not has_general:
        return _make_fast_path(problem, alm_cfg, panoc_cfg, group)
    return _make_general_path(problem, alm_cfg, panoc_cfg, group)


def _make_fast_path(problem, alm_cfg, panoc_cfg, group):
    """No bounded general constraint: one full-tolerance PANOC solve."""
    def psi_vg(u, args):
        return value_and_grad(problem.cost, u, args)

    panoc = make_panoc_solver(psi_vg, problem.C, panoc_cfg,
                              psi_vg_multi=problem.cost_multi, group=group)

    def solve(param, u0, lam0, tol=None, sigma0=None, gamma0=None):
        with span("alm.solve"):
            return _solve(param, u0, lam0, tol, sigma0, gamma0)

    def _solve(param, u0, lam0, tol, sigma0, gamma0):
        # ``tol`` overrides the configured tolerance per call; +inf makes a
        # lane converge at iteration 0.
        if tol is None:
            tol = alm_cfg.eps
        if problem.param_prep is not None:
            param = problem.param_prep(param)
        res = panoc(u0, tol, param, gamma_init=gamma0)
        B = u0.shape[0]
        sigma = sigma0 if sigma0 is not None else \
            torch.zeros((B, problem.m), dtype=u0.dtype, device=u0.device)
        return AlmResult(
            u=res.u, lam=lam0, psi=res.psi, converged=res.converged,
            outer_iterations=torch.ones((B,), dtype=torch.int32,
                                        device=u0.device),
            inner_iterations=res.iterations,
            constraint_violation=torch.zeros((B,), dtype=u0.dtype,
                                             device=u0.device),
            inner_convergence_failures=(~res.converged).to(torch.int32),
            sigma=sigma, gamma=res.gamma, inner_trace=res.trace,
            stats=res.stats._replace(outer_passes=1),
            inner_gamma=res.gamma, inner_lam=lam0, inner_sigma=sigma)

    solve.fan_graph = panoc.fan_graph
    return solve


def _make_general_path(problem, alm_cfg, panoc_cfg, group):
    """The outer multiplier/penalty loop (mpc_tpu/solver/alm.py:135-311)."""
    m, D = problem.m, problem.D

    def al_terms(g, lam, sigma):
        """``(zeta - zhat, g - zhat)`` of constraint values ``g``: the AL
        residual and the violation."""
        zhat = project(g + lam / sigma, D)
        return g + lam / sigma - zhat, g - zhat

    # the AL objective takes cost and constraints from one rollout where the
    # problem gives both (mpc_tpu/solver/alm.py:136-146 leaves that to XLA)
    if problem.cost_constraints is not None:
        cost_constraints = problem.cost_constraints
    else:
        def cost_constraints(u, param):
            return problem.cost(u, param), problem.constraints(u, param)

    def psi_vg(u, args):
        param, lam, sigma = args

        def psi(u_, param):
            f, g = cost_constraints(u_, param)
            r, _ = al_terms(g, lam, sigma)
            return f + 0.5 * (sigma * r ** 2).sum(dim=1)

        return value_and_grad(psi, u, param)

    psi_vg_multi = None
    if problem.al_multi is not None:
        def psi_vg_multi(cands, args):
            return problem.al_multi(cands, *args)

    panoc = make_panoc_solver(psi_vg, problem.C, panoc_cfg,
                              psi_vg_multi=psi_vg_multi, group=group)
    sigma_0 = torch.as_tensor(alm_cfg.sigma_0, dtype=torch.float32)
    if sigma_0.dim() > 1 or sigma_0.numel() not in (1, m):
        raise ValueError(f"AlmConfig.sigma_0 must be a scalar or have {m} "
                         f"entries, got shape {tuple(sigma_0.shape)}")

    def solve(param, u0, lam0, tol=None, sigma0=None, gamma0=None):
        with span("alm.solve"):
            return _solve(param, u0, lam0, tol, sigma0, gamma0)

    def _solve(param, u0, lam0, tol, sigma0, gamma0):
        t_entry = time.perf_counter()
        dtype, device = u0.dtype, u0.device
        B = u0.shape[0]
        if problem.param_prep is not None:
            param = problem.param_prep(param)
        if tol is None:
            tol = alm_cfg.eps
        # tol only marks skipped lanes (> 1e30): they exit before the first
        # outer iteration, keeping their incoming sigma and gamma
        skip = torch.as_tensor(tol, dtype=dtype, device=device).expand(B) \
            > 1e30
        # Warm lanes (every carried penalty > 0) start at the final
        # tolerance with their penalties capped at sigma_0; cold lanes run
        # the eps_0 -> eps homotopy from sigma_0 (mpc_tpu/solver/alm.py:162-190).
        if sigma0 is None:
            warm = torch.zeros((B,), dtype=torch.bool, device=device)
            sigma_in = torch.zeros((B, m), dtype=dtype, device=device)
        else:
            sigma_in = sigma0.to(dtype)
            warm = (sigma_in > 0).all(dim=1)
        sigma_cold = sigma_0.to(dtype=dtype, device=device).expand(m)
        sigma_init = torch.where(
            warm[:, None],
            torch.minimum(torch.clamp(sigma_in, min=1e-12), sigma_cold),
            sigma_cold)
        gamma_in = gamma0.to(dtype) if gamma0 is not None else \
            torch.zeros((B,), dtype=dtype, device=device)
        zero = torch.zeros((B,), dtype=dtype, device=device)
        izero = torch.zeros((B,), dtype=torch.int32, device=device)
        tr0 = itr0 = None
        if alm_cfg.trace:
            nanbuf = torch.full((B, alm_cfg.max_iter), float("nan"),
                                dtype=dtype, device=device)
            tr0 = AlmTrace(*(nanbuf.clone() for _ in AlmTrace._fields))
        if panoc_cfg.trace:
            inanbuf = torch.full((B, panoc_cfg.max_iter), float("nan"),
                                 dtype=dtype, device=device)
            itr0 = PanocTrace(*(inanbuf.clone() for _ in PanocTrace._fields))
        gamma_init = torch.where(warm, gamma_in, zero)
        st = _OuterState(
            u=u0, lam=lam0.to(dtype), sigma=sigma_init, gamma=gamma_init,
            eps_k=torch.where(warm, torch.full_like(zero, alm_cfg.eps),
                              torch.full_like(zero, alm_cfg.eps_0)),
            e_prev=torch.full((B, m), float("inf"), dtype=dtype,
                              device=device),
            psi=zero, outer=izero, inner_total=izero, failures=izero,
            converged=skip,
            violation=torch.full_like(zero, float("inf")),
            inner_gamma=gamma_init, inner_lam=lam0.to(dtype),
            inner_sigma=sigma_init, trace=tr0, inner_trace=itr0)
        lanes = torch.arange(B, device=device)

        def cond(st):
            return (~st.converged) & (st.outer < alm_cfg.max_iter)

        def _update(st, active, res):
            """The state after the inner solve ``res`` on the ``active``
            lanes."""
            r, e = al_terms(problem.constraints(res.u, param), st.lam,
                            st.sigma)
            viol = e.abs().amax(dim=1)
            # inexact ALM: lam is updated even when the inner solve hit its
            # iteration cap (mpc_tpu/solver/alm.py:233-240)
            lam_new = torch.clamp(st.sigma * r, -alm_cfg.lam_max,
                                  alm_cfg.lam_max)
            # grow sigma only on constraints still violated beyond delta
            # that did not shrink enough (mpc_tpu/solver/alm.py:242-254)
            need_more = (e.abs() > alm_cfg.delta) \
                & (e.abs() > alm_cfg.theta * st.e_prev.abs())
            sigma_new = torch.where(
                need_more,
                torch.clamp(st.sigma * alm_cfg.penalty_factor,
                            max=alm_cfg.sigma_max),
                st.sigma)
            at_final_eps = st.eps_k <= alm_cfg.eps * (1.0 + 1e-6)
            done = res.converged & at_final_eps & (viol <= alm_cfg.delta)
            eps_next = torch.clamp(st.eps_k * alm_cfg.rho_eps,
                                   min=alm_cfg.eps)

            tr = st.trace
            if alm_cfg.trace:
                k = torch.clamp(st.outer.long(), max=alm_cfg.max_iter - 1)
                bufs = []
                for buf, val in zip(tr, (res.psi, viol, st.eps_k,
                                         st.sigma.amax(dim=1),
                                         res.iterations.to(dtype))):
                    buf = buf.clone()
                    buf[lanes, k] = val
                    bufs.append(buf)
                tr = AlmTrace(*bufs)

            # the PANOC step size is not carried across outer iterations
            # (mpc_tpu/solver/alm.py:262-268): gamma resets to 0
            st_new = _OuterState(
                u=res.u, lam=lam_new, sigma=sigma_new, gamma=zero,
                eps_k=eps_next, e_prev=e.abs(), psi=res.psi,
                outer=st.outer + 1,
                inner_total=st.inner_total + res.iterations,
                failures=st.failures + (~res.converged).to(torch.int32),
                converged=done, violation=viol, inner_gamma=res.gamma,
                inner_lam=st.lam, inner_sigma=st.sigma, trace=tr,
                inner_trace=res.trace if panoc_cfg.trace else None)
            return _where(active, st_new, st)

        def outer(st, active):
            """One outer iteration on the ``active`` lanes: ``(state,
            PANOC's stats)``."""
            # lanes that are done converge at once; their result is dropped
            tol_k = torch.where(active, st.eps_k,
                                torch.full_like(st.eps_k, float("inf")))
            res = panoc(st.u, tol_k, (param, st.lam, st.sigma),
                        gamma_init=st.gamma)
            with span("alm.update"):
                return _update(st, active, res), res.stats

        # the stats: PANOC's trips and waits summed over the outer
        # iterations, with the outer loop's own all-lanes-done waits, this
        # solve's own host seconds and its passes
        trips, sync_wait_s, passes = 0, 0.0, 0
        while True:
            active = cond(st)
            t0 = time.perf_counter()
            more = any_lane(active, group)
            sync_wait_s += time.perf_counter() - t0
            if not more:
                break
            with span("alm.outer"):
                st, inner = outer(st, active)
            trips += inner.trips
            sync_wait_s += inner.sync_wait_s
            passes += 1

        return AlmResult(
            u=st.u, lam=st.lam, psi=st.psi, converged=st.converged,
            outer_iterations=st.outer, inner_iterations=st.inner_total,
            constraint_violation=st.violation,
            inner_convergence_failures=st.failures,
            sigma=torch.where(skip[:, None], sigma_in, st.sigma),
            gamma=torch.where(skip, gamma_in, st.gamma),
            trace=st.trace, inner_trace=st.inner_trace,
            stats=SolveStats(trips, time.perf_counter() - t_entry,
                             sync_wait_s, passes),
            inner_gamma=st.inner_gamma, inner_lam=st.inner_lam,
            inner_sigma=st.inner_sigma)

    solve.fan_graph = panoc.fan_graph
    return solve
