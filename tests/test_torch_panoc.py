"""Parity of the port's batched PANOC/ALM solver (mpc_tpu_torch/solver) with
the JAX package on problems with known solutions (the cases of
tests/test_solver.py:23-116): solutions, convergence flags and iteration
counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.solver.alm import make_alm_solver
from mpc_tpu.solver.problem import Box, Problem
from mpc_tpu_torch.config import AlmConfig as TAlmConfig
from mpc_tpu_torch.config import PanocConfig as TPanocConfig
from mpc_tpu_torch.solver import alm as talm
from mpc_tpu_torch.solver import panoc as tpanoc
from mpc_tpu_torch.solver import problem as tproblem

torch.set_num_threads(1)


def _port_solve(cost, lower, upper, n, param, u0, eps, memory, max_iter):
    C = tproblem.Box(torch.as_tensor(np.asarray(lower, np.float32)),
                     torch.as_tensor(np.asarray(upper, np.float32)))
    prob = tproblem.Problem(cost=cost, constraints=None, C=C,
                            D=tproblem.Box.unbounded(0), n=n, m=0)
    solve = talm.make_alm_solver(
        prob, TAlmConfig(eps=eps),
        TPanocConfig(lbfgs_memory=memory, max_iter=max_iter))
    u0 = torch.as_tensor(np.asarray(u0, np.float32))
    return solve(param, u0, torch.zeros((u0.shape[0], 0)))


def _assert_same(res_t, res_j, atol=1e-4):
    np.testing.assert_allclose(res_t.u.numpy(), np.asarray(res_j.u), atol=atol)
    np.testing.assert_array_equal(res_t.converged.numpy(),
                                  np.asarray(res_j.converged))
    np.testing.assert_array_equal(res_t.inner_iterations.numpy(),
                                  np.asarray(res_j.inner_iterations))


def _qp_cost_jax(u, t):
    return 0.5 * jnp.sum((u - t) ** 2)


def _qp_cost_torch(u, t):
    return 0.5 * ((u - t) ** 2).sum(dim=1)


@pytest.mark.parametrize("case", ["single", "batch"])
def test_box_qp_matches_jax(case):
    if case == "single":
        ts = np.array([[0.3, -2.0, 5.0, 0.9, -0.1, 1.5]], np.float32)
        eps, memory = 1e-5, 5
    else:
        ts = np.array([[0.5, 2.0, -3.0, 0.1], [-0.5, -2.0, 3.0, -0.1],
                       [0.0, 0.0, 0.0, 0.0], [10.0, -10.0, 0.2, 0.9]],
                      np.float32)
        eps, memory = 1e-5, 4
    n = ts.shape[1]
    prob = Problem(cost=_qp_cost_jax, constraints=None,
                   C=Box(-jnp.ones(n), jnp.ones(n)), D=Box.unbounded(0),
                   n=n, m=0)
    solve = make_alm_solver(prob, AlmConfig(eps=eps),
                            PanocConfig(lbfgs_memory=memory, max_iter=100))
    res_j = jax.jit(jax.vmap(lambda t: solve(t, jnp.zeros(n),
                                             jnp.zeros(0))))(jnp.asarray(ts))
    res_t = _port_solve(_qp_cost_torch, -np.ones(n), np.ones(n), n,
                        torch.as_tensor(ts), np.zeros_like(ts), eps, memory,
                        100)
    _assert_same(res_t, res_j)
    assert res_t.converged.all()
    np.testing.assert_allclose(res_t.u.numpy(), np.clip(ts, -1, 1), atol=1e-4)


def test_trace_and_progress_callback_match_jax():
    # PanocConfig(trace=True) records psi, criterion and gamma per iterate as
    # the JAX solver does (NaN past each lane's last iterate); the progress
    # callback sees, for each active lane, the values that were traced.
    ts = np.array([[0.5, 2.0, -3.0, 0.1], [0.0, 0.0, 0.0, 0.0],
                   [10.0, -10.0, 0.2, 0.9]], np.float32)
    n, eps, memory, max_iter = 4, 1e-5, 4, 30
    prob = Problem(cost=_qp_cost_jax, constraints=None,
                   C=Box(-jnp.ones(n), jnp.ones(n)), D=Box.unbounded(0),
                   n=n, m=0)
    solve = make_alm_solver(prob, AlmConfig(eps=eps),
                            PanocConfig(lbfgs_memory=memory,
                                        max_iter=max_iter, trace=True))
    res_j = jax.jit(jax.vmap(lambda t: solve(t, jnp.zeros(n),
                                             jnp.zeros(0))))(jnp.asarray(ts))

    seen = []
    panoc = tpanoc.make_panoc_solver(
        lambda u, t: tproblem.value_and_grad(_qp_cost_torch, u, t),
        tproblem.Box(-torch.ones(n), torch.ones(n)),
        TPanocConfig(lbfgs_memory=memory, max_iter=max_iter, trace=True),
        progress_callback=lambda *vals: seen.append(
            [v.clone() for v in vals]))
    tts = torch.as_tensor(ts)
    res_t = panoc(torch.zeros_like(tts), eps, tts)

    np.testing.assert_array_equal(res_t.iterations.numpy(),
                                  np.asarray(res_j.inner_iterations))
    for got, ref in zip(res_t.trace, res_j.inner_trace):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)
    n_active = 0
    for iters, psi, crit, gamma in seen:
        for b in range(len(ts)):
            k = int(iters[b])
            if k < int(res_t.iterations[b]):
                n_active += 1
                for val, buf in zip((psi, crit, gamma), res_t.trace):
                    assert float(val[b]) == float(buf[b, k])
    assert n_active == int(res_t.iterations.sum())


def test_rosenbrock_box_matches_jax():
    def cost_j(u, _):
        return (1 - u[0]) ** 2 + 100.0 * (u[1] - u[0] ** 2) ** 2

    def cost_t(u, _):
        return (1 - u[:, 0]) ** 2 + 100.0 * (u[:, 1] - u[:, 0] ** 2) ** 2

    prob = Problem(cost=cost_j, constraints=None,
                   C=Box(-2 * jnp.ones(2), 2 * jnp.ones(2)),
                   D=Box.unbounded(0), n=2, m=0)
    solve = make_alm_solver(prob, AlmConfig(eps=1e-5),
                            PanocConfig(lbfgs_memory=10, max_iter=500))
    u0 = np.array([[-1.5, 1.5]], np.float32)
    res_j = jax.jit(jax.vmap(lambda u: solve(None, u, jnp.zeros(0))))(
        jnp.asarray(u0))
    res_t = _port_solve(cost_t, -2 * np.ones(2), 2 * np.ones(2), 2, None, u0,
                        1e-5, 10, 500)
    _assert_same(res_t, res_j)
    np.testing.assert_allclose(res_t.u.numpy()[0], [1.0, 1.0], atol=2e-3)


def test_divergent_lane_matches_jax():
    # one lane's cost is NaN: it must exit on its own (plateau) while the
    # others converge, with the same iteration counts as the JAX solver
    def cost_j(u, t):
        return 0.5 * jnp.sum((u - t) ** 2) + jnp.where(
            jnp.isnan(t[0]), jnp.nan, 0.0)

    def cost_t(u, t):
        return 0.5 * ((u - t) ** 2).sum(dim=1) + torch.where(
            torch.isnan(t[:, 0]), float("nan"), 0.0)

    prob = Problem(cost=cost_j, constraints=None,
                   C=Box(-jnp.ones(2), jnp.ones(2)), D=Box.unbounded(0),
                   n=2, m=0)
    solve = make_alm_solver(prob, AlmConfig(eps=1e-5),
                            PanocConfig(lbfgs_memory=3, max_iter=50))
    ts = np.array([[0.5, 0.5], [np.nan, 0.0], [-0.3, 0.8]], np.float32)
    res_j = jax.jit(jax.vmap(lambda t: solve(t, jnp.zeros(2),
                                             jnp.zeros(0))))(jnp.asarray(ts))
    res_t = _port_solve(cost_t, -np.ones(2), np.ones(2), 2,
                        torch.as_tensor(ts), np.zeros_like(ts), 1e-5, 3, 50)
    ok = res_t.converged.numpy()
    assert ok[0] and ok[2] and not ok[1]
    np.testing.assert_array_equal(ok, np.asarray(res_j.converged))
    np.testing.assert_array_equal(res_t.inner_iterations.numpy(),
                                  np.asarray(res_j.inner_iterations))
    good = [0, 2]
    np.testing.assert_allclose(res_t.u.numpy()[good],
                               np.asarray(res_j.u)[good], atol=1e-4)


def test_lbfgs_two_loop_matches_jax():
    # Ring buffers of different fill per lane: the batched push/direction
    # must agree with the JAX per-lane functions lane by lane.
    from mpc_tpu.solver.panoc import (lbfgs_direction, lbfgs_init,
                                      lbfgs_push)
    rng = np.random.default_rng(1)
    n, M, B = 5, 3, 3
    Q = rng.normal(size=(n, n))
    A = (Q @ Q.T + n * np.eye(n)).astype(np.float32)
    st_t = tpanoc.lbfgs_init(B, M, n)
    st_j = [lbfgs_init(M, n) for _ in range(B)]
    for step in range(5):
        s = rng.normal(size=(B, n)).astype(np.float32)
        y = (s @ A.T).astype(np.float32)
        y[step % B] *= -1.0          # one lane per step fails curvature
        st_t = tpanoc.lbfgs_push(st_t, torch.as_tensor(s), torch.as_tensor(y))
        st_j = [lbfgs_push(st_j[b], jnp.asarray(s[b]), jnp.asarray(y[b]))
                for b in range(B)]
    q = rng.normal(size=(B, n)).astype(np.float32)
    d_t = tpanoc.lbfgs_direction(st_t, torch.as_tensor(q)).numpy()
    for b in range(B):
        d_j = np.asarray(lbfgs_direction(st_j[b], jnp.asarray(q[b])))
        np.testing.assert_allclose(d_t[b], d_j, rtol=1e-5, atol=1e-6)
        assert int(st_t.head[b]) == int(st_j[b].head)
        np.testing.assert_array_equal(st_t.valid[b].numpy(),
                                      np.asarray(st_j[b].valid))


def test_general_constraints_raise():
    n = 2
    C = tproblem.Box(-torch.ones(n), torch.ones(n))
    D = tproblem.Box(torch.tensor([-float("inf")]), torch.tensor([1.0]))
    prob = tproblem.Problem(cost=lambda u, _: (u ** 2).sum(1),
                            constraints=lambda u, _: u.sum(1, keepdim=True),
                            C=C, D=D, n=n, m=1)
    with pytest.raises(NotImplementedError, match="general-constraint"):
        talm.make_alm_solver(prob)
