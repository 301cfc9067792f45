"""Parity of the port's ALM general-constraint path
(mpc_tpu_torch/solver/alm.py) with ``mpc_tpu.solver.alm.make_alm_solver`` on
the constrained problems of tests/test_solver.py:48-81: converged flags,
outer and inner iteration counts, multipliers, penalties and step sizes,
with a batch that mixes cold lanes, warm lanes and skipped lanes (the
``tol > 1e30`` sentinel).
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
from mpc_tpu_torch.solver import problem as tproblem

torch.set_num_threads(1)

# lanes: targets t (the cost's minimiser), carried sigma (0 = cold), carried
# gamma, and tol (1e31 = skip the lane)
TARGETS = np.array([[2.0, 2.0], [2.0, 2.0], [0.2, 0.3], [3.0, -1.0],
                    [1.5, 0.5], [2.0, 2.0]], np.float32)
SIGMA0 = np.array([[0.0], [50.0], [0.0], [1e6], [20.0], [5.0]], np.float32)
GAMMA0 = np.array([0.0, 0.05, 0.0, 0.1, 0.0, 0.2], np.float32)
TOL = np.array([1e-4, 1e-4, 1e-4, 1e-4, 1e-4, 1e31], np.float32)

# eps = delta = 1e-4: at 1e-5 these problems reach the float32 floor of the
# PANOC criterion, where rounding alone decides an iteration more or less
ALM = dict(eps=1e-4, delta=1e-4, sigma_0=100.0, max_iter=12, eps_0=1e-2)
PANOC = dict(lbfgs_memory=5, max_iter=200)


def _cost_j(u, t):
    return (u[0] - t[0]) ** 2 + (u[1] - t[1]) ** 2


def _cost_t(u, t):
    return (u[:, 0] - t[:, 0]) ** 2 + (u[:, 1] - t[:, 1]) ** 2


def _g_j(u, _):
    return jnp.array([u[0] + u[1]])


def _g_t(u, _):
    return u[:, :1] + u[:, 1:]


def _solve_both(lower, upper, trace=False):
    prob = Problem(cost=_cost_j, constraints=_g_j, C=Box.unbounded(2),
                   D=Box(jnp.array([lower]), jnp.array([upper])), n=2, m=1)
    solve = make_alm_solver(prob, AlmConfig(trace=trace, **ALM),
                            PanocConfig(trace=trace, **PANOC))
    res_j = jax.jit(jax.vmap(
        lambda t, s, g, tol: solve(t, jnp.zeros(2), jnp.zeros(1), tol=tol,
                                   sigma0=s, gamma0=g)))(
        jnp.asarray(TARGETS), jnp.asarray(SIGMA0), jnp.asarray(GAMMA0),
        jnp.asarray(TOL))

    tprob = tproblem.Problem(
        cost=_cost_t, constraints=_g_t, C=tproblem.Box.unbounded(2),
        D=tproblem.Box(torch.tensor([lower]), torch.tensor([upper])),
        n=2, m=1)
    tsolve = talm.make_alm_solver(tprob, TAlmConfig(trace=trace, **ALM),
                                  TPanocConfig(trace=trace, **PANOC))
    B = len(TARGETS)
    res_t = tsolve(torch.as_tensor(TARGETS), torch.zeros((B, 2)),
                   torch.zeros((B, 1)), tol=torch.as_tensor(TOL),
                   sigma0=torch.as_tensor(SIGMA0),
                   gamma0=torch.as_tensor(GAMMA0))
    return res_t, res_j


def _assert_same(res_t, res_j):
    for f in ("converged", "outer_iterations", "inner_iterations",
              "inner_convergence_failures"):
        np.testing.assert_array_equal(getattr(res_t, f).numpy(),
                                      np.asarray(getattr(res_j, f)),
                                      err_msg=f)
    np.testing.assert_allclose(res_t.u.numpy(), np.asarray(res_j.u),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(res_t.lam.numpy(), np.asarray(res_j.lam),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res_t.sigma.numpy(), np.asarray(res_j.sigma),
                               rtol=1e-6)
    np.testing.assert_allclose(res_t.gamma.numpy(), np.asarray(res_j.gamma),
                               rtol=1e-4)
    np.testing.assert_allclose(res_t.constraint_violation.numpy(),
                               np.asarray(res_j.constraint_violation),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["inequality", "equality"])
def test_general_alm_matches_jax(kind):
    # u0 + u1 <= 1 (tests/test_solver.py:48-63) or u0 + u1 = 1 through the
    # degenerate box (:66-81), over the mixed batch
    lower, upper = (-np.inf, 1.0) if kind == "inequality" else (1.0, 1.0)
    res_t, res_j = _solve_both(lower, upper)
    _assert_same(res_t, res_j)
    conv = res_t.converged.numpy()
    assert conv[:5].all() and conv[5]                  # the skipped lane too
    if kind == "inequality":
        # lane 0: the case of tests/test_solver.py, u* = (0.5, 0.5), lam* = 3
        np.testing.assert_allclose(res_t.u[0].numpy(), [0.5, 0.5], atol=1e-3)
        np.testing.assert_allclose(res_t.lam[0].numpy(), [3.0], atol=5e-2)
        # lane 2 is strictly feasible: the constraint never binds
        np.testing.assert_allclose(res_t.u[2].numpy(), [0.2, 0.3], atol=1e-4)


def test_general_alm_warm_cold_and_skip_lanes():
    # Cold lanes start the eps homotopy at eps_0 with sigma_0; warm lanes
    # start at the final eps with their carried penalties capped at sigma_0
    # (1e6 -> 100); the skipped lane does no work and hands its incoming
    # sigma and gamma back.
    res_t, _ = _solve_both(-np.inf, 1.0, trace=True)
    eps_k, sigma_max = res_t.trace.eps_k[:, 0], res_t.trace.sigma_max[:, 0]
    cold, warm = SIGMA0[:5, 0] == 0, SIGMA0[:5, 0] > 0
    assert (eps_k[:5][cold] == np.float32(ALM["eps_0"])).all()
    assert (eps_k[:5][warm] == np.float32(ALM["eps"])).all()
    np.testing.assert_array_equal(sigma_max[:5].numpy(),
                                  np.minimum(np.where(cold, 100.0,
                                                      SIGMA0[:5, 0]), 100.0))
    assert int(res_t.outer_iterations[5]) == 0
    assert int(res_t.inner_iterations[5]) == 0
    assert float(res_t.sigma[5, 0]) == SIGMA0[5, 0]
    assert float(res_t.gamma[5]) == GAMMA0[5]
    assert bool(res_t.trace.psi[5].isnan().all())


def test_general_alm_trace_matches_jax():
    # AlmConfig(trace=True) records psi, violation, eps_k, max sigma and the
    # inner iterations per outer iteration, NaN past each lane's last one;
    # the last inner solve's PANOC trace comes along.
    res_t, res_j = _solve_both(-np.inf, 1.0, trace=True)
    _assert_same(res_t, res_j)
    # the violation of a converged lane is float32 noise below 1e-5
    for f, got, ref in zip(res_t.trace._fields, res_t.trace, res_j.trace):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(
        np.isnan(res_t.inner_trace.psi.numpy()),
        np.isnan(np.asarray(res_j.inner_trace.psi)))


def test_general_alm_nan_lane_does_not_stall_batch():
    # tests/test_solver.py:99-116 on the general path: one lane's cost is
    # NaN; the other lanes converge as in the JAX package, with the same
    # iteration counts, and the NaN lane stops at its caps.
    targets = np.array([[0.5, 0.5], [np.nan, 0.0], [-0.3, 0.8]], np.float32)
    prob = Problem(cost=_cost_j, constraints=_g_j, C=Box(-jnp.ones(2),
                                                        jnp.ones(2)),
                   D=Box(jnp.array([-jnp.inf]), jnp.array([1.0])), n=2, m=1)
    solve = make_alm_solver(prob, AlmConfig(**ALM),
                            PanocConfig(lbfgs_memory=3, max_iter=50))
    res_j = jax.jit(jax.vmap(lambda t: solve(t, jnp.zeros(2),
                                             jnp.zeros(1))))(
        jnp.asarray(targets))
    tprob = tproblem.Problem(
        cost=_cost_t, constraints=_g_t,
        C=tproblem.Box(-torch.ones(2), torch.ones(2)),
        D=tproblem.Box(torch.tensor([-float("inf")]), torch.tensor([1.0])),
        n=2, m=1)
    tsolve = talm.make_alm_solver(tprob, TAlmConfig(**ALM),
                                  TPanocConfig(lbfgs_memory=3, max_iter=50))
    res_t = tsolve(torch.as_tensor(targets), torch.zeros((3, 2)),
                   torch.zeros((3, 1)))
    for f in ("converged", "outer_iterations", "inner_iterations",
              "inner_convergence_failures"):
        np.testing.assert_array_equal(getattr(res_t, f).numpy(),
                                      np.asarray(getattr(res_j, f)),
                                      err_msg=f)
    conv = res_t.converged.numpy()
    assert conv[0] and conv[2] and not conv[1]
    np.testing.assert_allclose(res_t.u.numpy()[[0, 2]],
                               np.asarray(res_j.u)[[0, 2]], rtol=0, atol=1e-5)
    np.testing.assert_allclose(res_t.u[0].numpy(), [0.5, 0.5], atol=1e-3)


def test_project_difference_matches_jax():
    # x - Pi_box(x) (mpc_tpu/solver/problem.py:49-51), one-sided and
    # two-sided boxes, points inside and outside
    from mpc_tpu.solver.problem import project_difference
    x = np.array([[-3.0, 0.5, 2.0, -0.2], [0.0, -1.5, 7.0, 0.3]], np.float32)
    lo = np.array([-1.0, -np.inf, 1.0, -0.2], np.float32)
    up = np.array([1.0, 1.0, np.inf, 0.2], np.float32)
    got = tproblem.project_difference(
        torch.as_tensor(x), tproblem.Box(torch.as_tensor(lo),
                                         torch.as_tensor(up)))
    ref = project_difference(jnp.asarray(x), Box(jnp.asarray(lo),
                                                  jnp.asarray(up)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
