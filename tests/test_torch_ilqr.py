"""Parity of the port's iLQR (mpc_tpu_torch/solver/ilqr.py:
``make_ilqr_solver``) with ``mpc_tpu.solver.ilqr.make_ilqr_solver``, the
JAX solver ``vmap``-ed over the same lanes, on the vehicle OCP: the
kinematic and the Pacejka model with Gauss-Newton curvature, a batch that
mixes lanes converging at different iterations with a skipped and a NaN
lane, and the ``trace=True`` buffers. Also: the full-Hessian branch reaches
the Gauss-Newton optimum, the parallel backward pass the sequential one's,
the residual form sums to the stage cost, and per-stage bounds raise.

Tolerances: converged flags, skips and iteration counts equal; cost within
1e-5 relative; inputs within 5e-4. The last iteration of a lane decides
between accepting a step and declaring a stall on a cost change at the
float32 noise floor (|dcost| <= tol_stall |cost|), where the two
frameworks' sin/cos rounding can tip it either way: both then converge at
the same iteration with the same cost to 2e-7, but one has taken a last
step that moves weakly determined inputs by up to 2.2e-4 (seen on the
Pacejka lanes here). N <= 8, a few lanes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.models.bicycle import pacejka_dynamics as j_pacejka
from mpc_tpu.models.bicycle import simplified_dynamics as j_simplified
from mpc_tpu.models.integrators import discretize as j_discretize
from mpc_tpu.models.params import VehicleParams as JParams
from mpc_tpu.ops.costs import vehicle_stage_cost as j_cost
from mpc_tpu.ops.costs import vehicle_stage_residuals as j_residuals
from mpc_tpu.ops.road import straight_centerline as j_straight
from mpc_tpu.solver.ilqr import IlqrConfig as JIlqrConfig
from mpc_tpu.solver.ilqr import make_ilqr_solver as j_make
from mpc_tpu.solver.problem import Box as JBox
from mpc_tpu_torch.config import IlqrConfig
from mpc_tpu_torch.models.bicycle import pacejka_dynamics, simplified_dynamics
from mpc_tpu_torch.models.integrators import discretize
from mpc_tpu_torch.models.params import VehicleParams
from mpc_tpu_torch.ops.costs import vehicle_stage_cost, vehicle_stage_residuals
from mpc_tpu_torch.ops.road import straight_centerline
from mpc_tpu_torch.solver.ilqr import make_al_ilqr_solver, make_ilqr_solver
from mpc_tpu_torch.solver.problem import Box

torch.set_num_threads(1)

N = 8
LIM = (1.0, 0.32)
MODELS = {"simplified": (4, simplified_dynamics, j_simplified),
          "pacejka": (6, pacejka_dynamics, j_pacejka)}
# lanes: offsets from the centreline, headings and speeds; the last two
# lanes of the mixed batch are skipped and NaN
Y0 = {"simplified": [[0.0, 0.05, 0.1, 0.4], [0.0, 0.0, 0.0, 0.5],
                     [0.0, -0.08, -0.2, 0.9], [0.1, 0.02, 0.0, 0.3]],
      "pacejka": [[0.0, 0.05, 0.1, 0.4, 0.0, 0.0],
                  [0.0, 0.0, 0.0, 0.5, 0.0, 0.0],
                  [0.0, -0.08, -0.2, 0.9, 0.05, 0.1],
                  [0.1, 0.02, 0.0, 0.3, 0.0, 0.0]]}


def t_solver(model, cfg, **kw):
    sd, dyn, _ = MODELS[model]
    lim = torch.tensor(LIM).repeat(N)
    return make_ilqr_solver(
        discretize(dyn),
        lambda x, u, prm: vehicle_stage_cost(x, u, prm["centerline"], 1.0),
        N, sd, 2, u_box=Box(-lim, lim), cfg=cfg,
        stage_residuals=lambda x, u, prm: vehicle_stage_residuals(
            x, u, prm["centerline"], 1.0), **kw)


@functools.lru_cache(maxsize=None)
def j_solver(model, gauss_newton=True, trace=False):
    """The JAX solver over lanes: ``(us0 (B, 2N), y0 (B, sd), skip (B,))``."""
    sd, _, dyn = MODELS[model]
    lim = jnp.tile(jnp.asarray(LIM, jnp.float32), N)
    cl = j_straight(100)
    solve = j_make(
        j_discretize(dyn),
        lambda x, u, prm: j_cost(x, u, prm["centerline"], 1.0),
        N, sd, 2, u_box=JBox(-lim, lim),
        cfg=JIlqrConfig(gauss_newton=gauss_newton, trace=trace),
        stage_residuals=lambda x, u, prm: j_residuals(
            x, u, prm["centerline"], 1.0))
    return jax.jit(jax.vmap(lambda us0, y0, skip: solve(
        us0, {"y0": y0, "p": JParams(), "centerline": cl}, skip=skip)))


def inputs(model, lanes):
    y0 = np.asarray(Y0[model], np.float32)[:lanes]
    us0 = np.tile(np.asarray([1.0, 0.0], np.float32), (lanes, N))
    return us0, y0


def run_port(solve, us0, y0, skip=None):
    param = {"y0": torch.as_tensor(y0), "p": VehicleParams(),
             "centerline": straight_centerline(100)}
    return solve(torch.as_tensor(us0), param,
                 skip=None if skip is None else torch.as_tensor(skip))


def assert_same(res, ref, what=""):
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(ref.converged), err_msg=what)
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.asarray(ref.iterations), err_msg=what)
    ok = np.isfinite(np.asarray(ref.cost))
    np.testing.assert_allclose(res.cost.numpy()[ok], np.asarray(ref.cost)[ok],
                               rtol=1e-5, err_msg=what)
    np.testing.assert_allclose(res.us.numpy()[ok], np.asarray(ref.us)[ok],
                               rtol=0, atol=5e-4, err_msg=what)


@pytest.mark.parametrize("model", ["simplified", "pacejka"])
def test_gauss_newton_ilqr_matches_jax(model):
    us0, y0 = inputs(model, 4)
    skip = np.zeros(4, bool)
    res = run_port(t_solver(model, IlqrConfig()), us0, y0)
    ref = j_solver(model)(us0, y0, skip)
    assert res.converged.all()
    assert res.xs.shape == (4, N + 1, MODELS[model][0])
    assert_same(res, ref, model)
    # the clamped rollout keeps every input inside the box
    U = res.us.numpy().reshape(4, N, 2)
    assert np.all(np.abs(U) <= np.asarray(LIM) + 1e-6)


def test_mixed_lanes_skip_and_nan_match_jax():
    # lanes converging at different iterations, a skipped lane (exits at
    # iteration 0 with its inputs as given, unclamped) and a NaN lane
    # (rejects every step until reg passes reg_max, never converges)
    us0, y0 = inputs("pacejka", 4)
    us0 = np.concatenate([us0, us0[:2]])
    us0[4, 0] = 1.7                       # outside the box: kept as given
    y0 = np.concatenate([y0, y0[:1], np.full((1, 6), np.nan, np.float32)])
    skip = np.array([False] * 4 + [True, False])
    res = run_port(t_solver("pacejka", IlqrConfig()), us0, y0, skip)
    ref = j_solver("pacejka")(us0, y0, skip)
    assert_same(res, ref)
    np.testing.assert_array_equal(res.converged.numpy(),
                                  [True] * 5 + [False])
    assert int(res.iterations[4]) == 0
    np.testing.assert_array_equal(res.us[4].numpy(), us0[4])
    assert len(set(res.iterations[:4].tolist())) > 1
    assert int(res.iterations[5]) == 13   # 1e-3 * 8^13 >= reg_max = 1e8
    assert not torch.isfinite(res.cost[5])


def test_trace_buffers_match_jax():
    us0, y0 = inputs("simplified", 3)
    skip = np.zeros(3, bool)
    res = run_port(t_solver("simplified", IlqrConfig(trace=True)), us0, y0)
    ref = j_solver("simplified", trace=True)(us0, y0, skip)
    assert_same(res, ref)
    # every row the iterations wrote, NaN after; the chosen step sizes
    # equal but on each lane's last iteration, whose accept-or-stall choice
    # is made at the noise floor (see the module docstring); the gradient
    # proxy to 1e-6 absolute, its float32 rounding near the optimum
    k = res.iterations.numpy()
    written = np.arange(IlqrConfig().max_iter)[None] < k[:, None]
    before_last = np.arange(IlqrConfig().max_iter)[None] < k[:, None] - 1
    for f, rtol, atol, rows in (("cost", 1e-5, 0, written),
                                ("grad_norm", 1e-4, 1e-6, written),
                                ("reg", 0, 0, written),
                                ("alpha", 0, 0, before_last)):
        got = getattr(res.trace, f).numpy()
        want = np.asarray(getattr(ref.trace, f))
        assert got.shape == (3, IlqrConfig().max_iter)
        assert np.isnan(got[~written]).all(), f
        np.testing.assert_allclose(got[rows], want[rows], rtol=rtol,
                                   atol=atol, err_msg=f)


def test_full_hessian_reaches_the_gauss_newton_optimum():
    # both curvatures minimise the same cost: the optima agree to solver
    # tolerance (the 2% bar of tests/test_ilqr.py:109-125)
    us0, y0 = inputs("pacejka", 2)
    gn = run_port(t_solver("pacejka", IlqrConfig()), us0, y0)
    full = run_port(t_solver("pacejka", IlqrConfig(gauss_newton=False)),
                    us0, y0)
    assert gn.converged.all() and full.converged.all()
    np.testing.assert_allclose(full.cost.numpy(), gn.cost.numpy(), rtol=2e-2)


def test_full_hessian_matches_jax():
    us0, y0 = inputs("simplified", 2)
    skip = np.zeros(2, bool)
    res = run_port(t_solver("simplified", IlqrConfig(gauss_newton=False)),
                   us0, y0)
    ref = j_solver("simplified", gauss_newton=False)(us0, y0, skip)
    assert_same(res, ref)


def test_parallel_backward_agrees_with_sequential():
    # the bar of tests/test_ilqr.py:171-186
    us0, y0 = inputs("simplified", 3)
    seq = run_port(t_solver("simplified", IlqrConfig()), us0, y0)
    par = run_port(t_solver("simplified",
                            IlqrConfig(parallel_backward=True)), us0, y0)
    assert par.converged.all()
    np.testing.assert_allclose(par.us.numpy(), seq.us.numpy(), atol=2e-3)


def test_convergence_gated_on_regularization():
    # an absurd tol_grad would exit at once; the reg gate makes reg decay
    # from 100 below reg_conv_max = 1 first (>= 7 halvings), as in
    # tests/test_ilqr.py:128-150
    cfg = IlqrConfig(reg_init=100.0, reg_conv_max=1.0, tol_grad=1e10,
                     trace=True)
    us0, y0 = inputs("simplified", 2)
    res = run_port(t_solver("simplified", cfg), us0, y0)
    assert res.converged.all()
    for lane in range(2):
        k = int(res.iterations[lane])
        assert k >= 7, k
        assert float(res.trace.reg[lane, k - 1]) <= cfg.reg_conv_max + 1e-6


def test_stage_residuals_sum_to_the_stage_cost_and_match_jax():
    cl_t, cl_j = straight_centerline(100), j_straight(100)
    rng = np.random.default_rng(3)
    for sd in (6, 4):
        x = rng.normal(0, 0.5, (5, sd)).astype(np.float32)
        u = rng.normal(0, 0.3, (5, 2)).astype(np.float32)
        r = vehicle_stage_residuals(torch.as_tensor(x), torch.as_tensor(u),
                                    cl_t, 1.0)
        c = vehicle_stage_cost(torch.as_tensor(x), torch.as_tensor(u), cl_t,
                               1.0)
        assert r.shape == (5, 6)
        np.testing.assert_allclose(c.numpy(), (r ** 2).sum(1).numpy(),
                                   rtol=1e-5)
        r_j = jax.vmap(lambda a, b: j_residuals(a, b, cl_j, 1.0))(x, u)
        np.testing.assert_allclose(r.numpy(), np.asarray(r_j), rtol=1e-6,
                                   atol=1e-7)


def test_per_stage_bounds_raise():
    lo = -torch.arange(1.0, 2 * 4 + 1)              # varies per stage
    with pytest.raises(ValueError, match="stage-uniform"):
        make_ilqr_solver(lambda x, u, p: x, lambda x, u, p: x[:, 0],
                         n_horiz=4, state_dim=4, input_dim=2,
                         u_box=Box(lo, -lo))
    box = Box(-torch.ones(8), torch.ones(8))
    d_hi = torch.zeros(4 * 6)
    d_hi[6] = 1.0                                    # stage 1 differs
    with pytest.raises(ValueError, match="stage-uniform"):
        make_al_ilqr_solver(lambda x, u, p: x, lambda x, u, p: x[:, 0],
                            n_horiz=4, state_dim=6, input_dim=2, u_box=box,
                            stage_constraints=lambda x, u, p: x,
                            n_stage_constraints=6,
                            D=Box(torch.full((24,), -float("inf")), d_hi))


def test_config_matches_jax_but_unroll():
    # every field and default of the reference's IlqrConfig but unroll, the
    # XLA scan-unrolling hint the port has no scan for
    ref = JIlqrConfig()._asdict()
    assert ref.pop("unroll") is None
    port = {f: getattr(IlqrConfig(), f) for f in ref}
    assert port == ref
    assert set(IlqrConfig.__dataclass_fields__) == set(ref)


def test_prepared_iterations_are_the_solve():
    # solve.prepare hands out the solve's own state and masked iteration:
    # iterating until no lane's condition holds gives the solve's result
    us0, y0 = inputs("simplified", 3)
    solve = t_solver("simplified", IlqrConfig())
    param = {"y0": torch.as_tensor(y0), "p": VehicleParams(),
             "centerline": straight_centerline(100)}
    st, iterate, cond, result = solve.prepare(torch.as_tensor(us0), param)
    k = 0
    while bool(cond(st).any()):
        st = iterate(st)
        k += 1
    by_hand, res = result(st), solve(torch.as_tensor(us0), param)
    assert k == int(res.iterations.max())
    for f in ("us", "xs", "cost", "converged", "iterations", "grad_norm"):
        assert torch.equal(getattr(by_hand, f), getattr(res, f)), f
