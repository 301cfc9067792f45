"""The port's batched AL-iLQR controller over a (scenario, horizon) mesh
(mpc_tpu_torch/parallel/ilqr_sharded.py, ``build_vehicle_ilqr_controller(
mesh=)``) on a 2-rank gloo world against the JAX package's
``BatchedMpcController`` on a (2, 4) virtual mesh, on
tests/test_ilqr_sharded.py's setup (the config-2 OCP with bounded state
constraints at N = 8, B = 4, the lane-change road): a closed loop of 3
steps, each step's converged flags and outer iterations equal, inner
iterations within the port's band of 2 per outer iteration
(tests/test_torch_mpc_ilqr.py), the first step's inputs and the last
states within 5e-3. The (1, 2) mesh shards the backward pass over the
horizon; the (2, 1) mesh splits the lanes over the scenario axis.

Also ``make_ilqr_solver_batched`` on the same meshes and lanes against the
JAX package's on the (2, 4) mesh: the Pacejka OCP with Gauss-Newton
curvature, the augmented-Lagrangian terms of a speed bound (``al_args``,
split by lane like the inputs) and a skipped lane on the second scenario
rank; converged flags and iteration counts equal, cost within 1e-5
relative, inputs within 5e-4 (tests/test_torch_ilqr.py's tolerances), the
skipped lane's inputs as given. The ranks run while the JAX references
compile.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.config import AlmConfig as JAlmConfig
from mpc_tpu.control.mpc import build_vehicle_ilqr_controller
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.bezier import bezier_centerline, lane_change_control_points
from mpc_tpu.ops.costs import vehicle_stage_cost, vehicle_stage_residuals
from mpc_tpu.parallel.ilqr_sharded import (BatchedMpcController,
                                           make_ilqr_solver_batched)
from mpc_tpu.parallel.mesh import make_horizon_mesh
from mpc_tpu.solver.ilqr import IlqrConfig as JIlqrConfig
from mpc_tpu.solver.problem import Box
from mpc_tpu_torch.parallel._dist_worker import launch

torch.set_num_threads(1)

N, B, N_STEPS = 8, 4, 3
ALM = dict(delta=1e-3, max_iter=4, sigma_0=1e3, penalty_factor=5.0)
ILQR = dict(max_iter=15)
PORT_MESHES = {"horizon": (1, 2), "scenario": (2, 1)}
INNER_BAND = 2          # per outer iteration
BAND = 5e-3
# make_ilqr_solver_batched's case: a speed bound v <= V_MAX in AL form
U_LIM, V_MAX, LAM, SIGMA = (1.0, 0.32), 0.6, 0.1, 100.0
SKIP = np.array([False, False, False, True])


def _setup():
    """tests/test_ilqr_sharded.py's road and initial states."""
    pts = lane_change_control_points(5.0).control_points * 0.01
    cl = np.asarray(bezier_centerline(pts, size=50), np.float32)
    rng = np.random.default_rng(0)
    d0 = cl[1] - cl[0]
    hd = float(np.arctan2(d0[1], d0[0]))
    y0 = np.stack([
        np.array([float(cl[0, 0]), float(cl[0, 1]) + rng.uniform(-0.02, 0.02),
                  hd, rng.uniform(0.3, 0.7), 0, 0], np.float32)
        for _ in range(B)])
    return cl, y0


def _jax_loop(cl, y0s):
    ctrl = build_vehicle_ilqr_controller(
        n_horiz=N, bound_state_constraints=True, alm_cfg=JAlmConfig(**ALM),
        ilqr_cfg=JIlqrConfig(**ILQR),
        mesh=make_horizon_mesh(n_scenario=2, n_horizon=4,
                               devices=jax.devices()[:8]))
    assert isinstance(ctrl, BatchedMpcController)
    params = VehicleParams()
    f_d = discretize(pacejka_dynamics)
    cl = jnp.asarray(cl)

    @jax.jit
    def step(ys, carry):
        out = ctrl.step(carry, {"y0": ys, "p": params, "centerline": cl})
        return jax.vmap(lambda y, u: f_d(y, u, params))(ys, out.u0), out

    carry, ys = ctrl.init_carry(B), jnp.asarray(y0s)
    steps = {k: [] for k in ("u0", "converged", "outer", "inner")}
    for _ in range(N_STEPS):
        ys, out = step(ys, carry)
        carry = out.carry
        for k, v in zip(steps, (out.u0, out.result.converged,
                                out.result.outer_iterations,
                                out.result.inner_iterations)):
            steps[k].append(np.asarray(v))
    return {**{k: np.stack(v) for k, v in steps.items()},
            "ys": np.asarray(ys)}


def _solver_inputs(cl, y0s):
    return dict(us0=np.tile(np.asarray([1.0, 0.0], np.float32), (B, N)),
                y0s=y0s, cl=cl, lam=np.full((B, N), LAM, np.float32),
                sigma=np.full((B, N), SIGMA, np.float32), skip=SKIP)


def _jax_solver(a):
    lim = jnp.tile(jnp.asarray(U_LIM, jnp.float32), N)

    def speed_res(xn, u, prm, lam_k, sigma_k):
        zeta = xn[3:4] - V_MAX + lam_k / sigma_k
        return jnp.sqrt(0.5 * sigma_k) * jnp.maximum(zeta, 0.0)

    def speed_al(xn, u, prm, lam_k, sigma_k):
        return jnp.sum(speed_res(xn, u, prm, lam_k, sigma_k) ** 2)

    solve = make_ilqr_solver_batched(
        discretize(pacejka_dynamics),
        lambda x, u, prm: vehicle_stage_cost(x, u, prm["centerline"], 1.0),
        N, 6, 2, u_box=Box(-lim, lim), cfg=JIlqrConfig(**ILQR),
        stage_residuals=lambda x, u, prm: vehicle_stage_residuals(
            x, u, prm["centerline"], 1.0),
        mesh=make_horizon_mesh(n_scenario=2, n_horizon=4,
                               devices=jax.devices()[:8]))
    a = {k: jnp.asarray(v) for k, v in a.items()}
    res = jax.jit(lambda a: solve(
        a["us0"], {"y0": a["y0s"], "p": VehicleParams(),
                   "centerline": a["cl"]},
        al_args=(a["lam"], a["sigma"], speed_al, speed_res),
        skip=a["skip"]))(a)
    return {f: np.asarray(getattr(res, f))
            for f in ("us", "cost", "converged", "iterations")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(controller, controller_ref, solver, solver_ref)``: the port's
    ranks run both jobs while JAX compiles."""
    cl, y0s = _setup()
    spec, sspec, arrays = {}, {}, {}
    for name, mesh in PORT_MESHES.items():
        spec[name] = dict(mesh=list(mesh), n_horiz=N, alm=ALM, ilqr=ILQR,
                          n_steps=N_STEPS)
        arrays.update({f"{name}/cl": cl, f"{name}/y0s": y0s})
        sspec[f"s_{name}"] = dict(mesh=list(mesh), n_horiz=N, ilqr=ILQR,
                                  u_lim=list(U_LIM), v_max=V_MAX)
        arrays.update({f"s_{name}/{k}": v
                       for k, v in _solver_inputs(cl, y0s).items()})
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(launch, "ilqr,ilqr_solver", 2,
                      str(tmp_path_factory.mktemp("ilqr")),
                      spec={"ilqr": {"cases": spec},
                            "ilqr_solver": {"cases": sspec}},
                      arrays=arrays, device="cpu")
    pool.shutdown(wait=False)
    ref = _jax_loop(cl, y0s)
    sref = _jax_solver(_solver_inputs(cl, y0s))
    res = fut.result()
    port = {case: {k.split("/", 1)[1]: v for k, v in res.items()
                   if k.startswith(case + "/")}
            for name in PORT_MESHES for case in (name, f"s_{name}")}
    return ({name: port[name] for name in PORT_MESHES}, ref,
            {name: port[f"s_{name}"] for name in PORT_MESHES}, sref)


@pytest.mark.parametrize("name", PORT_MESHES)
def test_returns_batched_controller(runs, name):
    assert runs[0][name]["batched"]


@pytest.mark.parametrize("name", PORT_MESHES)
@pytest.mark.parametrize("step", range(N_STEPS))
def test_step_flags_and_counts_match_jax(runs, name, step):
    got, want = runs[0][name], runs[1]
    np.testing.assert_array_equal(got["converged"][step],
                                  want["converged"][step])
    np.testing.assert_array_equal(got["outer"][step], want["outer"][step])
    gap = np.abs(got["inner"][step].astype(int)
                 - want["inner"][step].astype(int))
    assert (gap <= INNER_BAND * want["outer"][step]).all(), gap


@pytest.mark.parametrize("name", PORT_MESHES)
def test_closed_loop_matches_jax(runs, name):
    got, want = runs[0][name], runs[1]
    assert got["converged"].all()
    np.testing.assert_allclose(got["u0"][0], want["u0"][0], atol=BAND,
                               rtol=0)
    assert np.isfinite(got["ys"]).all()
    np.testing.assert_allclose(got["ys"], want["ys"], atol=BAND, rtol=0)


@pytest.mark.parametrize("name", PORT_MESHES)
def test_batched_ilqr_solver_matches_jax(runs, name):
    got, want = runs[2][name], runs[3]
    np.testing.assert_array_equal(got["converged"], want["converged"])
    np.testing.assert_array_equal(got["iterations"], want["iterations"])
    assert got["converged"].all()
    np.testing.assert_array_equal(got["us"][SKIP],
                                  _solver_inputs(*_setup())["us0"][SKIP])
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-5)
    np.testing.assert_allclose(got["us"], want["us"], atol=5e-4, rtol=0)
