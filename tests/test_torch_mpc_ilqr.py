"""Parity of the port's AL-iLQR vehicle controller
(``mpc_tpu_torch.control.mpc.build_vehicle_ilqr_controller``) with the JAX
package's, with the bounded state constraints (Pacejka, N=8) and the solver
settings of config 2 (examples/bench_suite.py:145-169): three warm-started
steps, each fed the JAX controller's carry, then a cold reset.

Each step holds: converged flags, outer iteration counts and failures
equal; inner iteration counts within 2 per outer iteration (the exit
``rel < tol_dcost = 1e-7`` sits below the float32 resolution of the cost,
so rounding moves it by an iteration or two); the sigma carry equal to 1e-6
relative (its entries are sigma_0 times powers of the penalty factor); the
tracking cost of the returned inputs within 1e-4 relative (float32 rounding
of the iterates, see tests/test_torch_ilqr.py); the constraints met to
delta on converged lanes; the first inputs within 2e-3.

The lanes converge with room to spare. On a lane whose inner solve runs
out of its 30 iterations in every outer iteration (e.g. y0 = [0, 0.05,
0.1, 0.4, 0, 0] here: steps of 0.01-0.03 against the penalties, then
rejections until reg passes reg_conv_max), the outcome is decided by
rounding: the JAX package fails it in all 8 outer iterations, the port
converges in the 7th. One JAX controller per test module (its XLA:CPU
compile takes most of the time).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.config import AlmConfig
from mpc_tpu.control.mpc import build_vehicle_ilqr_controller
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.road import straight_centerline
from mpc_tpu.solver.ilqr import IlqrConfig
from mpc_tpu_torch import config as tconfig
from mpc_tpu_torch.control import mpc as tmpc
from mpc_tpu_torch.convert import carry_from_numpy, centerline_from_numpy
from mpc_tpu_torch.models.params import VehicleParams as TVehicleParams

torch.set_num_threads(1)

N_HORIZ = 8
# config 2's solver settings (examples/bench_suite.py:158-162)
ALM = dict(delta=1e-3, max_iter=8, sigma_0=1e3, penalty_factor=5.0)
ILQR = dict(max_iter=30)
PARAMS = VehicleParams()
CL = straight_centerline(100)
# lanes: on the line, offset and turned (one needs a second outer
# iteration), fast, and one spinning near the yaw-rate bound
# omega^2 <= 0.1, whose constraint binds on the first stages
Y0 = np.array([[0.0, 0.0, 0.0, 0.5, 0.0, 0.0],
               [0.0, 0.03, 0.05, 0.6, 0.0, 0.0],
               [0.0, -0.06, -0.2, 0.9, 0.02, 0.31],
               [0.0, -0.04, -0.05, 0.7, 0.0, 0.0],
               [0.0, 0.05, 0.0, 1.0, 0.0, 0.0]], np.float32)


@functools.lru_cache(maxsize=None)
def _controllers():
    jctrl = build_vehicle_ilqr_controller(
        n_horiz=N_HORIZ, bound_state_constraints=True,
        alm_cfg=AlmConfig(**ALM), ilqr_cfg=IlqrConfig(**ILQR))
    f_d = discretize(pacejka_dynamics)

    @jax.jit
    def jstep(ys, carries):
        def one(y, carry):
            out = jctrl.step(carry, {"y0": y, "p": PARAMS, "centerline": CL})
            return f_d(y, out.u0, PARAMS), out.carry, out.u0, out.result
        return jax.vmap(one)(ys, carries)

    tctrl = tmpc.build_vehicle_ilqr_controller(
        n_horiz=N_HORIZ, bound_state_constraints=True,
        alm_cfg=tconfig.AlmConfig(**ALM),
        ilqr_cfg=tconfig.IlqrConfig(**ILQR), device="cpu")
    return jctrl, jstep, tctrl


def _port_step(tctrl, ys, carries):
    t_carry = carry_from_numpy(
        {f: np.asarray(v) for f, v in carries._asdict().items()})
    return tctrl.step(t_carry, {"y0": torch.as_tensor(np.array(ys)),
                                "p": TVehicleParams(),
                                "centerline": centerline_from_numpy(
                                    np.array(CL))})


def _hold(out, res, carries, u0, jctrl, ys, msg, lanes=slice(None)):
    """Hold the port's step against the JAX one on ``lanes``; the converged
    flags and failures on every lane."""
    np.testing.assert_array_equal(out.result.converged.numpy(),
                                  np.asarray(res.converged), err_msg=msg)
    np.testing.assert_array_equal(out.carry.failures.numpy(),
                                  np.asarray(carries.failures))
    out = type(out)(type(out.carry)(*(t[lanes] for t in out.carry)),
                    out.u0[lanes],
                    type(out.result)(*(None if t is None else t[lanes]
                                       for t in out.result)))
    res, carries, u0, ys = jax.tree_util.tree_map(
        lambda t: t[lanes], (res, carries, u0, ys))
    r, c = out.result, out.carry
    for name in ("outer_iterations", "inner_convergence_failures"):
        np.testing.assert_array_equal(getattr(r, name).numpy(),
                                      np.asarray(getattr(res, name)),
                                      err_msg=f"{msg}: {name}")
    gap = np.abs(r.inner_iterations.numpy()
                 - np.asarray(res.inner_iterations))
    assert np.all(gap <= 2 * np.asarray(res.outer_iterations)), (msg, gap)
    np.testing.assert_allclose(c.sigma.numpy(), np.asarray(carries.sigma),
                               rtol=1e-6, err_msg=msg)
    assert float(c.gamma.abs().max()) == 0.0
    cost = jax.vmap(lambda U, y: jctrl.problem.cost(
        U, {"y0": y, "p": PARAMS, "centerline": CL}))
    np.testing.assert_allclose(
        np.asarray(cost(jnp.asarray(c.U.numpy()), ys)),
        np.asarray(cost(carries.U, ys)), rtol=1e-4, err_msg=msg)
    ok = r.converged.numpy()
    assert np.all(r.constraint_violation.numpy()[ok] <= ALM["delta"]), msg
    g = jax.vmap(lambda U, y: jctrl.problem.constraints(
        U, {"y0": y, "p": PARAMS, "centerline": CL}))(
            jnp.asarray(c.U.numpy()), ys)
    assert np.all(np.asarray(g).max(axis=1)[ok] <= ALM["delta"]), msg
    np.testing.assert_allclose(out.u0.numpy(), np.asarray(u0), rtol=0,
                               atol=2e-3, err_msg=msg)


def test_warm_steps_match_jax():
    jctrl, jstep, tctrl = _controllers()
    ys = jnp.asarray(Y0)
    carries = jax.vmap(lambda _: jctrl.init_carry())(jnp.arange(len(Y0)))
    outers = []
    for k in range(3):
        out = _port_step(tctrl, ys, carries)
        ys_next, carries, u0, res = jstep(ys, carries)
        _hold(out, res, carries, u0, jctrl, ys, f"step {k}")
        assert bool(np.asarray(res.converged).all())
        outers.append(np.asarray(res.outer_iterations))
        ys = ys_next
    # the yaw-rate lane needs penalty updates on the cold step, none later;
    # warm steps start from the carried penalties
    assert outers[0].max() > 1 and outers[2].max() == 1
    assert np.asarray(carries.sigma).min() >= ALM["sigma_0"]


def test_cold_reset_matches_jax():
    # a lane whose carried penalties are ruined (sigma = 1e-9 everywhere, so
    # the AL term vanishes and one outer iteration cannot meet the
    # constraint) fails, and its carry goes back to the cold sentinel:
    # sigma = 0, which the next solve starts from sigma_0
    jctrl, jstep, tctrl = _controllers()
    ys = jnp.asarray(Y0)
    carries = jax.vmap(lambda _: jctrl.init_carry())(jnp.arange(len(Y0)))
    carries = carries._replace(sigma=carries.sigma.at[2].set(1e-9))
    out = _port_step(tctrl, ys, carries)
    ys, carries2, u0, res = jstep(ys, carries)
    _hold(out, res, carries2, u0, jctrl, jnp.asarray(Y0), "reset step")
    np.testing.assert_array_equal(np.asarray(res.converged),
                                  [True, True, False, True, True])
    np.testing.assert_array_equal(out.result.outer_iterations[2].item(),
                                  ALM["max_iter"])
    assert float(out.carry.sigma[2].abs().max()) == 0.0
    assert int(out.carry.failures[2]) == 1
    # the next step starts the lane cold from the failed solve's plan, 3.4
    # outside the constraints: both converge, in a number of outer
    # iterations that rounding decides (port 2, JAX 1); its carry is warm
    # again, from sigma_0 up
    out = _port_step(tctrl, ys, carries2)
    ys, carries3, u0, res = jstep(ys, carries2)
    _hold(out, res, carries3, u0, jctrl, ys, "step after the reset",
          lanes=np.array([0, 1, 3, 4]))
    assert bool(out.result.converged[2])
    assert float(out.carry.sigma[2].min()) >= ALM["sigma_0"]
    assert float(np.asarray(carries3.sigma[2]).min()) >= ALM["sigma_0"]


def test_default_device_and_unported_options():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmpc.build_vehicle_ilqr_controller(n_horiz=4)
    # the obstacle field is ported (tests/test_torch_obstacle_ilqr.py), and
    # so is the horizon-sharded mesh (tests/test_torch_ilqr_sharded.py):
    # over a world of one rank in this process it is the batched controller
    assert tmpc.build_vehicle_ilqr_controller(
        n_horiz=4, obstacle_weight=1.0, device="cpu").problem.uses_obstacles
    import torch.distributed as dist
    from mpc_tpu_torch.parallel.distributed import initialize
    from mpc_tpu_torch.parallel.ilqr_sharded import BatchedMpcController
    from mpc_tpu_torch.parallel.mesh import make_horizon_mesh
    initialize("gloo", "cpu", store=dist.HashStore(), rank=0, world_size=1)
    try:
        assert isinstance(tmpc.build_vehicle_ilqr_controller(
            n_horiz=4, mesh=make_horizon_mesh(1, 1), device="cpu"),
            BatchedMpcController)
    finally:
        dist.destroy_process_group()
