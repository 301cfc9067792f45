"""Parity of the port's state-constrained controller
(``build_vehicle_controller(bound_state_constraints=True)``: the ALM general
path, whose candidate fan is K3) with the JAX package, over one cold and two
warm MPC steps at B=2, N=4 on the lane-change road of the ss_n40 path.

Before every step the JAX carry is carried across with
``convert.carry_from_numpy``, so both controllers start each step from the
same warm start. A file of its own: compiling the constrained JAX controller
takes most of its time (N <= 4 keeps it near a minute on XLA:CPU); both
cases share one compiled controller.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.control.mpc import build_vehicle_controller
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.bezier import bezier_centerline, lane_change_control_points
from mpc_tpu_torch import config as tconfig
from mpc_tpu_torch.bench import ss_n40_states
from mpc_tpu_torch.control import mpc as tmpc
from mpc_tpu_torch.convert import carry_from_numpy, centerline_from_numpy
from mpc_tpu_torch.models.params import VehicleParams as TVehicleParams

torch.set_num_threads(1)

B, N_HORIZ = 2, 4
# the ss_n40 solver settings (examples/exp_ms.py:113-117), at N=4
ALM = dict(eps=1e-3, delta=1e-3, max_iter=8, eps_0=1e-2, sigma_0=1e3)
PARAMS = VehicleParams()
CL = bezier_centerline(
    lane_change_control_points(5.0).control_points * 0.01, size=100)


@functools.lru_cache(maxsize=None)
def _controllers():
    jctrl = build_vehicle_controller(
        n_horiz=N_HORIZ, bound_state_constraints=True,
        alm_cfg=AlmConfig(**ALM),
        panoc_cfg=PanocConfig(lbfgs_memory=N_HORIZ, max_iter=150),
        fused="xla")
    f_d = discretize(pacejka_dynamics)

    @jax.jit
    def jstep(ys, carries):
        def one(y, carry):
            out = jctrl.step(carry, {"y0": y, "p": PARAMS, "centerline": CL})
            return f_d(y, out.u0, PARAMS), out.carry, out.u0, out.result
        return jax.vmap(one)(ys, carries)

    tctrl = tmpc.build_vehicle_controller(
        n_horiz=N_HORIZ, bound_state_constraints=True,
        alm_cfg=tconfig.AlmConfig(**ALM),
        panoc_cfg=tconfig.PanocConfig(lbfgs_memory=N_HORIZ, max_iter=150),
        device="cpu")
    return jctrl, jstep, tctrl


@functools.lru_cache(maxsize=None)
def _jax_plain_solve():
    """The same JAX controller on its plain path (the AL objective by
    ``jax.value_and_grad``, no fused fan): one batched solve."""
    ctrl = build_vehicle_controller(
        n_horiz=N_HORIZ, bound_state_constraints=True,
        alm_cfg=AlmConfig(**ALM),
        panoc_cfg=PanocConfig(lbfgs_memory=N_HORIZ, max_iter=150))
    return jax.jit(jax.vmap(lambda y, carry: ctrl.step(
        carry, {"y0": y, "p": PARAMS, "centerline": CL}).result))


def _binding_states():
    """At the road's start, turning at a yaw rate just inside its bound
    (omega^2 <= 0.1) while heading 0.3 rad off the road: the yaw-rate and
    heading constraints bind, and the multipliers and the clip of K3 act."""
    ys = np.zeros((B, 6), np.float32)
    ys[:, 0] = float(CL[0, 0])
    ys[:, 1] = float(CL[0, 1]) + np.array([0.015, -0.01])
    ys[:, 2] = [-0.3, 0.3]
    ys[:, 3] = [0.6, 0.8]
    ys[:, 5] = [-0.31, 0.31]
    return ys


@pytest.mark.parametrize("start", ["ss_n40", "binding"])
def test_constrained_cold_and_warm_steps_match_jax(start):
    # "ss_n40": the path's own initial states, where the constraints hold
    # with room to spare. Flags and outer and inner iteration counts are
    # equal, and
    # the solves agree within the bands of tests/test_fused_psi.py:187-192
    # (the JAX package's fused AL path against its plain one): tracking
    # cost within 2%, feasible to 2e-3, first inputs within 3e-2.
    # "binding": there the float32 ALM path depends on rounding, and the
    # JAX package's own plain and fused paths differ by 3.8% and 9.7% in
    # the tracking cost of the cold step on these two lanes, with other
    # outer and inner iteration counts (test_binding_band_is_jax_own_spread
    # below). So flags, feasibility and first inputs are held as above, the
    # cost within 5%, and the multipliers must be active on both sides.
    jctrl, jstep, tctrl = _controllers()
    assert tctrl.problem.m == 6 * N_HORIZ
    assert tctrl.problem.al_multi is not None
    tcl = centerline_from_numpy(np.array(CL))
    ys = jnp.asarray(ss_n40_states(B) if start == "ss_n40"
                     else _binding_states())
    carries = jax.vmap(lambda _: jctrl.init_carry())(jnp.arange(B))
    for k in range(3):
        t_carry = carry_from_numpy(
            {f: np.asarray(v) for f, v in carries._asdict().items()})
        param = {"y0": torch.as_tensor(np.array(ys)), "p": TVehicleParams(),
                 "centerline": tcl}
        out = tctrl.step(t_carry, param)
        ys, carries, u0, res = jstep(ys, carries)
        r, msg = out.result, f"step {k}"
        np.testing.assert_array_equal(r.converged.numpy(),
                                      np.asarray(res.converged), err_msg=msg)
        assert bool(r.converged.all()), msg
        np.testing.assert_array_equal(out.carry.failures.numpy(),
                                      np.asarray(carries.failures))
        # the carry hands on the solve's penalties (the next solve caps
        # them at sigma_0)
        np.testing.assert_array_equal(out.carry.sigma.numpy(),
                                      r.sigma.numpy())
        # the tracking cost of each solution, both by the same function:
        # the AL objective psi also holds the penalty term, which depends on
        # where each solve left sigma
        cost_t, cost_j = (tctrl.problem.cost(torch.as_tensor(np.array(u)),
                                             param).numpy()
                          for u in (r.u, res.u))
        np.testing.assert_allclose(cost_t, cost_j,
                                   rtol=2e-2 if start == "ss_n40" else 5e-2,
                                   atol=1e-4, err_msg=msg)
        assert float(r.constraint_violation.max()) <= 2e-3, msg
        assert float(np.max(res.constraint_violation)) <= 2e-3, msg
        np.testing.assert_allclose(out.u0.numpy(), np.asarray(u0), rtol=0,
                                   atol=3e-2, err_msg=msg)
        if start == "ss_n40":
            for name in ("outer_iterations", "inner_iterations"):
                np.testing.assert_array_equal(getattr(r, name).numpy(),
                                              np.asarray(getattr(res, name)),
                                              err_msg=f"{msg}: {name}")
        else:
            assert int((r.lam > 0).sum()) > 0 and int((res.lam > 0).sum()) > 0
            assert (r.outer_iterations.numpy() <= ALM["max_iter"]).all()


def test_binding_band_is_jax_own_spread():
    # The witness for the 5% cost band of the "binding" start: there the
    # JAX package's plain path and its fused path, the one the port is held
    # against, differ in the tracking cost of the cold step by more than the
    # 2% band of the ss_n40 start (3.8% and 9.7% on XLA:CPU), and the port
    # differs from the fused path by no more than the plain path does, on
    # each lane.
    jctrl, jstep, tctrl = _controllers()
    ys = jnp.asarray(_binding_states())
    carries = jax.vmap(lambda _: jctrl.init_carry())(jnp.arange(B))
    _, _, _, fused = jstep(ys, carries)
    plain = _jax_plain_solve()(ys, carries)
    param = {"y0": torch.as_tensor(np.array(ys)), "p": TVehicleParams(),
             "centerline": centerline_from_numpy(np.array(CL))}
    port = tctrl.step(carry_from_numpy(
        {f: np.asarray(v) for f, v in carries._asdict().items()}),
        param).result
    assert bool(np.all(fused.converged)) and bool(np.all(plain.converged))
    assert bool(port.converged.all())
    cost_f, cost_p, cost_t = (
        tctrl.problem.cost(torch.as_tensor(np.array(u)), param).numpy()
        for u in (fused.u, plain.u, port.u))
    jax_spread = np.abs(cost_p - cost_f) / np.abs(cost_f)
    port_gap = np.abs(cost_t - cost_f) / np.abs(cost_f)
    assert jax_spread.max() > 2e-2, jax_spread
    assert (port_gap <= jax_spread).all(), (port_gap, jax_spread)
    assert port_gap.max() <= 5e-2
