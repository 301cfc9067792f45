"""Cold reset of the port's state-constrained controller against the JAX
package: with ``AlmConfig.max_iter = 1`` a cold lane cannot converge, since
its single outer iteration runs at ``eps_0 > eps``, while a warm lane can.
The failed lane's penalties and step size are reset to the cold sentinel
(``mpc_tpu/control/mpc.py:114-126``), so it starts cold, and fails, again
on the next step.

B=2, N=4 on the lane-change road of the ss_n40 path, its own initial
states; a file of its own because it compiles a JAX controller of its own
(XLA:CPU, about a minute at N=4).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
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
# the ss_n40 solver settings (examples/exp_ms.py:113-117) with one outer
# iteration
ALM = dict(eps=1e-3, delta=1e-3, max_iter=1, eps_0=1e-2, sigma_0=1e3)
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


def test_failed_constrained_lane_is_reset_cold_as_in_jax():
    jctrl, jstep, tctrl = _controllers()
    tcl = centerline_from_numpy(np.array(CL))
    ys = jnp.asarray(ss_n40_states(B))
    carries = jax.vmap(lambda _: jctrl.init_carry())(jnp.arange(B))
    # lane 0 warm: every penalty at sigma_0 (> 0), zero inputs and
    # multipliers; lane 1 at the cold sentinel (sigma = 0)
    carries = carries._replace(
        sigma=carries.sigma.at[0].set(ALM["sigma_0"]))
    for k in range(2):
        t_carry = carry_from_numpy(
            {f: np.asarray(v) for f, v in carries._asdict().items()})
        param = {"y0": torch.as_tensor(np.array(ys)), "p": TVehicleParams(),
                 "centerline": tcl}
        out = tctrl.step(t_carry, param)
        ys, carries, u0, res = jstep(ys, carries)
        r, c, msg = out.result, out.carry, f"step {k}"
        np.testing.assert_array_equal(np.asarray(res.converged),
                                      [True, False], err_msg=msg)
        np.testing.assert_array_equal(r.converged.numpy(),
                                      np.asarray(res.converged), err_msg=msg)
        for name in ("outer_iterations", "inner_iterations",
                     "inner_convergence_failures"):
            np.testing.assert_array_equal(getattr(r, name).numpy(),
                                          np.asarray(getattr(res, name)),
                                          err_msg=f"{msg}: {name}")
        np.testing.assert_array_equal(c.failures.numpy(),
                                      np.asarray(carries.failures))
        np.testing.assert_array_equal(c.failures.numpy(), [0, k + 1])
        # the failed lane's carry is back at the cold sentinel on both
        # sides; the converged lane hands on its solve's penalties
        assert float(c.sigma[1].abs().max()) == 0.0, msg
        assert float(jnp.max(jnp.abs(carries.sigma[1]))) == 0.0, msg
        np.testing.assert_array_equal(c.gamma.numpy(),
                                      np.asarray(carries.gamma), err_msg=msg)
        np.testing.assert_allclose(c.sigma.numpy(), np.asarray(carries.sigma),
                                   rtol=1e-6, err_msg=msg)
        np.testing.assert_array_equal(c.sigma[0].numpy(), r.sigma[0].numpy())
        np.testing.assert_allclose(out.u0.numpy(), np.asarray(u0), rtol=0,
                                   atol=3e-2, err_msg=msg)
