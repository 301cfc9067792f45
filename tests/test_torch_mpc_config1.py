"""Parity of the port's kinematic-bicycle controller (config 1:
``build_vehicle_controller(model="simplified")``, whose candidate fan is K2)
with the JAX package, over one cold and five warm MPC steps at B=4, N=6.

Before every step the JAX carry is carried across with
``convert.carry_from_numpy``, so both controllers start each step from the
same warm start. A file of its own: compiling the JAX controller takes most
of its time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.control.mpc import build_vehicle_controller
from mpc_tpu.models.bicycle import simplified_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.road import straight_centerline
from mpc_tpu_torch import config as tconfig
from mpc_tpu_torch.bench import config1_states
from mpc_tpu_torch.control import mpc as tmpc
from mpc_tpu_torch.convert import carry_from_numpy, centerline_from_numpy
from mpc_tpu_torch.models.params import VehicleParams as TVehicleParams

torch.set_num_threads(1)


@pytest.mark.parametrize("max_iter", [200, 15])
def test_config1_cold_and_warm_steps_match_jax(max_iter):
    # Config 1's solver (examples/bench_suite.py:116-128) at N=6: eps=1e-4,
    # L-BFGS memory N; max_iter 200 as there, and 15, where some lanes stop
    # at the cap, fail, and are reset to the cold sentinels (sigma = gamma =
    # 0) for their next step.
    B, n_horiz, eps = 4, 6, 1e-4
    jctrl = build_vehicle_controller(
        n_horiz=n_horiz, model="simplified", alm_cfg=AlmConfig(eps=eps),
        panoc_cfg=PanocConfig(lbfgs_memory=n_horiz, max_iter=max_iter),
        fused="xla")
    tctrl = tmpc.build_vehicle_controller(
        n_horiz=n_horiz, model="simplified", alm_cfg=tconfig.AlmConfig(eps=eps),
        panoc_cfg=tconfig.PanocConfig(lbfgs_memory=n_horiz,
                                      max_iter=max_iter), device="cpu")
    assert tctrl.problem.m == 0 and tctrl.problem.al_multi is None
    cl = straight_centerline(100)
    tcl = centerline_from_numpy(np.array(cl))
    params, f_d = VehicleParams(), discretize(simplified_dynamics)

    @jax.jit
    def jstep(ys, carries):
        def one(y, carry):
            out = jctrl.step(carry, {"y0": y, "p": params, "centerline": cl})
            return f_d(y, out.u0, params), out.carry, out.u0, out.result
        return jax.vmap(one)(ys, carries)

    ys = jnp.asarray(config1_states(B))
    carries = jax.vmap(lambda _: jctrl.init_carry())(jnp.arange(B))
    failed = 0
    for k in range(6):
        t_carry = carry_from_numpy(
            {f: np.asarray(v) for f, v in carries._asdict().items()})
        out = tctrl.step(t_carry, {"y0": torch.as_tensor(np.array(ys)),
                                   "p": TVehicleParams(), "centerline": tcl})
        ys, carries, u0, res = jstep(ys, carries)
        msg = f"step {k}"
        conv = np.asarray(res.converged)
        np.testing.assert_array_equal(out.result.converged.numpy(), conv,
                                      err_msg=msg)
        # the cold reset: a lane that did not converge hands on gamma = 0
        np.testing.assert_array_equal(out.carry.gamma.numpy() == 0,
                                      np.asarray(carries.gamma) == 0,
                                      err_msg=msg)
        np.testing.assert_array_equal(out.carry.failures.numpy(),
                                      np.asarray(carries.failures),
                                      err_msg=msg)
        failed += int((~conv).sum())
        # Iteration counts: equal where both stop at the cap. On converged
        # lanes the two fans round differently (XLA's and PyTorch's sin,
        # cos and reduction orders), which can move the L-BFGS path by a
        # few iterations; a lane that exits by stalling is not compared.
        it_t = out.result.inner_iterations.numpy()
        it_j = np.asarray(res.inner_iterations)
        capped = it_j == max_iter
        np.testing.assert_array_equal(it_t[capped], it_j[capped], err_msg=msg)
        assert (np.abs(it_t - it_j)[conv] <= 2 + 0.35 * it_j[conv]).all(), msg
        np.testing.assert_allclose(out.result.psi.numpy()[conv],
                                   np.asarray(res.psi)[conv], rtol=1e-3,
                                   atol=1e-5, err_msg=msg)
        np.testing.assert_allclose(out.u0.numpy(), np.asarray(u0), rtol=0,
                                   atol=5e-3, err_msg=msg)
    if max_iter == 15:
        assert failed > 0                   # the cold reset was exercised
    else:
        assert failed <= 1                  # one cold lane stalls at N=6
