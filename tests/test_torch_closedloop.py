"""Parity of the port's closed loop (mpc_tpu_torch/sim/closedloop.py) with the
JAX package's ``run_closed_loop``, on the fused path (the candidate fan
through ``fan_value_and_grad``, whose plain version runs on the CPU).

A file of its own: compiling the JAX closed loop takes most of its time, and
a separate file lets that run beside the controller test on another worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.control.mpc import build_vehicle_controller
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.road import straight_centerline
from mpc_tpu.sim.closedloop import run_closed_loop
from mpc_tpu_torch import config as tconfig
from mpc_tpu_torch.bench import initial_states
from mpc_tpu_torch.control import mpc as tmpc
from mpc_tpu_torch.convert import centerline_from_numpy
from mpc_tpu_torch.models import bicycle as tbicycle
from mpc_tpu_torch.models import integrators as tintegrators
from mpc_tpu_torch.models.params import VehicleParams as TVehicleParams
from mpc_tpu_torch.sim.closedloop import run_closed_loop as trun_closed_loop

torch.set_num_threads(1)


def test_closed_loop_matches_jax():
    # 20 closed-loop steps at eps=1e-5: plant states within 1e-3. The JAX
    # side takes the plain per-lane path (the same mathematics as its fused
    # XLA path), which compiles in about half the time on XLA:CPU.
    B, n_horiz, n_sim, eps, max_iter = 2, 4, 20, 1e-5, 200
    params, tparams = VehicleParams(), TVehicleParams()
    jctrl = build_vehicle_controller(
        n_horiz=n_horiz, alm_cfg=AlmConfig(eps=eps),
        panoc_cfg=PanocConfig(lbfgs_memory=n_horiz, max_iter=max_iter))
    tctrl = tmpc.build_vehicle_controller(
        n_horiz=n_horiz, alm_cfg=tconfig.AlmConfig(eps=eps),
        panoc_cfg=tconfig.PanocConfig(lbfgs_memory=n_horiz,
                                      max_iter=max_iter))
    cl = straight_centerline(100)
    y0 = initial_states(B, 1)
    f_d = discretize(pacejka_dynamics)
    ref = jax.jit(jax.vmap(lambda y: run_closed_loop(
        jctrl, f_d, y, {"p": params, "centerline": cl}, n_sim, params)))(
            jnp.asarray(y0))

    tf_d = tintegrators.discretize(tbicycle.pacejka_dynamics)
    out = trun_closed_loop(
        tctrl, tf_d, torch.as_tensor(y0),
        {"p": tparams, "centerline": centerline_from_numpy(cl)},
        n_sim, tparams)
    assert out.ys.shape == (B, n_sim, 6)
    assert bool(torch.isfinite(out.ys).all())
    np.testing.assert_allclose(out.ys.numpy(), np.asarray(ref.ys), rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(ref.converged))
