"""Parity of the port's models, parameters and configuration
(mpc_tpu_torch/models, mpc_tpu_torch/config.py) with the JAX package."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu import config as jconfig
from mpc_tpu.models.bicycle import clip_inputs, pacejka_dynamics, \
    simplified_dynamics
from mpc_tpu.models.integrators import discretize, rollout
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.fused_psi import _params_to_kernel_vec
from mpc_tpu_torch import config as tconfig
from mpc_tpu_torch.convert import vehicle_params_from_numpy
from mpc_tpu_torch.models import bicycle as tbicycle
from mpc_tpu_torch.models import integrators as tintegrators
from mpc_tpu_torch.models.params import VehicleParams as TVehicleParams

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
MODELS = {
    "pacejka": (pacejka_dynamics, tbicycle.pacejka_dynamics, 6),
    "simplified": (simplified_dynamics, tbicycle.simplified_dynamics, 4),
}


def _states_inputs(seed, B, sd, N):
    rng = np.random.default_rng(seed)
    x = np.zeros((B, sd), np.float32)
    x[:, 0] = rng.uniform(-1.0, 1.0, B)
    x[:, 1] = rng.uniform(-1.0, 1.0, B)
    x[:, 2] = rng.uniform(-3.0, 3.0, B)
    x[:, 3] = rng.uniform(0.2, 1.5, B)
    # vy = omega = 0 at the start (as the benchmark's lanes start): the yaw
    # dynamics are stiff (inertia 1.8e-4), and a lane started at omega ~ 1
    # amplifies libm rounding differences past 1e-5 within 12 steps
    us =np.stack([rng.uniform(-1.0, 1.0, (B, N)),
                   rng.uniform(-0.32, 0.32, (B, N))], axis=2).astype(np.float32)
    return x, us


@pytest.mark.parametrize("model", ["pacejka", "simplified"])
def test_discrete_step_and_rollout_match_jax(model):
    f_j, f_t, sd = MODELS[model]
    B, N = 6, 12
    x, us = _states_inputs(0, B, sd, N)
    p_j, p_t = VehicleParams(), TVehicleParams()
    fd_j, fd_t = discretize(f_j), tintegrators.discretize(f_t)

    step_j = jax.jit(jax.vmap(fd_j, in_axes=(0, 0, None)))(
        jnp.asarray(x), jnp.asarray(us[:, 0]), p_j)
    step_t = fd_t(torch.as_tensor(x), torch.as_tensor(us[:, 0]), p_t)
    np.testing.assert_allclose(step_t.numpy(), np.asarray(step_j), **TOL)

    xs_j = jax.vmap(lambda x0, u: rollout(fd_j, x0, u, p_j))(
        jnp.asarray(x), jnp.asarray(us))
    xs_t = tintegrators.rollout(fd_t, torch.as_tensor(x),
                                torch.as_tensor(us), p_t)
    assert xs_t.shape == (B, N, sd)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), **TOL)


@pytest.mark.parametrize("model", ["pacejka", "simplified"])
def test_ode_with_clipped_inputs_matches_jax(model):
    f_j, f_t, sd = MODELS[model]
    x, us = _states_inputs(1, 5, sd, 1)
    u = us[:, 0] * np.float32(3.0)            # beyond the box
    p_j, p_t = VehicleParams(), TVehicleParams()
    ref = jax.vmap(lambda a, b: f_j(a, b, p_j, clip=True))(
        jnp.asarray(x), jnp.asarray(u))
    got = f_t(torch.as_tensor(x), torch.as_tensor(u), p_t, clip=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(
        tbicycle.clip_inputs(torch.as_tensor(u), p_t).numpy(),
        np.asarray(jax.vmap(lambda b: clip_inputs(b, p_j))(jnp.asarray(u))))


def test_kernel_vec_order_matches_jax():
    p_j = dataclasses.replace(VehicleParams(), mass=0.25, cm1=0.4, cr1=0.7,
                              friction=0.3)
    p_t = TVehicleParams(mass=0.25, cm1=0.4, cr1=0.7, friction=0.3)
    np.testing.assert_array_equal(p_t.to_kernel_vec().numpy(),
                                  np.asarray(_params_to_kernel_vec(p_j))[0])
    np.testing.assert_array_equal(p_t.to_vector().numpy(),
                                  np.asarray(p_j.to_vector()))
    leaves = {f.name: np.asarray(getattr(p_j, f.name))
              for f in dataclasses.fields(p_j)}
    assert vehicle_params_from_numpy(leaves) == p_t


@pytest.mark.parametrize("name", ["PanocConfig", "AlmConfig", "MpcConfig"])
def test_config_defaults_match_jax(name):
    ref, port = getattr(jconfig, name)(), getattr(tconfig, name)()
    ref_fields = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    port_fields = {f.name: getattr(port, f.name)
                   for f in dataclasses.fields(port)}
    assert port_fields == ref_fields
