"""Parity of the port's candidate fan (mpc_tpu_torch/ops/fused_psi.py) with
the JAX package: the plain PyTorch version against the fused XLA evaluator,
against the per-lane ``vmap(value_and_grad(problem.cost))`` and against the
Pallas kernel in interpret mode; the hand-written adjoint against autograd;
and the wrapper's checks. The CUDA kernel itself is held against the plain
version in tests/test_torch_cuda.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.control.mpc import build_vehicle_ocp
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.fused_psi import make_vehicle_cost_multi
from mpc_tpu.ops.road import circle_centerline, straight_centerline
from mpc_tpu_torch.models.params import VehicleParams as TVehicleParams
from mpc_tpu_torch.ops import fused_psi as tfp
from mpc_tpu_torch.ops.costs import DEFAULT_VEHICLE_WEIGHTS

torch.set_num_threads(1)

PARAMS = VehicleParams()
# the bar of tests/test_fused_psi.py:52-53
PSI_TOL = dict(rtol=2e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def _inputs(seed, B, K, n_horiz):
    rng = np.random.default_rng(seed)
    cands = rng.uniform(-0.3, 1.0, (B, K, n_horiz * 2)).astype(np.float32)
    y0 = np.zeros((B, 6), np.float32)
    y0[:, 0] = rng.uniform(-0.1, 0.5, B)
    y0[:, 1] = rng.uniform(-0.1, 0.1, B)
    y0[:, 2] = rng.uniform(-0.3, 0.3, B)
    y0[:, 3] = rng.uniform(0.2, 1.0, B)
    return cands, y0


def _road(kind):
    # both roads pass through the origin heading along +x, where the lanes
    # start (the circle of radius 5 about (0, 5) at its lowest point)
    # both roads have 50 points, so each jitted JAX reference below
    # compiles once for the module
    return straight_centerline(50) if kind == "straight" \
        else circle_centerline(50)


@functools.lru_cache(maxsize=None)
def _jax_fused_xla(n_horiz):
    multi = make_vehicle_cost_multi(n_horiz, backend="xla")
    return jax.jit(jax.vmap(multi, in_axes=(0, 0, None, None)))


@functools.lru_cache(maxsize=None)
def _jax_per_lane(n_horiz):
    problem = build_vehicle_ocp(n_horiz=n_horiz)

    def ref(u, y, cl):
        return jax.value_and_grad(problem.cost)(
            u, {"y0": y, "p": PARAMS, "centerline": cl})

    return jax.jit(jax.vmap(jax.vmap(ref, in_axes=(0, None, None)),
                            in_axes=(0, 0, None)))


def _port_fan(cands, y0, cl, n_horiz, substeps=4, ts=0.05, p=None):
    """The port's fan on numpy inputs: (psi (B, K), grad (B, K, n))."""
    p = TVehicleParams() if p is None else p
    cltab, pvec = tfp.fan_params(torch.as_tensor(np.array(cl)), p)
    multi = tfp.make_vehicle_cost_multi(n_horiz, ts=ts, substeps=substeps)
    psi, grad = multi(torch.as_tensor(cands), torch.as_tensor(y0), cltab, pvec)
    return psi.numpy(), grad.numpy()


@pytest.mark.parametrize("road", ["straight", "circle"])
def test_plain_fan_matches_jax_fused_xla(road):
    n_horiz, B, K = 8, 5, 3
    cl = _road(road)
    cands, y0 = _inputs(0, B, K, n_horiz)
    ref_psi, ref_grad = _jax_fused_xla(n_horiz)(
        jnp.asarray(cands), jnp.asarray(y0), cl, PARAMS)
    psi, grad = _port_fan(cands, y0, cl, n_horiz)
    np.testing.assert_allclose(psi, np.asarray(ref_psi), **PSI_TOL)
    np.testing.assert_allclose(grad, np.asarray(ref_grad), **GRAD_TOL)


@pytest.mark.parametrize("road", ["straight", "circle"])
def test_plain_fan_matches_jax_per_lane(road):
    n_horiz, B, K = 8, 5, 3
    cl = _road(road)
    cands, y0 = _inputs(1, B, K, n_horiz)
    ref_psi, ref_grad = _jax_per_lane(n_horiz)(
        jnp.asarray(cands), jnp.asarray(y0), cl)
    psi, grad = _port_fan(cands, y0, cl, n_horiz)
    np.testing.assert_allclose(psi, np.asarray(ref_psi), **PSI_TOL)
    np.testing.assert_allclose(grad, np.asarray(ref_grad), **GRAD_TOL)


def test_plain_fan_matches_pallas_interpret_minimal():
    # The JAX Pallas kernel in interpret mode, as
    # tests/test_fused_psi.py::test_fused_pallas_interpret_gradient_parity_minimal
    # runs it: N=2, substeps=1, non-default physical parameters. The Pallas
    # kernel uses a polynomial arctan, hence that test's looser tolerance.
    from jax.experimental.pallas import tpu as pltpu

    n_horiz = 2
    cl = straight_centerline(12)
    cands, y0 = _inputs(4, 1, 1, n_horiz)
    p_run = dataclasses.replace(PARAMS, mass=0.25, cm1=0.4)
    pal = make_vehicle_cost_multi(n_horiz, substeps=1, backend="pallas",
                                  block_e=1)
    with pltpu.force_tpu_interpret_mode():
        psi_p, grad_p = pal(jnp.asarray(cands[0]), jnp.asarray(y0[0]), cl,
                            p_run)
    psi, grad = _port_fan(cands, y0, cl, n_horiz, substeps=1,
                          p=TVehicleParams(mass=0.25, cm1=0.4))
    np.testing.assert_allclose(psi[0], np.asarray(psi_p), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(grad[0], np.asarray(grad_p), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("road", ["straight", "circle"])
def test_adjoint_transcription_matches_autograd(road):
    # The algorithm of csrc/fused_psi.cu, in batched torch, against the
    # plain version's autograd gradient.
    n_horiz, E = 6, 9
    cl = _road(road)
    cands, y0 = _inputs(5, E, 1, n_horiz)
    u, y0t = torch.as_tensor(cands[:, 0]), torch.as_tensor(y0)
    p = TVehicleParams(mass=0.2, cm1=0.3, df=3.0)
    cltab, pvec = tfp.fan_params(torch.as_tensor(np.array(cl)), p)
    args = (cltab, pvec, n_horiz, 4, 0.0125, 1.0, DEFAULT_VEHICLE_WEIGHTS)
    psi_ref, grad_ref = tfp.fan_value_and_grad_reference(u, y0t, *args)
    psi, grad = tfp._fan_adjoint_transcription(u, y0t, *args)
    np.testing.assert_allclose(psi.numpy(), psi_ref.numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(grad.numpy(), grad_ref.numpy(), rtol=2e-5,
                               atol=2e-6)


def test_make_cltab_matches_jax():
    from mpc_tpu.ops.fused_psi import make_cltab
    cl = circle_centerline(30)
    got = tfp.make_cltab(torch.as_tensor(np.array(cl)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(make_cltab(cl)))


def test_wrapper_checks_inputs_and_uses_plain_version_on_cpu():
    n_horiz, E = 3, 4
    cands, y0 = _inputs(6, E, 1, n_horiz)
    u, y0t = torch.as_tensor(cands[:, 0]), torch.as_tensor(y0)
    cltab, pvec = tfp.fan_params(torch.as_tensor(np.array(
        straight_centerline(20))), TVehicleParams())
    args = (n_horiz, 4, 0.0125, 1.0)
    before = tfp.fan_value_and_grad.launches
    psi, grad = tfp.fan_value_and_grad(u, y0t, cltab, pvec, *args)
    psi_r, grad_r = tfp.fan_value_and_grad_reference(
        u, y0t, cltab, pvec, *args, DEFAULT_VEHICLE_WEIGHTS)
    assert tfp.fan_value_and_grad.launches == before   # no kernel on the CPU
    np.testing.assert_array_equal(psi.numpy(), psi_r.numpy())
    np.testing.assert_array_equal(grad.numpy(), grad_r.numpy())
    with pytest.raises(TypeError):
        tfp.fan_value_and_grad(u.double(), y0t, cltab, pvec, *args)
    with pytest.raises(ValueError):
        tfp.fan_value_and_grad(u[:, :-1], y0t, cltab, pvec, *args)
    with pytest.raises(ValueError):
        tfp.fan_value_and_grad(u.t().contiguous().t(), y0t, cltab, pvec, *args)
    with pytest.raises(ValueError):
        tfp.fan_value_and_grad(u, y0t[:, :4], cltab, pvec, *args)


def _out_of_box(seed, E, n_horiz):
    # candidates far outside the solver's box (|d| <= 1, |delta| <= 0.32),
    # from standstill up: some lanes brake to vx ~ 0 or spin round, where the
    # gradient is ill-conditioned in float32
    rng = np.random.default_rng(seed)
    u = np.empty((E, 2 * n_horiz), np.float32)
    u[:, 0::2] = rng.uniform(-1.5, 1.5, (E, n_horiz))
    u[:, 1::2] = rng.uniform(-1.0, 1.0, (E, n_horiz))
    y0 = np.zeros((E, 6), np.float32)
    y0[:, 0] = rng.uniform(-0.1, 0.5, E)
    y0[:, 1] = rng.uniform(-0.1, 0.1, E)
    y0[:, 2] = rng.uniform(-0.3, 0.3, E)
    y0[:, 3] = rng.uniform(0.0, 1.0, E)
    return torch.as_tensor(u), torch.as_tensor(y0)


@pytest.mark.parametrize("road", ["straight", "circle"])
def test_fan_check_passes_the_kernel_algorithm_out_of_box(road):
    # The kernel's algorithm (the adjoint transcription) through the check
    # chip_smoke.py and the on-card tests apply: lanes beyond the bar occur
    # far outside the box, and each is one the plain f32 version cannot
    # evaluate to the bar either.
    from mpc_tpu_torch.kernels.check import compare_fan
    n_horiz, E = 12, 600
    u, y0 = _out_of_box(7, E, n_horiz)
    cltab, pvec = tfp.fan_params(torch.as_tensor(np.array(_road(road))),
                                 TVehicleParams())
    args = (n_horiz, 4, 0.0125, 1.0, DEFAULT_VEHICLE_WEIGHTS)
    psi, grad = tfp._fan_adjoint_transcription(u, y0, cltab, pvec, *args)
    r = compare_fan(psi, grad, u, y0, cltab, pvec, *args, PSI_TOL, GRAD_TOL,
                    chunk=256)
    assert r["lanes"] == E and r["failed"] == 0, r
    assert r["excused"] == r["beyond_bar"] <= E // 20, r


def test_fan_check_catches_a_wrong_gradient():
    from mpc_tpu_torch.kernels.check import compare_fan
    n_horiz, E = 6, 64
    cands, y0 = _inputs(8, E, 1, n_horiz)
    u, y0t = torch.as_tensor(cands[:, 0]), torch.as_tensor(y0)
    cltab, pvec = tfp.fan_params(torch.as_tensor(np.array(_road("circle"))),
                                 TVehicleParams())
    args = (n_horiz, 4, 0.0125, 1.0, DEFAULT_VEHICLE_WEIGHTS)
    psi, grad = tfp.fan_value_and_grad_reference(u, y0t, cltab, pvec, *args)
    ok = compare_fan(psi, grad, u, y0t, cltab, pvec, *args, PSI_TOL, GRAD_TOL)
    assert ok["beyond_bar"] == 0 and ok["max_abs_err_grad"] == 0.0, ok
    bad = grad.clone()
    bad[::2, 3] *= 1.01
    r = compare_fan(psi, bad, u, y0t, cltab, pvec, *args, PSI_TOL, GRAD_TOL)
    assert r["failed"] == E // 2, r
