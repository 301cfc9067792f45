"""Parity of the port's K2 and K3 fans (mpc_tpu_torch/ops/fused_psi.py) with
the JAX package: K2, the kinematic-bicycle fan (``model="simplified"``), and
K3, the Pacejka fan with the augmented-Lagrangian penalty of the bounded
state constraints. The plain PyTorch versions against the fused XLA
evaluators and against the Pallas kernel in interpret mode; the kernels'
algorithm (the phased kernel of csrc/fused_psi.cu, transcribed into batched
torch) against autograd; the wrappers' CPU path and the kernel check on both
variants. The CUDA kernels themselves
are held against the plain versions in tests/test_torch_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.fused_psi import make_vehicle_al_multi, make_vehicle_cost_multi
from mpc_tpu.ops.road import circle_centerline, straight_centerline
from mpc_tpu_torch.kernels.check import compare_fan
from mpc_tpu_torch.models.params import VehicleParams as TVehicleParams
from mpc_tpu_torch.ops import fused_psi as tfp
from mpc_tpu_torch.ops.costs import DEFAULT_VEHICLE_WEIGHTS

torch.set_num_threads(1)

PARAMS = VehicleParams()
OFFSETS = (20.0, 1.0, 1.0, 2.0, 1.0, 0.1)
# K2: the bar of tests/test_fused_psi.py:52-53; K3: that of
# tests/test_fused_psi.py:162-163 (the AL variant against its per-lane form)
K2_PSI_TOL, K2_GRAD_TOL = dict(rtol=2e-5, atol=1e-6), dict(rtol=2e-4, atol=2e-5)
K3_PSI_TOL, K3_GRAD_TOL = dict(rtol=2e-5, atol=1e-5), dict(rtol=2e-4, atol=3e-4)


def _road(kind, size=50):
    # both roads pass through the origin heading along +x, where lanes start
    return straight_centerline(size) if kind == "straight" \
        else circle_centerline(size)


def _inputs(seed, B, K, n_horiz, sd):
    rng = np.random.default_rng(seed)
    cands = rng.uniform(-0.3, 1.0, (B, K, n_horiz * 2)).astype(np.float32)
    y0 = np.zeros((B, sd), np.float32)
    y0[:, 0] = rng.uniform(-0.1, 0.5, B)
    y0[:, 1] = rng.uniform(-0.1, 0.1, B)
    y0[:, 2] = rng.uniform(-0.3, 0.3, B)
    y0[:, 3] = rng.uniform(0.2, 1.0, B)
    return cands, y0


def _al(seed, B, n_horiz, sigma_range=(10.0, 1e3)):
    """Multipliers in [0, 2] and penalties in ``sigma_range`` (by default
    as tests/test_fused_psi.py:142-143), for the bounds x^2 - off <= 0."""
    rng = np.random.default_rng(seed + 100)
    m = 6 * n_horiz
    lam = rng.uniform(0.0, 2.0, (B, m)).astype(np.float32)
    sigma = rng.uniform(*sigma_range, (B, m)).astype(np.float32)
    return lam, sigma, np.full(m, -np.inf, np.float32), np.zeros(m, np.float32)


def _tables(cl, p=None):
    return tfp.fan_params(torch.as_tensor(np.array(cl)),
                          TVehicleParams() if p is None else p)


@functools.lru_cache(maxsize=None)
def _jax_kin_xla(n_horiz):
    multi = make_vehicle_cost_multi(n_horiz, model="simplified", backend="xla")
    return jax.jit(jax.vmap(multi, in_axes=(0, 0, None, None)))


@functools.lru_cache(maxsize=None)
def _jax_al_xla(n_horiz):
    m = 6 * n_horiz
    multi = make_vehicle_al_multi(n_horiz, OFFSETS, np.full(m, -np.inf),
                                  np.zeros(m), backend="xla")
    return jax.jit(jax.vmap(multi, in_axes=(0, 0, None, None, 0, 0)))


def _port_kin(cands, y0, cl, n_horiz, substeps=4):
    cltab, pvec = _tables(cl)
    multi = tfp.make_vehicle_cost_multi(n_horiz, substeps=substeps,
                                        model="simplified")
    psi, grad = multi(torch.as_tensor(cands), torch.as_tensor(y0), cltab,
                      pvec)
    return psi.numpy(), grad.numpy()


def _port_al(cands, y0, cl, n_horiz, lam, sigma, d_lo, d_up, substeps=4):
    cltab, pvec = _tables(cl)
    multi = tfp.make_vehicle_al_multi(n_horiz, OFFSETS, d_lo, d_up,
                                      substeps=substeps)
    psi, grad = multi(torch.as_tensor(cands), torch.as_tensor(y0), cltab,
                      pvec, torch.as_tensor(lam), torch.as_tensor(sigma))
    return psi.numpy(), grad.numpy()


@pytest.mark.parametrize("road", ["straight", "circle"])
def test_kin_plain_fan_matches_jax_fused_xla(road):
    n_horiz, B, K = 8, 5, 3
    cl = _road(road)
    cands, y0 = _inputs(0, B, K, n_horiz, 4)
    y0[0, 3] = 0.0                                  # one lane at standstill
    ref_psi, ref_grad = _jax_kin_xla(n_horiz)(jnp.asarray(cands),
                                              jnp.asarray(y0), cl, PARAMS)
    psi, grad = _port_kin(cands, y0, cl, n_horiz)
    np.testing.assert_allclose(psi, np.asarray(ref_psi), **K2_PSI_TOL)
    np.testing.assert_allclose(grad, np.asarray(ref_grad), **K2_GRAD_TOL)


@pytest.mark.parametrize("road", ["straight", "circle"])
def test_al_plain_fan_matches_jax_fused_xla(road):
    n_horiz, B, K = 6, 4, 3
    cl = _road(road)
    cands, y0 = _inputs(1, B, K, n_horiz, 6)
    lam, sigma, d_lo, d_up = _al(1, B, n_horiz)
    ref_psi, ref_grad = _jax_al_xla(n_horiz)(
        jnp.asarray(cands), jnp.asarray(y0), cl, PARAMS, jnp.asarray(lam),
        jnp.asarray(sigma))
    psi, grad = _port_al(cands, y0, cl, n_horiz, lam, sigma, d_lo, d_up)
    np.testing.assert_allclose(psi, np.asarray(ref_psi), **K3_PSI_TOL)
    # plus float32 rounding at the lane's scale (1e-6 of its largest entry,
    # about 8 ulp): the penalties make entries of 1e4-1e5 beside entries of
    # order 1, and the two frameworks sum the stages' terms in other orders
    ref_grad = np.asarray(ref_grad)
    lane = np.abs(ref_grad).max(axis=2, keepdims=True)
    assert (np.abs(grad - ref_grad) <= K3_GRAD_TOL["atol"] + 1e-6 * lane
            + K3_GRAD_TOL["rtol"] * np.abs(ref_grad)).all()
    # the clip is active on some constraints (the penalty adds to the
    # tracking cost) and not on others
    cltab, pvec = _tables(cl)
    cost, _ = tfp.make_vehicle_cost_multi(n_horiz)(
        torch.as_tensor(cands), torch.as_tensor(y0), cltab, pvec)
    assert (psi > cost.numpy()).all()
    assert 0.0 < _active_share(cands, y0, cltab, pvec, n_horiz, lam,
                               sigma) < 1.0


def _active_share(cands, y0, cltab, pvec, n_horiz, lam, sigma):
    """Share of (lane, constraint) pairs where zeta = x^2 - off + lam/sigma
    lies above the bound 0, i.e. where the clip is active."""
    B, K, n = cands.shape
    u = torch.as_tensor(cands.reshape(B * K, n))
    al = (torch.as_tensor(np.repeat(lam, K, 0)),
          torch.as_tensor(np.repeat(sigma, K, 0)), torch.tensor(OFFSETS),
          torch.full((lam.shape[1],), -float("inf")),
          torch.zeros(lam.shape[1]))
    x = tuple(torch.as_tensor(np.repeat(y0, K, 0)).unbind(1))
    p = tfp._Params(pvec)
    active = []
    for k in range(n_horiz):
        x = tfp._rk4_substeps(tfp._pacejka_deriv, x, u[:, 2 * k],
                              u[:, 2 * k + 1], p, 0.0125, 4)
        active += [r > 0 for _, r in tfp._al_residuals(x, k, al)]
    return float(torch.stack(active).float().mean())


@pytest.mark.parametrize("variant", ["kin", "al"])
def test_plain_fan_matches_pallas_interpret_minimal(variant):
    # The JAX Pallas kernel in interpret mode, as
    # tests/test_fused_psi.py::test_fused_pallas_interpret_gradient_parity_minimal
    # runs it: N=2, substeps=1, block_e=1. The Pallas kernel uses a
    # polynomial arctan, hence that test's looser tolerance; for K3 the
    # gradient's error scales with the penalties, so it is held relative to
    # the largest entry.
    from jax.experimental.pallas import tpu as pltpu

    n_horiz, K = 2, 1
    cl = straight_centerline(12)
    sd = 4 if variant == "kin" else 6
    cands, y0 = _inputs(4, 1, K, n_horiz, sd)
    if variant == "kin":
        pal = make_vehicle_cost_multi(n_horiz, substeps=1, model="simplified",
                                      backend="pallas", block_e=1)
        with pltpu.force_tpu_interpret_mode():
            psi_p, grad_p = pal(jnp.asarray(cands[0]), jnp.asarray(y0[0]),
                                cl, PARAMS)
        psi, grad = _port_kin(cands, y0, cl, n_horiz, substeps=1)
        grad_atol = 1e-4
    else:
        # penalties in [1, 10]: the error of the Pallas kernel's polynomial
        # arctan grows with them (against the JAX package's own XLA
        # evaluator too: 6e-4 of psi with penalties up to 1e3 and 3 lanes)
        lam, sigma, d_lo, d_up = _al(4, 1, n_horiz, sigma_range=(1.0, 10.0))
        pal = make_vehicle_al_multi(n_horiz, OFFSETS, d_lo, d_up, substeps=1,
                                    backend="pallas", block_e=1)
        with pltpu.force_tpu_interpret_mode():
            psi_p, grad_p = pal(jnp.asarray(cands[0]), jnp.asarray(y0[0]),
                                cl, PARAMS, jnp.asarray(lam[0]),
                                jnp.asarray(sigma[0]))
        psi, grad = _port_al(cands, y0, cl, n_horiz, lam, sigma, d_lo, d_up,
                             substeps=1)
        grad_atol = 1e-3 * float(np.abs(np.asarray(grad_p)).max())
    np.testing.assert_allclose(psi[0], np.asarray(psi_p), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(grad[0], np.asarray(grad_p), rtol=1e-3,
                               atol=grad_atol)


def _flat(variant, seed, E, n_horiz, cl):
    """Inputs of one wrapper call: ``(u, y0, cltab, pvec, model, al)``."""
    sd = 4 if variant == "kin" else 6
    cands, y0 = _inputs(seed, E, 1, n_horiz, sd)
    cltab, pvec = _tables(cl, TVehicleParams(mass=0.2, cm1=0.3, df=3.0))
    al = None
    if variant == "al":
        lam, sigma, d_lo, d_up = _al(seed, E, n_horiz)
        al = (torch.as_tensor(lam), torch.as_tensor(sigma),
              torch.tensor(OFFSETS), torch.as_tensor(d_lo),
              torch.as_tensor(d_up))
    return (torch.as_tensor(cands[:, 0]), torch.as_tensor(y0), cltab, pvec,
            "simplified" if variant == "kin" else "pacejka", al)


@pytest.mark.parametrize("variant", ["kin", "al"])
@pytest.mark.parametrize("road", ["straight", "circle"])
def test_adjoint_transcription_matches_autograd(variant, road):
    # The kernels' algorithm in batched torch (the phased kernel), against
    # the plain version's autograd gradient. The kinematic lanes include a
    # car at standstill with no drive, whose speed stays exactly 0, where
    # d|v|/dv = sign(0) = 0.
    n_horiz, E = 6, 9
    u, y0, cltab, pvec, model, al = _flat(variant, 5, E, n_horiz,
                                          _road(road))
    if variant == "kin":
        y0[:3, 3] = 0.0
        u[:3, 0::2] = 0.0
    args = (cltab, pvec, n_horiz, 4, 0.0125, 1.0, DEFAULT_VEHICLE_WEIGHTS)
    psi_ref, grad_ref = tfp.fan_value_and_grad_reference(u, y0, *args,
                                                         model=model, al=al)
    psi, grad = tfp._fan_phased_transcription(u, y0, *args, model=model,
                                              al=al)
    np.testing.assert_allclose(psi.numpy(), psi_ref.numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(grad.numpy(), grad_ref.numpy(), rtol=2e-5,
                               atol=2e-6)
    if variant == "kin":
        assert float(grad_ref[:3].abs().max()) > 0.0   # steering still acts


@pytest.mark.parametrize("variant", ["kin", "al"])
def test_wrapper_uses_plain_version_on_cpu(variant):
    n_horiz, E = 3, 4
    u, y0, cltab, pvec, model, al = _flat(variant, 6, E, n_horiz,
                                          straight_centerline(20))
    args = (n_horiz, 4, 0.0125, 1.0)
    wrapper = tfp.kin_fan_value_and_grad if variant == "kin" \
        else tfp.al_fan_value_and_grad
    before = wrapper.launches
    psi, grad = wrapper(u, y0, cltab, pvec, *(al or ()), *args)
    assert wrapper.launches == before            # no kernel on the CPU
    psi_r, grad_r = tfp.fan_value_and_grad_reference(
        u, y0, cltab, pvec, *args, DEFAULT_VEHICLE_WEIGHTS, model=model, al=al)
    np.testing.assert_array_equal(psi.numpy(), psi_r.numpy())
    np.testing.assert_array_equal(grad.numpy(), grad_r.numpy())
    # the state dimension is the model's; the AL operands are checked too
    with pytest.raises(ValueError):
        wrapper(u, torch.zeros((E, 5)), cltab, pvec, *(al or ()), *args)
    if al is not None:
        with pytest.raises(ValueError, match="sigma"):
            wrapper(u, y0, cltab, pvec, al[0], al[1][:, :-1], *al[2:], *args)


@pytest.mark.parametrize("variant", ["kin", "al"])
def test_fan_check_on_the_kernel_algorithm(variant):
    # The kernel's algorithm (its batched transcription) through the check
    # chip_smoke.py applies, out of the box for the kinematic model (|delta|
    # up to 1.4, where tan(delta) is large): nothing fails; a gradient
    # perturbed by 1% fails on every lane it touches, at the lane's largest
    # entry and at a small one (2%): the smallest entry of at least 1e-3 of
    # the lane's largest, and the last stage's steering entry wherever it is
    # that large. A bar relative to the lane's largest entry alone (2e-4 of
    # it) would pass the small ones.
    n_horiz, E = 8, 64
    u, y0, cltab, pvec, model, al = _flat(variant, 7, E, n_horiz,
                                          _road("circle"))
    if variant == "kin":
        rng = np.random.default_rng(8)
        u[:, 1::2] = torch.as_tensor(
            rng.uniform(-1.4, 1.4, (E, n_horiz)).astype(np.float32))
    args = (n_horiz, 4, 0.0125, 1.0, DEFAULT_VEHICLE_WEIGHTS)
    tol = (K2_PSI_TOL, K2_GRAD_TOL)
    psi, grad = tfp._fan_phased_transcription(u, y0, cltab, pvec, *args,
                                              model=model, al=al)
    r = compare_fan(psi, grad, u, y0, cltab, pvec, *args, *tol, model=model,
                    al=al)
    assert r["failed"] == 0 and r["excused"] <= E // 20, r
    bad = grad.clone()
    col = bad.abs().argmax(dim=1)
    bad[torch.arange(0, E, 2), col[::2]] *= 1.01
    r = compare_fan(psi, bad, u, y0, cltab, pvec, *args, *tol, model=model,
                    al=al)
    assert r["failed"] == E // 2, r

    share = grad.abs() / grad.abs().amax(dim=1, keepdim=True)
    small = torch.where(share >= 1e-3, share, float("inf")).argmin(dim=1)
    last = share[:, -1] >= 1e-3
    assert int(last.sum()) >= E // 4
    for col, lanes in ((small, torch.arange(0, E, 2)),
                       (torch.full((E,), 2 * n_horiz - 1),
                        last.nonzero()[:, 0])):
        bad = grad.clone()
        bad[lanes, col[lanes]] *= 1.02
        r = compare_fan(psi, bad, u, y0, cltab, pvec, *args, *tol,
                        model=model, al=al)
        assert r["failed"] == len(lanes) and r["excused"] == 0, r
