"""On-card tests of the port's CUDA kernel (mpc_tpu_torch/csrc/fused_psi.cu).

They need an NVIDIA GPU and nvcc and skip without them. This module imports
neither jax nor the JAX package, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mpc_tpu_torch.config import AlmConfig, PanocConfig
from mpc_tpu_torch.control.mpc import build_vehicle_controller
from mpc_tpu_torch.models.params import VehicleParams
from mpc_tpu_torch.ops import fused_psi as fp
from mpc_tpu_torch.ops.road import circle_centerline, straight_centerline

PSI_TOL = dict(rtol=2e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed, E, n_horiz, device):
    rng = np.random.default_rng(seed)
    # inside the solver's input box, driving forward (see chip_smoke.py: far
    # outside it a lane can stop at vx ~ 0, where the gradient is singular)
    u = np.empty((E, 2 * n_horiz), np.float32)
    u[:, 0::2] = rng.uniform(0.0, 1.0, (E, n_horiz))
    u[:, 1::2] = rng.uniform(-0.32, 0.32, (E, n_horiz))
    y0 = np.zeros((E, 6), np.float32)
    y0[:, 0] = rng.uniform(-0.1, 0.5, E)
    y0[:, 1] = rng.uniform(-0.1, 0.1, E)
    y0[:, 2] = rng.uniform(-0.3, 0.3, E)
    y0[:, 3] = rng.uniform(0.2, 1.0, E)
    return (torch.as_tensor(u, device=device),
            torch.as_tensor(y0, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("road,E,n_horiz,substeps", [
    ("straight", 1, 12, 4), ("circle", 37, 12, 4), ("straight", 300, 2, 1),
    ("circle", 1000, 8, 4)])
def test_kernel_matches_plain_version(cuda, road, E, n_horiz, substeps):
    cl = straight_centerline(100, device=cuda) if road == "straight" \
        else circle_centerline(100, device=cuda)
    u, y0 = _inputs(E, E, n_horiz, cuda)
    cltab, pvec = fp.fan_params(cl, VehicleParams(mass=0.25, cm1=0.4))
    args = (n_horiz, substeps, 0.05 / substeps, 1.0, fp.DEFAULT_VEHICLE_WEIGHTS)
    before = fp.fan_value_and_grad.launches
    psi, grad = fp.fan_value_and_grad(u, y0, cltab, pvec, *args)
    torch.cuda.synchronize()
    assert fp.fan_value_and_grad.launches == before + 1
    psi_r, grad_r = fp.fan_value_and_grad_reference(u, y0, cltab, pvec, *args)
    print(f"{road} E={E} N={n_horiz}: max |dpsi| "
          f"{float((psi - psi_r).abs().max()):.3e} max |dgrad| "
          f"{float((grad - grad_r).abs().max()):.3e}")
    np.testing.assert_allclose(psi.cpu().numpy(), psi_r.cpu().numpy(),
                               **PSI_TOL)
    np.testing.assert_allclose(grad.cpu().numpy(), grad_r.cpu().numpy(),
                               **GRAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("road", ["straight", "circle"])
def test_kernel_matches_plain_version_out_of_box(cuda, road):
    # Candidates far outside the solver's box, from standstill up, as the
    # unprojected L-BFGS candidates of a PANOC iteration can be. A lane
    # beyond the bar is excused only where the plain version in float32
    # misses its own float64 value by the bar too (kernels/check.py).
    from mpc_tpu_torch.kernels.check import compare_fan
    E, n_horiz, substeps = 5120, 12, 4
    rng = np.random.default_rng(11)
    u = np.empty((E, 2 * n_horiz), np.float32)
    u[:, 0::2] = rng.uniform(-1.5, 1.5, (E, n_horiz))
    u[:, 1::2] = rng.uniform(-1.0, 1.0, (E, n_horiz))
    y0 = np.zeros((E, 6), np.float32)
    y0[:, 0] = rng.uniform(-0.1, 0.5, E)
    y0[:, 1] = rng.uniform(-0.1, 0.1, E)
    y0[:, 2] = rng.uniform(-0.3, 0.3, E)
    y0[:, 3] = rng.uniform(0.0, 1.0, E)
    u = torch.as_tensor(u, device=cuda)
    y0 = torch.as_tensor(y0, device=cuda)
    cl = straight_centerline(100, device=cuda) if road == "straight" \
        else circle_centerline(100, device=cuda)
    cltab, pvec = fp.fan_params(cl, VehicleParams())
    args = (n_horiz, substeps, 0.05 / substeps, 1.0, fp.DEFAULT_VEHICLE_WEIGHTS)
    psi, grad = fp.fan_value_and_grad(u, y0, cltab, pvec, *args)
    torch.cuda.synchronize()
    r = compare_fan(psi, grad, u, y0, cltab, pvec, *args, PSI_TOL, GRAD_TOL)
    print(f"out of box, {road}: {r}")
    assert r["failed"] == 0, r
    assert r["excused"] <= E // 100, r


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda):
    u, y0 = _inputs(0, 4, 70, cuda)
    cltab, pvec = fp.fan_params(straight_centerline(100, device=cuda),
                                VehicleParams())
    with pytest.raises(ValueError):
        fp.fan_value_and_grad(u, y0, cltab, pvec, 70, 4, 0.0125, 1.0)
    with pytest.raises(ValueError):
        fp.fan_value_and_grad(u, y0.cpu(), cltab, pvec, 70, 4, 0.0125, 1.0)


@pytest.mark.cuda
def test_controller_step_on_card_matches_cpu(cuda):
    # One cold MPC step through the kernel on the card against the same step
    # through the plain version on the CPU.
    B, n_horiz = 8, 12
    rng = np.random.default_rng(3)
    y0 = np.zeros((B, 6), np.float32)
    y0[:, 0] = rng.uniform(-0.1, 0.5, B)
    y0[:, 1] = rng.uniform(-0.1, 0.1, B)
    y0[:, 3] = rng.uniform(0.3, 1.0, B)
    out = {}
    for dev in ("cpu", cuda):
        ctrl = build_vehicle_controller(
            n_horiz=n_horiz, alm_cfg=AlmConfig(eps=1e-4),
            panoc_cfg=PanocConfig(lbfgs_memory=n_horiz, max_iter=300),
            device=dev)
        param = {"y0": torch.as_tensor(y0, device=dev), "p": VehicleParams(),
                 "centerline": straight_centerline(100, device=dev)}
        before = fp.fan_value_and_grad.launches
        res = ctrl.step(ctrl.init_carry(B, dev), param)
        out[str(dev)] = (res, fp.fan_value_and_grad.launches - before)
    (r_cpu, n_cpu), (r_gpu, n_gpu) = out["cpu"], out["cuda"]
    assert n_cpu == 0 and n_gpu > int(r_gpu.result.inner_iterations.max())
    assert bool(r_gpu.result.converged.all())
    np.testing.assert_array_equal(r_gpu.result.converged.cpu().numpy(),
                                  r_cpu.result.converged.numpy())
    np.testing.assert_allclose(r_gpu.result.psi.cpu().numpy(),
                               r_cpu.result.psi.numpy(), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(r_gpu.u0.cpu().numpy(), r_cpu.u0.numpy(),
                               rtol=0, atol=5e-3)
