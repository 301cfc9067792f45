"""On-card tests of the port's CUDA kernels (mpc_tpu_torch/csrc/fused_psi.cu:
K1, the Pacejka fan, on one road and on per-lane roads, K2, the kinematic
fan, and K3, the augmented-Lagrangian fan, all instances of the phased
kernel; csrc/panoc_direction.cu: P1, PANOC's direction and candidates),
and of the AL-iLQR path on
the card (the LQT solves, an iteration that never waits for the card, the
controller's default device).

They need an NVIDIA GPU and nvcc and skip without them. This module imports
neither jax nor the JAX package, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mpc_tpu_torch.config import AlmConfig, PanocConfig
from mpc_tpu_torch.control.mpc import (STATE_CONSTRAINT_OFFSETS,
                                       build_vehicle_controller,
                                       build_vehicle_ilqr_controller)
from mpc_tpu_torch.kernels.check import (compare_direction, compare_fan,
                                         drawn_direction_inputs)
from mpc_tpu_torch.models.params import VehicleParams
from mpc_tpu_torch.ops import fused_psi as fp
from mpc_tpu_torch.ops.bezier import (bezier_centerline,
                                      lane_change_control_points)
from mpc_tpu_torch.ops.road import circle_centerline, straight_centerline
from mpc_tpu_torch.sim.scenarios import random_scenarios
from mpc_tpu_torch.solver import panoc

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


# ---------------------------------------------------------------------------
# K2 (kinematic bicycle) and K3 (augmented-Lagrangian fan)
# ---------------------------------------------------------------------------

def _variant_inputs(seed, E, n_horiz, sd, device, out_of_box=False):
    """Fan inputs for a state of ``sd`` components. In the box: d in [0, 1],
    |delta| <= 0.32, speed in [0.2, 1]. Out of it: |d| <= 1.5, |delta| <= 1.4
    (where tan(delta) is large), speed in [0, 1] with every eighth lane at
    standstill."""
    rng = np.random.default_rng(seed)
    u = np.empty((E, 2 * n_horiz), np.float32)
    if out_of_box:
        u[:, 0::2] = rng.uniform(-1.5, 1.5, (E, n_horiz))
        u[:, 1::2] = rng.uniform(-1.4, 1.4, (E, n_horiz))
    else:
        u[:, 0::2] = rng.uniform(0.0, 1.0, (E, n_horiz))
        u[:, 1::2] = rng.uniform(-0.32, 0.32, (E, n_horiz))
    y0 = np.zeros((E, sd), np.float32)
    y0[:, 0] = rng.uniform(-0.1, 0.5, E)
    y0[:, 1] = rng.uniform(-0.1, 0.1, E)
    y0[:, 2] = rng.uniform(-0.3, 0.3, E)
    y0[:, 3] = rng.uniform(0.0 if out_of_box else 0.2, 1.0, E)
    if out_of_box:
        y0[::8, 3] = 0.0
    return (torch.as_tensor(u, device=device),
            torch.as_tensor(y0, device=device))


def _al_operands(seed, E, n_horiz, device, log_sigma):
    """Multipliers in [0, 2] and penalties log-uniform over
    ``10**log_sigma``, with the bounded state constraints x^2 - off <= 0."""
    rng = np.random.default_rng(seed + 1000)
    m = 6 * n_horiz
    lam = rng.uniform(0.0, 2.0, (E, m)).astype(np.float32)
    sigma = (10.0 ** rng.uniform(*log_sigma, (E, m))).astype(np.float32)
    as_t = lambda a: torch.as_tensor(a, device=device)   # noqa: E731
    return (as_t(lam), as_t(sigma),
            torch.tensor(STATE_CONSTRAINT_OFFSETS, device=device),
            torch.full((m,), -float("inf"), device=device),
            torch.zeros((m,), device=device))


def _lane_change_road(device):
    return bezier_centerline(
        lane_change_control_points(5.0, device=device).control_points * 0.01,
        size=100)


def _check_variant(tag, wrapper, psi_grad, u, y0, cltab, pvec, args, model,
                   al, excused_share):
    before = wrapper.launches
    psi, grad = psi_grad()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    r = compare_fan(psi, grad, u, y0, cltab, pvec, *args, PSI_TOL, GRAD_TOL,
                    model=model, al=al)
    print(f"{tag}: {r}")
    assert r["failed"] == 0, r
    assert r["excused"] <= excused_share * u.shape[0], r
    return r


@pytest.mark.cuda
@pytest.mark.parametrize("road,E,out_of_box", [
    ("straight", 1, False), ("circle", 37, False), ("straight", 5120, False),
    ("circle", 5120, True)])
def test_kin_kernel_matches_plain_version(cuda, road, E, out_of_box):
    n_horiz = 20
    cl = straight_centerline(100, device=cuda) if road == "straight" \
        else circle_centerline(100, device=cuda)
    u, y0 = _variant_inputs(E, E, n_horiz, 4, cuda, out_of_box)
    cltab, pvec = fp.fan_params(cl, VehicleParams())
    args = (n_horiz, 4, 0.0125, 1.0, fp.DEFAULT_VEHICLE_WEIGHTS)
    _check_variant(f"K2 {road} E={E} out_of_box={out_of_box}",
                   fp.kin_fan_value_and_grad,
                   lambda: fp.kin_fan_value_and_grad(u, y0, cltab, pvec, *args),
                   u, y0, cltab, pvec, args, "simplified", None,
                   0.01 if out_of_box else 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("E,log_sigma,out_of_box", [
    (1, (-1, 3), False), (37, (-1, 3), False), (512, (3, 9), False),
    (1280, (-1, 3), True)])
def test_al_kernel_matches_plain_version(cuda, E, log_sigma, out_of_box):
    n_horiz = 40
    u, y0 = _variant_inputs(E, E, n_horiz, 6, cuda, out_of_box)
    al = _al_operands(E, E, n_horiz, cuda, log_sigma)
    cltab, pvec = fp.fan_params(_lane_change_road(cuda), VehicleParams())
    args = (n_horiz, 4, 0.0125, 1.0, fp.DEFAULT_VEHICLE_WEIGHTS)
    _check_variant(f"K3 E={E} sigma 1e{log_sigma} out_of_box={out_of_box}",
                   fp.al_fan_value_and_grad,
                   lambda: fp.al_fan_value_and_grad(u, y0, cltab, pvec, *al,
                                                    *args),
                   u, y0, cltab, pvec, args, "pacejka", al,
                   0.01 if out_of_box or E > 100 else 0.0)


def _active_al_operands(seed, E, n_horiz, device):
    """Penalties log-uniform over 10^-1 .. 10^3 and multipliers of which
    about a third are above 0, as in the constrained cell, where 33-41% of
    the lanes carry an active multiplier."""
    lam, sigma, *bounds = _al_operands(seed, E, n_horiz, device, (-1, 3))
    rng = np.random.default_rng(seed + 2000)
    keep = torch.as_tensor(rng.uniform(size=tuple(lam.shape)) < 1 / 3,
                           device=device)
    return (torch.where(keep, lam, torch.zeros_like(lam)), sigma, *bounds)


@pytest.mark.cuda
@pytest.mark.parametrize("E", [8192, 20480, 1, 37, 4229])
def test_al_kernel_matches_plain_version_at_the_cell_shapes(cuda, E):
    # K3 through its scratch at the constrained cell's fan sizes (E = 2 B
    # for the Lipschitz pair at B = 4,096, 5 B a trip) and at one lane, 37
    # and a ragged 4,229 (5 lanes in the rollout's last block of 32, 72
    # pairs in the stage terms' last block of 128): N = 40 on the 100-point
    # lane-change road. psi is the plain version's to the bit.
    n_horiz = 40
    u, y0 = _variant_inputs(E + 11, E, n_horiz, 6, cuda)
    al = _active_al_operands(E + 11, E, n_horiz, cuda)
    cltab, pvec = fp.fan_params(_lane_change_road(cuda), VehicleParams())
    args = (n_horiz, 4, 0.0125, 1.0, fp.DEFAULT_VEHICLE_WEIGHTS)
    r = _check_variant(f"K3 scratch E={E}", fp.al_fan_value_and_grad,
                       lambda: fp.al_fan_value_and_grad(u, y0, cltab, pvec,
                                                        *al, *args),
                       u, y0, cltab, pvec, args, "pacejka", al,
                       0.01 if E > 100 else 0.0)
    assert r["max_abs_err_psi"] == 0.0, r
    print(f"K3 scratch E={E}: multipliers above 0 "
          f"{float((al[0] > 0).float().mean()):.3f}")


class _Captured(Exception):
    """Ends a step once the fan calls it was run for are captured."""


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [4096, 8192])
def test_al_kernel_matches_plain_version_on_the_constrained_cell(
        cuda, monkeypatch, batch):
    # K3 at the benchmark cell constrained_n40.lanechange_b4096's shapes,
    # and at twice its batch (E = 2 B for the Lipschitz pair, 5 B a trip;
    # N = 40, the lane-change Bezier road), on the fans of the cell's first
    # cold step
    from benchmark.core import spec, window
    cell = spec.cell("constrained_n40.lanechange_b4096")
    cell.traffic["batch"] = batch
    program = cell.program()
    program.set_precision(cell.cfg)
    prog = program.build(cell.cfg, cell.traffic, "cuda")
    shared, lanes = window.inputs(cell, 11, "cuda")
    calls, kernel = [], fp.al_fan_value_and_grad

    def capture(*args):
        calls.append(tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args))
        if len(calls) == 4:
            raise _Captured
        # the wrapper counts its launches on the module's name
        setattr(fp, "al_fan_value_and_grad", kernel)
        try:
            return kernel(*args)
        finally:
            setattr(fp, "al_fan_value_and_grad", capture)

    monkeypatch.setattr(fp, "al_fan_value_and_grad", capture)
    with pytest.raises(_Captured):
        prog.step(prog.init_carry(batch), lanes["y0"], shared)
    monkeypatch.setattr(fp, "al_fan_value_and_grad", kernel)
    assert [c[0].shape[0] for c in calls] == [2 * batch] + [5 * batch] * 3
    for u, y0, cltab, pvec, *rest in calls:
        al, args = tuple(rest[:5]), tuple(rest[5:])
        r = _check_variant(f"K3 cell E={u.shape[0]}", kernel,
                           lambda: kernel(u, y0, cltab, pvec, *al, *args),
                           u, y0, cltab, pvec, args, "pacejka", al, 0.01)
        assert r["lanes"] == u.shape[0]


@pytest.mark.cuda
def test_variant_wrappers_raise_instead_of_falling_back(cuda):
    # On a CUDA tensor the K2 and K3 wrappers launch their kernel or raise;
    # they never run the plain version.
    cltab, pvec = fp.fan_params(straight_centerline(100, device=cuda),
                                VehicleParams())
    u, y4 = _variant_inputs(0, 4, 70, 4, cuda)
    _, y6 = _variant_inputs(0, 4, 70, 6, cuda)
    al = _al_operands(0, 4, 70, cuda, (0, 1))
    kin0, al0 = fp.kin_fan_value_and_grad.launches, \
        fp.al_fan_value_and_grad.launches
    with pytest.raises(ValueError, match="N <="):
        fp.kin_fan_value_and_grad(u, y4, cltab, pvec, 70, 4, 0.0125, 1.0)
    with pytest.raises(ValueError, match="N <="):
        fp.al_fan_value_and_grad(u, y6, cltab, pvec, *al, 70, 4, 0.0125, 1.0)
    with pytest.raises(ValueError, match="is on"):
        fp.kin_fan_value_and_grad(u, y4.cpu(), cltab, pvec, 70, 4, 0.0125,
                                  1.0)
    # a road too long for the card's shared memory even at one lane per
    # block (10,000 rows: 240 KB of centerline table alone)
    n = 40
    u, y6 = _variant_inputs(0, 4, n, 6, cuda)
    al = _al_operands(0, 4, n, cuda, (0, 1))
    long_tab, _ = fp.fan_params(straight_centerline(10000, device=cuda),
                                VehicleParams())
    with pytest.raises(ValueError, match="shared"):
        fp.al_fan_value_and_grad(u, y6, long_tab, pvec, *al, n, 4, 0.0125,
                                 1.0)
    assert fp.kin_fan_value_and_grad.launches == kin0
    assert fp.al_fan_value_and_grad.launches == al0


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["config1", "constrained"])
def test_variant_controller_step_on_card_matches_cpu(cuda, variant):
    # One cold MPC step of the kinematic controller (K2) or of the
    # state-constrained controller (K3, ALM general path) through the kernel
    # on the card, against the same step through the plain version on the
    # CPU.
    B = 8
    rng = np.random.default_rng(5)
    if variant == "config1":
        n_horiz, wrapper = 20, fp.kin_fan_value_and_grad
        kw = dict(model="simplified", alm_cfg=AlmConfig(eps=1e-4),
                  panoc_cfg=PanocConfig(lbfgs_memory=n_horiz, max_iter=200))
        y0 = np.zeros((B, 4), np.float32)
        y0[:, 1] = rng.uniform(-0.05, 0.05, B)
        y0[:, 3] = rng.uniform(0.2, 1.0, B)
    else:
        n_horiz, wrapper = 8, fp.al_fan_value_and_grad
        kw = dict(bound_state_constraints=True,
                  alm_cfg=AlmConfig(eps=1e-3, delta=1e-3, max_iter=8,
                                    eps_0=1e-2, sigma_0=1e3),
                  panoc_cfg=PanocConfig(lbfgs_memory=n_horiz, max_iter=150))
        y0 = np.zeros((B, 6), np.float32)
        y0[:, 1] = rng.uniform(-0.02, 0.02, B)
        y0[:, 3] = rng.uniform(0.2, 0.8, B)
    out = {}
    for dev in ("cpu", cuda):
        ctrl = build_vehicle_controller(n_horiz=n_horiz, device=dev, **kw)
        road = straight_centerline(100, device=dev) if variant == "config1" \
            else _lane_change_road(dev)
        param = {"y0": torch.as_tensor(y0, device=dev), "p": VehicleParams(),
                 "centerline": road}
        before = wrapper.launches
        res = ctrl.step(ctrl.init_carry(B, dev), param)
        out[str(dev)] = (res, wrapper.launches - before)
    (r_cpu, n_cpu), (r_gpu, n_gpu) = out["cpu"], out["cuda"]
    print(f"{variant}: launches {n_gpu}, inner iterations "
          f"{r_gpu.result.inner_iterations.tolist()} (card) "
          f"{r_cpu.result.inner_iterations.tolist()} (CPU)")
    assert n_cpu == 0 and n_gpu > int(r_gpu.result.inner_iterations.max())
    assert bool(r_gpu.result.converged.all())
    np.testing.assert_array_equal(r_gpu.result.converged.cpu().numpy(),
                                  r_cpu.result.converged.numpy())
    np.testing.assert_allclose(r_gpu.result.psi.cpu().numpy(),
                               r_cpu.result.psi.numpy(), rtol=2e-2, atol=1e-4)
    np.testing.assert_allclose(r_gpu.u0.cpu().numpy(), r_cpu.u0.numpy(),
                               rtol=0, atol=3e-2)


# ---------------------------------------------------------------------------
# The fan kernels, K1 and K2 (the phased kernel) and K3 (its phases as three
# kernels through a device scratch): lanes per block, ragged blocks, shared
# and device memory
# ---------------------------------------------------------------------------

#: kernel -> (path's horizon, model, state dimension, wrapper)
PHASED = {"K1": (12, "pacejka", 6, "fan_value_and_grad"),
          "K2": (20, "simplified", 4, "kin_fan_value_and_grad"),
          "K3": (40, "pacejka", 6, "al_fan_value_and_grad")}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,E", [
    ("K1", 1), ("K1", 37), ("K1", 5120), ("K1", 4229), ("K2", 1),
    ("K2", 37), ("K2", 5120), ("K2", 4229), ("K3", 1), ("K3", 37),
    ("K3", 1280), ("K3", 1059)])
def test_phased_kernel_matches_plain_version(cuda, kernel, E):
    # At the paths' shapes (K1 N=12, K2 N=20, K3 N=40), at E=1 and 37 (one
    # lane per block, so that the grid covers the SMs), and at E=4229 and
    # 1059, whose last block of 32 or 8 lanes holds only 5 or 3, on drawn
    # in-box inputs.
    # K3's rollout and adjoint take a thread a lane and a warp a block, so
    # that E=1059's last block holds 3 lanes.
    al_kernel = kernel == "K3"
    n_horiz, model, sd, name = PHASED[kernel]
    u, y0 = _variant_inputs(E + 7, E, n_horiz, sd, cuda)
    road = _lane_change_road(cuda) if al_kernel \
        else circle_centerline(100, device=cuda)
    cltab, pvec = fp.fan_params(road, VehicleParams())
    args = (n_horiz, 4, 0.0125, 1.0, fp.DEFAULT_VEHICLE_WEIGHTS)
    if al_kernel:
        lanes = 32
    else:
        lanes, smem = fp.phased_plan(E, n_horiz, cltab.shape[0], model)
        print(f"{kernel} E={E}: {lanes} lanes per block, {smem} B of shared "
              f"memory")
    if E in (4229, 1059):
        assert E % lanes != 0, (E, lanes)
    wrapper = getattr(fp, name)
    al = _al_operands(E, E, n_horiz, cuda, (-1, 3)) if al_kernel else ()
    r = _check_variant(f"{kernel} E={E}", wrapper,
                       lambda: wrapper(u, y0, cltab, pvec, *al, *args),
                       u, y0, cltab, pvec, args, model, al or None,
                       0.01 if E > 100 else 0.0)
    assert r["max_abs_err_psi"] == 0.0, r


@pytest.mark.cuda
def test_phased_kernel_opts_in_to_large_shared_memory(cuda):
    # The paths' shapes need more than the default 48 KB of shared memory
    # per block, and give a grid of at least one block per SM. K3 keeps a
    # lane's intermediates in a device scratch instead: a call asks for its
    # outputs and one scratch of al_scratch_floats(E, N) floats of device
    # memory, and hands the scratch back when it returns. The last call,
    # E=1280, is held against the plain version.
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    for E, kernel in ((5120, "K1"), (5120, "K2")):
        n_horiz, model = PHASED[kernel][:2]
        lanes, smem = fp.phased_plan(E, n_horiz, 99, model)
        assert smem > 48 * 1024 and -(-E // lanes) >= n_sm, (E, lanes, smem)
    cltab, pvec = fp.fan_params(_lane_change_road(cuda), VehicleParams())
    for E in (40960, 20480, 1280):
        u, y0 = _variant_inputs(3, E, 40, 6, cuda)
        al = _al_operands(3, E, 40, cuda, (3, 9))
        psi = grad = None       # the last call's outputs, handed back
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(cuda)
        held = torch.cuda.memory_stats(cuda)["requested_bytes.all.current"]
        before = fp.al_fan_value_and_grad.launches
        psi, grad = fp.al_fan_value_and_grad(u, y0, cltab, pvec, *al, 40, 4,
                                             0.0125, 1.0)
        torch.cuda.synchronize()
        stats = torch.cuda.memory_stats(cuda)
        assert fp.al_fan_value_and_grad.launches == before + 1
        outputs = 4 * (E + E * 80)
        assert stats["requested_bytes.all.peak"] - held \
            == outputs + 4 * fp.al_scratch_floats(E, 40), E
        assert stats["requested_bytes.all.current"] - held == outputs, E
    psi_r, _ = fp.fan_value_and_grad_reference(
        u, y0, cltab, pvec, 40, 4, 0.0125, 1.0, fp.DEFAULT_VEHICLE_WEIGHTS,
        al=al)
    assert torch.equal(psi, psi_r)
    assert bool(torch.isfinite(grad).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_phased_kernel_refuses_an_oversize_shape(cuda, kernel):
    # a road too long for the card's shared memory even at one lane per
    # block (10,000 rows: 240 KB of centerline table alone)
    n_horiz, model, sd, name = PHASED[kernel]
    wrapper = getattr(fp, name)
    u, y0 = _variant_inputs(0, 64, n_horiz, sd, cuda)
    long_tab, pvec = fp.fan_params(straight_centerline(10000, device=cuda),
                                   VehicleParams())
    before = wrapper.launches
    with pytest.raises(ValueError, match="shared memory"):
        fp.phased_plan(64, n_horiz, long_tab.shape[0], model)
    with pytest.raises(ValueError, match="shared memory"):
        wrapper(u, y0, long_tab, pvec, n_horiz, 4, 0.0125, 1.0)
    assert wrapper.launches == before


@pytest.mark.cuda
def test_al_kernel_refuses_an_oversize_road(cuda):
    # K3's stage terms stage the road table beside the bounds: 10,000 rows
    # (240 KB) exceed the card's shared memory, and the call raises before
    # it counts a launch
    u, y0 = _variant_inputs(0, 64, 40, 6, cuda)
    al = _al_operands(0, 64, 40, cuda, (-1, 3))
    long_tab, pvec = fp.fan_params(straight_centerline(10000, device=cuda),
                                   VehicleParams())
    before = fp.al_fan_value_and_grad.launches
    with pytest.raises(ValueError, match="shared memory"):
        fp.al_fan_value_and_grad(u, y0, long_tab, pvec, *al, 40, 4, 0.0125,
                                 1.0)
    assert fp.al_fan_value_and_grad.launches == before


# ---------------------------------------------------------------------------
# K1 on per-lane roads ("K1 roads"): lane e on road e // K
# ---------------------------------------------------------------------------

def _scenario_fan(seed, E, K, device):
    """In-box fan inputs of E lanes on E / K roads of ``random_scenarios``
    (straight, arc and lane-change roads), each lane starting from its
    scenario's initial state."""
    sc = random_scenarios(E // K, 100,
                          generator=torch.Generator().manual_seed(seed),
                          device=device)
    u, _ = _inputs(seed, E, 12, device)
    y0 = sc.y0.repeat_interleave(K, dim=0).contiguous()
    cltab, pvec = fp.fan_params(sc.centerline, VehicleParams())
    return u, y0, cltab, pvec


@pytest.mark.cuda
@pytest.mark.parametrize("E,K", [(1, 1), (37, 1), (35, 5), (10240, 5),
                                 (4230, 5), (2560, 5), (2, 2), (38, 2),
                                 (4096, 2), (1024, 2)])
def test_roads_kernel_matches_plain_version(cuda, E, K):
    u, y0, cltab, pvec = _scenario_fan(E + K, E, K, cuda)
    args = (12, 4, 0.0125, 1.0, fp.DEFAULT_VEHICLE_WEIGHTS)
    lanes, smem = fp.phased_plan(E, 12, cltab.shape[1], "pacejka",
                                 E // K)
    print(f"K1 roads E={E} K={K}: {lanes} lanes per block, {smem} B")
    before = (fp.fan_value_and_grad.launches,
              fp.fan_value_and_grad.road_launches)
    psi, grad = fp.fan_value_and_grad(u, y0, cltab, pvec, *args)
    torch.cuda.synchronize()
    assert (fp.fan_value_and_grad.launches,
            fp.fan_value_and_grad.road_launches) == (before[0] + 1,
                                                     before[1] + 1)
    r = compare_fan(psi, grad, u, y0, cltab, pvec, *args, PSI_TOL, GRAD_TOL)
    print(f"K1 roads E={E} K={K}: {r}")
    assert r["failed"] == 0 and r["excused"] <= 0.01 * E, r
    assert r["max_abs_err_psi"] == 0.0, r


@pytest.mark.cuda
def test_roads_kernel_stages_each_blocks_roads(cuda):
    # at the paths' shapes the roads of a block (at most (L - 1) / K + 2 of
    # 2,376 B each) come on top of the shared-road kernel's memory
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    road_bytes = 99 * 6 * 4
    for E, K in ((10240, 5), (4096, 2), (2560, 5), (1024, 2), (320, 5)):
        lanes, smem = fp.phased_plan(E, 12, 99, "pacejka", E // K)
        lanes0, smem0 = fp.phased_plan(E, 12, 99, "pacejka")
        assert lanes == lanes0 and -(-E // lanes) >= min(n_sm, E), (E, K)
        assert smem - smem0 == ((lanes - 1) // K + 1) * road_bytes, \
            (E, K, smem, smem0)


@pytest.mark.cuda
def test_roads_kernel_on_copies_of_one_road_is_the_shared_launch(cuda):
    # the shared-road launch (road stride 0) is unchanged: per-lane copies
    # of its road give the same bits
    E, K = 5120, 5
    u, y0 = _inputs(11, E, 12, cuda)
    road = circle_centerline(100, device=cuda)
    args = (12, 4, 0.0125, 1.0)
    shared = fp.fan_value_and_grad(u, y0, *fp.fan_params(road,
                                                         VehicleParams()),
                                   *args)
    cltab, pvec = fp.fan_params(road.expand(E // K, -1, -1).contiguous(),
                                VehicleParams())
    roads = fp.fan_value_and_grad(u, y0, cltab, pvec, *args)
    torch.cuda.synchronize()
    assert torch.equal(shared[0], roads[0])
    assert torch.equal(shared[1], roads[1])


@pytest.mark.cuda
def test_k2_and_k3_raise_on_per_lane_roads_on_card(cuda):
    E, n = 10, 12
    cltab, pvec = fp.fan_params(straight_centerline(100, device=cuda)
                                .expand(2, -1, -1).contiguous(),
                                VehicleParams())
    u, y4 = _variant_inputs(0, E, n, 4, cuda)
    _, y6 = _variant_inputs(0, E, n, 6, cuda)
    al = _al_operands(0, E, n, cuda, (0, 1))
    before = (fp.kin_fan_value_and_grad.launches,
              fp.al_fan_value_and_grad.launches)
    with pytest.raises(NotImplementedError):
        fp.kin_fan_value_and_grad(u, y4, cltab, pvec, n, 4, 0.0125, 1.0)
    with pytest.raises(NotImplementedError):
        fp.al_fan_value_and_grad(u, y6, cltab, pvec, *al, n, 4, 0.0125, 1.0)
    assert (fp.kin_fan_value_and_grad.launches,
            fp.al_fan_value_and_grad.launches) == before


@pytest.mark.cuda
def test_suite_step_on_card_matches_cpu(cuda):
    # One cold MPC step with one road per lane through the kernel on the
    # card against the same step through the plain version on the CPU.
    B, n_horiz = 8, 12
    sc = random_scenarios(B, 100, generator=torch.Generator().manual_seed(5))
    out = {}
    for dev in ("cpu", cuda):
        ctrl = build_vehicle_controller(
            n_horiz=n_horiz, alm_cfg=AlmConfig(eps=1e-4),
            panoc_cfg=PanocConfig(lbfgs_memory=n_horiz, max_iter=150),
            device=dev)
        param = {"y0": sc.y0.to(dev), "p": VehicleParams(),
                 "centerline": sc.centerline.to(dev)}
        before = fp.fan_value_and_grad.road_launches
        res = ctrl.step(ctrl.init_carry(B, dev), param)
        out[str(dev)] = (res, fp.fan_value_and_grad.road_launches - before)
    (r_cpu, n_cpu), (r_gpu, n_gpu) = out["cpu"], out["cuda"]
    assert n_cpu == 0 and n_gpu > int(r_gpu.result.inner_iterations.max())
    np.testing.assert_array_equal(r_gpu.result.converged.cpu().numpy(),
                                  r_cpu.result.converged.numpy())
    np.testing.assert_allclose(r_gpu.result.psi.cpu().numpy(),
                               r_cpu.result.psi.numpy(), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(r_gpu.u0.cpu().numpy(), r_cpu.u0.numpy(),
                               rtol=0, atol=5e-3)


@pytest.mark.cuda
def test_step_spans_own_the_idle_gaps_and_fan_kernels(cuda):
    # Two warm controller steps at B = 1024 on K1 under torch.profiler:
    # span_breakdown gives every device idle gap to a span of the program
    # (or to the host outside it) and every K1 launch to PANOC's fan or its
    # start-up, or counts it as unattributed where the trace lacks it.
    from mpc_tpu_torch.utils import timing
    B, n_horiz = 1024, 12
    ctrl = build_vehicle_controller(
        n_horiz=n_horiz, alm_cfg=AlmConfig(eps=1e-4),
        panoc_cfg=PanocConfig(lbfgs_memory=n_horiz, max_iter=300),
        device=cuda)
    rng = np.random.default_rng(11)
    y0 = np.zeros((B, 6), np.float32)
    y0[:, 0] = rng.uniform(-0.1, 0.5, B)
    y0[:, 1] = rng.uniform(-0.1, 0.1, B)
    y0[:, 2] = rng.uniform(-0.2, 0.2, B)
    y0[:, 3] = rng.uniform(0.3, 1.0, B)
    param = {"y0": torch.as_tensor(y0, device=cuda), "p": VehicleParams(),
             "centerline": straight_centerline(100, device=cuda)}
    carry = ctrl.step(ctrl.init_carry(B), param).carry
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    trips = 0
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(2):
            out = ctrl.step(carry, param)
            carry = out.carry
            trips += out.result.stats.trips
        torch.cuda.synchronize()
    # the spans are host ranges alone: no device event carries their names
    assert not [ev.name() for ev in prof.profiler.kineto_results.events()
                if ev.device_type() == torch.autograd.DeviceType.CUDA
                and ev.name() in timing.SPANS]
    dev, spans, launches = timing.profiler_events(prof)
    r = timing.span_breakdown(dev, spans, launches)
    print(f"span breakdown: {r}")
    # every gap goes to a span or to the host outside the controller, and
    # the gaps make up the trace's span less its busy union
    assert set(r["idle_s"]) <= set(timing.SPANS) | {timing.OUTSIDE}
    first = min(iv[0] for iv in dev)
    last = max(iv[1] for iv in dev)
    idle_s = (last - first) / 1e9 - r["busy_s"]
    assert sum(r["idle_s"].values()) == pytest.approx(idle_s, rel=0.01)

    fan = [iv for iv in dev if "fused_psi_fan" in iv[3]]
    # one fan a trip and one at each solve's start
    assert len(fan) == trips + 2
    k = timing.span_breakdown(fan, spans, launches)["kernels"]
    print(f"fan kernels by span: {k}")
    assert set(k) <= {"panoc.fan", "panoc.init", timing.UNATTRIBUTED}
    if timing.UNATTRIBUTED not in k:
        assert k == {"panoc.fan": trips, "panoc.init": 2}


# ---------------------------------------------------------------------------
# P1: PANOC's direction and candidates (csrc/panoc_direction.cu)
# ---------------------------------------------------------------------------

TAUS = (1.0, 0.25, 1.0 / 16.0, 1.0 / 64.0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,M,bounded,tr_mult", [
    # the straight and circle cells, the kinematic cell, config 2's K3
    # path (K = 3); B not a multiple of a block's lanes; ms_n40_m8's
    # decisions (K = 4, n not a multiple of 32); the largest ring the
    # kernel takes (K = 4, M n = 6144, one lane a block); no bounds; a
    # binding cap
    (16384, 24, 12, True, 1e5), (32768, 40, 20, True, 1e5),
    (1001, 80, 40, True, 1e5), (256, 122, 40, True, 1e5),
    (37, 128, 48, True, 1e5), (999, 24, 12, False, 1e5),
    (515, 40, 20, True, 0.05),
    # the constrained benchmark cell's shape (K = 3 at a fleet's batch)
    (8192, 80, 40, True, 1e5), (4096, 80, 40, True, 1e5)])
def test_direction_kernel_matches_plain_version(cuda, B, n, M, bounded,
                                                tr_mult):
    # every ring state (empty, partly valid, wrapped, stale slots) and a
    # lane with a NaN gradient, which must stay NaN
    u, g, gamma, C, lb = drawn_direction_inputs(
        B, n, M, seed=B + n, device=cuda, bounded=bounded, nan_lanes=(5,))
    before = panoc.direction.launches
    got = panoc.direction(u, g, gamma, C, lb, tr_mult, TAUS)
    torch.cuda.synchronize()
    assert panoc.direction.launches == before + 1
    r = compare_direction(got, u, g, gamma, C, lb, tr_mult, TAUS)
    print(f"direction B={B} n={n} M={M}: {r}")
    assert r["failed"] == 0 and r["nan_mismatch"] == 0, r
    assert r["elementwise_equal"], r
    assert r["excused"] <= B // 100, r
    assert bool(torch.isnan(got.cands[5]).all())


@pytest.mark.cuda
def test_direction_kernel_raises_on_what_it_cannot_take(cuda):
    u, g, gamma, C, lb = drawn_direction_inputs(8, 6, 4, seed=0, device=cuda)
    call = lambda *a: panoc.direction(*a, 1e5, TAUS)       # noqa: E731
    before = panoc.direction.launches
    call(u, g, gamma, C, lb)
    assert panoc.direction.launches == before + 1
    with pytest.raises(ValueError, match="g_u"):
        call(u, g.cpu(), gamma, C, lb)
    with pytest.raises(ValueError, match="contiguous"):
        call(u, g.t().contiguous().t(), gamma, C, lb)
    with pytest.raises(ValueError, match="shape"):
        call(u, g[:4], gamma, C, lb)
    with pytest.raises(TypeError, match="head"):
        call(u, g, gamma, C, lb._replace(head=lb.head.int()))
    # outside the entry's limits, one at a time: memory above 64, n above
    # 128, a ring (M n) over 6144 floats, a ring not of a multiple of 4
    # floats, more than 8 taus; none launches
    before = panoc.direction.launches
    for B, n, M in ((8, 6, 65), (8, 130, 4), (8, 100, 64), (8, 6, 3)):
        with pytest.raises(ValueError, match="does not take"):
            call(*drawn_direction_inputs(B, n, M, seed=0, device=cuda))
    with pytest.raises(ValueError, match="does not take"):
        panoc.direction(u, g, gamma, C, lb, 1e5, (0.5,) * 9)
    # another dtype on the card is refused, not handed to the plain version
    with pytest.raises(TypeError, match="float32"):
        panoc.direction(u.double(), g.double(), gamma.double(),
                        type(C)(C.lower.double(), C.upper.double()),
                        lb._replace(S=lb.S.double(), Y=lb.Y.double(),
                                    rho=lb.rho.double()), 1e5, TAUS)
    assert panoc.direction.launches == before


@pytest.mark.cuda
def test_solve_launches_the_direction_kernel_once_a_trip(cuda, monkeypatch):
    # One cold ALM fast-path solve (a controller step) at B = 512: the
    # kernel launches exactly once per masked trip, and on the solve's own
    # first calls it holds the plain version, u_hat = cands[:, 0] bit for
    # bit.
    B, n_horiz = 512, 12
    ctrl = build_vehicle_controller(
        n_horiz=n_horiz, alm_cfg=AlmConfig(eps=1e-4),
        panoc_cfg=PanocConfig(lbfgs_memory=n_horiz, max_iter=300),
        device=cuda)
    rng = np.random.default_rng(5)
    y0 = np.zeros((B, 6), np.float32)
    y0[:, 0] = rng.uniform(-0.1, 0.5, B)
    y0[:, 1] = rng.uniform(-0.1, 0.1, B)
    y0[:, 2] = rng.uniform(-0.2, 0.2, B)
    y0[:, 3] = rng.uniform(0.3, 1.0, B)
    param = {"y0": torch.as_tensor(y0, device=cuda), "p": VehicleParams(),
             "centerline": straight_centerline(100, device=cuda)}
    calls, kernel = [], panoc.direction

    def recording(*args):
        out = kernel(*args)
        if len(calls) < 12:
            calls.append((args, out))
        return out

    # the wrapper counts on the module's ``direction``, here the recorder
    recording.launches = 0
    monkeypatch.setattr(panoc, "direction", recording)
    res = ctrl.step(ctrl.init_carry(B), param).result
    torch.cuda.synchronize()
    assert res.stats.trips > 0
    assert recording.launches == res.stats.trips
    for args, out in calls[::4]:
        r = compare_direction(out, *args)
        assert r["failed"] == 0 and r["nan_mismatch"] == 0, r
        ref = panoc.direction_reference(*args)
        assert torch.equal(out.cands[:, 0], ref.cands[:, 0])


# ---------------------------------------------------------------------------
# AL-iLQR: no kernel of its own, batched torch ops on the card
# ---------------------------------------------------------------------------

def _lqt_batch(B, N, seed):
    """Drawn well-posed LQT problems with the cross term, (B, N, ...)."""
    rng = np.random.default_rng(seed)
    n, m = 6, 2

    def psd(k, scale):
        M = rng.normal(size=(B, N, k, k))
        return scale * (M @ np.swapaxes(M, -1, -2) / k + np.eye(k))

    A = np.eye(n) + 0.1 * rng.normal(size=(B, N, n, n))
    args = [rng.normal(size=(B, n)), A, 0.5 * rng.normal(size=(B, N, n, m)),
            0.1 * rng.normal(size=(B, N, n)), psd(n, 0.5),
            0.1 * rng.normal(size=(B, N, n)), psd(m, 1.0),
            0.1 * rng.normal(size=(B, N, m)), psd(n, 1.0)[:, 0],
            0.1 * rng.normal(size=(B, n)), 0.1 * rng.normal(size=(B, N, m, n))]
    return [torch.as_tensor(a, dtype=torch.float32) for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 64])
def test_lqt_solves_on_card_match_cpu(cuda, B):
    from mpc_tpu_torch.solver.lqr import (lqt_solve_parallel,
                                          lqt_solve_sequential)
    args = _lqt_batch(B, 40, seed=B)
    for fn in (lqt_solve_sequential, lqt_solve_parallel):
        cpu = fn(*args[:10], P=args[10])
        gpu = fn(*(a.to(cuda) for a in args[:10]), P=args[10].to(cuda))
        for f in ("xs", "us", "Ko", "ko"):
            np.testing.assert_allclose(getattr(gpu, f).cpu().numpy(),
                                       getattr(cpu, f).numpy(), rtol=0,
                                       atol=1e-4, err_msg=f"{fn.__name__} {f}")


@pytest.mark.cuda
def test_ilqr_iteration_never_waits_for_the_card(cuda):
    ctrl = build_vehicle_ilqr_controller(
        n_horiz=8, bound_state_constraints=True,
        alm_cfg=AlmConfig(delta=1e-3, max_iter=8, sigma_0=1e3,
                          penalty_factor=5.0), device=cuda)
    B = 4
    carry = ctrl.init_carry(B)
    y0 = torch.zeros((B, 6), device=cuda)
    y0[:, 3] = torch.linspace(0.3, 0.9, B, device=cuda)
    param = {"y0": y0, "p": VehicleParams(),
             "centerline": straight_centerline(100, device=cuda)}
    st, iterate, cond, result = ctrl.solve.prepare_inner(
        param, carry.U, carry.lam, torch.full_like(carry.lam, 1e3))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            st = iterate(st)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    res = result(st)
    assert bool(torch.isfinite(res.cost).all())
    assert res.iterations.min().item() >= 1


@pytest.mark.cuda
def test_ilqr_controller_defaults_to_the_card(cuda):
    ctrl = build_vehicle_ilqr_controller(n_horiz=4, model="simplified")
    assert ctrl.device.type == "cuda"
    carry = ctrl.init_carry(2)
    assert carry.U.is_cuda
    y0 = torch.tensor([[0.0, 0.05, 0.1, 0.4], [0.0, 0.0, 0.0, 0.5]],
                      device=cuda)
    out = ctrl.step(carry, {"y0": y0, "p": VehicleParams(),
                            "centerline": straight_centerline(100,
                                                              device=cuda)})
    assert out.u0.is_cuda and bool(out.result.converged.all())


# ---------------------------------------------------------------------------
# The plain OCP (windowed search, obstacle field), multiple shooting and the
# hanging chain: no kernel, batched torch ops and autograd on the card
# ---------------------------------------------------------------------------

def _unfused_case(variant, dev):
    """``(controller, param)`` of one small unfused path on ``dev``."""
    from mpc_tpu_torch.control.chain_mpc import (build_chain_controller,
                                                 floor_coefficients)
    from mpc_tpu_torch.control.mpc import build_vehicle_ms_controller
    from mpc_tpu_torch.models.chain import ChainSpec, chain_dynamics
    from mpc_tpu_torch.models.integrators import discretize
    from mpc_tpu_torch.models.params import ChainParams
    B, n_horiz = 4, 8
    rng = np.random.default_rng(11)
    y0 = np.zeros((B, 6), np.float32)
    y0[:, 1] = rng.uniform(-0.03, 0.03, B)
    y0[:, 3] = rng.uniform(0.4, 0.9, B)
    param = {"y0": torch.as_tensor(y0, device=dev), "p": VehicleParams(),
             "centerline": straight_centerline(100, device=dev)}
    field = {"a_f": 1.0, "sigma_x": 0.2}
    obstacles = torch.tensor([[1.0, 0.05, 0.0, 0.0], [0.5, -0.04, 0.0, 0.1]],
                             device=dev)
    alm, panoc = AlmConfig(eps=1e-4), PanocConfig(lbfgs_memory=n_horiz,
                                                  max_iter=150)
    if variant == "window":
        ctrl = build_vehicle_controller(n_horiz=n_horiz, alm_cfg=alm,
                                        panoc_cfg=panoc, window=16,
                                        device=dev)
    elif variant == "obstacles":
        ctrl = build_vehicle_controller(
            n_horiz=n_horiz, alm_cfg=alm, panoc_cfg=panoc,
            obstacle_weight=1.0, obstacle_field_kwargs=field, device=dev)
        param["obstacles"] = obstacles[None].expand(B, 2, 4).contiguous()
    elif variant == "ilqr_obstacles":
        ctrl = build_vehicle_ilqr_controller(
            n_horiz=n_horiz, obstacle_weight=2.0,
            obstacle_field_kwargs=field, device=dev)
        param["obstacles"] = obstacles[:1]
    elif variant == "ms":
        ctrl, _ = build_vehicle_ms_controller(
            n_horiz=n_horiz, n_segments=4,
            panoc_cfg=PanocConfig(lbfgs_memory=16, max_iter=250),
            device=dev)
        param["y0"] = torch.zeros((2, 6), device=dev)
        param["y0"][:, 3] = torch.tensor([0.5, 1.0], device=dev)
    else:
        spec = ChainSpec(6, 2)
        f_d = discretize(chain_dynamics(spec))
        y = spec.initial_state(1, device=dev)
        for _ in range(3):
            y = f_d(y, torch.tensor([[-0.5, 0.5]], device=dev), ChainParams())
        ctrl = build_chain_controller(spec, 4, device=dev)
        param = {"y0": y, "p": ChainParams(),
                 "constr": floor_coefficients(device=dev)[0]}
    return ctrl, param


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["window", "obstacles", "ilqr_obstacles",
                                     "ms", "chain"])
def test_unfused_step_on_card_matches_cpu(cuda, variant):
    # One cold step of an unfused path on the card against the same step on
    # the CPU: no fan kernel may launch on the card.
    wrappers = (fp.fan_value_and_grad, fp.kin_fan_value_and_grad,
                fp.al_fan_value_and_grad)
    out = {}
    for dev in ("cpu", cuda):
        ctrl, param = _unfused_case(variant, dev)
        before = [w.launches for w in wrappers]
        with torch.no_grad():
            res = ctrl.step(ctrl.init_carry(param["y0"].shape[0]), param)
        assert [w.launches for w in wrappers] == before
        out[str(dev)] = res
    r_cpu, r_gpu = out["cpu"], out["cuda"]
    assert r_gpu.u0.device.type == "cuda"
    np.testing.assert_array_equal(r_gpu.result.converged.cpu().numpy(),
                                  r_cpu.result.converged.numpy())
    np.testing.assert_allclose(r_gpu.u0.cpu().numpy(), r_cpu.u0.numpy(),
                               rtol=0, atol=5e-3)
    assert bool(torch.isfinite(r_gpu.result.u).all())


@pytest.mark.cuda
def test_suite_with_obstacles_on_card(cuda):
    # a two-tier suite step with per-lane obstacles on the card: finite,
    # no fan kernel
    from mpc_tpu_torch.models.bicycle import pacejka_dynamics
    from mpc_tpu_torch.models.integrators import discretize
    from mpc_tpu_torch.sim.scenarios import run_scenario_suite_two_tier
    sc = random_scenarios(8, 100, generator=torch.Generator().manual_seed(2),
                          device=cuda)
    full, cheap = (build_vehicle_controller(
        n_horiz=8, alm_cfg=AlmConfig(eps=1e-3),
        panoc_cfg=PanocConfig(lbfgs_memory=8, max_iter=it),
        obstacle_weight=1.0, obstacle_field_kwargs={"a_f": 1.0,
                                                    "sigma_x": 0.2},
        device=cuda) for it in (60, 3))
    before = fp.fan_value_and_grad.launches
    state, conv = run_scenario_suite_two_tier(
        full, cheap, discretize(pacejka_dynamics), sc, VehicleParams(), 2,
        straggler_pad=4)
    assert fp.fan_value_and_grad.launches == before
    assert bool(torch.isfinite(state["ys"]).all()) and conv.shape == (8, 2)


@pytest.fixture
def world1(cuda):
    """A world of one rank on NCCL in this process (the sharded paths'
    collectives are then copies), torn down after the test."""
    import torch.distributed as dist
    from mpc_tpu_torch.parallel.distributed import initialize_world
    initialize_world()
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    try:
        yield cuda
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_world_of_one_sharded_solve_equals_unsharded(world1):
    """The (1, 1)-mesh solver runs K1 on the same lanes as the unsharded
    solver: its outputs are the same bit for bit."""
    from mpc_tpu_torch.bench import mesh_dp_inputs
    from mpc_tpu_torch.control.mpc import build_vehicle_ocp
    from mpc_tpu_torch.parallel.mesh import make_mesh
    from mpc_tpu_torch.parallel.sharding import make_sharded_vehicle_solver
    from mpc_tpu_torch.solver.alm import make_alm_solver
    alm, panoc = AlmConfig(eps=1e-4), PanocConfig(lbfgs_memory=12,
                                                  max_iter=60)
    y0s, cl, U0s, lam0s = mesh_dp_inputs(32, 12, world1)
    p = VehicleParams()
    fp.fan_value_and_grad.launches = 0
    got = make_sharded_vehicle_solver(make_mesh(1, 1), alm_cfg=alm,
                                      panoc_cfg=panoc)(y0s, cl, p, U0s, lam0s)
    assert fp.fan_value_and_grad.launches > 0
    want = make_alm_solver(build_vehicle_ocp(12, device=world1), alm, panoc)(
        {"y0": y0s, "p": p, "centerline": cl}, U0s, lam0s)
    for g, w in zip(got, (want.u, want.lam, want.converged,
                          want.inner_iterations)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_world_of_one_lqt_equals_parallel_scan(world1):
    """A blocked scan over one rank folds in identity elements, which is
    exact: the (1, 1)-mesh LQT equals lqt_solve_parallel."""
    from mpc_tpu_torch.bench import mesh_lqt_problem
    from mpc_tpu_torch.parallel.lqr_sharded import make_lqt_horizon_sharded
    from mpc_tpu_torch.parallel.mesh import make_horizon_mesh
    from mpc_tpu_torch.solver.lqr import lqt_solve_parallel
    args = [torch.as_tensor(a, device=world1)
            for a in mesh_lqt_problem(4, 64)]
    got = make_lqt_horizon_sharded(make_horizon_mesh(1, 1))(*args)
    want = lqt_solve_parallel(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_world_of_one_batched_ilqr_step_equals_unsharded(world1):
    """build_vehicle_ilqr_controller(mesh=) over one rank: a step equals the
    unsharded controller's with the parallel-scan backward pass."""
    from mpc_tpu_torch.config import IlqrConfig
    from mpc_tpu_torch.parallel.ilqr_sharded import BatchedMpcController
    from mpc_tpu_torch.parallel.mesh import make_horizon_mesh
    kw = dict(n_horiz=8, bound_state_constraints=True,
              alm_cfg=AlmConfig(delta=1e-3, max_iter=4, sigma_0=1e3),
              ilqr_cfg=IlqrConfig(max_iter=15, parallel_backward=True))
    ctrl = build_vehicle_ilqr_controller(mesh=make_horizon_mesh(1, 1), **kw)
    assert isinstance(ctrl, BatchedMpcController)
    base = build_vehicle_ilqr_controller(**kw)
    rng = np.random.default_rng(0)
    y0 = np.zeros((8, 6), np.float32)
    y0[:, 1] = rng.uniform(-0.05, 0.05, 8)
    y0[:, 3] = rng.uniform(0.3, 0.8, 8)
    param = {"y0": torch.as_tensor(y0, device=world1), "p": VehicleParams(),
             "centerline": straight_centerline(100, device=world1)}
    got = ctrl.step(ctrl.init_carry(8), param)
    want = base.step(base.init_carry(8), param)
    for g, w in zip(got.result, want.result):
        if g is not None:
            assert torch.equal(g, w)
