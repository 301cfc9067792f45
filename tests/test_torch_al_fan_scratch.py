"""What the host side of K3 decides (mpc_tpu_torch/ops/fused_psi.py): the
size of the device scratch its wrapper allocates for the kernels of
csrc/fused_psi.cu that hand a lane's intermediates on
(``al_scratch_floats``; the kernels lay the planes out themselves), and
the CPU route of ``al_fan_value_and_grad`` (the plain version, no launch).
The kernels themselves are held against the plain version in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from mpc_tpu_torch.control.mpc import STATE_CONSTRAINT_OFFSETS
from mpc_tpu_torch.models.params import VehicleParams
from mpc_tpu_torch.ops import fused_psi as fp
from mpc_tpu_torch.ops.bezier import (bezier_centerline,
                                      lane_change_control_points)

SD = 6


@pytest.mark.parametrize("n_horiz", [12, 40, 64])
@pytest.mark.parametrize("E", [1, 37, 4229, 20480])
def test_scratch_holds_a_plane_of_every_lane_for_each_value(E, n_horiz):
    # the values a lane hands on: the N + 1 boundary states, and each
    # stage's Jacobian columns, state gradient, cost and penalties
    planes = SD * (n_horiz + 1) + n_horiz * (SD * SD + SD + 1 + SD)
    floats = fp.al_scratch_floats(E, n_horiz)
    assert floats % planes == 0
    pitch = floats // planes
    # each plane holds every lane, and starts on a 128-byte boundary, with
    # less than a warp's lanes of padding
    assert E <= pitch < E + 32 and pitch % 32 == 0


def test_scratch_at_the_constrained_cell():
    # E = 20,480 lanes (4,096 cars x 5 candidates) at N = 40: 2,206 planes,
    # 180.7 MB; twice the cars, twice the bytes; the Lipschitz pair at
    # E = 8,192, 72.3 MB
    assert fp.al_scratch_floats(20480, 40) == 2206 * 20480 == 45_178_880
    assert fp.al_scratch_floats(40960, 40) == 2 * 45_178_880
    assert 4 * fp.al_scratch_floats(8192, 40) == 72_286_208


def _al_inputs(seed, E, n_horiz):
    """In-box fan inputs on the lane-change road with multipliers of which
    about a third are above 0."""
    rng = np.random.default_rng(seed)
    u = np.empty((E, 2 * n_horiz), np.float32)
    u[:, 0::2] = rng.uniform(0.0, 1.0, (E, n_horiz))
    u[:, 1::2] = rng.uniform(-0.32, 0.32, (E, n_horiz))
    y0 = np.zeros((E, SD), np.float32)
    y0[:, 0] = rng.uniform(-0.1, 0.5, E)
    y0[:, 1] = rng.uniform(-0.1, 0.1, E)
    y0[:, 2] = rng.uniform(-0.3, 0.3, E)
    y0[:, 3] = rng.uniform(0.2, 1.0, E)
    m = SD * n_horiz
    lam = np.where(rng.uniform(size=(E, m)) < 1 / 3,
                   rng.uniform(0.0, 2.0, (E, m)), 0.0).astype(np.float32)
    sigma = (10.0 ** rng.uniform(-1, 3, (E, m))).astype(np.float32)
    road = bezier_centerline(
        lane_change_control_points(5.0).control_points * 0.01, size=100)
    cltab, pvec = fp.fan_params(road, VehicleParams())
    al = (torch.as_tensor(lam), torch.as_tensor(sigma),
          torch.tensor(STATE_CONSTRAINT_OFFSETS),
          torch.full((m,), -float("inf")), torch.zeros((m,)))
    return torch.as_tensor(u), torch.as_tensor(y0), cltab, pvec, al


@pytest.mark.parametrize("E", [1, 5, 37, 1059])
def test_al_fan_cpu_route_is_the_plain_version(E):
    n_horiz = 40
    u, y0, cltab, pvec, al = _al_inputs(E, E, n_horiz)
    args = (n_horiz, 4, 0.0125, 1.0)
    before = fp.al_fan_value_and_grad.launches
    psi, grad = fp.al_fan_value_and_grad(u, y0, cltab, pvec, *al, *args)
    psi_r, grad_r = fp.fan_value_and_grad_reference(
        u, y0, cltab, pvec, *args, fp.DEFAULT_VEHICLE_WEIGHTS, al=al)
    assert fp.al_fan_value_and_grad.launches == before   # no kernel here
    assert torch.equal(psi, psi_r) and torch.equal(grad, grad_r)
    assert bool(torch.isfinite(psi).all()) and bool(torch.isfinite(grad).all())
