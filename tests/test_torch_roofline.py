"""The port's count of operations and bytes (mpc_tpu_torch/utils/
roofline.py), which takes the place of XLA's ``cost_analysis()`` in the
port's exp_mfu: the four fan kernels' bounds at their paths' shapes equal,
to the operation, what chip_smoke.py's own count gave before the count
moved into the module (K1 0.00276, K1 roads 0.00552, K2 0.00209, K3
0.00240 ms, as chip_smoke.py prints them); each AL-iLQR phase's
operations are linear in the lanes B and its bytes affine (the road and
the step sizes are read once for all lanes); and each phase at B = 1, N = 1
equals a count by hand. Exact integers: nothing here is measured.
"""

import pytest
import torch

from mpc_tpu_torch.utils import roofline as rl

torch.set_num_threads(1)

F32 = torch.float32

# (model, al, E, N, road tables, operations, bound_ms as chip_smoke.py
# printed it): chip_smoke.py's fan_ops of the parent tree at the paths'
# shapes, 4 substeps, the 99 rows of a 100-point road's table
FANS = {
    "K1": ("pacejka", False, 5120, 12, 0, 184811520, "0.00276"),
    "K1 roads": ("pacejka", False, 10240, 12, 2048, 369623040, "0.00552"),
    "K2": ("simplified", False, 5120, 20, 0, 140083200, "0.00209"),
    "K3": ("pacejka", True, 1280, 40, 0, 160768000, "0.00240"),
}


def _operands(model, al, E, N, roads):
    sd = rl.STATE_DIM[model]
    tab = (roads, 99, 6) if roads else (99, 6)
    ops = [torch.zeros(E, 2 * N), torch.zeros(E, sd), torch.zeros(tab),
           torch.zeros(16)]
    if al:
        m = 6 * N
        ops += [torch.zeros(E, m), torch.zeros(E, m), torch.zeros(6),
                torch.zeros(m), torch.zeros(m)]
    return ops, [torch.zeros(E), torch.zeros(E, 2 * N)]


@pytest.mark.parametrize("name", FANS)
def test_fan_bounds_pinned_to_the_former_count(name):
    model, al, E, N, roads, ops, printed = FANS[name]
    operands, outputs = _operands(model, al, E, N, roads)
    bound_ms, by, nbytes, got_ops, former = rl.fan_bound(
        model, al, E, N, 4, 99, operands, outputs)
    assert got_ops == ops == rl.fan_ops(model, al, E, N, 4, 99)
    assert by == "operations"
    assert bound_ms == ops / 67e12 * 1e3
    assert f"{bound_ms:.5f}" == printed
    assert nbytes == sum(t.numel() * 4 for t in operands + outputs)
    assert former >= nbytes / 3.35e12 * 1e3


PHASES = (rl.ilqr_rollout, rl.ilqr_derivatives, rl.ilqr_riccati_sequential,
          rl.ilqr_forward_fan)


@pytest.mark.parametrize("count", PHASES, ids=lambda f: f.__name__)
def test_phase_counts_scale_with_the_lanes(count):
    c1, c2, c3 = (count(B, 40) for B in (256, 512, 768))
    assert c2.ops == 2 * c1.ops and c3.ops == 3 * c1.ops
    assert c3.bytes - c2.bytes == c2.bytes - c1.bytes > 0
    n1, n2 = count(256, 40), count(256, 80)
    assert n2.ops == 2 * n1.ops


# one lane, one stage, by hand (Pacejka: 53 operations an evaluation, 2 per
# stage, 13 per state component and RK4 step, 4 substeps; the 99
# candidates of a 100-point road; 6 constraints; n = 6, m = 2)
F_D = 2 + 4 * (4 * 53 + 13 * 6)                  # 1162
STAGE_COST, ARGMIN, AL6 = 45, 6 * 99, 6 * 11     # 45, 594, 66
ROLLOUT = 2 * 2 + F_D + STAGE_COST + ARGMIN + AL6 + 1   # clamp .. the sum
PRIMAL = F_D + STAGE_COST + AL6                  # 1273
# Q, q, R, r, P over 12 residuals (a c (2b - 1) a product) and their
# doubling
PRODUCTS = (36 * 23 + 36) + (6 * 23 + 6) + (4 * 23 + 4) + (2 * 23 + 2) \
    + (12 * 23 + 12)
DERIVATIVES = PRIMAL + ARGMIN + 8 * PRIMAL + PRODUCTS
SOLVE_2_6, SOLVE_2_1 = 3 + 6 * 6, 3 + 6          # LU of 2x2, then 6 a RHS
ELIM = SOLVE_2_6 + SOLVE_2_1 + (108 + 36) + (18 + 6) + (108 + 36) + (18 + 6)
GAINS = 132 + (44 + 4) + (132 + SOLVE_2_6) + (2 * 22 + 2 + SOLVE_2_1)
VALUE = (108 + 36) + (2 * 396 + 36) + (2 * 66 + 18) + 2 * 36
LQT_FORWARD = 2 * 22 + 4 * 2 + 66 + 18 + 12
RICCATI = 2 + ELIM + GAINS + VALUE + LQT_FORWARD + 12 + 2 + 4
POLICY = 6 + 22 + 2 + 4                          # dx, K dx, alpha ko, subs
FAN = 6 * (POLICY + ROLLOUT)                     # the clamp counted once


@pytest.mark.parametrize("count, ops", [
    (rl.ilqr_rollout, ROLLOUT), (rl.ilqr_derivatives, DERIVATIVES),
    (rl.ilqr_riccati_sequential, RICCATI), (rl.ilqr_forward_fan, FAN)],
    ids=lambda v: getattr(v, "__name__", str(v)))
def test_phase_counts_by_hand_at_one_stage(count, ops):
    assert count(1, 1).ops == ops


def test_phase_bytes_by_hand_at_one_stage():
    # floats read and written by one lane of one stage, 4 bytes each
    road = 200
    assert rl.ilqr_rollout(1, 1).bytes == 4 * (2 + 6 + 12 + road + 12 + 1)
    assert rl.ilqr_riccati_sequential(1, 1).bytes == 4 * (
        36 + 12 + 36 + 6 + 4 + 2 + 12 + 1 + 12 + 2 + 1)
    assert rl.ilqr_forward_fan(1, 1).bytes == 4 * (
        12 + 2 + 14 + 12 + road + 6 + 6 * (12 + 2 + 1))


def test_bound_names_its_binding_term():
    assert rl.bound(67e9, 0) == (1.0, "operations")
    assert rl.bound(0, 3.35e9) == (1.0, "bytes")
    assert rl.solve_ops(2, 1) == 9 and rl.mm(2, 6, 1) == 22
