"""The float64 reference against the program on the CPU: the same cost,
gradient and plant where both compute in float64, and a tiny run of each
cell that comes out correct."""

import pytest
import torch

from benchmark.core import spec
from benchmark.generators import fleet
from benchmark.reference import vehicle as ref
from benchmark.tests.conftest import tiny

from mpc_tpu_torch.models.bicycle import pacejka_dynamics, simplified_dynamics
from mpc_tpu_torch.models.integrators import discretize
from mpc_tpu_torch.models.params import VehicleParams
from mpc_tpu_torch.ops.fused_psi import (fan_params,
                                         fan_value_and_grad_reference)


def _inputs(cfg, road, B=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    sd = ref.STATE_DIM[cfg["model"]]
    y = torch.zeros(B, sd, dtype=torch.float64)
    y[:, :2] = road[0].double() + 0.05 * torch.randn(B, 2, generator=g,
                                                    dtype=torch.float64)
    y[:, 3] = 0.5 + 0.3 * torch.rand(B, generator=g, dtype=torch.float64)
    u = torch.rand(B, 2 * cfg["n_horiz"], generator=g, dtype=torch.float64)
    u[:, 0::2] = 2 * u[:, 0::2] - 1
    u[:, 1::2] = 0.3 * (2 * u[:, 1::2] - 1)
    return y, u


@pytest.mark.parametrize("cell", ["vehicle_n12.straight_b16384",
                                  "kinematic_n20.straight_b32768",
                                  "vehicle_n12.circle_b16384"])
def test_cost_and_grad_match_the_programs_plain_fan(cell):
    c = spec.cell(cell)
    cfg = c.cfg
    road = torch.as_tensor(fleet.road(c.traffic))
    y, u = _inputs(cfg, road)
    psi, grad, amb = ref.cost_and_grad(cfg, u, y, road)
    cltab, pvec = fan_params(road.double(), VehicleParams(**cfg["params"]))
    p_psi, p_grad = fan_value_and_grad_reference(
        u, y, cltab, pvec.double(), cfg["n_horiz"], cfg["substeps"],
        cfg["ts"] / cfg["substeps"], cfg["v_ref"], cfg["weights"],
        model=cfg["model"])
    keep = ~amb
    assert keep.sum() >= 3
    # the program holds its parameters in float32 (about 3e-8 of each)
    torch.testing.assert_close(psi[keep], p_psi[keep], rtol=1e-7, atol=0)
    torch.testing.assert_close(grad[keep], p_grad[keep], rtol=1e-6,
                               atol=1e-6 * float(grad.abs().max()))


@pytest.mark.parametrize("model", ["pacejka", "simplified"])
def test_plant_matches_the_programs(model):
    cfg = spec.cell("vehicle_n12.straight_b16384").cfg if model == "pacejka" \
        else spec.cell("kinematic_n20.straight_b32768").cfg
    road = torch.as_tensor(fleet.road(
        {"road": {"kind": "straight", "points": 100, "spacing": 0.1,
                  "start": -0.1}}))
    y, u = _inputs(cfg, road, B=7, seed=1)
    f_d = discretize(pacejka_dynamics if model == "pacejka"
                     else simplified_dynamics, ts=cfg["ts"])
    torch.testing.assert_close(ref.plant(cfg, y, u[:, :2]),
                               f_d(y, u[:, :2], VehicleParams()),
                               rtol=1e-13, atol=1e-13)


def test_tf32_rounding_keeps_ten_bits():
    x = torch.randn(10000) * 100
    r = ref.tf32_round(x)
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)
    assert float(((r - x).abs() / x.abs()).max()) <= 2 ** -11


@pytest.mark.parametrize("cell", ["vehicle_n12.straight_b16384",
                                  "kinematic_n20.straight_b32768",
                                  "vehicle_n12.circle_b16384"])
def test_a_tiny_run_is_correct(cell):
    from benchmark import run
    c = tiny(spec.cell(cell))
    res = run.measure(c, 2 ** 31 + 77, 0.0, False, "cpu")
    assert res["correct"], res["check"]
    assert res["attempted"] == 2 * c.traffic["batch"]
    assert res["detail"]["judged"] > 0
    assert list(res["check"]) == ["psi_gap", "crit_ratio", "plant_gap",
                                  "unconverged_share"]
    assert set(res["metrics"]) >= {"solves_per_s", "setup_s"}
    assert list(res)[-1] == "check"
