"""A run whose timed path is broken underneath comes out not correct: one
case for each fault the cells can have (a step that returns its state
unchanged, flagged unconverged or, its solve skipped, flagged converged
with its true cost; half of the batch left out; the fan's gradient wrong
while its value is right; an answer altered where it is produced), and the
control (the reference in TF32 in the program's place). The harness's
look for a card is skipped: the rest of a run is driven on the CPU at a
tiny size."""

import pytest

from benchmark import run
from benchmark.core import spec
from benchmark.tests.conftest import tiny

SEED = 2 ** 31 + 4242

#: the number that each fault has to fail, where one alone can see it
CAUGHT_BY = {"stale": "crit_ratio", "grad_half": "crit_ratio",
             "psi": "psi_gap", "u0": "plant_gap",
             "unchanged": "unconverged_share"}


def _over(res) -> list:
    return [k for k, v in res["check"].items() if not v["value"] <= v["limit"]]


@pytest.mark.parametrize("name", ["vehicle_n12.straight_b16384",
                                  "kinematic_n20.straight_b32768"])
@pytest.mark.parametrize("fault", ["unchanged", "stale", "half", "grad_half",
                                   "psi", "u0"])
def test_a_broken_step_is_not_correct(name, fault):
    c = tiny(spec.cell(name), batch=4, steps=2)
    prog = c.program().broken(c.cfg, c.traffic, "cpu", fault)
    res = run.measure(c, SEED, 0.0, False, "cpu", prog=prog)
    assert not res["correct"], res["check"]
    if fault in CAUGHT_BY:
        assert CAUGHT_BY[fault] in _over(res), res["check"]


def test_every_fault_is_tested():
    c = spec.cell("vehicle_n12.straight_b16384")
    assert set(c.program().FAULTS) == {"unchanged", "stale", "half",
                                       "grad_half", "psi", "u0"}


def test_the_control_is_not_correct():
    c = tiny(spec.cell("vehicle_n12.straight_b16384"), batch=2, steps=1)
    ctl = c.program().control(c.cfg, c.traffic, "cpu")
    res = run.measure(c, SEED, 0.0, False, "cpu", prog=ctl)
    assert not res["correct"], res["check"]
    assert "plant_gap" in _over(res), res["check"]
