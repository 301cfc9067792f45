"""The traffic: a mix's pool of lanes is the same in every run, and each
seed hands it to the program in an order of its own, the same for one
seed."""

import numpy as np
import pytest
import torch

from benchmark.core import seeds, spec, window
from benchmark.generators import fleet

CELLS = ("vehicle_n12.straight_b16384", "kinematic_n20.straight_b32768",
         "vehicle_n12.circle_b16384")
BIG = 2 ** 31 + 12345


@pytest.mark.parametrize("name", CELLS)
def test_the_pool_is_the_mixs_own(name):
    c = spec.cell(name)
    shared, lanes = fleet.make(c.traffic)
    again_shared, again = fleet.make(c.traffic)
    y = lanes["y0"]
    assert y.shape == (c.traffic["batch"], len(c.traffic["initial_state"]))
    assert y.dtype == np.float32 and shared["centerline"].dtype == np.float32
    np.testing.assert_array_equal(y, again["y0"])
    np.testing.assert_array_equal(shared["centerline"],
                                  again_shared["centerline"])
    other = dict(c.traffic, pool_seed=c.traffic["pool_seed"] + 1)
    assert not np.array_equal(fleet.make(other)[1]["y0"], y)


@pytest.mark.parametrize("name", CELLS)
def test_every_seed_has_its_own_order(name):
    c = spec.cell(name)
    c.traffic["batch"] = 256
    _, pool = fleet.make(c.traffic)
    a = window.inputs(c, BIG, "cpu")[1]["y0"].numpy()
    b = window.inputs(c, BIG, "cpu")[1]["y0"].numpy()
    other = window.inputs(c, BIG + 1, "cpu")[1]["y0"].numpy()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, other)
    for x in (a, other):
        np.testing.assert_array_equal(np.unique(x, axis=0),
                                      np.unique(pool["y0"], axis=0))


def test_circle_starts_on_its_road():
    c = spec.cell("vehicle_n12.circle_b16384")
    shared, lanes = fleet.make(c.traffic)
    road, y = shared["centerline"], lanes["y0"]
    np.testing.assert_allclose(y[:, 0], road[0, 0])
    assert np.all(np.abs(y[:, 1] - road[0, 1]) <= 0.05 + 1e-6)
    np.testing.assert_allclose(y[:, 2], np.pi / 2, atol=0.05)


def test_large_seeds_are_taken():
    for s in (2 ** 31 + 5, 2 ** 63 + 5, -3):
        assert sorted(seeds.order(s, 10)) == list(range(10))
    assert not np.array_equal(seeds.order(2 ** 63 + 5, 50),
                              seeds.order(2 ** 63 + 6, 50))


def test_the_window_runs_the_least_number_of_steps():
    """A window closes at an episode's end, once ``seconds`` have passed
    and ``min_steps`` have run."""
    from benchmark.tests.conftest import tiny

    class Fake:
        def init_carry(self, B):
            return None

        def step(self, carry, y, inputs):
            from types import SimpleNamespace
            res = SimpleNamespace(inner_iterations=torch.ones(y.shape[0]))
            return SimpleNamespace(carry=None, u0=y[:, :2], result=res)

        def plant(self, y, u0):
            return y

    c = tiny(spec.cell("vehicle_n12.straight_b16384"), batch=2, steps=3)
    c.traffic["min_steps"] = 7
    win = window.run(Fake(), c, 1, 0.0, "cpu")
    assert len(win.steps) == 9
    assert [s.episode for s in win.steps] == [0] * 3 + [1] * 3 + [2] * 3
