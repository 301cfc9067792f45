"""The readers of the program's solve counters (``step.result.stats``):
``panoc_lane_occupancy``, ``host_ms_per_trip`` and ``device_wait_share``
on a synthetic run, nothing on a program that keeps no counters, and all
three on a tiny window of a cell on the CPU, whose every step ran whole
chunks of trips, no fewer than its slowest lane's iterations and at most
a chunk more."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.core import spec
from benchmark.tests.conftest import tiny

READERS = ("panoc_lane_occupancy", "host_ms_per_trip", "device_wait_share")


def _stats(trips, loop_s, sync_wait_s):
    return SimpleNamespace(trips=trips, loop_s=loop_s,
                           sync_wait_s=sync_wait_s)


def _run(stats, batch, lane_iters):
    steps = [SimpleNamespace(result=SimpleNamespace(stats=s)) for s in stats]
    return SimpleNamespace(steps=steps, batch=batch,
                           lane_iters=np.asarray(lane_iters))


def test_readers_on_a_synthetic_run():
    # two steps of 4 lanes: 8 and 12 trips, 20 and 30 lane iterations
    run = _run([_stats(8, 0.10, 0.02), _stats(12, 0.30, 0.06)],
               [4, 4], [20, 30])
    read = {n: spec.metric_reader(n).read(run) for n in READERS}
    assert read["panoc_lane_occupancy"] == pytest.approx(
        100.0 * 50 / (4 * 8 + 4 * 12))
    assert read["host_ms_per_trip"] == pytest.approx(1e3 * 0.32 / 20)
    assert read["device_wait_share"] == pytest.approx(100.0 * 0.08 / 0.40)


def test_readers_read_nothing_without_counters():
    # a program whose results carry no stats field, or an empty one
    bare = SimpleNamespace(steps=[SimpleNamespace(result=SimpleNamespace())],
                           batch=[4], lane_iters=np.array([20]))
    for run in (bare, _run([None], [4], [20])):
        for n in READERS:
            assert spec.metric_reader(n).read(run) is None, n


def test_readers_on_a_tiny_window():
    from benchmark.core import window
    c = tiny(spec.cell("vehicle_n12.straight_b16384"))
    prog = c.program().build(c.cfg, c.traffic, "cpu")
    win = window.run(prog, c, 2 ** 31 + 5, 0.0, "cpu", episodes=1)
    iters = torch.stack([s.iters for s in win.steps])
    for s, slowest in zip(win.steps, iters.amax(dim=1).tolist()):
        trips = s.result.stats.trips
        assert trips % 4 == 0 and slowest <= trips <= slowest + 4
    run = SimpleNamespace(steps=win.steps, batch=[len(i) for i in iters],
                          lane_iters=iters.sum(dim=1).numpy())
    m = {n: spec.metric_reader(n).read(run) for n in READERS}
    assert 0.0 < m["panoc_lane_occupancy"] <= 100.0
    assert 0.0 <= m["device_wait_share"] < 100.0
    assert m["host_ms_per_trip"] > 0.0
