"""The solve path's counters and spans: ``SolveStats`` on PANOC, on the ALM
general path and on the vehicle controller's CPU path; the spans' names and
nesting under ``torch.profiler`` for one controller step; ``span`` as a
shared no-op with no profiler recording; and ``span_breakdown``'s
attribution of idle gaps and kernels on synthetic intervals.
"""

import numpy as np
import pytest
import torch

from mpc_tpu_torch.config import AlmConfig, PanocConfig
from mpc_tpu_torch.control.mpc import build_vehicle_controller
from mpc_tpu_torch.models.params import VehicleParams
from mpc_tpu_torch.ops.road import straight_centerline
from mpc_tpu_torch.solver import alm as talm
from mpc_tpu_torch.solver import panoc as tpanoc
from mpc_tpu_torch.solver.problem import Box, Problem, value_and_grad
from mpc_tpu_torch.utils import timing

torch.set_num_threads(1)

CHUNK = tpanoc._CHUNK


def _assert_stats(stats, iterations):
    """The invariants of one PANOC solve's stats against its lanes'
    iterations: whole chunks, at least the slowest lane's iterations and
    at most a chunk more (a lane that converges spends one trip finding
    it), the waits inside the solve's time."""
    slowest = int(iterations.max())
    assert stats.trips % CHUNK == 0
    assert slowest <= stats.trips <= slowest + CHUNK
    assert 0.0 <= stats.sync_wait_s <= stats.loop_s


def _rosenbrock(u, t):
    return (t[:, 0] - u[:, 0]) ** 2 + 20.0 * (u[:, 1] - u[:, 0] ** 2) ** 2


def test_panoc_counts_its_trips():
    calls = []
    solve = tpanoc.make_panoc_solver(
        lambda u, t: value_and_grad(_rosenbrock, u, t),
        Box(torch.tensor([-2.0, -2.0]), torch.tensor([2.0, 2.0])),
        PanocConfig(lbfgs_memory=5, max_iter=100),
        progress_callback=lambda *a: calls.append(1))
    t = torch.tensor([[1.0], [0.5], [-0.7], [1.5], [0.0]])
    res = solve(torch.zeros((5, 2)), 1e-5, t)
    _assert_stats(res.stats, res.iterations)
    # the body runs once a trip over every lane, active or not
    assert len(calls) == res.stats.trips
    assert len(set(res.iterations.tolist())) > 1


def test_general_alm_path_sums_its_outer_iterations(monkeypatch):
    inner = []
    build = talm.make_panoc_solver

    def recording(*args, **kwargs):
        solve = build(*args, **kwargs)

        def wrapped(*a, **k):
            res = solve(*a, **k)
            inner.append(res)
            return res
        wrapped.fan_graph = solve.fan_graph
        return wrapped

    monkeypatch.setattr(talm, "make_panoc_solver", recording)
    prob = Problem(
        cost=lambda u, t: ((u - t) ** 2).sum(dim=1),
        constraints=lambda u, _: u[:, :1] + u[:, 1:], C=Box.unbounded(2),
        D=Box(torch.tensor([-1.0]), torch.tensor([1.0])), n=2, m=1)
    solve = talm.make_alm_solver(
        prob, AlmConfig(eps=1e-4, delta=1e-4, sigma_0=100.0, max_iter=12,
                        eps_0=1e-2),
        PanocConfig(lbfgs_memory=5, max_iter=200))
    targets = torch.tensor([[2.0, 2.0], [0.2, 0.3], [3.0, -1.0]])
    res = solve(targets, torch.zeros((3, 2)), torch.zeros((3, 1)))
    assert len(inner) == int(res.outer_iterations.max()) > 1
    for r in inner:
        _assert_stats(r.stats, r.iterations)
    assert res.stats.trips == sum(r.stats.trips for r in inner)
    assert res.stats.sync_wait_s >= sum(r.stats.sync_wait_s for r in inner)
    assert res.stats.loop_s >= sum(r.stats.loop_s for r in inner)
    assert 0.0 <= res.stats.sync_wait_s <= res.stats.loop_s
    assert res.stats.trips >= int(res.inner_iterations.max())


def _vehicle_step(batch=3, n_horiz=6, max_iter=40):
    ctrl = build_vehicle_controller(
        n_horiz=n_horiz, alm_cfg=AlmConfig(eps=1e-4),
        panoc_cfg=PanocConfig(lbfgs_memory=n_horiz, max_iter=max_iter),
        device="cpu")
    rng = np.random.default_rng(3)
    y0 = np.zeros((batch, 6), np.float32)
    y0[:, 0] = rng.uniform(-0.1, 0.5, batch)
    y0[:, 1] = rng.uniform(-0.1, 0.1, batch)
    y0[:, 3] = rng.uniform(0.3, 1.0, batch)
    param = {"y0": torch.as_tensor(y0), "p": VehicleParams(),
             "centerline": straight_centerline(100)}
    return ctrl, ctrl.init_carry(batch), param


def test_controller_step_carries_the_stats():
    ctrl, carry, param = _vehicle_step(n_horiz=4)
    out = ctrl.step(carry, param)
    _assert_stats(out.result.stats, out.result.inner_iterations)


def _spans(prof):
    _, spans, _ = timing.profiler_events(prof)
    return sorted(spans, key=lambda s: (s[0], -s[1]))


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_step_spans_nest_under_the_profiler():
    # one chunk, at N = 2: the profiler records every operation
    ctrl, carry, param = _vehicle_step(batch=2, n_horiz=2, max_iter=3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = ctrl.step(carry, param)
    spans = _spans(prof)
    by = {}
    for s in spans:
        by.setdefault(s[2], []).append(s)
    trips = out.result.stats.trips
    # the fast path: no outer iteration
    assert set(by) == set(timing.SPANS) - {"alm.outer", "alm.update"}
    counts = {k: len(v) for k, v in by.items()}
    assert counts == {"mpc.step": 1, "alm.solve": 1, "panoc.init": 1,
                      "panoc.final": 1, "panoc.sync": trips // CHUNK + 1,
                      "panoc.chunk": trips // CHUNK,
                      "panoc.direction": trips, "panoc.fan": trips,
                      "panoc.accept": trips}
    step, = by["mpc.step"]
    solve, = by["alm.solve"]
    assert _inside(solve, step)
    for name in ("panoc.init", "panoc.final", "panoc.sync", "panoc.chunk"):
        assert all(_inside(s, solve) for s in by[name]), name
    for name in ("panoc.direction", "panoc.fan", "panoc.accept"):
        assert all(any(_inside(s, c) for c in by["panoc.chunk"])
                   for s in by[name]), name
    # one trip: direction, then the fan, then the accept, disjoint
    for d, f, a in zip(by["panoc.direction"], by["panoc.fan"],
                       by["panoc.accept"]):
        assert d[1] <= f[0] and f[1] <= a[0]


def test_span_is_a_shared_no_op_without_a_profiler(monkeypatch):
    made = []

    def record(name):
        made.append(name)
        return timing._NO_SPAN

    monkeypatch.setattr(timing, "_record", record)
    first = timing.span("panoc.fan")
    assert first is timing.span("panoc.chunk") is timing._NO_SPAN
    with timing.span("panoc.fan"):
        pass
    assert made == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        timing.span("panoc.fan")
    assert made == ["panoc.fan"]


def test_spans_are_host_ranges_of_the_function_scope():
    # not record_function's user scope, whose ranges the profiler mirrors
    # on the device's timeline when it traces CUDA
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timing.span("panoc.chunk"):
            with timing.span("panoc.fan"):
                torch.ones(2).sum()
    evs = [ev for ev in prof.profiler.kineto_results.events()
           if ev.name() in timing.SPANS]
    assert sorted(ev.name() for ev in evs) == ["panoc.chunk", "panoc.fan"]
    assert not any(ev.is_user_annotation() for ev in evs)


def test_span_breakdown_attributes_gaps_and_kernels():
    spans = [(0, 1000, "panoc.chunk"), (100, 400, "panoc.fan"),
             (500, 900, "panoc.accept")]
    # (start, end, correlation id, name) on the device; launches by id
    dev = [(10, 90, 1, "k_direction"), (80, 120, 2, "k_more"),
           (300, 350, 3, "fused_psi_fan_phased"),
           (600, 700, 4, "Memcpy HtoD"),
           (1500, 1600, 5, "k_plant"),
           (1700, 1750, 6, "k_no_launch")]
    launches = {1: 5, 2: 70, 3: 250, 4: 550, 5: 1400}
    r = timing.span_breakdown(dev, spans, launches)
    # gaps: 120-300 ended by the fan kernel (launched inside panoc.fan),
    # 350-600 by the copy (inside panoc.accept), 700-1500 by the plant's
    # kernel (launched after every span closed), 1600-1700 by a kernel
    # with no launch, dated by its start (after every span)
    assert r["idle_s"] == pytest.approx({
        "panoc.fan": 180e-9, "panoc.accept": 250e-9,
        timing.OUTSIDE: 900e-9})
    # the gaps make up the trace's span less its busy union
    assert r["busy_s"] == pytest.approx(410e-9)
    assert sum(r["idle_s"].values()) == pytest.approx((1750 - 10) * 1e-9
                                                      - r["busy_s"])
    assert r["gaps_dated_by_device"] == 1
    assert r["kernels"] == {"panoc.chunk": 2, "panoc.fan": 1,
                            timing.OUTSIDE: 1, timing.UNATTRIBUTED: 1}
    assert list(r["idle_s"])[0] == timing.OUTSIDE
