"""Where a closed-loop step's time goes on the card: device-busy time, the
fan kernel's share of it, device kernels per step, and the device's idle
share. Same controllers, roads and initial states as ``mpc_tpu_torch.bench``.

    python -m mpc_tpu_torch.profile_step [headline|config1|ss_n40|ilqr_n40|etc|config5|config4|ms_n40_m8|config5_obs|chain|mesh_dp|mesh_lqt|mesh_ilqr]

For the cell's batch (and its batch-1 loop's, where it has one): the cell's
warm-up steps, then 3 steps (1 for ss_n40, whose step runs some 1,500
device kernels per PANOC iteration over hundreds of iterations) run twice
from the same state. For ilqr_n40, whose inner iteration issues some 45,000
kernels and whose step runs tens of them, the profiled unit is 2 AL-iLQR
inner iterations from the warm carry (``solve.prepare_inner``), not a step.
For etc it is the cell's 12 timed steps: its lanes re-solve together, on
the step where their plans expire (one step in 12), and replay between.
For config5 it is the first 3 steps of the two-tier suite after its
untimed 2-step pass, both tiers; the fan kernel's time is also split by
tier (each tier's launches, counted per controller step, in launch
order), which gives the straggler lanes' share of K1 time. For config4 it is the first 3
steps of the two-car loop after a warm loop. The cells of the plain OCP
(ms_n40_m8, config5_obs, chain), whose fans launch some 10^4 kernels per
PANOC iteration over hundreds of iterations a step, are profiled over one
controller step at the cell's batch with one outer iteration of at most
``CAPPED_ITERS`` PANOC iterations (config5_obs: its cheap tier over all
lanes), from the cell's start: the kernels per iteration and the idle
share of an iteration. The sharded cells (mesh_dp, mesh_lqt, mesh_ilqr)
are profiled over one warm call of the cell's runner (``MESH_RUNNERS``:
one sharded solve, one LQT solve, one closed-loop step) after one warm-up
call, over a world of one rank in this process: the runner's own host
clock gives the call's wall, and ``torch.profiler`` around that call alone
(the card's activity only, no trace file: a mesh_ilqr step launches some
390,000 kernels) its device-busy time and kernels, the sum of the device
events' times over one stream.
The first time they are timed on the host clock, with a synchronise after
each and no profiler. The second time they run under ``torch.profiler``.
They are deterministic, so both runs do the same work; the script checks
that their iteration counts agree. So the idle share, ``1 - busy / wall``,
takes busy from the profiled run and wall from the unprofiled run of the
same work in the same process.

Busy is the union of the device intervals (kernels, copies, sets) in the
profiler's trace. The trace is written to ``build/profile/`` in the checkout.
Prints one JSON line per batch, then the card's name and power limit.

For the closed-loop cells with a fan (headline, config1, ss_n40, etc) the
line also puts the profiled steps' device idle gaps and kernels down to the
program's spans (``utils/timing.py:span_breakdown``): ``idle_by_span_s``,
each gap's seconds under the innermost span open when the host issued the
work that ended it, and ``kernels_per_trip_by_span``, each span's kernels
per masked PANOC trip; ``(outside the controller)`` is the plant and the
loop, ``(unattributed)`` kernels whose launch the trace lacks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from mpc_tpu_torch.bench import (CELLS, MESH_RUNNERS, ChainCell, ClosedLoop,
                                 MeshCell, StepRecord, SuiteCell, TwoCarCell,
                                 chain_setup, gpu_info, suite_setup,
                                 two_car_setup)
from mpc_tpu_torch.config import IlqrConfig
from mpc_tpu_torch.sim.scenarios import run_scenario_suite_two_tier
from mpc_tpu_torch.utils.timing import (UNATTRIBUTED, profiler_events,
                                        span_breakdown)

N_PROFILED = {"headline": 3, "config1": 3, "ss_n40": 1, "ilqr_n40": 2,
              "etc": 12, "config5": 3, "config4": 3}
UNFUSED = ("ms_n40_m8", "config5_obs", "chain")
CAPPED_ITERS = 4      # one chunk of masked PANOC iterations
FAN_KERNEL = "fused_psi_fan"   # K1, K2 fused_psi_fan_phased; K3 its 3 kernels
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "build", "profile")


def _clone(ys, carry):
    return ys.clone(), type(carry)(*(t.clone() for t in carry))


def _run_steps(loop, ys, carry, trips=None):
    """The cell's profiled steps; per step the wall time (s) and the slowest
    lane's iteration count. ``trips``, a list, gets each step's masked
    PANOC trips (``SolveStats.trips``)."""
    walls, iters = [], []
    for _ in range(N_PROFILED[loop.cell.name]):
        t0 = time.perf_counter()
        ys, carry, out = loop.step(ys, carry)
        iters.append(int(out.result.inner_iterations.max()))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if trips is not None:
            trips.append(out.result.stats.trips)
    return walls, iters


def _run_inner_iterations(iterate, st):
    """Masked AL-iLQR inner iterations from ``st``; per iteration the wall
    time (s) and 1."""
    walls = []
    for _ in range(N_PROFILED["ilqr_n40"]):
        t0 = time.perf_counter()
        st = iterate(st)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls, [1] * len(walls)


def _profile(work, name: str, batch: int):
    """``work() -> (walls, iters)``, run once on the host clock and once
    under the profiler: ``(walls, iters, walls under the profiler, the
    trace's events as ``utils.timing.profiler_events`` reads them, the
    trace's path)``; RuntimeError if the two runs did other work."""
    walls, iters = work()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_walls, prof_iters = work()
    if prof_iters != iters:
        raise RuntimeError(f"the profiled steps did other work than the "
                           f"timed ones: iterations {prof_iters} vs {iters}")
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"trace_{name}_batch{batch}.json")
    prof.export_chrome_trace(path)
    return walls, iters, prof_walls, profiler_events(prof), path


def device_time(prof) -> tuple:
    """``(device-busy ms, device kernels)`` of a finished ``torch.profiler``
    run, read from its raw events (building its averages takes seconds a
    100,000 events): the device events' summed time (on one stream they do
    not overlap) and the kernels among them (not the copies and sets).
    Raises if the run holds no kernel."""
    from torch.autograd import DeviceType
    busy_ns, kernels = 0, 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        busy_ns += ev.duration_ns()
        if not ev.name().startswith(("Memcpy", "Memset")):
            kernels += 1
    if not kernels:
        raise RuntimeError("the profiler saw no device kernel: device time "
                           "not measured")
    return busy_ns / 1e6, kernels


def _summary(name, batch, unit, walls, iters, prof_walls, events, path,
             has_fan=True, trips=None) -> dict:
    """The line of a profiled run from ``_profile``'s results; with
    ``trips``, the masked PANOC trips of the profiled steps, also the
    idle and kernels by span (``_by_span``). Returns the line and the fan
    kernels' device intervals (ns), in order."""
    dev = events[0]
    kernels = [iv for iv in dev
               if not iv[3].startswith(("Memcpy", "Memset"))]
    fan = [iv for iv in kernels if FAN_KERNEL in iv[3]]
    if not kernels or has_fan != bool(fan):
        raise RuntimeError(f"the profiler's trace holds {len(kernels)} "
                           f"device kernels, {len(fan)} of them the fan "
                           f"kernel, on a path {'with' if has_fan else 'without'}"
                           f" one")
    spans = span_breakdown(*events)
    busy_ms = spans["busy_s"] * 1e3
    wall_ms = sum(walls) * 1e3
    r = {
        "cell": name, "batch": batch, "unit": unit,
        "units": len(iters), "slowest_lane_iters": iters,
        "wall_ms": wall_ms, "wall_ms_under_profiler": sum(prof_walls) * 1e3,
        "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
        "device_kernels": len(kernels),
        "device_kernels_per_iteration": len(kernels) / sum(iters),
        "trace": os.path.relpath(path, ROOT),
    }
    if has_fan:
        fan_ms = sum(b - a for a, b, _, _ in fan) / 1e6
        r.update({
            "fan_kernel_ms": fan_ms, "fan_share_of_busy": fan_ms / busy_ms,
            "fan_kernels_in_trace": len(fan),
            "fan_us_per_launch": fan_ms * 1e3 / len(fan)})
    if trips is not None:
        r.update(_by_span(spans, trips))
    return r, sorted(fan)


@torch.no_grad()
def profile_suite(cell: SuiteCell) -> dict:
    """Config 5: ``N_PROFILED`` steps of the two-tier suite from the
    scenarios' start, after the cell's untimed pass. The profiled unit is a
    step; its iterations are the slowest lane's over both tiers."""
    from mpc_tpu_torch.ops import fused_psi as fp
    record = StepRecord()
    sc, params, f_d, full, cheap = suite_setup(cell, record)
    n = N_PROFILED[cell.name]

    def suite(n_sim):
        return run_scenario_suite_two_tier(full, cheap, f_d, sc, params,
                                           n_sim, cell.straggler_pad)

    suite(cell.n_warm_steps)
    torch.cuda.synchronize()
    stats = []

    def work():
        record.clear()
        launches0 = fp.fan_value_and_grad.launches
        t0 = time.perf_counter()
        state, _ = suite(n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = state["stats"]
        stats.append((st, record.launches_by_tier(),
                      fp.fan_value_and_grad.launches - launches0))
        # per step, the slowest lane of each tier (a tier that ran)
        it = [int(x) for x in torch.stack(record.iters).cpu()]
        per_step, k = [], 0
        for j in range(n):
            m = 2 if st["n_stragglers"][j] else 1
            per_step.append(sum(it[k:k + m]))
            k += m
        return [wall / n] * n, per_step

    walls, iters, prof_walls, events, path = _profile(work, cell.name,
                                                      cell.batch)
    r, fan = _summary(cell.name, cell.batch, "step", walls, iters,
                      prof_walls, events, path)
    st, tiers, launches = stats[-1]
    # the fan kernels run in launch order on one stream: each step's cheap
    # tier's launches, then its straggler tier's
    tier_ms = {"cheap": 0.0, "straggler": 0.0}
    k = 0
    for nc, ns in zip(tiers["cheap"], tiers["straggler"]):
        for tier, cnt in (("cheap", nc), ("straggler", ns)):
            tier_ms[tier] += sum(b - a for a, b, _, _ in fan[k:k + cnt]) / 1e6
            k += cnt
    if k != len(fan) or launches != len(fan):
        raise RuntimeError(f"{len(fan)} fan kernels in the trace, "
                           f"{launches} launched ({k} counted by tier)")
    r.update({
        "wall_ms_note": "the suite's wall over its steps",
        "fan_launches": launches,
        "n_stragglers": st["n_stragglers"],
        "fan_launches_cheap": tiers["cheap"],
        "fan_launches_straggler": tiers["straggler"],
        "fan_ms_cheap": tier_ms["cheap"],
        "fan_ms_straggler": tier_ms["straggler"],
        "straggler_share_of_fan": tier_ms["straggler"] / r["fan_kernel_ms"],
        # the tiers' host-clock seconds of the unprofiled run
        "cheap_s": stats[0][0]["cheap_s"],
        "straggler_s": stats[0][0]["straggler_s"]})
    return r


@torch.no_grad()
def profile_two_car(cell: TwoCarCell) -> dict:
    """Config 4: ``N_PROFILED`` steps of the two-car loop over its pairs,
    after one warm loop. The profiled unit is a step."""
    from mpc_tpu_torch.ops import fused_psi as fp
    record = StepRecord()
    n = N_PROFILED[cell.name]
    game, y0a, y0b = two_car_setup(
        dataclasses.replace(cell, n_sim=n), record)
    game(y0a, y0b, 1, 1)
    torch.cuda.synchronize()
    launches = []

    def work():
        record.clear()
        launches0 = fp.fan_value_and_grad.launches
        t0 = time.perf_counter()
        game(y0a, y0b, 1, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches.append(fp.fan_value_and_grad.launches - launches0)
        return [wall / n] * n, [int(x)
                                for x in torch.stack(record.iters).cpu()]

    walls, iters, prof_walls, events, path = _profile(work, cell.name,
                                                      cell.pairs)
    r, _ = _summary(cell.name, cell.pairs, "step (2 x pairs lanes)", walls,
                    iters, prof_walls, events, path)
    r["wall_ms_note"] = "the loop's wall over its steps"
    r["fan_launches"] = launches[-1]
    return r


@torch.no_grad()
def profile_batch(loop: ClosedLoop, batch: int) -> dict:
    from mpc_tpu_torch.ops import fused_psi as fp
    wrappers = (fp.fan_value_and_grad, fp.kin_fan_value_and_grad,
                fp.al_fan_value_and_grad)
    ys, carry = loop.start(batch)
    for _ in range(loop.cell.n_warmup):
        ys, carry, _ = loop.step(ys, carry)
    torch.cuda.synchronize()

    has_fan = not isinstance(loop.cell.solver_cfg, IlqrConfig)
    trips = []
    if has_fan:
        def work():
            trips.clear()
            return _run_steps(loop, *_clone(ys, carry), trips)
    else:
        # the inner problem of the next step's first outer iteration: the
        # warm carry's multipliers and penalties (cold lanes at sigma_0)
        sigma = torch.where(carry.sigma > 0, carry.sigma,
                            torch.full_like(carry.sigma,
                                            loop.cell.alm_cfg.sigma_0))
        st, iterate, _, _ = loop.ctrl.solve.prepare_inner(
            {"y0": ys, "p": loop.params, "centerline": loop.centerline},
            carry.U, carry.lam, sigma)

        def work():
            return _run_inner_iterations(iterate, st)

    launches0 = sum(w.launches for w in wrappers)
    walls, iters, prof_walls, events, path = _profile(
        work, loop.cell.name, batch)
    # the profiled run's launches: half of the two runs'
    launches = (sum(w.launches for w in wrappers) - launches0) // 2
    r, _ = _summary(loop.cell.name, batch,
                    "step" if has_fan else "inner iteration", walls, iters,
                    prof_walls, events, path, has_fan,
                    sum(trips) if has_fan else None)
    if has_fan:
        r["fan_launches"] = launches
    return r


def _by_span(spans: dict, trips: int) -> dict:
    """The profiled steps' device idle (s) and kernels per masked PANOC
    trip by the program span that issued them (``utils.timing``)."""
    return {
        "idle_by_span_s": spans["idle_s"],
        "kernels_per_trip_by_span": {k: n / trips
                                     for k, n in spans["kernels"].items()},
        "trips": trips,
        "unattributed_kernels": spans["kernels"].get(UNATTRIBUTED, 0),
        "idle_gaps_dated_by_device": spans["gaps_dated_by_device"]}


@torch.no_grad()
def profile_unfused(cell) -> dict:
    """A cell of the plain OCP: one controller step at the cell's batch
    from its start, one outer iteration of at most ``CAPPED_ITERS`` PANOC
    iterations (config5_obs: its cheap tier over every lane, chain: from
    the disturbed chain). No fan kernel may run."""
    alm = dataclasses.replace(cell.alm_cfg, max_iter=1) \
        if cell.alm_cfg is not None else None
    record = StepRecord()
    if isinstance(cell, SuiteCell):
        capped = dataclasses.replace(
            cell, alm_cfg=alm, cheap_cfg=dataclasses.replace(
                cell.cheap_cfg, max_iter=CAPPED_ITERS))
        sc, params, _, _, ctrl = suite_setup(capped, record)
        param = {"y0": sc.y0, "p": params, "centerline": sc.centerline,
                 "obstacles": sc.obstacles}
        batch = cell.batch
    elif isinstance(cell, ChainCell):
        from mpc_tpu_torch.config import AlmConfig
        capped = dataclasses.replace(
            cell, alm_cfg=AlmConfig(eps=1e-4, delta=1e-4, sigma_0=1e5,
                                    max_iter=1, eps_0=1e-2),
            solver_cfg=dataclasses.replace(cell.solver_cfg,
                                           max_iter=CAPPED_ITERS))
        ctrl, _, static, _, ys = chain_setup(capped, record)
        param, batch = dict(static, y0=ys), cell.batch
    else:
        capped = dataclasses.replace(
            cell, alm_cfg=alm, solver_cfg=dataclasses.replace(
                cell.solver_cfg, max_iter=CAPPED_ITERS))
        loop = ClosedLoop(capped)
        ys, _ = loop.start(cell.batch)
        ctrl, batch = loop.ctrl, cell.batch
        param = {"y0": ys, "p": loop.params, "centerline": loop.centerline}
    carry = ctrl.init_carry(batch)
    ctrl.step(carry, param)           # warm-up: the allocator's first pass
    torch.cuda.synchronize()

    def work():
        t0 = time.perf_counter()
        out = ctrl.step(carry, param)
        torch.cuda.synchronize()
        return [time.perf_counter() - t0], \
            [int(out.result.inner_iterations.max())]

    walls, iters, prof_walls, events, path = _profile(work, cell.name, batch)
    r, _ = _summary(cell.name, batch,
                    f"one step capped at {CAPPED_ITERS} PANOC iterations",
                    walls, iters, prof_walls, events, path, has_fan=False)
    return r


#: what each sharded cell's runner reports of its timed call: the work
#: that must be the same in the plain and the profiled run
MESH_WORK = {"mesh_dp": "inner_iterations_run", "mesh_lqt": None,
             "mesh_ilqr": "inner_iters_mean"}


@torch.no_grad()
def profile_mesh(cell: MeshCell) -> dict:
    """A sharded cell: its runner (``MESH_RUNNERS``) with one warm-up
    and one timed call, twice: plain, and with ``torch.profiler`` around the
    timed call alone. Wall from the plain run's timed call, busy and
    kernels from the profiled one's; RuntimeError if the two did other
    work."""
    import torch.distributed as dist
    runner = MESH_RUNNERS[cell.name]
    one = dataclasses.replace(cell, n_warmup=1, n_steps=1)
    measured = {}

    @contextlib.contextmanager
    def profiled():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            yield
        measured["busy_ms"], measured["kernels"] = device_time(prof)

    plain = runner(one)
    traced = runner(one, timed_call=profiled)
    key = MESH_WORK[cell.name]
    if key is not None and plain[key] != traced[key]:
        raise RuntimeError(f"the profiled call did other work than the "
                           f"timed one: {key} {traced[key]} vs {plain[key]}")
    wall_ms = plain["times_s"][0] * 1e3
    r = {"cell": cell.name, "batch": cell.batch, "n_horiz": cell.n_horiz,
         "unit": {"mesh_dp": "one sharded solve", "mesh_lqt": "one LQT solve",
                  "mesh_ilqr": "one closed-loop step"}[cell.name],
         "world": plain["world"], "backend": plain["backend"],
         "mesh": plain["mesh"], "wall_ms": wall_ms,
         "wall_ms_under_profiler": traced["times_s"][0] * 1e3,
         "device_busy_ms": measured["busy_ms"],
         "idle_share": 1.0 - measured["busy_ms"] / wall_ms,
         "device_kernels": measured["kernels"]}
    if key is not None:
        r[key] = plain[key]
    if dist.is_initialized():
        dist.destroy_process_group()
    return r


@torch.no_grad()
def profile_closed_loop(cell) -> list:
    """A fused or AL-iLQR cell: ``profile_batch`` at its batch and, where
    it has a batch-1 loop, at batch 1."""
    loop = ClosedLoop(cell)
    batches = (cell.batch,) if cell.batch1_steps is None else (cell.batch, 1)
    return [profile_batch(loop, batch) for batch in batches]


def profiler(cell):
    """The profile of a cell: ``fn(cell) -> dict or list of dicts``."""
    if cell.name in UNFUSED:
        return profile_unfused
    for kind, fn in ((SuiteCell, profile_suite), (TwoCarCell, profile_two_car),
                     (MeshCell, profile_mesh)):
        if isinstance(cell, kind):
            return fn
    return profile_closed_loop


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    name = argv[0] if argv else "headline"
    if name not in CELLS or len(argv) > 1:
        raise SystemExit(f"usage: python -m mpc_tpu_torch.profile_step "
                         f"[{'|'.join(CELLS)}]")
    info = gpu_info()
    cell = CELLS[name]
    out = profiler(cell)(cell)
    for r in out if isinstance(out, list) else [out]:
        r["device"] = info["name"]
        r["power_limit"] = info["power_limit"]
        print(json.dumps({"profile": r}), flush=True)
    print(info["nvidia_smi"])


if __name__ == "__main__":
    main()
