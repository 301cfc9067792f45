"""Timing, profiling and metrics utilities (port of
mpc_tpu/utils/timing.py): host-clock timers fenced on the card, latency
percentiles, and a per-step metrics accumulator of the solver's counters.

PyTorch returns before the card finishes, so a timer that ends without a
fence measures the enqueue. The fence here is ``torch.cuda.synchronize``
once CUDA is in use; CPU work needs none.

The solve path's spans (:func:`span`, named in ``SPANS``) are host ranges
in a recording ``torch.profiler``'s trace and nothing otherwise. They ride
in the profiler's own trace, on the clock of its device events, and
:func:`span_breakdown` puts the device's idle gaps and kernels down to them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

#: the solve path's spans, outermost first: ``mpc.step`` (a controller
#: step), ``alm.solve`` (param_prep and the solve), ``alm.outer`` (one
#: outer iteration of the ALM general path) and inside it ``alm.update``
#: (the constraints at the inner solve's plan, the multiplier and penalty
#: update and the masked select), ``panoc.init`` (the projection and the
#: Lipschitz pair's fan), ``panoc.sync`` (the all-lanes-done check),
#: ``panoc.chunk`` (``_CHUNK`` masked trips); inside a trip
#: ``panoc.direction`` (the residual, the L-BFGS two-loop and the trust
#: cap), ``panoc.fan`` (the candidates and the fan's call) and
#: ``panoc.accept`` (QUB, FBE pick, L-BFGS push and the masked selects);
#: ``panoc.final`` (the criterion's refresh and the stagnation acceptance)
SPANS = ("mpc.step", "alm.solve", "alm.outer", "alm.update", "panoc.init",
         "panoc.sync", "panoc.chunk", "panoc.direction", "panoc.fan",
         "panoc.accept", "panoc.final")
#: the owner of device work issued while no span was open
OUTSIDE = "(outside the controller)"
#: the owner of kernels whose launch the trace lacks
UNATTRIBUTED = "(unattributed)"

_NO_SPAN = contextlib.nullcontext()
#: a host range of the function scope: ``record_function``'s user scope
#: would also put a copy of each range on the device's timeline (a
#: ``gpu_user_annotation`` over the kernels it launched), which a reader of
#: the device's intervals counts as busy time
_record = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A host range named ``name`` in the trace of a recording
    ``torch.profiler``; with no profiler recording, one shared no-op
    context (a flag's read: a range costs about 1 us unrecorded, 2 us
    recorded)."""
    if _autograd_profiler._is_profiler_enabled:
        return _record(name)
    return _NO_SPAN


def _fence() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_timer(result: Dict[str, float], key: str = "elapsed_s"):
    """Time a block to the end of its device work: ``result[key]`` is the
    host-clock seconds from entry to a fence at exit."""
    _fence()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _fence()
        result[key] = time.perf_counter() - t0


def timed(fn, *args, **kwargs):
    """Run ``fn``, fence the device, return ``(result, seconds)``."""
    _fence()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _fence()
    return out, time.perf_counter() - t0


def percentile_summary(samples) -> Dict[str, float]:
    s = np.asarray(samples, np.float64)
    return {
        "p50": float(np.percentile(s, 50)),
        "p90": float(np.percentile(s, 90)),
        "p99": float(np.percentile(s, 99)),
        "mean": float(s.mean()),
        "min": float(s.min()),
        "max": float(s.max()),
    }


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


@dataclasses.dataclass
class StepMetrics:
    """Per-MPC-step metrics across a run: latencies, inner iterations,
    solves and failures (mpc_tpu/utils/timing.py:51-78)."""
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    inner_iterations: List[int] = dataclasses.field(default_factory=list)
    failures: int = 0
    solves: int = 0

    def record(self, latency_s: float, iters, converged) -> None:
        iters = _numpy(iters)
        converged = _numpy(converged)
        self.latencies_s.append(float(latency_s))
        self.inner_iterations.append(int(iters.sum()))
        self.solves += int(converged.size)
        self.failures += int((~converged).sum())

    def summary(self) -> Dict[str, object]:
        lat = percentile_summary(self.latencies_s) if self.latencies_s else {}
        total_time = float(np.sum(self.latencies_s)) if self.latencies_s \
            else 0.0
        return {
            "solves": self.solves,
            "failures": self.failures,
            "tot_inner_iterations": int(np.sum(self.inner_iterations))
            if self.inner_iterations else 0,
            "solves_per_s": self.solves / total_time if total_time else 0.0,
            "step_latency": lat,
        }


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` over the block (the card's kernels too when CUDA
    is in use), its Chrome trace written to ``log_dir/trace.json``; yields
    the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        _fence()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _innermost(spans, times) -> list:
    """For each of ``times``, the name of the innermost of ``spans``
    ((start, end, name), nested as one thread opens them) open at it
    (start <= t < end), or ``OUTSIDE``."""
    spans = sorted(spans, key=lambda sp: (sp[0], -sp[1]))
    # at one time, ends (0) before starts (1), outer starts first
    bounds = sorted([(s, 1, i) for i, (s, _, _) in enumerate(spans)]
                    + [(e, 0, i) for i, (_, e, _) in enumerate(spans)])
    out = [OUTSIDE] * len(times)
    stack, j = [], 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        while j < len(bounds) and bounds[j][0] <= times[q]:
            _, opens, i = bounds[j]
            if opens:
                stack.append(i)
            elif stack and stack[-1] == i:
                stack.pop()
            else:
                stack.remove(i)
            j += 1
        if stack:
            out[q] = spans[stack[-1]][2]
    return out


def _by_value(totals: dict) -> dict:
    return dict(sorted(totals.items(), key=lambda kv: -kv[1]))


def span_breakdown(device_intervals, host_spans, launches) -> dict:
    """The device's idle gaps and kernels of a profiled run, put down to
    the program's spans.

    ``device_intervals``: ``(start ns, end ns, correlation id, name)`` of
    the device's events (kernels, copies, sets); ``host_spans``: ``(start
    ns, end ns, name)`` of the spans; ``launches``: ``{correlation id: host
    ns}`` of the host calls that issued device work; one clock for all.

    An idle gap (between two runs of the union of the device's intervals)
    goes to the innermost span open on the host when the work that ended
    it was issued: the launch of the gap's next event or, where the trace
    lacks that launch, the gap's end (``gaps_dated_by_device`` counts
    those). A kernel (not a copy or a set) goes to the innermost span open
    at its launch, or to ``UNATTRIBUTED`` where the trace lacks its launch.
    Work issued with no span open goes to ``OUTSIDE``.

    Returns ``{"idle_s": {owner: s}, "kernels": {owner: count}, "busy_s":
    the union of the intervals, "gaps_dated_by_device"}``, the dicts
    largest first.
    """
    ivs = sorted(device_intervals, key=lambda iv: (iv[0], iv[1]))
    gaps, gap_times, dated, busy, end = [], [], 0, 0, None
    for s, e, corr, _ in ivs:
        if end is not None and s <= end:        # the same run goes on
            busy += max(e - end, 0)
            end = max(e, end)
            continue
        if end is not None:
            gaps.append(s - end)
            when = launches.get(corr)
            if when is None:
                when, dated = s, dated + 1
            gap_times.append(when)
        busy += e - s
        end = e
    idle = {}
    for owner, g in zip(_innermost(host_spans, gap_times), gaps):
        idle[owner] = idle.get(owner, 0.0) + g / 1e9
    kern = [iv for iv in ivs if not iv[3].startswith(("Memcpy", "Memset"))]
    known = [iv for iv in kern if iv[2] in launches]
    counts = {}
    for owner in _innermost(host_spans, [launches[iv[2]] for iv in known]):
        counts[owner] = counts.get(owner, 0) + 1
    if len(known) < len(kern):
        counts[UNATTRIBUTED] = len(kern) - len(known)
    return {"idle_s": _by_value(idle), "kernels": _by_value(counts),
            "busy_s": busy / 1e9, "gaps_dated_by_device": dated}


def profiler_events(prof) -> tuple:
    """``(device_intervals, host_spans, launches)`` of a finished
    ``torch.profiler`` run, as :func:`span_breakdown` takes them, read from
    its raw events: the device's events, the host ranges named in
    ``SPANS``, and the host's CUDA API calls (``cu*``) by their
    correlation ids, which the device events they issued carry."""
    from torch.autograd import DeviceType
    wanted = set(SPANS)
    dev, spans, launches = [], [], {}
    for ev in prof.profiler.kineto_results.events():
        start, name = ev.start_ns(), ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():    # a host range's device copy
                dev.append((start, start + ev.duration_ns(),
                            ev.correlation_id(), name))
        elif name in wanted:
            spans.append((start, start + ev.duration_ns(), name))
        elif name.startswith("cu"):
            launches[ev.correlation_id()] = start
    return dev, spans, launches
