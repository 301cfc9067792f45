"""Timing, profiling and metrics utilities (port of
mpc_tpu/utils/timing.py): host-clock timers fenced on the card, latency
percentiles, and a per-step metrics accumulator of the solver's counters.

PyTorch returns before the card finishes, so a timer that ends without a
fence measures the enqueue. The fence here is ``torch.cuda.synchronize``
once CUDA is in use; CPU work needs none.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List

import numpy as np
import torch


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
