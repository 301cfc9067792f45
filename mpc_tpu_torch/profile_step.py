"""Where a closed-loop step's time goes on the card: device-busy time, the
fan kernel's share of it, device kernels per step, and the device's idle
share. Same controller, road and initial states as ``mpc_tpu_torch.bench``.

    python -m mpc_tpu_torch.profile_step

For batch 1024 and batch 1: 5 warm-up steps, then 3 steps run twice from the
same state. The first time they are timed on the host clock, with a
synchronise after each step and no profiler. The second time they run under
``torch.profiler``. The steps are deterministic, so both runs do the same
work; the script checks that their iteration counts agree. So the idle share,
``1 - busy / wall``, takes busy from the profiled run and wall from the
unprofiled run of the same steps in the same process.

Busy is the union of the device intervals (kernels, copies, sets) in the
profiler's trace. The trace is written to ``build/profile/`` in the checkout.
Prints one JSON line per batch, then the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from mpc_tpu_torch.bench import N_WARMUP, ClosedLoop, gpu_info

N_PROFILED = 3
FAN_KERNEL = "fused_psi_fan_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "build", "profile")


def _clone(ys, carry):
    return ys.clone(), type(carry)(*(t.clone() for t in carry))


def _run_steps(loop, ys, carry):
    """N_PROFILED steps; per step the wall time (s) and the slowest lane's
    iteration count."""
    walls, iters = [], []
    for _ in range(N_PROFILED):
        t0 = time.perf_counter()
        ys, carry, res = loop.step(ys, carry)
        iters.append(int(res.inner_iterations.max()))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls, iters


def _device_intervals(trace_path):
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    return [(e["ts"], e["ts"] + e["dur"], e["cat"], e["name"])
            for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for a, b in sorted((a, b) for a, b, _, _ in intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


@torch.no_grad()
def profile_batch(loop: ClosedLoop, batch: int) -> dict:
    from mpc_tpu_torch.ops import fused_psi as fp
    ys, carry = loop.start(batch)
    for _ in range(N_WARMUP):
        ys, carry, _ = loop.step(ys, carry)
    torch.cuda.synchronize()

    walls, iters = _run_steps(loop, *_clone(ys, carry))
    launches0 = fp.fan_value_and_grad.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_walls, prof_iters = _run_steps(loop, *_clone(ys, carry))
    launches = fp.fan_value_and_grad.launches - launches0
    if prof_iters != iters:
        raise RuntimeError(f"the profiled steps did other work than the "
                           f"timed ones: iterations {prof_iters} vs {iters}")

    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"trace_batch{batch}.json")
    prof.export_chrome_trace(path)
    dev = _device_intervals(path)
    kernels = [iv for iv in dev if iv[2] == "kernel"]
    fan = [iv for iv in kernels if FAN_KERNEL in iv[3]]
    if not kernels or not fan:
        raise RuntimeError(f"the profiler's trace holds {len(kernels)} "
                           f"device kernels, {len(fan)} of them the fan "
                           f"kernel: no device time to report")
    busy_ms = _union_us(dev) / 1e3
    fan_ms = sum(b - a for a, b, _, _ in fan) / 1e3
    wall_ms = sum(walls) * 1e3
    return {
        "batch": batch, "steps": N_PROFILED, "slowest_lane_iters": iters,
        "wall_ms": wall_ms, "wall_ms_under_profiler": sum(prof_walls) * 1e3,
        "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
        "fan_kernel_ms": fan_ms, "fan_share_of_busy": fan_ms / busy_ms,
        "fan_launches": launches, "fan_kernels_in_trace": len(fan),
        "fan_us_per_launch": fan_ms * 1e3 / len(fan),
        "device_kernels": len(kernels),
        "device_kernels_per_iteration": len(kernels) / sum(iters),
        "trace": os.path.relpath(path, ROOT),
    }


def main():
    info = gpu_info()
    loop = ClosedLoop()
    for batch in (1024, 1):
        r = profile_batch(loop, batch)
        r["device"] = info["name"]
        r["power_limit"] = info["power_limit"]
        print(json.dumps({"profile": r}), flush=True)
    print(info["nvidia_smi"])


if __name__ == "__main__":
    main()
