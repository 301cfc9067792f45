"""Device time from ``torch.profiler``'s raw events (its averages take
seconds to build at 10^5 kernels): the union of the device's intervals,
the time of the kernels by name, and the host's idle gaps by the host
operation that ended each (the one that launched the next device work).

The traced run profiles a slice of steps that the window already ran,
again from the state it ran them from, so that busy time (profiled) and
wall time (the same steps unprofiled, in the window) come from the same
work.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: the fan kernels K1, K1 roads, K2 and K3 are instances of
#: ``fused_psi_fan_phased`` in the program's csrc/fused_psi.cu
FAN_KERNEL = "fused_psi_fan"


@dataclasses.dataclass
class DeviceTrace:
    busy_s: float
    fan_s: float
    kernels: int
    device_ops: list          # [[name, seconds], ...] the 10 longest
    idle_gaps: list           # [[host op, seconds], ...] the 10 longest


def _short(name: str) -> str:
    name = name.split("(")[0]
    return name[5:] if name.startswith("void ") else name


def profile(fn):
    """Run ``fn()`` under the profiler (host and device activity)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    return prof


def reduce(prof) -> DeviceTrace:
    from torch.autograd import DeviceType
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start, dur = ev.start_ns(), ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            dev.append((start, start + dur, ev.name()))
        elif ev.device_type() == DeviceType.CPU and dur > 0:
            name = ev.name()
            if not name.startswith(("cuda", "ProfilerStep", "[memory]")):
                host.append((start, name))
    return reduce_intervals(dev, host)


def reduce_intervals(dev: list, host: list) -> DeviceTrace:
    """``dev``: (start ns, end ns, name) of the device's events; ``host``:
    (start ns, name) of the host's operations."""
    if not dev:
        return DeviceTrace(0.0, 0.0, 0, [], [])
    by_name, fan_ns, kernels = {}, 0, 0
    for s, e, name in dev:
        by_name[_short(name)] = by_name.get(_short(name), 0) + (e - s)
        if FAN_KERNEL in name:
            fan_ns += e - s
        if not name.startswith(("Memcpy", "Memset")):
            kernels += 1
    iv = np.array([(s, e) for s, e, _ in dev], dtype=np.int64)
    iv = iv[np.argsort(iv[:, 0])]
    # union of the intervals: a new run starts where an interval begins
    # after every earlier one has ended
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    run_id = np.cumsum(new) - 1
    starts = iv[new, 0]
    run_ends = np.zeros(run_id[-1] + 1, np.int64)
    np.maximum.at(run_ends, run_id, iv[:, 1])
    busy_ns = int((run_ends - starts).sum())
    gaps = []
    if len(starts) > 1 and host:
        g0, g1 = run_ends[:-1], starts[1:]
        hs = np.array([h[0] for h in host], dtype=np.int64)
        order = np.argsort(hs)
        hs = hs[order]
        names = [host[i][1] for i in order]
        who = np.searchsorted(hs, g1, side="right") - 1
        tot = {}
        for w, d in zip(who, g1 - g0):
            key = names[w] if w >= 0 else "host before the first operation"
            tot[key] = tot.get(key, 0) + int(d)
        gaps = sorted(tot.items(), key=lambda kv: -kv[1])[:10]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return DeviceTrace(busy_ns / 1e9, fan_ns / 1e9, kernels,
                       [[n, v / 1e9] for n, v in ops],
                       [[n, v / 1e9] for n, v in gaps])
