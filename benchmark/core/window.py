"""The timed window of a run, and the same loop for the set-up's warm-up.

The mix's generator (``benchmark/generators/<generator>.py``) makes its
inputs: those all lanes share, and the lanes, which the run puts in the
order its seed draws (``core/seeds.py``). Both go to the device once,
before the window. The window then runs whole episodes of the mix's loop
(``benchmark/loops/<loop>.py``), back to back, each from a cold start on
the same lanes, and closes at the end of the first episode that ends once
``seconds`` have passed and at least the mix's ``min_steps`` steps have
run: every run measures whole episodes, for at least ``seconds``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import torch

from benchmark.core import seeds


@dataclasses.dataclass
class Window:
    steps: List[object]
    wall: float
    inputs: dict


def sync_of(device) -> Callable[[], None]:
    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def inputs(cell, seed: int, device) -> tuple:
    """``(shared, lanes)`` of the cell's mix on ``device``, the lanes in
    the seed's order."""
    shared, lanes = cell.generator().make(cell.traffic, cell.root)
    n = len(next(iter(lanes.values())))
    order = seeds.order(seed, n)
    return ({k: torch.as_tensor(v, device=device) for k, v in shared.items()},
            {k: torch.as_tensor(v[order], device=device)
             for k, v in lanes.items()})


def trace_slice(traffic: dict) -> range:
    sl = traffic["trace_slice"]
    return range(sl["start"], sl["start"] + sl["steps"])


def run(prog, cell, seed: int, seconds: float, device,
        episodes: Optional[int] = None,
        n_steps: Optional[int] = None) -> Window:
    """Whole episodes of ``n_steps`` (the mix's ``episode_steps``) until
    ``seconds`` have passed and ``min_steps`` have run, or exactly
    ``episodes`` of them. The first episode's steps in the mix's
    ``trace_slice`` keep their carries."""
    loop, traffic = cell.loop(), cell.traffic
    sync = sync_of(device)
    shared, lanes = inputs(cell, seed, device)
    T = n_steps or traffic["episode_steps"]
    min_steps = traffic.get("min_steps", 0)
    keep = trace_slice(traffic)
    steps = []
    sync()
    t_start = time.perf_counter()
    e = 0
    while True:
        new = loop.episode(prog, shared, lanes, T, sync,
                           keep if e == 0 else ())
        for s in new:
            s.episode = e
        steps += new
        e += 1
        if episodes is not None:
            if e >= episodes:
                break
        elif time.perf_counter() - t_start >= seconds \
                and len(steps) >= min_steps:
            break
    return Window(steps, time.perf_counter() - t_start, shared)
