"""One episode of a closed loop: every lane from a cold carry, each step
the program's controller on every lane and then the plant, ended by a
sync and timed on the host clock.

The program (``benchmark/programs/<program>.py``) gives ``init_carry(B)``,
``step(carry, y, inputs) -> (carry, u0, result)``, with ``result`` the
solver's answer for every lane (its ``inner_iterations`` the work), and
``plant(y, u0) -> y_next``. Nothing is copied or reduced inside an
episode: a step keeps references to what the program returned.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch


@dataclasses.dataclass
class Step:
    """One closed-loop step of every lane, as the program left it: the
    plant states before (``y``) and after (``y_next``), the solver's
    ``result``, each lane's inner iterations (``iters``), the shared inputs
    (``inputs``, the road), the step's host seconds and, where the trace
    replays from it, the carry the step started from."""
    episode: int
    index: int
    y: torch.Tensor
    y_next: torch.Tensor
    result: object
    iters: torch.Tensor
    inputs: dict
    seconds: float
    carry: object = None


def episode(prog, inputs: dict, lanes: dict, n_steps: int,
            sync: Callable[[], None], keep=()) -> list:
    """``n_steps`` steps from ``lanes["y0"]``; the steps whose index is in
    ``keep`` keep the carry they started from."""
    y = lanes["y0"]
    carry = prog.init_carry(y.shape[0])
    steps = []
    for k in range(n_steps):
        t0 = time.perf_counter()
        out = prog.step(carry, y, inputs)
        y2 = prog.plant(y, out.u0)
        sync()
        dt = time.perf_counter() - t0
        steps.append(Step(0, k, y, y2, out.result,
                          out.result.inner_iterations, inputs, dt,
                          carry=carry if k in keep else None))
        y, carry = y2, out.carry
    return steps


def replay(prog, steps: list, sync: Callable[[], None]) -> Callable:
    """A function that runs ``steps`` again from the state and carry the
    first of them started from, and syncs."""
    def work():
        y, carry = steps[0].y, steps[0].carry
        for s in steps:
            out = prog.step(carry, y, s.inputs)
            y, carry = prog.plant(y, out.u0), out.carry
        sync()
    return work
