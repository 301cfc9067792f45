"""The benchmark's own tests: CPU tests at a tiny size (a few lanes, a
step or two), and tests marked ``cuda`` that run the harness on the card
and skip without one. Run from the repository's root:

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def tiny(cell, batch=3, steps=2):
    """``cell`` cut to ``batch`` lanes and ``steps`` steps an episode, one
    warm-up step, no least number of steps, a trace slice of the first
    step."""
    cell.traffic.update(batch=batch, episode_steps=steps, warmup_steps=1,
                        min_steps=0)
    cell.traffic["trace_slice"] = {"start": 0, "steps": 1}
    return cell
