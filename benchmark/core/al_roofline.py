"""The yardstick of the AL fan's roofline metric: the operations and bytes
of one evaluation of kernel K3, the Pacejka candidate fan plus the
augmented-Lagrangian terms of the state constraints, counted from the
shapes.

A frozen rule beside ``core/roofline.py``, whose K1 count it extends and
whose rule it follows (each add, subtract, multiply, compare and select
counts 1, and so do each division and transcendental function; the
gradient counts as one more pass over the same operations without the
nearest-point search; each operand read once and each output written once,
float32). Per constraint and stage (``AL_OPS`` = 11): g = x^2 - offset
(2), zeta = g + lam / sigma (2), zhat = clip(zeta, lower, upper) (2),
r = zeta - zhat (1), sigma r^2 / 2 (3) and its add into the total (1).
"""

from __future__ import annotations

from benchmark.core import roofline as rf

AL_OPS = 11


def eval_ops(cfg: dict, road_points: int) -> int:
    """Operations of one K3 evaluation (one lane, one candidate): K1's
    count and the AL terms of the state's constraints at every stage,
    forward and gradient."""
    n_cons = len(cfg["constraints"]["offsets"])
    return rf.eval_ops(cfg, road_points) \
        + cfg["n_horiz"] * 2 * n_cons * AL_OPS


def eval_bytes(cfg: dict) -> int:
    """Bytes of one evaluation: K1's, and the lane's multipliers and
    penalties read."""
    m = len(cfg["constraints"]["offsets"]) * cfg["n_horiz"]
    return rf.eval_bytes(cfg) + 2 * m * rf.F32
