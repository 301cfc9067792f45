"""The yardstick of the benchmark's roofline and utilisation metrics: the
published peaks of one H100 and the operations of one evaluation of the
PANOC candidate fan, counted from the shapes.

A frozen copy of the program's utils/roofline.py rule (``fan_ops``), kept
here so that a change to the program cannot change what it is measured
against. The rule: each add, subtract, multiply, compare and select counts
1, and so does each transcendental function, square root and division; the
gradient counts as one more pass over the same operations without the
nearest-point search. Bytes: each operand read once and each output written
once, float32.
"""

from __future__ import annotations

#: NVIDIA's data sheet, H100 SXM at 700 W: float32 outside the tensor
#: cores, and device memory
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
F32 = 4

#: per evaluation of the ODE f(x, d, delta), and per stage for the terms
#: of (d, delta) alone (cos and sin delta; the kinematic model's beta)
ODE_OPS = {"pacejka": 53, "simplified": 8}
STAGE_OPS = {"pacejka": 2, "simplified": 6}
RK4_OPS = 13        # per state component and RK4 step
COST_OPS = 45       # one stage cost at its selected road points
ARGMIN_OPS = 6      # per road candidate: 2 differences, 2 squares, sum, compare
STATE_DIM = {"pacejka": 6, "simplified": 4}

#: fan evaluations of one PANOC solve: the initial pair (u0 and u0 + h),
#: then per iteration the forward-backward point and the 4 line-search taus
INIT_EVALS = 2
EVALS_PER_ITER = 5


def lane_stage_ops(model: str, substeps: int) -> int:
    """One stage of one lane without the nearest-point search."""
    sd = STATE_DIM[model]
    step = 4 * ODE_OPS[model] + RK4_OPS * sd
    return STAGE_OPS[model] + substeps * step + COST_OPS


def eval_ops(cfg: dict, road_points: int) -> int:
    """Operations of one fan evaluation (one lane, one candidate): the
    forward pass over N stages with the argmin over the road's
    ``road_points - 1`` candidates, and the gradient pass."""
    stage = lane_stage_ops(cfg["model"], cfg["substeps"])
    return cfg["n_horiz"] * (2 * stage + ARGMIN_OPS * (road_points - 1))


def eval_bytes(cfg: dict) -> int:
    """Bytes of one evaluation: the plan and the initial state read, the
    cost and the gradient written."""
    n = 2 * cfg["n_horiz"]
    return F32 * (n + STATE_DIM[cfg["model"]] + 1 + n)


def evaluations(lane_iterations: int, lane_solves: int) -> int:
    """The fan evaluations that ``lane_solves`` solves needed, given the
    sum of their own inner iterations."""
    return INIT_EVALS * lane_solves + EVALS_PER_ITER * lane_iterations


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the float32 rate
    or bytes at the memory rate, whichever is longer."""
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)
