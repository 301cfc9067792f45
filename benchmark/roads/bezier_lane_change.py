"""A lane change: ``points`` points of the quintic Bezier of member
``member`` of the source's lane-change family (its bezier_curves.py), its
control points times ``scale``, (S, 2) float32, at the parameters
``k / (points - 1)``.

Member i's control points, from the family's geometry (lane width
``H = 3.75``, car width ``W = 1.8``, maximum heading ``THETA = 3.2`` deg,
segment ``SEG = 3.0`` and front overhang ``LF = 1.0``, speeds ``V0 = 20``
and ``V1 = 10``, gap ``D1 = 50``):

    d  = (LF + SEG) cos(atan2(W, 2 LF) - THETA)
    p2 = V0 D1 / (V0 - V1) - d,  p5 = 2 p2
    x  = (0, p2 / i, p2, p2, p5 - (p5 - p2) / i, p5),  y = (0, 0, 0, H, H, H)

and the curve ``sum_j C(5, j) (1 - t)^(5 - j) t^j P_j``, in float64 here.
"""

import math

import numpy as np

H, W, THETA = 3.75, 1.8, 3.2 / 180.0 * math.pi
SEG, LF = 3.0, 1.0
V0, V1, D1 = 20.0, 10.0, 50.0


def control_points(member: float) -> np.ndarray:
    """(6, 2) control points of member ``member``, unscaled."""
    d = (LF + SEG) * math.cos(math.atan2(W, 2.0 * LF) - THETA)
    p2 = V0 * D1 / (V0 - V1) - d
    p5 = 2.0 * p2
    x = [0.0, p2 / member, p2, p2, p5 - (p5 - p2) / member, p5]
    y = [0.0, 0.0, 0.0, H, H, H]
    return np.stack([x, y], axis=1)


def points(spec: dict) -> np.ndarray:
    S = spec["points"]
    t = np.arange(S, dtype=np.float64)[:, None] / (S - 1)
    j = np.arange(6, dtype=np.float64)[None, :]
    binom = np.array([math.comb(5, k) for k in range(6)], np.float64)
    basis = binom * (1.0 - t) ** (5 - j) * t ** j
    pts = basis @ (spec["scale"] * control_points(spec["member"]))
    return pts.astype(np.float32)
