"""A straight road: ``points`` points ``start + spacing * i`` on the x
axis, (S, 2) float32 (the program's ``straight_centerline``)."""

import numpy as np


def points(spec: dict) -> np.ndarray:
    i = np.arange(spec["points"], dtype=np.float64)
    pts = np.stack([spec["start"] + spec["spacing"] * i, np.zeros_like(i)],
                   axis=1)
    return pts.astype(np.float32)
