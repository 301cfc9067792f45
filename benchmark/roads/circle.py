"""A circle: ``points`` points of radius ``radius`` about ``center``,
shifted by ``y_offset``, the first and the last at angle 0, (S, 2)
float32 (the circle road of the program's warm-start experiment)."""

import numpy as np


def points(spec: dict) -> np.ndarray:
    S = spec["points"]
    theta = np.arange(S, dtype=np.float64) * (2.0 * np.pi / (S - 1))
    cx, cy = spec["center"]
    pts = np.stack([spec["radius"] * np.cos(theta) + cx,
                    spec["radius"] * np.sin(theta) + cy + spec["y_offset"]],
                   axis=1)
    return pts.astype(np.float32)
