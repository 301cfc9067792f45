"""PANOC's inner iterations per step on the slowest lane, the mean over
the window's steps: the masked loop runs until its slowest lane is
done."""

import numpy as np

UNIT = "iters"
LAYER = "PANOC: solver/panoc.py"
MOVES = "solves_per_s"


def read(run):
    return float(np.mean(run.slowest))
