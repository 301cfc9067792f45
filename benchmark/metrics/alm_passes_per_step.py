"""The ALM outer loop's passes per step, the mean over the window's steps
(``result.stats.outer_passes``: the loop runs until its slowest lane is
done, each pass one PANOC solve of the whole batch). Nothing where the
program keeps no such count."""

import numpy as np

from benchmark.core.solve_stats import window_stats

UNIT = "passes"
LAYER = "ALM: solver/alm.py"
MOVES = "solves_per_s"


def read(run):
    stats = window_stats(run)
    if stats is None or any(getattr(s, "outer_passes", None) is None
                            for s in stats):
        return None
    return float(np.mean([s.outer_passes for s in stats]))
