"""The share of the ALM outer loop's lane-passes that a lane still needed,
in percent: every lane's outer iterations over the batch times the passes
the loop ran (``result.stats.outer_passes``), summed over the window's
steps. A lane that is done rides along in every pass's fan calls, its
inner solve flagged done at once, until its batch's slowest lane is done. Nothing where the program keeps no
such count."""

from benchmark.core.solve_stats import window_stats

UNIT = "%"
LAYER = "ALM: solver/alm.py"
MOVES = "solves_per_s"


def read(run):
    stats = window_stats(run)
    if stats is None or any(getattr(s, "outer_passes", None) is None
                            for s in stats):
        return None
    lane_passes = sum(b * s.outer_passes for b, s in zip(run.batch, stats))
    outer = sum(int(s.result.outer_iterations.sum()) for s in run.steps)
    return 100.0 * outer / lane_passes
