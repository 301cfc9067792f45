"""The share of the masked PANOC loop's lane-trips that a lane still
needed, in percent: every lane's inner iterations over the batch times the
trips the loop ran (``result.stats.trips``, whole chunks of masked
iterations over all lanes), summed over the window's steps. A lane that
has finished rides along until its batch's slowest lane is done: 100%
less this share is the most of the lane-trips that dropping finished
lanes from the batch can save. Nothing where the program keeps no such
count."""

from benchmark.core.solve_stats import window_stats

UNIT = "%"
LAYER = "PANOC: solver/panoc.py"
MOVES = "solves_per_s"


def read(run):
    stats = window_stats(run)
    if stats is None:
        return None
    lane_trips = sum(b * s.trips for b, s in zip(run.batch, stats))
    return 100.0 * float(run.lane_iters.sum()) / lane_trips
