"""The host's own time per trip of the masked PANOC loop, in ms: the
solves' host seconds less those spent blocked in the all-lanes-done
checks (``result.stats``: ``loop_s - sync_wait_s``), over the trips the
loops ran, summed over the window's steps. The cost of issuing a trip's
kernels, which a graph of the loop's chunk would cut. Nothing where the
program keeps no such count."""

from benchmark.core.solve_stats import window_stats

UNIT = "ms"
LAYER = "PANOC: solver/panoc.py"
MOVES = "solves_per_s"


def read(run):
    stats = window_stats(run)
    if stats is None:
        return None
    host = sum(s.loop_s - s.sync_wait_s for s in stats)
    return 1e3 * host / sum(s.trips for s in stats)
