"""The share of the solves' host time spent blocked on the device in the
masked PANOC loop's all-lanes-done checks, in percent: ``sync_wait_s``
over ``loop_s`` (``result.stats``), summed over the window's steps. A
faster host raises it, faster kernels lower it. Nothing where the program
keeps no such count."""

from benchmark.core.solve_stats import window_stats

UNIT = "%"
LAYER = "device: the H100"
MOVES = "solves_per_s"


def read(run):
    stats = window_stats(run)
    if stats is None:
        return None
    return 100.0 * sum(s.sync_wait_s for s in stats) \
        / sum(s.loop_s for s in stats)
