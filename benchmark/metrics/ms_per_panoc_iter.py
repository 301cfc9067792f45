"""Window wall time per slowest-lane PANOC iteration, in ms: what one
masked iteration of the whole batch costs end to end."""

UNIT = "ms"
LAYER = "PANOC: solver/panoc.py"
MOVES = "solves_per_s"


def read(run):
    return 1e3 * run.wall / float(run.slowest.sum())
