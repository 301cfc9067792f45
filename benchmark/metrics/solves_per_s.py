"""Lane-solves completed per second: every lane of every step in the
window over the window's wall time (host clock, the window ended by a
sync)."""

UNIT = "solves/s"


def read(run):
    return sum(run.batch) / run.wall
