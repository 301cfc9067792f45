"""The device's idle share, in percent: 1 - busy / wall over a slice of
the window's steps, busy from their profiled repeat from the same state
(the union of the device's intervals), wall from the same steps in the
window, unprofiled."""

UNIT = "%"
LAYER = "device: the H100"
MOVES = "solves_per_s"


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - t.busy_s / run.slice_wall_s)
