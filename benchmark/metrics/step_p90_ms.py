"""The 90th percentile of the closed-loop steps' host-clock times over the
window (each step from the controller's call to the plant's next state,
ended by a sync): the control interval a fleet of the cell's batch sees."""

import numpy as np

UNIT = "ms"


def read(run):
    return float(np.percentile(run.step_seconds, 90)) * 1e3
