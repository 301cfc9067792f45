"""The whole step's share of the card's float32 peak, in percent: the
operations that the window's solves needed (the fan's count per
evaluation, times the evaluations each lane's own inner iterations need)
over the window's wall time at 67 TFLOP/s. It does not depend on which
kernel does the work, so it bounds every kernel's gain."""

from benchmark.core import roofline as rf

UNIT = "%"
LAYER = "controller step: control/mpc.py"
MOVES = "solves_per_s"


def read(run):
    evals = rf.evaluations(int(run.lane_iters.sum()), sum(run.batch))
    ops = evals * rf.eval_ops(
        run.cfg, run.steps[0].inputs["centerline"].shape[-2])
    return 100.0 * ops / (run.wall * rf.PEAK_F32_FLOPS)
