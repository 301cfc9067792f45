"""The fan kernels' share of their roofline, in percent: the least time
the card needs for the fan evaluations that the traced slice's solves
needed (``benchmark/core/roofline.py``) over the device time of the
kernels named ``fused_psi_fan*`` in the slice's profiled repeat."""

from benchmark.core import roofline as rf

UNIT = "%"
LAYER = "kernels: csrc/fused_psi.cu via ops/fused_psi.py"
MOVES = "solves_per_s"


def read(run):
    t = run.trace
    if t is None or t.fan_s <= 0.0:
        return None
    sl = run.slice
    road = run.steps[0].inputs["centerline"]
    S = road.shape[-2]
    evals = rf.evaluations(sl["lane_iters"], sl["lane_solves"])
    ops = evals * rf.eval_ops(run.cfg, S)
    nbytes = evals * rf.eval_bytes(run.cfg)
    if road.dim() == 3:
        # one road table per lane, read once a solve
        nbytes += sl["lane_solves"] * (S - 1) * 6 * rf.F32
    return 100.0 * rf.bound_s(ops, nbytes) / t.fan_s
