"""Kernel K3's share of its roofline, in percent: the least time the card
needs for the AL fan evaluations that the traced slice's solves needed
(``benchmark/core/al_roofline.py``: 2 a lane's outer iteration and 5 an
inner iteration) over the device time of the kernels named
``fused_psi_fan*`` in the slice's profiled repeat (K3 is the only fan a
constrained cell launches). Nothing where the slice's results carry no
outer iterations."""

from benchmark.core import al_roofline as al
from benchmark.core import roofline as rf
from benchmark.core import window

UNIT = "%"
LAYER = "kernels: csrc/fused_psi.cu via ops/fused_psi.py"
MOVES = "solves_per_s"


def read(run):
    t = run.trace
    if t is None or t.fan_s <= 0.0:
        return None
    keep = window.trace_slice(run.traffic)
    sl = [s for s in run.steps if s.episode == 0 and s.index in keep]
    outer = [getattr(s.result, "outer_iterations", None) for s in sl]
    if not sl or any(o is None for o in outer):
        return None
    # each lane's outer iteration is one PANOC solve: its pair, then 5 an
    # inner iteration
    evals = rf.evaluations(int(sum(int(s.iters.sum()) for s in sl)),
                           int(sum(int(o.sum()) for o in outer)))
    S = run.steps[0].inputs["centerline"].shape[-2]
    ops = evals * al.eval_ops(run.cfg, S)
    nbytes = evals * al.eval_bytes(run.cfg)
    return 100.0 * rf.bound_s(ops, nbytes) / t.fan_s
