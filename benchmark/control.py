"""The readings that a cell's limits (``benchmark/limits/<cell>.json``) are
set from. The benchmark's own runs never run this.

    python3 -m benchmark.control --workload <cell> \
        [--seeds 11,12,13] [--faults stale,grad_half --fault-seeds 1,2,3] \
        [--program-seeds 21,22,...] [--steps 2] [--sample 4900]

- ``--seeds``: the control, the program's controller and loop with the
  reference put in the place of its fan and its plant, computed in TF32
  (float32 with a 10-bit mantissa), the precision next below the float32
  that the configurations state (the program module's ``control``);
- ``--faults``: the program with each of these faults planted (the
  program module's ``FAULTS``), on each of ``--fault-seeds``;
- ``--program-seeds``: the program itself, one whole episode per seed.

The control and the faults run ``--steps`` steps of the cell's traffic
from a cold start at the cell's batch. Every side is judged as a run is,
on ``--sample`` sampled lane-solves, as many as a run compares. Prints one
JSON line per seed and side: ``{"side", "seed", "numbers", "attempted",
"failed", "detail", "seconds"}``.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time


def _readings(side, cell, prog, seed, steps, sample, device):
    from benchmark.core import check, window
    t0 = time.perf_counter()
    win = window.run(prog, cell, seed, 0.0, device, episodes=1,
                     n_steps=steps)
    per_step = math.ceil(sample / len(win.steps))
    saved = cell.traffic["sample"]
    cell.traffic["sample"] = {k: per_step for k in saved}
    res = check.judge(cell, win.steps, seed, device)
    cell.traffic["sample"] = saved
    res["side"], res["seed"] = side, seed
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps(res), flush=True)


def _ints(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--sample", type=int, default=4900)
    args = ap.parse_args(argv)

    import torch
    from benchmark.core import spec
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    program = cell.program()
    program.set_precision(cell.cfg)
    cfg, traffic = cell.cfg, cell.traffic
    sides = []
    if args.program_seeds:
        sides.append(("program", lambda: program.build(cfg, traffic, "cuda"),
                      _ints(args.program_seeds), None))
    for f in (s for s in args.faults.split(",") if s):
        sides.append((f, lambda f=f: program.broken(cfg, traffic, "cuda", f),
                      _ints(args.fault_seeds), args.steps))
    if args.seeds:
        sides.append(("control", lambda: program.control(cfg, traffic,
                                                         "cuda"),
                      _ints(args.seeds), args.steps))
    for side, make, seeds, steps in sides:
        prog = make()
        for s in seeds:
            _readings(side, cell, prog, s, steps, args.sample, "cuda")
        del prog
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
