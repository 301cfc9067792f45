"""Runs one cell of the benchmark once and prints its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a host with the cards the cell asks
for; without them it exits 2 and prints no result. The run:
1. set-up: imports the program (``mpc_tpu_torch``) through the
   configuration's ``benchmark/programs/<program>.py``, builds it as the
   configuration states it, loads its kernels (built into the checkout's
   build/ on first use), makes the mix's inputs and runs one short warm-up
   episode of the cell's own shapes on them;
2. the window: whole episodes of the mix's loop, back to back, until
   ``--seconds`` have passed and the mix's ``min_steps`` have run
   (``core/window.py``);
3. with ``--trace 1``, a profiled repeat of a slice of the window's steps
   (``core/trace.py``);
4. the check (``core/check.py``): the configuration's
   ``benchmark/checks/<check>.py`` judges a sample of the window's
   lane-solves by a plain float64 reference, each number against the
   cell's limit;
5. the metrics: the cell's end-to-end metrics (``--trace 0``) or its
   per-layer metrics (``--trace 1``), each read by
   ``benchmark/metrics/<name>.py``.

The last line of standard output is the result, a JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and with
``--trace 1`` ``breakdown``), then ``check``: each compared number with
its limit, which also ends standard error. A run that finds ``jax``,
``jaxlib``, ``flax`` or ``mpc_tpu`` among its process's top-level module
names exits 3 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

from benchmark.core import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mpc_tpu")


def forbidden_modules() -> list:
    """The forbidden top-level names among the loaded modules, compared as
    whole names (``mpc_tpu_torch`` is not ``mpc_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def measure(cell, seed: int, seconds: float, traced: bool, device,
            prog=None) -> dict:
    """One run of ``cell`` on ``device``: the result line's fields.
    ``prog`` replaces the program (the control, or a broken program in a
    test)."""
    import torch
    from benchmark.core import check, trace, window

    program = cell.program()
    program.set_precision(cell.cfg)
    torch.set_num_threads(1)
    if prog is None:
        prog = program.build(cell.cfg, cell.traffic, device)
    window.run(prog, cell, seed, 0.0, device, episodes=1,
               n_steps=cell.traffic["warmup_steps"])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START

    win = window.run(prog, cell, seed, seconds, device)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    steps = win.steps
    iters = torch.stack([s.iters for s in steps])
    run = SimpleNamespace(
        cfg=cell.cfg, traffic=cell.traffic, setup_s=setup_s, wall=win.wall,
        steps=steps, batch=[s.iters.shape[0] for s in steps],
        step_seconds=np.array([s.seconds for s in steps]),
        slowest=iters.amax(dim=1).cpu().numpy(),
        lane_iters=iters.sum(dim=1).cpu().numpy(),
        trace=None, slice_wall_s=None, slice=None)
    out = {}
    if traced:
        sl = [s for s in steps if s.episode == 0
              and s.index in window.trace_slice(cell.traffic)]
        sync = window.sync_of(device)
        sync()
        dt = trace.reduce(trace.profile(cell.loop().replay(prog, sl, sync)))
        run.trace = dt
        run.slice_wall_s = float(sum(s.seconds for s in sl))
        run.slice = {"lane_iters": int(sum(int(s.iters.sum()) for s in sl)),
                     "lane_solves": sum(s.iters.shape[0] for s in sl)}
        out["breakdown"] = {"device_ops": dt.device_ops,
                            "idle_gaps": dt.idle_gaps}
    for s in steps:
        s.carry = None
    del prog, win
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    judged = check.judge(cell, steps, seed, device)
    correct, numbers = check.verdict(judged["numbers"], cell.limits)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = spec.metric_reader(m["name"], cell.root).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if traced:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.slice_wall_s
    if cuda:
        dev["power_limit"] = _power_limit()
    res = {"correct": correct, "attempted": judged["attempted"],
           "failed": judged["failed"], "metrics": metrics, "device": dev}
    res.update(out)
    res["detail"] = dict(episodes=len({s.episode for s in steps}),
                         steps=len(steps), window_s=run.wall,
                         **judged["detail"])
    res["check"] = numbers
    return res


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def emit(res: dict) -> int:
    """Print the check's lines on standard error and the result line last
    on standard output; 3 and no result where a forbidden module is
    loaded."""
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    for k, v in res["check"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(f"correct: {res['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; no result", file=sys.stderr)
        return 2
    res = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    return emit(res)


if __name__ == "__main__":
    sys.exit(main())
