"""Where an AL-iLQR step's time goes at config 2's shape, by sweeps (port of
examples/profile_config2.py:63-186): the Pacejka OCP with the bounded state
constraints at N=40 on the lane-change Bezier road, solved by AL-iLQR.

The per-step cost is about ``overhead + n_outer * (t_outer + n_inner *
t_iter)``: sweeping the iteration caps at a fixed batch gives the cost of
an inner and of an outer iteration by differences, and the iteration
counts say how many of each a warm MPC step needs. Every point is the
bench's ilqr_n40 cell (``bench.ILQR_N40``: its initial states, the JAX
script's, its ``AlmConfig(delta=1e-3, sigma_0=1e3, penalty_factor=5.0)``)
with the point's caps, step sizes and backward pass replaced
(``dataclasses.replace``), run by the bench's closed-loop runner
(``bench.run``): 3 warm-up steps, then ``--n-steps`` timed ones, no batch-1
loop; on the card unless ``--device`` names another.

    python -m mpc_tpu_torch.examples.profile_config2 [--sweep point|batch|iters|alphas|backward]
        [--batch 256] [--max-outer 8] [--max-inner 30] [--n-alphas 0]
        [--n-steps 6] [--seq] [--record] [--record-key 9] [--device D]

As in the JAX script the parallel Riccati backward pass is the default and
``--seq`` selects the sequential one (``bench.ILQR_N40`` and
``IlqrConfig`` default to the sequential pass). ``--n-alphas K`` takes the
step sizes 0.5^i, i < K, 0 the solver's 6. The JAX script's ``--sweep
unroll`` and ``--unroll`` are not offered: ``unroll`` only steers XLA.

Prints the device, then one JSON line per point with the JAX script's keys
(``solves_per_s`` = batch over the p50 step, ``p50_step_s``,
``converged_fraction``, ``outer_mean/max``, ``inner_mean/max``) and the
bench's own ``solves_per_s`` over all the timed steps
(``solves_per_s_all_steps``); ``main`` returns the rows by name.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from mpc_tpu_torch import bench
from mpc_tpu_torch.config import IlqrConfig
from mpc_tpu_torch.examples import add_device_arg, start

N_WARM = 3


def point_cell(batch: int, max_outer: int = 8, max_inner: int = 30,
               n_alphas: int = 0, n_steps: int = 6,
               parallel_backward: bool = True) -> bench.Cell:
    """ilqr_n40 with one point's settings."""
    alphas = tuple(0.5 ** i for i in range(n_alphas)) if n_alphas \
        else IlqrConfig().alphas
    cell = bench.ILQR_N40
    return dataclasses.replace(
        cell, batch=batch, n_warmup=N_WARM, n_steps=n_steps,
        batch1_steps=None,
        alm_cfg=dataclasses.replace(cell.alm_cfg, max_iter=max_outer),
        solver_cfg=dataclasses.replace(
            cell.solver_cfg, max_iter=max_inner, alphas=alphas,
            parallel_backward=parallel_backward))


def bench_point(tag: str, cell: bench.Cell, device=None) -> dict:
    """One point through ``bench.run``: the JAX script's row."""
    r = bench.run(cell, device)
    p50 = r["p50_step_latency_s"]
    row = {
        "exp": tag, "batch": cell.batch, "max_outer": cell.alm_cfg.max_iter,
        "max_inner": cell.solver_cfg.max_iter,
        "n_alphas": len(cell.solver_cfg.alphas),
        "parallel_backward": cell.solver_cfg.parallel_backward,
        "solves_per_s": round(cell.batch / p50, 1),
        "p50_step_s": round(p50, 4),
        "converged_fraction": round(r["mean_converged_fraction"], 4),
        "outer_mean": round(r["outer_iters_mean"], 2),
        "outer_max": r["outer_iters_max"],
        "inner_mean": round(r["inner_iters_mean"], 1),
        "inner_max": r["inner_iters_max"],
        "solves_per_s_all_steps": round(r["solves_per_s"], 1),
        "states_finite": r["states_finite"],
    }
    print(json.dumps(row), flush=True)
    return row


def points(args) -> list:
    """``(tag, cell)`` of each point of the sweep."""
    pb = not args.seq

    def cell(batch=args.batch, outer=args.max_outer, inner=args.max_inner,
             alphas=args.n_alphas, parallel=pb):
        return point_cell(batch, outer, inner, alphas, args.n_steps,
                          parallel)

    if args.sweep == "batch":
        return [(f"b{b}", cell(batch=b)) for b in (128, 256, 512, 1024)]
    if args.sweep == "backward":
        # end to end, the parallel scan against the sequential Riccati
        return [(tag, cell(parallel=p))
                for tag, p in (("par", True), ("seq", False))]
    if args.sweep == "iters":
        # the slope: per inner iteration at max_outer=1, then the outer
        # iteration's cost at max_inner=1
        return ([(f"o1_i{mi}", cell(outer=1, inner=mi))
                 for mi in (1, 2, 4, 8)]
                + [(f"o{mo}_i1", cell(outer=mo, inner=1)) for mo in (2, 4)])
    if args.sweep == "alphas":
        return [(f"a{na}", cell(alphas=na)) for na in (6, 4, 3, 2)]
    return [("point", cell())]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", choices=["batch", "iters", "alphas",
                                        "backward", "point"],
                    default="point")
    ap.add_argument("--seq", action="store_true",
                    help="sequential Riccati backward pass (default: the "
                         "parallel scan)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--max-outer", type=int, default=8)
    ap.add_argument("--max-inner", type=int, default=30)
    ap.add_argument("--n-alphas", type=int, default=0)
    ap.add_argument("--n-steps", type=int, default=6)
    ap.add_argument("--record", action="store_true")
    ap.add_argument("--record-key", default="9")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = start(args.device)
    rows = [bench_point(tag, cell, dev) for tag, cell in points(args)]
    if args.record and rows:
        from mpc_tpu_torch.utils import perfdb
        rec = {"config": f"{args.record_key}: config #2 profile "
                         f"(AL-iLQR N=40, sweep={args.sweep})",
               "source": "python -m mpc_tpu_torch.examples.profile_config2 "
                         f"--sweep {args.sweep}"}
        for row in rows:
            rec[row["exp"]] = (
                f"{row['solves_per_s']} solves/s (p50 {row['p50_step_s']} s, "
                f"batch {row['batch']}, conv {row['converged_fraction']}, "
                f"outer {row['outer_mean']}/{row['outer_max']}, "
                f"inner {row['inner_mean']}/{row['inner_max']})")
        perfdb.record(args.record_key, rec)
    return {row["exp"]: row for row in rows}


if __name__ == "__main__":
    main()
