"""Which lane of ss_n40 spends the most inner iterations in a warm step:
the port against the JAX package on the CPU, from the same state and
carry (ROADMAP Queue 3's check). A script, not a tier-1 test: one warm step
of the N=40 constrained OCP takes minutes here.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/ss_n40_slowest_lane.py \\
        --lane L [--step T]

``python -m mpc_tpu_torch.bench ss_n40`` on the card prints, per timed
step T, the lane L that spent the most inner iterations. This script takes
lane L and its 7 neighbours of the cell's 256 initial states
(``bench.ss_n40_states``), runs the JAX package's controller of the cell
(its configurations; the plain path, as examples/exp_ms.py:108-119
builds it, with ``unroll=1``: the source's ``unroll=8`` only steers XLA,
and on XLA:CPU it compiles for over 13 minutes in more than 17 GB) over
the cell's 3 warm-up steps and T timed ones from a cold carry, and then
one more step from that state and carry in both packages (the carry carried across with
``convert.carry_from_numpy``). Then, for the JAX package's own spread,
the same JAX step from that state moved by one ulp in one component of
each lane, ``--ulp-draws`` times. It prints each package's inner and outer
iterations and converged flags per lane, the range of JAX's over the
draws, and which lane is the slowest in each, as one JSON line.
"""

import argparse
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpc_tpu.config import AlmConfig, PanocConfig  # noqa: E402
from mpc_tpu.control.mpc import build_vehicle_controller  # noqa: E402
from mpc_tpu.models.bicycle import pacejka_dynamics  # noqa: E402
from mpc_tpu.models.integrators import discretize  # noqa: E402
from mpc_tpu.models.params import VehicleParams  # noqa: E402
from mpc_tpu_torch import bench  # noqa: E402
from mpc_tpu_torch.control import mpc as tmpc  # noqa: E402
from mpc_tpu_torch.convert import carry_from_numpy  # noqa: E402
from mpc_tpu_torch.models.params import VehicleParams as TParams  # noqa: E402

NEIGHBOURS = 8


def lanes_around(lane: int, batch: int) -> np.ndarray:
    """``lane`` and the 7 lanes after it (before it near the batch's end)."""
    start = min(lane, batch - NEIGHBOURS)
    return np.arange(start, start + NEIGHBOURS)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lane", type=int, required=True)
    ap.add_argument("--step", type=int, default=0,
                    help="the timed step the card reported the lane in")
    ap.add_argument("--ulp-draws", type=int, default=4)
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)

    cell = bench.SS_N40
    lanes = lanes_around(args.lane, cell.batch)
    y0s = bench.ss_n40_states(cell.batch)[lanes]
    cl_t = bench.lane_change_road()
    cl = jnp.asarray(cl_t.numpy())
    params = VehicleParams()
    alm = {f: getattr(cell.alm_cfg, f) for f in
           ("eps", "delta", "max_iter", "eps_0", "sigma_0")}
    panoc = dict(lbfgs_memory=cell.n_horiz,
                 max_iter=cell.solver_cfg.max_iter)
    jctrl = build_vehicle_controller(
        n_horiz=cell.n_horiz, bound_state_constraints=True,
        alm_cfg=AlmConfig(**alm), panoc_cfg=PanocConfig(**panoc), unroll=1)
    f_d = discretize(pacejka_dynamics)

    @jax.jit
    def jstep(ys, carries):
        def one(y, carry):
            out = jctrl.step(carry, {"y0": y, "p": params, "centerline": cl})
            return f_d(y, out.u0, params), out.carry, out.result
        return jax.vmap(one)(ys, carries)

    t0 = time.perf_counter()
    ys = jnp.asarray(y0s)
    carries = jax.vmap(lambda _: jctrl.init_carry())(jnp.arange(len(lanes)))
    for _ in range(cell.n_warmup + args.step):
        ys, carries, _ = jstep(ys, carries)
    jax.block_until_ready(ys)
    t_warm = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, _, jres = jstep(ys, carries)
    jax.block_until_ready(jres)
    t_jax = time.perf_counter() - t0

    rng = np.random.default_rng(1)
    y = np.asarray(ys)
    draws = []
    for _ in range(args.ulp_draws):
        moved = y.copy()
        cols = rng.integers(0, y.shape[1], len(lanes))
        rows = np.arange(len(lanes))
        moved[rows, cols] = np.nextafter(moved[rows, cols], np.where(
            rng.random(len(lanes)) < 0.5, np.inf, -np.inf).astype(np.float32))
        _, _, res = jstep(jnp.asarray(moved), carries)
        draws.append((np.asarray(res.inner_iterations),
                      np.asarray(res.outer_iterations),
                      np.asarray(res.converged)))

    tctrl = tmpc.build_vehicle_controller(
        n_horiz=cell.n_horiz, bound_state_constraints=True,
        alm_cfg=cell.alm_cfg, panoc_cfg=cell.solver_cfg, device="cpu")
    t_carry = carry_from_numpy({f: np.asarray(v)
                                for f, v in carries._asdict().items()})
    t0 = time.perf_counter()
    with torch.no_grad():
        tres = tctrl.step(t_carry, {"y0": torch.as_tensor(np.asarray(ys)),
                                    "p": TParams(), "centerline": cl_t}
                          ).result
    t_port = time.perf_counter() - t0

    j_inner = np.asarray(jres.inner_iterations)
    t_inner = tres.inner_iterations.numpy()
    out = {
        "lanes": lanes.tolist(), "step": args.step,
        "jax_inner": j_inner.tolist(),
        "port_inner": t_inner.tolist(),
        "jax_outer": np.asarray(jres.outer_iterations).tolist(),
        "port_outer": tres.outer_iterations.numpy().tolist(),
        "jax_converged": np.asarray(jres.converged).tolist(),
        "port_converged": tres.converged.numpy().tolist(),
        "jax_slowest_lane": int(lanes[j_inner.argmax()]),
        "jax_ulp_inner_range": [[int(min(d[0][i] for d in draws)),
                                 int(max(d[0][i] for d in draws))]
                                for i in range(len(lanes))] if draws else [],
        "jax_ulp_outer_range": [[int(min(d[1][i] for d in draws)),
                                 int(max(d[1][i] for d in draws))]
                                for i in range(len(lanes))] if draws else [],
        "jax_ulp_converged_all": [bool(all(d[2][i] for d in draws))
                                  for i in range(len(lanes))],
        "jax_ulp_slowest_lanes": [int(lanes[d[0].argmax()]) for d in draws],
        "port_slowest_lane": int(lanes[t_inner.argmax()]),
        "seconds": {"jax_warm_up_with_compile": round(t_warm, 1),
                    "jax_step": round(t_jax, 1),
                    "port_step": round(t_port, 1)},
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
