"""mesh_dp's converged flags and iterations, lane by lane: the port against
the JAX package on the CPU, on the cell's own 256 lanes (ROADMAP Queue 3's
check). A script, not a tier-1 test: the two solves of 256 cold lanes take
minutes here.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/mesh_dp_flags.py [--batch 256]

Both packages solve the cell's lanes (``bench.mesh_dp_inputs``: y0[:, 1] ~
U(-0.1, 0.1), y0[:, 3] ~ U(0.3, 1.0) from ``default_rng(0)``, cold U0 =
[1, 0], zero multipliers, the 100-point straight road) with its settings
(``AlmConfig(eps=1e-4)``, ``PanocConfig(lbfgs_memory=12, max_iter=60)``)
through ``make_sharded_vehicle_solver`` on a (1, 1) mesh: the JAX package
on one CPU device, the port over a gloo world of one rank. Then both again
on the same lanes with y0[:, 3] moved up by one ulp (``np.nextafter``),
which gives each package's own spread. It prints one JSON line: the
converged count of each run, the lanes each fails, the lanes whose flags
differ and how many lanes' iteration counts agree, with the largest gap,
between the packages and between each package and itself moved.
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

from mpc_tpu.config import AlmConfig as JAlmConfig  # noqa: E402
from mpc_tpu.config import PanocConfig as JPanocConfig  # noqa: E402
from mpc_tpu.models.params import VehicleParams as JParams  # noqa: E402
from mpc_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from mpc_tpu.parallel.sharding import \
    make_sharded_vehicle_solver as jmake_solver  # noqa: E402
from mpc_tpu_torch import bench  # noqa: E402
from mpc_tpu_torch.models.params import VehicleParams  # noqa: E402
from mpc_tpu_torch.parallel.distributed import initialize_world  # noqa: E402
from mpc_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from mpc_tpu_torch.parallel.sharding import \
    make_sharded_vehicle_solver  # noqa: E402


def moved(y0s: np.ndarray) -> np.ndarray:
    """The lanes with y0[:, 3] moved up by one ulp."""
    out = y0s.copy()
    out[:, 3] = np.nextafter(out[:, 3], np.float32(np.inf))
    return out


def jax_runs(y0s, cl, U0s, lam0s):
    cell = bench.MESH_DP
    solve = jmake_solver(
        jmake_mesh(n_scenario=1, n_model=1, devices=jax.devices()[:1]),
        n_horiz=cell.n_horiz,
        alm_cfg=JAlmConfig(eps=bench.MESH_DP_ALM.eps),
        panoc_cfg=JPanocConfig(
            lbfgs_memory=bench.MESH_DP_PANOC.lbfgs_memory,
            max_iter=bench.MESH_DP_PANOC.max_iter))
    out = []
    for y in (y0s, moved(y0s)):
        _, _, conv, iters = solve(jnp.asarray(y), jnp.asarray(cl), JParams(),
                                  jnp.asarray(U0s), jnp.asarray(lam0s))
        out.append((np.asarray(conv), np.asarray(iters)))
    return out


def port_runs(y0s, cl, U0s, lam0s):
    initialize_world(device="cpu")
    cell = bench.MESH_DP
    solve = make_sharded_vehicle_solver(
        make_mesh(1, 1, device_type="cpu"), n_horiz=cell.n_horiz,
        alm_cfg=bench.MESH_DP_ALM, panoc_cfg=bench.MESH_DP_PANOC,
        device="cpu")
    out = []
    for y in (y0s, moved(y0s)):
        _, _, conv, iters = solve(torch.as_tensor(y), torch.as_tensor(cl),
                                  VehicleParams(), torch.as_tensor(U0s),
                                  torch.as_tensor(lam0s))
        out.append((conv.numpy(), iters.numpy()))
    return out


def compare(a, b) -> dict:
    (ca, ia), (cb, ib) = a, b
    gap = np.abs(ia.astype(np.int64) - ib.astype(np.int64))
    return {"flags_differ": np.flatnonzero(ca != cb).tolist(),
            "iterations_agree": int((gap == 0).sum()),
            "largest_gap": int(gap.max())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=bench.MESH_DP.batch)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(args.threads)

    y0s, cl, U0s, lam0s = (t.numpy() for t in bench.mesh_dp_inputs(
        args.batch, device="cpu"))
    t0 = time.perf_counter()
    jx = jax_runs(y0s, cl, U0s, lam0s)
    t1 = time.perf_counter()
    pt = port_runs(y0s, cl, U0s, lam0s)
    t2 = time.perf_counter()
    runs = {"jax": jx[0], "jax_moved": jx[1], "port": pt[0],
            "port_moved": pt[1]}
    row = {"batch": args.batch,
           "converged": {k: int(c.sum()) for k, (c, _) in runs.items()},
           "failed_lanes": {k: np.flatnonzero(~c.astype(bool)).tolist()
                            for k, (c, _) in runs.items()},
           "port_vs_jax": compare(pt[0], jx[0]),
           "jax_vs_jax_moved": compare(jx[0], jx[1]),
           "port_vs_port_moved": compare(pt[0], pt[1]),
           "port_moved_vs_jax_moved": compare(pt[1], jx[1]),
           "seconds": {"jax": round(t1 - t0, 1), "port": round(t2 - t1, 1)}}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
