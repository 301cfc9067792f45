"""Multi-process worker: one rank of a ``torch.distributed`` world running a
named job (port of mpc_tpu/parallel/_dist_worker.py).

    python -m mpc_tpu_torch.parallel._dist_worker <job> <rank> <world> <dir> \\
        [<device> [<backend>]]

The ranks meet through a ``dist.FileStore`` in ``<dir>`` (no TCP port, so
parallel runs cannot race for one), read their inputs from
``<dir>/in.npz`` and rank 0 writes the job's outputs to ``<dir>/out.npz``.
``device`` is ``cuda`` (the default: the card ``LOCAL_RANK`` names, as
``distributed.rank_device`` picks it) or ``cpu``; ``backend`` defaults to
gloo on the CPU and NCCL on a card. Each rank uses one thread and imports
no JAX. :func:`launch` starts the ranks and collects the outputs.

Jobs (``JOBS``):

- ``box_qp``: the JAX worker's job. A box QP ``min 0.5 ||u - t||^2`` over
  ``[-1, 1]^4`` for B = 16 targets ``t``; each rank solves the rows
  ``local_batch_slice`` gives it, and the solutions are gathered;
- ``road_sp``: the sequence-parallel road errors on a (1, world) mesh;
- ``lqt``: the horizon-sharded LQT;
- ``solver``: the sharded vehicle solver and its closed loop;
- ``ilqr``: steps of ``build_vehicle_ilqr_controller(mesh=)``;
- ``ilqr_solver``: one solve of ``make_ilqr_solver_batched`` on the
  Pacejka vehicle OCP, with the augmented-Lagrangian terms of a speed bound
  (``al_args``) and skipped lanes.
- ``dryrun``: ``entry.dryrun_parts``, the multi-rank dry run
  (``entry.dryrun_multichip``); no inputs, the parts' output shapes out.

The inputs of every job but ``box_qp`` hold ``spec``, a JSON string with
the cases' settings, and each case's arrays under ``<case>/<name>``. A
comma-separated ``<job>`` runs several jobs in one launch, each with
``spec[<job>]``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

#: seconds a launch may take before every rank is killed
LAUNCH_TIMEOUT = 300


def _t(a, dev, dtype=None):
    import torch
    return torch.as_tensor(np.asarray(a), device=dev, dtype=dtype)


def _np(t):
    return t.detach().cpu().numpy()


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _box_qp(spec, arrays, dev):
    import torch
    import torch.distributed as dist
    from mpc_tpu_torch.config import AlmConfig, PanocConfig
    from mpc_tpu_torch.parallel.distributed import (local_batch_slice,
                                                    pod_mesh)
    from mpc_tpu_torch.parallel.sharding import gather_scenarios
    from mpc_tpu_torch.solver.alm import make_alm_solver
    from mpc_tpu_torch.solver.problem import Box, Problem

    n, B = 4, 16

    def cost(u, t):
        return 0.5 * ((u - t) ** 2).sum(dim=1)

    ones = torch.ones(n, device=dev)
    prob = Problem(cost=cost, constraints=None, C=Box(-ones, ones),
                   D=Box.unbounded(0, device=dev), n=n, m=0)
    solve = make_alm_solver(prob, AlmConfig(eps=1e-5),
                            PanocConfig(lbfgs_memory=4, max_iter=100))
    mesh = pod_mesh(device_type=dev.type)
    if mesh.shape != (dist.get_world_size(), 1):
        raise RuntimeError(f"pod_mesh gave {mesh.shape}")
    ts_global = np.linspace(-2.0, 2.0, B * n).reshape(B, n).astype(np.float32)
    ts = _t(ts_global[local_batch_slice(B)], dev)
    res = solve(ts, torch.zeros_like(ts), torch.zeros((ts.shape[0], 0),
                                                      device=dev))
    return dict(u=_np(gather_scenarios(mesh, res.u)),
                converged=_np(gather_scenarios(mesh, res.converged)),
                ts=ts_global, mesh_axes=np.array(mesh.mesh_dim_names))


def _road_sp(spec, arrays, dev):
    import torch
    import torch.distributed as dist
    from mpc_tpu_torch.parallel.mesh import (MODEL_AXIS, centerline_chunk,
                                             make_mesh)
    from mpc_tpu_torch.parallel.road_sp import compute_errors_ocp_sp
    mesh = make_mesh(1, dist.get_world_size(), device_type=dev.type)
    out = {}
    for case in spec["cases"]:
        a = {k: _t(arrays[f"{case}/{k}"], dev) for k in ("cl", "pos", "hd")}
        with torch.enable_grad():
            pos = a["pos"].requires_grad_(True)
            err = compute_errors_ocp_sp(pos, a["hd"],
                                        centerline_chunk(mesh, a["cl"]), mesh,
                                        MODEL_AXIS, a["cl"].shape[0])
            (grad,) = torch.autograd.grad(sum((e ** 2).sum() for e in err),
                                          pos)
        for name, v in zip(("cte", "heading_error", "pos_error"), err):
            out[f"{case}/{name}"] = _np(v)
        out[f"{case}/grad"] = _np(grad)
    return out


LQT_ARGS = ("x0", "A", "B", "c", "Q", "q", "R", "r", "QN", "qN")


def _lqt(spec, arrays, dev):
    from mpc_tpu_torch.parallel.lqr_sharded import make_lqt_horizon_sharded
    from mpc_tpu_torch.parallel.mesh import make_horizon_mesh
    out, meshes = {}, {}
    for case, c in spec["cases"].items():
        shape = tuple(c["mesh"])
        if shape not in meshes:
            meshes[shape] = make_horizon_mesh(*shape, device_type=dev.type)
        solve = make_lqt_horizon_sharded(meshes[shape])
        args = [_t(arrays[f"{case}/{k}"], dev) for k in LQT_ARGS]
        key = f"{case}/P"
        P = _t(arrays[key], dev) if key in arrays else None
        sol = solve(*args, P=P)
        _sync(dev)
        times = []
        for _ in range(c.get("timed", 0)):
            t0 = time.perf_counter()
            solve(*args, P=P)
            _sync(dev)
            times.append(time.perf_counter() - t0)
        if times:
            out[f"{case}/p50_s"] = np.float64(np.median(times))
        for f in ("us", "xs", "Ko", "ko", "Ss"):
            out[f"{case}/{f}"] = _np(getattr(sol, f))
    return out


def _solver(spec, arrays, dev):
    from mpc_tpu_torch.config import AlmConfig, PanocConfig
    from mpc_tpu_torch.models.params import VehicleParams
    from mpc_tpu_torch.ops import fused_psi as fp
    from mpc_tpu_torch.parallel.mesh import make_mesh
    from mpc_tpu_torch.parallel.sharding import (make_sharded_closed_loop,
                                                 make_sharded_vehicle_solver)
    out = {}
    for case, c in spec["cases"].items():
        mesh = make_mesh(*c["mesh"], device_type=dev.type)
        kw = dict(n_horiz=c["n_horiz"], alm_cfg=AlmConfig(**c["alm"]),
                  panoc_cfg=PanocConfig(**c["panoc"]), device=dev)
        a = {k: _t(arrays[f"{case}/{k}"], dev)
             for k in ("y0s", "cl", "U0s", "lam0s")}
        solve = make_sharded_vehicle_solver(mesh, centerline_size=int(
            a["cl"].shape[0]), **kw)
        fp.fan_value_and_grad.launches = 0
        t0 = time.perf_counter()
        res = solve(a["y0s"], a["cl"], VehicleParams(), a["U0s"], a["lam0s"])
        _sync(dev)
        out[f"{case}/wall_s"] = np.float64(time.perf_counter() - t0)
        out[f"{case}/k1_launches"] = np.int64(fp.fan_value_and_grad.launches)
        out[f"{case}/fan_graph"] = np.bool_(solve.fan_graph)
        for name, v in zip(("u", "lam", "converged", "iters"), res):
            out[f"{case}/{name}"] = _np(v)
        if c.get("n_sim"):
            run = make_sharded_closed_loop(mesh, c["n_sim"], centerline_size=
                                           int(a["cl"].shape[0]), **kw)
            ys, traj, conv = run(a["y0s"], a["cl"], VehicleParams())
            out.update({f"{case}/cl_ys": _np(ys), f"{case}/cl_traj": _np(traj),
                        f"{case}/cl_conv": _np(conv)})
    return out


def _ilqr(spec, arrays, dev):
    from mpc_tpu_torch.config import AlmConfig, IlqrConfig
    from mpc_tpu_torch.control.mpc import build_vehicle_ilqr_controller
    from mpc_tpu_torch.models.bicycle import pacejka_dynamics
    from mpc_tpu_torch.models.integrators import discretize
    from mpc_tpu_torch.models.params import VehicleParams
    from mpc_tpu_torch.parallel.ilqr_sharded import BatchedMpcController
    from mpc_tpu_torch.parallel.mesh import make_horizon_mesh
    out = {}
    params = VehicleParams()
    f_d = discretize(pacejka_dynamics)
    for case, c in spec["cases"].items():
        mesh = make_horizon_mesh(*c["mesh"], device_type=dev.type)
        ctrl = build_vehicle_ilqr_controller(
            n_horiz=c["n_horiz"], bound_state_constraints=True,
            alm_cfg=AlmConfig(**c["alm"]),
            ilqr_cfg=IlqrConfig(**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in c["ilqr"].items()}),
            mesh=mesh, device=dev)
        out[f"{case}/batched"] = np.bool_(isinstance(ctrl,
                                                     BatchedMpcController))
        cl = _t(arrays[f"{case}/cl"], dev)
        ys = _t(arrays[f"{case}/y0s"], dev)
        carry = ctrl.init_carry(ys.shape[0], device=dev)
        steps = {k: [] for k in ("u0", "converged", "outer", "inner",
                                 "wall_s")}
        for _ in range(c["n_steps"]):
            t0 = time.perf_counter()
            o = ctrl.step(carry, {"y0": ys, "p": params, "centerline": cl})
            _sync(dev)
            steps["wall_s"].append(time.perf_counter() - t0)
            carry = o.carry
            ys = f_d(ys, o.u0, params)
            steps["u0"].append(_np(o.u0))
            steps["converged"].append(_np(o.result.converged))
            steps["outer"].append(_np(o.result.outer_iterations))
            steps["inner"].append(_np(o.result.inner_iterations))
        out.update({f"{case}/{k}": np.stack(v) for k, v in steps.items()})
        out[f"{case}/ys"] = _np(ys)
    return out


def _ilqr_solver(spec, arrays, dev):
    import torch
    from mpc_tpu_torch.config import IlqrConfig
    from mpc_tpu_torch.models.bicycle import pacejka_dynamics
    from mpc_tpu_torch.models.integrators import discretize
    from mpc_tpu_torch.models.params import VehicleParams
    from mpc_tpu_torch.ops.costs import (vehicle_stage_cost,
                                         vehicle_stage_residuals)
    from mpc_tpu_torch.parallel.ilqr_sharded import make_ilqr_solver_batched
    from mpc_tpu_torch.parallel.mesh import make_horizon_mesh
    from mpc_tpu_torch.solver.problem import Box
    out = {}
    for case, c in spec["cases"].items():
        mesh = make_horizon_mesh(*c["mesh"], device_type=dev.type)
        n_horiz, v_max = c["n_horiz"], c["v_max"]
        lim = torch.tensor(c["u_lim"], device=dev).repeat(n_horiz)
        solve = make_ilqr_solver_batched(
            discretize(pacejka_dynamics),
            lambda x, u, prm: vehicle_stage_cost(x, u, prm["centerline"],
                                                 1.0),
            n_horiz, 6, 2, u_box=Box(-lim, lim), cfg=IlqrConfig(**c["ilqr"]),
            stage_residuals=lambda x, u, prm: vehicle_stage_residuals(
                x, u, prm["centerline"], 1.0), mesh=mesh)

        def speed_res(xn, u, prm, lam_k, sigma_k):
            zeta = xn[:, 3:4] - v_max + lam_k / sigma_k
            return torch.sqrt(0.5 * sigma_k) * zeta.clamp(min=0.0)

        def speed_al(xn, u, prm, lam_k, sigma_k):
            return (speed_res(xn, u, prm, lam_k, sigma_k) ** 2).sum(dim=1)

        a = {k: _t(arrays[f"{case}/{k}"], dev)
             for k in ("us0", "y0s", "cl", "lam", "sigma", "skip")}
        res = solve(a["us0"], {"y0": a["y0s"], "p": VehicleParams(),
                               "centerline": a["cl"]},
                    al_args=(a["lam"], a["sigma"], speed_al, speed_res),
                    skip=a["skip"])
        for f in ("us", "cost", "converged", "iterations"):
            out[f"{case}/{f}"] = _np(getattr(res, f))
    return out


def _dryrun(spec, arrays, dev):
    from mpc_tpu_torch.entry import dryrun_parts
    return {k: np.array(v) for k, v in dryrun_parts(dev).items()}


JOBS = {"box_qp": _box_qp, "road_sp": _road_sp, "lqt": _lqt,
        "solver": _solver, "ilqr": _ilqr, "ilqr_solver": _ilqr_solver,
        "dryrun": _dryrun}


def main() -> None:
    job, rank, world, workdir = (sys.argv[1], int(sys.argv[2]),
                                 int(sys.argv[3]), sys.argv[4])
    device = sys.argv[5] if len(sys.argv) > 5 else "cuda"
    backend = sys.argv[6] if len(sys.argv) > 6 else None
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from mpc_tpu_torch.parallel.distributed import initialize, rank_device

    # a rank on a card takes the card LOCAL_RANK names (the launcher sets
    # it to the rank): with one card, every rank shares it
    dev_arg = None if device == "cuda" else device
    initialize(backend, dev_arg, store=dist.FileStore(
        os.path.join(workdir, "store"), world), rank=rank, world_size=world)
    dev = rank_device(dev_arg)
    inputs = os.path.join(workdir, "in.npz")
    arrays = dict(np.load(inputs)) if os.path.exists(inputs) else {}
    spec = json.loads(str(arrays.pop("spec"))) if "spec" in arrays else {}
    out = {}
    with torch.no_grad():
        for name in job.split(","):
            out.update(JOBS[name](spec.get(name, spec), arrays, dev))
    if rank == 0:
        np.savez(os.path.join(workdir, "out.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


def launch(job: str, world: int, workdir: str, spec=None, arrays=None,
           device: str = "cuda", backend=None,
           timeout: float = LAUNCH_TIMEOUT) -> dict:
    """Run ``job`` on ``world`` ranks, each a process of this module, in
    ``workdir`` (a fresh directory); returns rank 0's outputs. ``spec``
    (JSON-able) and ``arrays`` (name -> numpy array) are the inputs; the
    ranks run on the card unless ``device`` is ``"cpu"``. Every
    rank is killed when the launch outlasts ``timeout`` seconds; a rank that
    fails or is killed raises, with every rank's output."""
    os.makedirs(workdir, exist_ok=True)
    if spec is not None or arrays:
        np.savez(os.path.join(workdir, "in.npz"),
                 spec=np.array(json.dumps(spec or {})), **(arrays or {}))
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "mpc_tpu_torch.parallel._dist_worker", job,
           "", str(world), workdir, device] + ([backend] if backend else [])
    logs = [os.path.join(workdir, f"rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        cmd[4] = str(r)
        with open(logs[r], "wb") as log:
            procs.append(subprocess.Popen(list(cmd), env=dict(
                env, LOCAL_RANK=str(r)), cwd=repo,
                                          stdout=log,
                                          stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    timed_out = False
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            timed_out = True
            break
    if timed_out:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
    rcs = [p.returncode for p in procs]
    if timed_out or any(rcs):
        text = "".join(f"--- rank {r} ---\n"
                       + open(logs[r], errors="replace").read()[-4000:]
                       for r in range(world))
        raise RuntimeError(f"job {job} on {world} ranks: "
                           + (f"killed after {timeout} s" if timed_out
                              else f"exit codes {rcs}") + f"\n{text}")
    return dict(np.load(os.path.join(workdir, "out.npz")))


if __name__ == "__main__":
    main()
