"""Sharded batched vehicle MPC solves over a (scenario, model) mesh (port of
mpc_tpu/parallel/sharding.py).

The JAX package maps one solve over the mesh with ``shard_map``; here every
rank runs the same program on its part (SPMD): its scenario slice of the
lanes and, on the model axis, its chunk of the centerline. The contract is
the JAX package's: global arrays in, global arrays out on every rank (an
``all_gather`` over the scenario group at the end; a copy in a world of
one).

With one rank on the model axis there is no ``errors_fn``: the dense fused
OCP, whose PANOC fan is kernel K1, solves each slice. With more, the road
errors come from ``parallel/road_sp.py`` and the OCP is the plain one, its
fan the cost and autograd over B*K lanes; the JAX package's fused backends
refuse an ``errors_fn`` in the same way (mpc_tpu/control/mpc.py:246-252).
The ranks of a model group hold the same lanes, so their loops run in
lockstep; each loop's all-lanes-done test is reduced over the group all the
same. That fan communicates, so it runs eager: gloo's collectives cannot
be captured into a CUDA graph, and NCCL's capture has not been run on
several cards.
``solve_batch.fan_graph`` says which.
"""

from __future__ import annotations

from typing import Optional

import torch

from mpc_tpu_torch.config import AlmConfig, PanocConfig
from mpc_tpu_torch.control.mpc import build_vehicle_ocp
from mpc_tpu_torch.models.bicycle import pacejka_dynamics
from mpc_tpu_torch.models.integrators import discretize
from mpc_tpu_torch.ops.costs import DEFAULT_VEHICLE_WEIGHTS
from mpc_tpu_torch.parallel.distributed import rank_device
from mpc_tpu_torch.parallel.mesh import (MODEL_AXIS, SCENARIO_AXIS,
                                         all_gather_rows, axis_size,
                                         centerline_chunk, scenario_slice)
from mpc_tpu_torch.parallel.road_sp import make_sp_errors_fn
from mpc_tpu_torch.solver.alm import make_alm_solver


def gather_scenarios(mesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The global tensor of this rank's slice ``t`` along ``dim``: the
    slices of the scenario group in order."""
    rows = all_gather_rows(t.movedim(dim, 0), mesh.get_group(SCENARIO_AXIS))
    return rows.reshape((-1,) + tuple(rows.shape[2:])).movedim(0, dim)


def _build(mesh, n_horiz, centerline_size, v_ref, ts, weights, alm_cfg,
           panoc_cfg, device):
    if alm_cfg is None:
        alm_cfg = AlmConfig(eps=1e-5)
    if panoc_cfg is None:
        panoc_cfg = PanocConfig(lbfgs_memory=n_horiz, max_iter=300)
    dev = rank_device(device)
    n_model = axis_size(mesh, MODEL_AXIS)
    errors_fn = group = None
    if n_model > 1:
        errors_fn = make_sp_errors_fn(mesh, centerline_size)
        group = mesh.get_group(MODEL_AXIS)
    problem = build_vehicle_ocp(n_horiz, v_ref, ts, weights=weights,
                                errors_fn=errors_fn, device=dev)
    return problem, make_alm_solver(problem, alm_cfg, panoc_cfg,
                                    group=group), dev


def make_sharded_vehicle_solver(mesh, n_horiz: int = 12,
                                centerline_size: int = 100,
                                v_ref: float = 1.0, ts: float = 0.05,
                                weights=DEFAULT_VEHICLE_WEIGHTS,
                                alm_cfg: Optional[AlmConfig] = None,
                                panoc_cfg: Optional[PanocConfig] = None,
                                device=None):
    """Build ``solve_batch(y0s, centerline, params, U0s, lam0s) -> (u, lam,
    converged, inner_iterations)``.

    Every rank passes the global inputs: ``y0s`` (B, 6), ``centerline``
    (centerline_size, 2), ``U0s`` (B, 2N), ``lam0s`` (B, m); B must divide
    by the scenario axis, ``centerline_size`` by the model axis. Each rank
    solves its scenario slice on its centerline chunk, and every rank gets
    the global outputs. Defaults: ``AlmConfig(eps=1e-5)``,
    ``PanocConfig(lbfgs_memory=n_horiz, max_iter=300)``; ``device`` is
    ``distributed.rank_device``'s (the rank's card unless it names the
    CPU).
    """
    problem, solve, dev = _build(mesh, n_horiz, centerline_size, v_ref, ts,
                                 weights, alm_cfg, panoc_cfg, device)

    def solve_batch(y0s, centerline, params, U0s, lam0s):
        rows = scenario_slice(mesh, y0s.shape[0])
        res = solve({"y0": y0s[rows].to(dev), "p": params,
                     "centerline": centerline_chunk(mesh, centerline.to(dev))},
                    U0s[rows].to(dev), lam0s[rows].to(dev))
        return tuple(gather_scenarios(mesh, t) for t in
                     (res.u, res.lam, res.converged, res.inner_iterations))

    solve_batch.fan_graph = solve.fan_graph
    return solve_batch


def make_sharded_closed_loop(mesh, n_sim: int, n_horiz: int = 12,
                             centerline_size: int = 100, v_ref: float = 1.0,
                             ts: float = 0.05,
                             weights=DEFAULT_VEHICLE_WEIGHTS,
                             alm_cfg: Optional[AlmConfig] = None,
                             panoc_cfg: Optional[PanocConfig] = None,
                             device=None):
    """Build ``run(y0s, centerline, params) -> (ys (B, 6), traj (n_sim, B,
    6), converged (n_sim, B))``: ``n_sim`` closed-loop steps, each a solve
    of every lane warm-started from its last (U, lam; cold ``U = [1, 0] *
    N``, ``lam = 0``, a fresh step-size estimate every step, as the JAX
    package's loop calls its solver) and the plant stepped by the same
    ``f_d``. Each rank runs its scenario slice; the outputs are gathered
    at the end."""
    problem, solve, dev = _build(mesh, n_horiz, centerline_size, v_ref, ts,
                                 weights, alm_cfg, panoc_cfg, device)
    f_d = discretize(pacejka_dynamics, ts=ts)

    def run(y0s, centerline, params):
        rows = scenario_slice(mesh, y0s.shape[0])
        ys = y0s[rows].to(dev)
        cl_local = centerline_chunk(mesh, centerline.to(dev))
        b = ys.shape[0]
        Us = torch.tensor([1.0, 0.0], dtype=ys.dtype, device=dev) \
            .repeat(n_horiz).expand(b, -1).clone()
        lams = torch.zeros((b, problem.m), dtype=ys.dtype, device=dev)
        traj, conv = [], []
        for _ in range(n_sim):
            res = solve({"y0": ys, "p": params, "centerline": cl_local},
                        Us, lams)
            ys = f_d(ys, res.u[:, :2], params)
            Us, lams = res.u, res.lam
            traj.append(ys)
            conv.append(res.converged)
        return (gather_scenarios(mesh, ys),
                gather_scenarios(mesh, torch.stack(traj), dim=1),
                gather_scenarios(mesh, torch.stack(conv), dim=1))

    run.fan_graph = solve.fan_graph
    return run
