"""Device meshes over the ranks of a ``torch.distributed`` world (port of
mpc_tpu/parallel/mesh.py).

One process per rank, SPMD: every rank builds the same mesh, a
``DeviceMesh`` whose axes are named as the JAX package names them:

- ``scenario``: data parallelism over (initial state, road, parameters)
  lanes; no traffic during a solve;
- ``model``: the centerline sharded in chunks, the nearest-point search
  distributed over them (``parallel/road_sp.py``);
- ``horizon``: the Riccati scans of the LQT sharded over the stages
  (``parallel/lqr_sharded.py``).

The layout is row-major with the model or horizon axis innermost, as
``np.reshape`` lays out the JAX package's devices: rank ``r`` sits at
``(r // n_inner, r % n_inner)``, so an inner group is ``n_inner``
consecutive ranks, on one host wherever the launcher numbers ranks by
host. Every group of the mesh gets the timeout ``GROUP_TIMEOUT``: ranks
whose collectives pair up wrongly then fail within it instead of hanging.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

SCENARIO_AXIS = "scenario"
MODEL_AXIS = "model"
HORIZON_AXIS = "horizon"

#: the timeout of every process group the port makes
GROUP_TIMEOUT = timedelta(seconds=120)


def _make(names, n_scenario: Optional[int], n_inner: int,
          device_type: Optional[str]) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError("mpc_tpu_torch.parallel: no process group; call "
                           "parallel.distributed.initialize() first")
    n_dev = dist.get_world_size()
    if n_scenario is None:
        n_scenario = n_dev // n_inner
    if n_scenario * n_inner != n_dev:
        raise ValueError(f"mesh {n_scenario}x{n_inner} != {n_dev} devices")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    mesh = init_device_mesh(device_type, (n_scenario, n_inner),
                            mesh_dim_names=names)
    for name in names:
        dist.distributed_c10d._set_pg_timeout(GROUP_TIMEOUT,
                                              mesh.get_group(name))
    return mesh


def make_mesh(n_scenario: Optional[int] = None, n_model: int = 1,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A (scenario, model) mesh over the world's ranks; every rank on the
    scenario axis by default (pure data parallelism). ``device_type`` is the
    card's (``"cuda"``) where there is one, else ``"cpu"``."""
    return _make((SCENARIO_AXIS, MODEL_AXIS), n_scenario, n_model,
                 device_type)


def make_horizon_mesh(n_scenario: Optional[int] = None, n_horizon: int = 1,
                      device_type: Optional[str] = None) -> DeviceMesh:
    """A (scenario, horizon) mesh: data parallelism over scenarios and the
    LQT's stages over ``horizon``."""
    return _make((SCENARIO_AXIS, HORIZON_AXIS), n_scenario, n_horizon,
                 device_type)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The number of ranks on the axis ``name``."""
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def scenario_slice(mesh: DeviceMesh, batch: int) -> slice:
    """This rank's rows of a per-scenario batch of ``batch`` rows (the
    JAX package's ``scenario_sharding``); ``batch`` must divide by the
    scenario axis."""
    n = axis_size(mesh, SCENARIO_AXIS)
    if batch % n:
        raise ValueError(f"batch {batch} not divisible by the scenario axis "
                         f"{n}")
    per = batch // n
    i = mesh.get_local_rank(SCENARIO_AXIS)
    return slice(i * per, (i + 1) * per)


def centerline_chunk(mesh: DeviceMesh,
                     centerline: torch.Tensor) -> torch.Tensor:
    """This rank's chunk of a (S, 2) centerline sharded over the model axis
    (the JAX package's ``centerline_sharding``); S must divide by it."""
    n = axis_size(mesh, MODEL_AXIS)
    size = centerline.shape[0]
    if size % n:
        raise ValueError(f"centerline of {size} points not divisible by the "
                         f"model axis {n}")
    chunk = size // n
    i = mesh.get_local_rank(MODEL_AXIS)
    return centerline[i * chunk:(i + 1) * chunk]


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The tensors ``t`` of the group's ranks, in rank order, stacked along
    a new leading axis (one ``all_gather_into_tensor``; a copy in a group of
    one). Booleans travel as bytes. Gloo takes CUDA tensors and stages them
    through host memory itself."""
    n = dist.get_world_size(group)
    wire = (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous()
    out = torch.empty((n,) + tuple(wire.shape), dtype=wire.dtype,
                      device=wire.device)
    dist.all_gather_into_tensor(out.view(-1), wire.view(-1), group=group)
    return out.to(torch.bool) if t.dtype == torch.bool else out
