"""Sequence-parallel road geometry: the centerline sharded over the
``model`` axis (port of mpc_tpu/parallel/road_sp.py).

Each rank holds a chunk of the centerline and searches it for every lane;
the global pick takes one collective per call: an ``all_gather`` over the
model group of each rank's best candidate per lane, packed as one (L, 8)
row ``[d2, global index, nearest, previous, next]``, with one more row
carrying the chunk's first and last points. That row is the halo the JAX
package exchanges by a ring ``ppermute``: a candidate at the start of its
chunk takes its previous point from the preceding rank's last point, one at
the end its next point from the following rank's first. Gloo has no
send/recv for CUDA tensors, and one gather serves gloo and NCCL alike. The
winner is the argmin of ``d2 + index * 1e-12`` in float32 over the ranks,
the first on a tie, as ``jnp.argmin`` takes it.

Semantics are ``ops/road.py:compute_errors_ocp``'s: candidates ``0 ..
S-2`` (the last point is never selected), the previous point of index 0 is
the point itself. The selected points are constants for the gradient: the
collective sees detached tensors, and the gradient flows through ``pos``
alone.
"""

from __future__ import annotations

import torch

from mpc_tpu_torch.ops.road import RoadErrors, _errors
from mpc_tpu_torch.parallel.mesh import MODEL_AXIS, all_gather_rows, axis_size


def find_nearest_point_sp(pos: torch.Tensor, cl_local: torch.Tensor, mesh,
                          axis_name: str, size: int):
    """Distributed nearest-point search with OCP semantics.

    Args:
      pos: (L, 2) lane positions, the same on every rank of the axis.
      cl_local: (chunk, 2) this rank's chunk of the centerline.
      mesh, axis_name: the mesh and the axis the centerline is sharded over.
      size: the centerline's points.

    Returns:
      ``(nearest, previous, next)``, each (L, 2), the same on every rank of
      the axis.
    """
    group = mesh.get_group(axis_name)
    n_ranks, me = axis_size(mesh, axis_name), mesh.get_local_rank(axis_name)
    chunk = cl_local.shape[0]
    if chunk * n_ranks != size:
        raise ValueError(f"a chunk of {chunk} points on {n_ranks} ranks is "
                         f"not a centerline of {size}")
    cl, p = cl_local.detach(), pos.detach()
    L, dev = p.shape[0], p.device
    gidx = me * chunk + torch.arange(chunk, device=dev)
    d2 = ((cl[None] - p[:, None]) ** 2).sum(dim=2)          # (L, chunk)
    d2 = torch.where(gidx <= size - 2, d2, torch.full_like(d2, float("inf")))
    li = torch.argmin(d2, dim=1)
    lanes = torch.arange(L, device=dev)
    cand = torch.cat([d2[lanes, li, None], gidx[li, None].to(p.dtype), cl[li],
                      cl[torch.clamp(li - 1, min=0)],
                      cl[torch.clamp(li + 1, max=chunk - 1)]], dim=1)
    ends = torch.cat([cl[0], cl[-1], torch.zeros_like(cl[:2].reshape(-1))])
    rows = all_gather_rows(torch.cat([cand, ends[None]]), group)
    cands, ends = rows[:, :L], rows[:, L]           # (R, L, 8), (R, 8)
    key = cands[..., 0] + cands[..., 1] * 1e-12     # ties to the lower index
    w = torch.argmin(key, dim=0)                     # (L,)
    win = cands[w, lanes]
    g = win[:, 1]
    at_start = (g == (w * chunk).to(g.dtype)) & (g > 0)
    at_end = g == (w * chunk + chunk - 1).to(g.dtype)
    prev = torch.where(at_start[:, None], ends[w - 1, 2:4], win[:, 4:6])
    nxt = torch.where(at_end[:, None], ends[(w + 1) % n_ranks, 0:2],
                      win[:, 6:8])
    return win[:, 2:4], prev, nxt


def compute_errors_ocp_sp(pos: torch.Tensor, heading: torch.Tensor,
                          cl_local: torch.Tensor, mesh, axis_name: str,
                          size: int) -> RoadErrors:
    """Sequence-parallel ``ops/road.py:compute_errors_ocp`` (unnormalised
    cross products) of lanes ``pos`` (L, 2), ``heading`` (L,)."""
    near, prev, nxt = find_nearest_point_sp(pos, cl_local, mesh, axis_name,
                                            size)
    return _errors(pos, heading, near, prev, nxt)


def make_sp_errors_fn(mesh, size: int, axis_name: str = MODEL_AXIS):
    """``errors_fn(pos, heading, cl_local)`` with the mesh and the
    centerline's size bound: the signature ``build_vehicle_ocp(errors_fn=)``
    takes."""
    def errors_fn(pos, heading, cl_local):
        return compute_errors_ocp_sp(pos, heading, cl_local, mesh, axis_name,
                                     size)
    return errors_fn
