"""The port's sequence-parallel road errors (mpc_tpu_torch/parallel/road_sp.py)
on 2- and 4-rank gloo worlds against the JAX package's
``compute_errors_ocp_sp`` under ``shard_map`` on the virtual CPU mesh and
against the port's single-device ``compute_errors_ocp``, atol 1e-5.

The ranks are processes of ``mpc_tpu_torch.parallel._dist_worker`` (one
launch per world size, every case in it). The positions put the nearest
point at chunk boundaries on both sides (its previous or next point on the
neighbouring rank), at global index 0 and next to the last point, which is
never selected.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from mpc_tpu.parallel.mesh import MODEL_AXIS, make_mesh
from mpc_tpu.parallel.road_sp import compute_errors_ocp_sp
from mpc_tpu_torch.ops.bezier import (bezier_centerline,
                                      lane_change_control_points)
from mpc_tpu_torch.ops.road import compute_errors_ocp, straight_centerline
from mpc_tpu_torch.parallel._dist_worker import launch

torch.set_num_threads(1)

SIZE = 100          # divides by 2 and 4 ranks
WORLDS = (2, 4)
ROADS = ("straight", "bezier")
TOL = dict(atol=1e-5, rtol=0)
FIELDS = ("cte", "heading_error", "pos_error")


def _road(name):
    if name == "straight":
        return straight_centerline(SIZE).numpy()
    pts = lane_change_control_points(5.0).control_points * 0.01
    return bezier_centerline(pts, size=SIZE).numpy()


def _lanes(cl, seed=0):
    """Positions by the index of their nearest point, offset along the
    road's normal, and headings: chunk ends and starts for 2 and 4 ranks,
    index 0 (and a point before the road's start), the point before the
    last, beyond the road's end, and drawn ones."""
    rng = np.random.default_rng(seed)
    idx = [0, 0, 24, 25, 49, 50, 74, 75, 97, 98, 98] \
        + list(rng.integers(0, SIZE - 1, 9))
    d = np.diff(cl, axis=0)
    d = np.concatenate([d, d[-1:]])
    t = d / np.linalg.norm(d, axis=1, keepdims=True)
    nrm = np.stack([-t[:, 1], t[:, 0]], axis=1)
    off = rng.uniform(-0.05, 0.05, len(idx))
    pos = cl[idx] + off[:, None] * nrm[idx]
    pos[1] = cl[0] - 0.3 * t[0]           # before the start: index 0
    pos[10] = cl[-1] + 0.4 * t[-1]        # beyond the end: index S-2
    hd = rng.uniform(-0.5, 0.5, len(idx))
    return pos.astype(np.float32), hd.astype(np.float32)


def _case(world, road):
    return f"w{world}_{road}"


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Each world's outputs, every road in one launch."""
    out = {}
    for world in WORLDS:
        arrays = {}
        for road in ROADS:
            cl = _road(road)
            pos, hd = _lanes(cl)
            arrays.update({f"{road}/cl": cl, f"{road}/pos": pos,
                           f"{road}/hd": hd})
        res = launch("road_sp", world, str(tmp_path_factory.mktemp(
            f"road_sp{world}")), spec={"cases": list(ROADS)}, arrays=arrays,
            device="cpu")
        for road in ROADS:
            out[_case(world, road)] = {k: res[f"{road}/{k}"]
                                       for k in FIELDS + ("grad",)}
    return out


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's SP errors on a (1, world) virtual mesh, per world and road."""
    out = {}
    for world in WORLDS:
        mesh = make_mesh(n_scenario=1, n_model=world,
                         devices=jax.devices()[:world])
        f = jax.jit(shard_map(
            lambda ps, hs, cl_local: jax.vmap(
                lambda p, h: compute_errors_ocp_sp(
                    p, h, cl_local, axis_name=MODEL_AXIS, size=SIZE))(ps, hs),
            mesh=mesh, in_specs=(P(), P(), P(MODEL_AXIS, None)),
            out_specs=P(), check_vma=False))
        for road in ROADS:
            cl = _road(road)
            pos, hd = _lanes(cl)
            err = f(jnp.asarray(pos), jnp.asarray(hd), jnp.asarray(cl))
            out[_case(world, road)] = {k: np.asarray(v)
                                       for k, v in zip(FIELDS, err)}
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("road", ROADS)
def test_sp_errors_match_jax_sp(port, jax_ref, world, road):
    got, want = port[_case(world, road)], jax_ref[_case(world, road)]
    for k in FIELDS:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("road", ROADS)
def test_sp_errors_match_single_device(port, world, road):
    cl = _road(road)
    pos, hd = _lanes(cl)
    pos_t = torch.tensor(pos, requires_grad=True)
    want = compute_errors_ocp(pos_t, torch.tensor(hd), torch.tensor(cl))
    (grad,) = torch.autograd.grad(sum((e ** 2).sum() for e in want), pos_t)
    got = port[_case(world, road)]
    for k, w in zip(FIELDS, want):
        np.testing.assert_allclose(got[k], w.detach().numpy(), err_msg=k,
                                   **TOL)
    # the selected points are constants: the gradient flows through pos
    np.testing.assert_allclose(got["grad"], grad.numpy(), atol=1e-5,
                               rtol=1e-5)
