"""The port's sharded vehicle solver and closed loop
(mpc_tpu_torch/parallel/sharding.py) on a 2-rank gloo world, on (2, 1) and
(1, 2) meshes, against the JAX package's ``make_sharded_vehicle_solver`` on
(8, 1) and (4, 2) virtual meshes (B = 8, N = 6): equal converged flags and
every input within 5e-3, the JAX package's own band between meshes
(tests/test_sharding.py:111-113). The (2, 1) mesh solves through the fused
OCP (kernel K1's plain version here), the (1, 2) mesh through the plain OCP
with the sequence-parallel road errors, its fan eager under gloo. The
ranks run while the JAX references compile. The closed loop is
tests/test_torch_sharding_loop.py's.
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.config import AlmConfig as JAlmConfig
from mpc_tpu.config import PanocConfig as JPanocConfig
from mpc_tpu.models.params import VehicleParams as JVehicleParams
from mpc_tpu.parallel.mesh import make_mesh
from mpc_tpu.parallel.sharding import make_sharded_vehicle_solver
from mpc_tpu_torch.ops.road import straight_centerline
from mpc_tpu_torch.parallel._dist_worker import launch

torch.set_num_threads(1)

B, N, SIZE = 8, 6, 100
ALM = dict(eps=1e-4)
PANOC = dict(lbfgs_memory=N, max_iter=400)
BAND = 5e-3
PORT_MESHES = {"dp": (2, 1), "sp": (1, 2)}
JAX_MESHES = {"dp": (8, 1), "sp": (4, 2)}


def _inputs():
    rng = np.random.default_rng(0)
    y0s = np.zeros((B, 6), np.float32)
    y0s[:, 1] = rng.uniform(-0.1, 0.1, B)
    y0s[:, 3] = rng.uniform(0.3, 0.9, B)
    U0s = np.tile(np.asarray([1.0, 0.0], np.float32), (B, N))
    lam0s = np.zeros((B, 6 * N), np.float32)
    return y0s, straight_centerline(SIZE).numpy(), U0s, lam0s


def launch_solver(workdir, n_sim=0):
    """The port's 2-rank runs of both meshes, in a thread (a future)."""
    y0s, cl, U0s, lam0s = _inputs()
    spec, arrays = {}, {}
    for name, mesh in PORT_MESHES.items():
        spec[name] = dict(mesh=list(mesh), n_horiz=N, alm=ALM, panoc=PANOC,
                          n_sim=n_sim)
        arrays.update({f"{name}/y0s": y0s, f"{name}/cl": cl,
                       f"{name}/U0s": U0s, f"{name}/lam0s": lam0s})
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(launch, "solver", 2, str(workdir),
                      spec={"cases": spec}, arrays=arrays, device="cpu")
    pool.shutdown(wait=False)
    return fut


def by_case(res):
    return {name: {k.split("/", 1)[1]: v for k, v in res.items()
                   if k.startswith(name + "/")} for name in PORT_MESHES}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(port, jax_ref)``: the port's ranks run while JAX compiles."""
    fut = launch_solver(tmp_path_factory.mktemp("solver"))
    y0s, cl, U0s, lam0s = map(jnp.asarray, _inputs())
    out = {}
    for name, (ns, nm) in JAX_MESHES.items():
        solve = make_sharded_vehicle_solver(
            make_mesh(n_scenario=ns, n_model=nm), n_horiz=N,
            alm_cfg=JAlmConfig(**ALM), panoc_cfg=JPanocConfig(**PANOC))
        u, lam, conv, iters = solve(y0s, cl, JVehicleParams(), U0s, lam0s)
        out[name] = dict(u=np.asarray(u), converged=np.asarray(conv))
    return by_case(fut.result()), out


@pytest.mark.parametrize("name", PORT_MESHES)
@pytest.mark.parametrize("ref", JAX_MESHES)
def test_sharded_solver_matches_jax(runs, name, ref):
    got, want = runs[0][name], runs[1][ref]
    assert got["u"].shape == (B, 2 * N)
    np.testing.assert_array_equal(got["converged"], want["converged"])
    assert got["converged"].all()
    np.testing.assert_allclose(got["u"], want["u"], atol=BAND, rtol=0)


def test_sp_fan_is_eager_under_gloo(runs):
    """The (1, 2) mesh's fan communicates over gloo, so it is not captured;
    the (2, 1) mesh's is the fused fan."""
    assert not runs[0]["sp"]["fan_graph"] and not runs[0]["dp"]["fan_graph"]
