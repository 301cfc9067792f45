"""The port's horizon-sharded LQT (mpc_tpu_torch/parallel/lqr_sharded.py) on
2- and 4-rank gloo worlds against the JAX package's
``make_lqt_horizon_sharded`` on (2, 4) and (1, 8) virtual meshes and against
the port's single-device ``lqt_solve_parallel``, at the tolerances of
tests/test_lqr_sharded.py (us, xs, Ko, ko 2e-3; Ss 5e-3).

N = 5 and 13 are padded with identity elements on every mesh (N + 1 and N
not multiples of the horizon axis); the (2, 2) meshes split the lanes over
the scenario axis too; the no-cross-term case passes P = None.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.parallel.lqr_sharded import make_lqt_horizon_sharded
from mpc_tpu.parallel.mesh import make_horizon_mesh
from mpc_tpu_torch.parallel._dist_worker import LQT_ARGS, launch
from mpc_tpu_torch.solver.lqr import lqt_solve_parallel

torch.set_num_threads(1)

TOL = {"us": 2e-3, "xs": 2e-3, "Ko": 2e-3, "ko": 2e-3, "Ss": 5e-3}
# (port mesh (scenario, horizon), N, cross term); the JAX reference of each
# (N, cross) runs on JAX_MESH
CASES = [((1, 2), 5, True), ((1, 2), 13, True), ((1, 4), 5, True),
         ((1, 4), 13, True), ((2, 2), 5, True), ((2, 2), 13, True),
         ((1, 2), 12, False), ((2, 2), 12, False)]
JAX_MESH = {(5, True): (2, 4), (13, True): (1, 8), (12, False): (2, 4)}


def _random_lqt(seed, N, Bb=4, n=4, m=2, with_cross=True):
    """tests/test_lqr_sharded.py's generator."""
    rng = np.random.default_rng(seed)

    def psd(shape_head, d, scale):
        M = rng.normal(0, scale, (*shape_head, d, d)).astype(np.float32)
        return M @ np.swapaxes(M, -1, -2) + 0.3 * np.eye(d, dtype=np.float32)

    A = (np.eye(n, dtype=np.float32)
         + 0.15 * rng.normal(0, 1, (Bb, N, n, n)).astype(np.float32)
         / math.sqrt(n))
    B = rng.normal(0, 0.5, (Bb, N, n, m)).astype(np.float32)
    c = rng.normal(0, 0.1, (Bb, N, n)).astype(np.float32)
    Q = psd((Bb, N), n, 0.4)
    q = rng.normal(0, 0.3, (Bb, N, n)).astype(np.float32)
    R = psd((Bb, N), m, 0.4) + np.eye(m, dtype=np.float32)
    r = rng.normal(0, 0.3, (Bb, N, m)).astype(np.float32)
    QN = psd((), n, 0.4)
    qN = rng.normal(0, 0.3, n).astype(np.float32)
    P = (0.1 * rng.normal(0, 1, (Bb, N, m, n)).astype(np.float32)
         if with_cross else None)
    x0 = rng.normal(0, 0.5, (Bb, n)).astype(np.float32)
    return x0, A, B, c, Q, q, R, r, QN, qN, P


def _port_args(N, cross):
    """The problem in the port's form: terminal terms per lane."""
    x0, A, B, c, Q, q, R, r, QN, qN, P = _random_lqt(N, N, with_cross=cross)
    L = A.shape[0]
    QN = np.broadcast_to(QN, (L,) + QN.shape).copy()
    qN = np.broadcast_to(qN, (L,) + qN.shape).copy()
    return dict(zip(LQT_ARGS, (x0, A, B, c, Q, q, R, r, QN, qN)), P=P)


def _name(mesh, N, cross):
    return f"m{mesh[0]}x{mesh[1]}_N{N}_{'cross' if cross else 'nocross'}"


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = {}
    for world in (2, 4):
        cases = [c for c in CASES if c[0][0] * c[0][1] == world]
        arrays, spec = {}, {}
        for mesh, N, cross in cases:
            name = _name(mesh, N, cross)
            spec[name] = {"mesh": list(mesh)}
            arrays.update({f"{name}/{k}": v for k, v in
                           _port_args(N, cross).items() if v is not None})
        res = launch("lqt", world, str(tmp_path_factory.mktemp(f"lqt{world}")),
                     spec={"cases": spec}, arrays=arrays,
                     device="cpu")
        for name in spec:
            out[name] = {k: res[f"{name}/{k}"] for k in TOL}
    return out


@pytest.fixture(scope="module")
def jax_ref():
    out = {}
    for (N, cross), (ns, nh) in JAX_MESH.items():
        mesh = make_horizon_mesh(n_scenario=ns, n_horizon=nh,
                                 devices=jax.devices()[: ns * nh])
        args = _random_lqt(N, N, with_cross=cross)
        if not cross:
            args = args[:-1]
        sol = jax.jit(make_lqt_horizon_sharded(mesh))(
            *map(jnp.asarray, args))
        out[(N, cross)] = {k: np.asarray(getattr(sol, k)) for k in TOL}
    return out


def _close(got, want, what):
    for k, tol in TOL.items():
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=tol,
                                   err_msg=f"{k} against {what}")


@pytest.mark.parametrize("mesh,N,cross", CASES)
def test_sharded_lqt_matches_jax_sharded(port, jax_ref, mesh, N, cross):
    _close(port[_name(mesh, N, cross)], jax_ref[(N, cross)],
           f"JAX on {JAX_MESH[(N, cross)]}")


@pytest.mark.parametrize("mesh,N,cross", CASES)
def test_sharded_lqt_matches_single_device(port, mesh, N, cross):
    a = {k: None if v is None else torch.as_tensor(v)
         for k, v in _port_args(N, cross).items()}
    sol = lqt_solve_parallel(*(a[k] for k in LQT_ARGS), P=a["P"])
    _close(port[_name(mesh, N, cross)],
           {k: getattr(sol, k).numpy() for k in TOL}, "lqt_solve_parallel")
