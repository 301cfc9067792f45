"""Parity of the port's LQT solves (mpc_tpu_torch/solver/lqr.py) with
``mpc_tpu.solver.lqr`` and with a float64 dense KKT oracle, on batches of
drawn well-posed problems, with and without the cross term, at
N in {1, 2, 13, 40}.

The oracle solves the equality-constrained QP in all states and inputs
with numpy float64: an independent transcription of the optimality system
(a copy of the one in tests/test_lqr.py). Tolerances: 2e-4 against the
oracle, the bar of tests/test_lqr.py:93-100 (float32 Riccati at these
condition numbers); 5e-4 between the parallel and the sequential solve on
inputs and states and 5e-3 on the value Hessians, the bars of
tests/test_lqr.py:103-115; 2e-5 (relative to a quantity's largest entry)
between the port and the JAX package running the same algorithm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.solver.lqr import lqt_solve_parallel as j_parallel
from mpc_tpu.solver.lqr import lqt_solve_sequential as j_sequential
from mpc_tpu_torch.solver.lqr import lqt_solve_parallel, lqt_solve_sequential

torch.set_num_threads(1)

LANES = 3


def random_lqt(seed, N=12, n=4, m=2, cross=False):
    rng = np.random.default_rng(seed)

    def psd(k, scale=1.0):
        M = rng.normal(size=(k, k))
        return scale * (M @ M.T / k + np.eye(k))

    A = np.stack([np.eye(n) + 0.1 * rng.normal(size=(n, n))
                  for _ in range(N)])
    B = 0.5 * rng.normal(size=(N, n, m))
    c = 0.1 * rng.normal(size=(N, n))
    Q = np.stack([psd(n, 0.5) for _ in range(N)])
    q = 0.1 * rng.normal(size=(N, n))
    R = np.stack([psd(m, 1.0) for _ in range(N)])
    r = 0.1 * rng.normal(size=(N, m))
    P = 0.1 * rng.normal(size=(N, m, n)) if cross else None
    QN = psd(n, 1.0)
    qN = 0.1 * rng.normal(size=(n,))
    x0 = rng.normal(size=(n,))
    return x0, A, B, c, Q, q, R, r, QN, qN, P


def kkt_oracle(x0, A, B, c, Q, q, R, r, QN, qN, P=None):
    """Dense f64 solve of the KKT system; z = [x_1..x_N, u_0..u_{N-1}]."""
    N, n = A.shape[0], A.shape[1]
    m = B.shape[2]
    if P is None:
        P = np.zeros((N, m, n))
    nz = N * n + N * m

    def xi(k):
        return slice((k - 1) * n, k * n)

    def ui(k):
        return slice(N * n + k * m, N * n + (k + 1) * m)

    H = np.zeros((nz, nz))
    h = np.zeros(nz)
    for k in range(N):
        H[ui(k), ui(k)] += R[k]
        h[ui(k)] += r[k]
        if k == 0:
            h[ui(0)] += P[0] @ x0
        else:
            H[xi(k), xi(k)] += Q[k]
            h[xi(k)] += q[k]
            H[ui(k), xi(k)] += P[k]
            H[xi(k), ui(k)] += P[k].T
    H[xi(N), xi(N)] += QN
    h[xi(N)] += qN

    E = np.zeros((N * n, nz))
    d = np.zeros(N * n)
    for k in range(N):
        rows = slice(k * n, (k + 1) * n)
        E[rows, xi(k + 1)] = np.eye(n)
        E[rows, ui(k)] = -B[k]
        d[rows] = c[k]
        if k == 0:
            d[rows] += A[0] @ x0
        else:
            E[rows, xi(k)] = -A[k]

    KKT = np.block([[H, E.T], [E, np.zeros((N * n, N * n))]])
    sol = np.linalg.solve(KKT, np.concatenate([-h, d]))
    xs = np.concatenate([x0[None], sol[: N * n].reshape(N, n)])
    return xs, sol[N * n: nz].reshape(N, m)


def batch(N, cross, seed0=0):
    """``LANES`` problems stacked on a leading lane axis (float32 numpy),
    and the float64 oracle's (xs, us) of each."""
    probs = [random_lqt(seed0 + s, N=N, cross=cross) for s in range(LANES)]
    args = [None if probs[0][i] is None else
            np.stack([np.asarray(p[i], np.float32) for p in probs])
            for i in range(11)]
    oracle = [kkt_oracle(*p) for p in probs]
    return args, np.stack([o[0] for o in oracle]), \
        np.stack([o[1] for o in oracle])


def port(fn, args):
    return fn(*[None if a is None else torch.as_tensor(a) for a in args])


def jax_ref(fn, args):
    P = args[10]
    if P is None:
        return jax.vmap(lambda *a: fn(*a))(*map(jnp.asarray, args[:10]))
    return jax.vmap(lambda *a: fn(*a[:10], P=a[10]))(*map(jnp.asarray, args))


def close_to(a, b, rel, what):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale, err_msg=what)


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("N", [1, 2, 13, 40])
def test_lqt_solves_match_kkt_oracle_and_jax(N, cross):
    args, xs_o, us_o = batch(N, cross)
    for name, fn, jfn in (("sequential", lqt_solve_sequential, j_sequential),
                          ("parallel", lqt_solve_parallel,
                           jax.jit(j_parallel))):
        sol = port(fn, args)
        assert sol.xs.shape == (LANES, N + 1, 4)
        assert sol.us.shape == (LANES, N, 2)
        assert sol.Ss.shape == (LANES, N + 1, 4, 4)
        np.testing.assert_allclose(sol.us.numpy(), us_o, atol=2e-4,
                                   err_msg=name)
        np.testing.assert_allclose(sol.xs.numpy(), xs_o, atol=2e-4,
                                   err_msg=name)
        ref = jax_ref(jfn, args)
        for field in ("xs", "us", "Ks", "kffs", "Ss", "vs", "Ko", "ko"):
            close_to(getattr(sol, field).numpy(), getattr(ref, field), 2e-5,
                     f"{name} {field}")


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("N", [1, 2, 13, 40])
def test_parallel_matches_sequential(N, cross):
    args, _, _ = batch(N, cross, seed0=10)
    seq = port(lqt_solve_sequential, args)
    par = port(lqt_solve_parallel, args)
    np.testing.assert_allclose(par.us.numpy(), seq.us.numpy(), atol=5e-4)
    np.testing.assert_allclose(par.xs.numpy(), seq.xs.numpy(), atol=5e-4)
    np.testing.assert_allclose(par.Ss.numpy(), seq.Ss.numpy(), atol=5e-3)
    np.testing.assert_allclose(par.Ko.numpy(), seq.Ko.numpy(), atol=5e-4)


def test_lanes_are_independent():
    # one lane's singular input Hessian makes that lane non-finite and
    # leaves the others as they are alone (no error, no host check)
    args, _, us_o = batch(8, True)
    bad = [None if a is None else a.copy() for a in args]
    bad[6][1] = 0.0                       # R of lane 1: singular
    for fn in (lqt_solve_sequential, lqt_solve_parallel):
        sol = port(fn, bad)
        assert not torch.isfinite(sol.us[1]).all()
        np.testing.assert_allclose(sol.us[[0, 2]].numpy(), us_o[[0, 2]],
                                   atol=2e-4)
