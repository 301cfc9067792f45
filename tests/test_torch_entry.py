"""The port's entry-point contracts (mpc_tpu_torch/entry.py) against the
repository's ``__graft_entry__.py``: ``entry()``'s warm-started headline
step, ``u0`` and ``U`` within 1e-3 of the JAX function's under ``jax.jit``;
``dryrun_multichip`` over a world of one in this process and over two gloo
ranks (two processes of parallel/_dist_worker.py), each part's outputs of
the JAX function's shapes.
"""

import jax
import numpy as np
import torch

import __graft_entry__ as graft
from mpc_tpu_torch.entry import dryrun_multichip, entry

torch.set_num_threads(1)


def test_entry_matches_the_jax_entry():
    jfn, jargs = graft.entry()
    ju0, jU = jax.jit(jfn)(*jargs)
    fn, (carry, y0) = entry(device="cpu")
    assert carry.U.shape == (1, 24) and y0.shape == (1, 6)
    u0, U = fn(carry, y0)
    assert u0.shape == (1, 2) and U.shape == (1, 24)
    np.testing.assert_allclose(u0[0].numpy(), np.asarray(ju0), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(U[0].numpy(), np.asarray(jU), rtol=0,
                               atol=1e-3)


def test_dryrun_multichip_one_and_two_ranks():
    shapes = {"solver": (2, 8), "lqt": (2, 5, 2), "ilqr": (2, 2)}
    assert dryrun_multichip(1, device="cpu") == shapes
    assert not torch.distributed.is_initialized()
    assert dryrun_multichip(2, device="cpu") == shapes
