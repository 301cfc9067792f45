"""A real two-process ``torch.distributed`` run of the port (the counterpart
of tests/test_distributed.py): two ranks of
``mpc_tpu_torch.parallel._dist_worker`` meet through a ``FileStore``, build
a (scenario, model) mesh over the world, each solve the rows of a box QP
batch that ``local_batch_slice`` gives it, and gather the solutions. The box
QP ``min 0.5 ||u - t||^2`` over ``[-1, 1]^4`` has the solution clip(t).
"""

import numpy as np
import torch

from mpc_tpu_torch.parallel._dist_worker import launch

torch.set_num_threads(1)


def test_two_process_box_qp_matches_clip(tmp_path):
    out = launch("box_qp", 2, str(tmp_path), device="cpu", timeout=120)
    assert out["converged"].all()
    assert out["u"].shape == (16, 4)
    assert list(out["mesh_axes"]) == ["scenario", "model"]
    np.testing.assert_allclose(out["u"], np.clip(out["ts"], -1, 1),
                               atol=1e-4)
