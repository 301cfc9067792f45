"""The port's resumable scenario suite and its checkpoints
(mpc_tpu_torch/sim/scenarios.py, mpc_tpu_torch/utils/checkpoint.py),
mirroring tests/test_scenarios.py:61-137: the resumed run equals the
straight one; a checkpoint round-trips and one of another structure is
rejected. A checkpoint's keys are the JAX package's, so a checkpoint
written by the JAX package after one segment resumes in the port, and the
reverse.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.control.mpc import build_vehicle_controller
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.sim import closedloop as jcl
from mpc_tpu.sim import scenarios as jsc
from mpc_tpu.utils import checkpoint as jck
from mpc_tpu_torch import config as tconfig
from mpc_tpu_torch.control import mpc as tmpc
from mpc_tpu_torch.convert import scenario_batch_from_numpy
from mpc_tpu_torch.models import bicycle as tbicycle
from mpc_tpu_torch.models import integrators as tintegrators
from mpc_tpu_torch.models.params import VehicleParams as TVehicleParams
from mpc_tpu_torch.sim import closedloop as tcl
from mpc_tpu_torch.sim import scenarios as tsc
from mpc_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(1)

B, N_HORIZ, SEGMENT, EPS = 4, 4, 2, 1e-3
# across the two packages, as tests/test_torch_scenarios.py judges states:
# the solves stop at a criterion of EPS
STATE_BAND = dict(rtol=0, atol=1e-2)


def _scenarios():
    sc = jsc.random_scenarios(jax.random.PRNGKey(5), batch=B, size=100)
    return sc, scenario_batch_from_numpy(*(np.asarray(a) for a in sc))


def _port():
    ctrl = tmpc.build_vehicle_controller(
        n_horiz=N_HORIZ, alm_cfg=tconfig.AlmConfig(eps=EPS),
        panoc_cfg=tconfig.PanocConfig(lbfgs_memory=N_HORIZ, max_iter=60),
        device="cpu")
    return ctrl, tintegrators.discretize(tbicycle.pacejka_dynamics)


def _jax():
    ctrl = build_vehicle_controller(
        n_horiz=N_HORIZ, alm_cfg=AlmConfig(eps=EPS),
        panoc_cfg=PanocConfig(lbfgs_memory=N_HORIZ, max_iter=60))
    return ctrl, discretize(pacejka_dynamics)


def test_resumable_suite_matches_straight_run(tmp_path):
    _, sc = _scenarios()
    ctrl, f_d = _port()
    p = os.path.join(tmp_path, "ck.npz")
    state_a, conv = tsc.run_scenario_suite_resumable(
        ctrl, f_d, sc, TVehicleParams(), 2 * SEGMENT, segment=SEGMENT)
    # interrupted after one segment, then resumed from the checkpoint
    tsc.run_scenario_suite_resumable(ctrl, f_d, sc, TVehicleParams(),
                                     SEGMENT, segment=SEGMENT,
                                     checkpoint_path=p)
    state_b, conv_b = tsc.run_scenario_suite_resumable(
        ctrl, f_d, sc, TVehicleParams(), 2 * SEGMENT, segment=SEGMENT,
        checkpoint_path=p)
    assert conv.shape == (B, 2 * SEGMENT) and conv_b.shape == (B, SEGMENT)
    assert torch.equal(state_a["ys"], state_b["ys"])
    for a, b in zip(state_a["carries"], state_b["carries"]):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(conv[:, SEGMENT:], conv_b)
    # the straight run is the closed loop
    out = tcl.run_closed_loop(ctrl, f_d, sc.y0, {
        "p": TVehicleParams(), "centerline": sc.centerline}, 2 * SEGMENT,
        TVehicleParams())
    assert torch.equal(out.ys[:, -1], state_a["ys"])


def test_checkpoint_roundtrip(tmp_path):
    tree = {"ys": torch.arange(12.0).reshape(3, 4),
            "carry": (torch.zeros(5), torch.tensor(3, dtype=torch.int32))}
    p = os.path.join(tmp_path, "ckpt.npz")
    tck.save_checkpoint(p, tree, step=17)
    loaded, step = tck.load_checkpoint(p, tree)
    assert step == 17
    assert torch.equal(loaded["ys"], tree["ys"])
    assert torch.equal(loaded["carry"][0], torch.zeros(5))
    assert loaded["carry"][1].dtype == torch.int32 \
        and int(loaded["carry"][1]) == 3


def test_checkpoint_incompatible_structure_rejected(tmp_path):
    old = {"ys": torch.zeros((3, 4)), "carry": (torch.zeros(5),)}
    new = {"ys": torch.zeros((3, 4)),
           "carry": (torch.zeros(5), torch.zeros(5))}
    p = os.path.join(tmp_path, "ckpt.npz")
    tck.save_checkpoint(p, old, step=3)
    with pytest.raises(ValueError, match="incompatible checkpoint"):
        tck.load_checkpoint(p, new)
    bad_shape = {"ys": torch.zeros((3, 5)), "carry": (torch.zeros(5),)}
    with pytest.raises(ValueError, match="shape/dtype"):
        tck.load_checkpoint(p, bad_shape)
    bad_dtype = {"ys": torch.zeros((3, 4), dtype=torch.int32),
                 "carry": (torch.zeros(5),)}
    with pytest.raises(ValueError, match="shape/dtype"):
        tck.load_checkpoint(p, bad_dtype)


def test_checkpoint_keys_are_the_jax_packages():
    jctrl, _ = _jax()
    tctrl, _ = _port()
    jstate = {"ys": jnp.zeros((B, 6)),
              "carries": jax.vmap(lambda _: jctrl.init_carry())(
                  jnp.arange(B))}
    tstate = {"ys": torch.zeros((B, 6)), "carries": tctrl.init_carry(B)}
    jkeys = [(k, np.asarray(v).shape, np.asarray(v).dtype)
             for k, v in jck._flatten_with_paths(jstate)]
    tkeys = [(k, tuple(v.shape), v.numpy().dtype)
             for k, v in tck._flatten_with_paths(tstate)]
    assert tkeys == jkeys


def test_jax_checkpoint_resumes_in_the_port_and_the_reverse(tmp_path):
    jsc_, sc = _scenarios()
    jctrl, jf_d = _jax()
    tctrl, tf_d = _port()
    straight, _ = tsc.run_scenario_suite_resumable(
        tctrl, tf_d, sc, TVehicleParams(), 2 * SEGMENT, segment=SEGMENT)
    # JAX writes after one segment, the port resumes
    pj = os.path.join(tmp_path, "jax.npz")
    jsc.run_scenario_suite_resumable(jctrl, jf_d, jsc_, VehicleParams(),
                                     SEGMENT, segment=SEGMENT,
                                     checkpoint_path=pj)
    resumed, conv = tsc.run_scenario_suite_resumable(
        tctrl, tf_d, sc, TVehicleParams(), 2 * SEGMENT, segment=SEGMENT,
        checkpoint_path=pj)
    assert conv.shape == (B, SEGMENT) and conv.all()
    np.testing.assert_allclose(resumed["ys"].numpy(),
                               straight["ys"].numpy(), **STATE_BAND)
    assert resumed["carries"].tot_it.dtype == torch.int32
    # the port writes after one segment, JAX resumes
    pt = os.path.join(tmp_path, "port.npz")
    tsc.run_scenario_suite_resumable(tctrl, tf_d, sc, TVehicleParams(),
                                     SEGMENT, segment=SEGMENT,
                                     checkpoint_path=pt)
    jstate, jconv = jsc.run_scenario_suite_resumable(
        jctrl, jf_d, jsc_, VehicleParams(), 2 * SEGMENT, segment=SEGMENT,
        checkpoint_path=pt)
    assert np.asarray(jconv).shape == (B, SEGMENT)
    np.testing.assert_allclose(np.asarray(jstate["ys"]),
                               straight["ys"].numpy(), **STATE_BAND)
    _, step = jck.load_checkpoint(pj, jstate)
    assert step == 2 * SEGMENT


def test_suite_summary_keys_and_values_equal_the_jax_packages():
    rng = np.random.default_rng(0)
    ys = rng.normal(size=(B, 3, 6)).astype(np.float32)
    ys[1, -1, 2] = np.nan
    conv = rng.random((B, 3)) < 0.8
    iters = rng.integers(1, 50, (B, 3)).astype(np.int32)
    us = np.zeros((B, 3, 2), np.float32)
    ref = jsc.suite_summary(jcl.ClosedLoopOut(ys, us, None, iters, conv),
                            None)
    got = tsc.suite_summary(tcl.ClosedLoopOut(
        torch.as_tensor(ys), torch.as_tensor(us), None,
        torch.as_tensor(iters), torch.as_tensor(conv)), None)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-6), k
