"""The port's last names of the JAX package's library surface, against the
JAX package: ``VehicleParams.from_vector`` and ``ChainParams.from_vector``
(round trips, and the JAX function's fields), ``euler_step`` and
``rollout_scan`` (within tests/test_torch_models.py's 1e-5 relative,
1e-6 absolute), the dimension constants, ``H_LANE``, the
batched aliases (the port is batch-native, so each is the function
itself), ``native_available`` and the records store ``utils/perfdb.py``,
which writes only its own files; the package's top-level names, those of
``mpc_tpu/__init__.py``, with the same fields. Also: every new entry point
runs on the card by default and raises without one.
"""

import dataclasses
import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.decision import game_theory as jgame
from mpc_tpu.models import bicycle as jbicycle
from mpc_tpu.models import integrators as jintegrators
from mpc_tpu.models.params import ChainParams as JChainParams
from mpc_tpu.models.params import VehicleParams as JVehicleParams
from mpc_tpu_torch.decision import game_theory as tgame
from mpc_tpu_torch.io import native_scenarios as tns
from mpc_tpu_torch.models import bicycle as tbicycle
from mpc_tpu_torch.models import integrators as tintegrators
from mpc_tpu_torch.models.params import (PARAM_FIELDS, ChainParams,
                                         VehicleParams)
from mpc_tpu_torch.ops import road as troad
from mpc_tpu_torch.utils import perfdb

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _vec(seed, n):
    return np.random.default_rng(seed).uniform(0.05, 3.0, n).astype(
        np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_vehicle_params_from_vector(seed):
    vec = _vec(seed, len(PARAM_FIELDS))
    p = VehicleParams.from_vector(torch.as_tensor(vec))
    assert torch.equal(p.to_vector(), torch.as_tensor(vec))
    assert VehicleParams.from_vector(vec) == p
    assert VehicleParams.from_vector(list(vec)) == p
    assert (p.friction, p.acceleration) == (VehicleParams.friction,
                                            VehicleParams.acceleration)
    ref = JVehicleParams.from_vector(jnp.asarray(vec))
    for f in PARAM_FIELDS + ("friction", "acceleration"):
        assert getattr(p, f) == float(getattr(ref, f)), f
    assert VehicleParams.from_vector(VehicleParams().to_vector()) \
        .to_vector().equal(VehicleParams().to_vector())


def test_chain_params_from_vector():
    vec = _vec(2, 3)
    p = ChainParams.from_vector(torch.as_tensor(vec))
    assert torch.equal(p.to_vector(), torch.as_tensor(vec))
    ref = JChainParams.from_vector(jnp.asarray(vec))
    assert (p.m, p.D, p.L) == tuple(float(getattr(ref, f))
                                    for f in ("m", "D", "L"))
    assert ChainParams.from_vector(ChainParams().to_vector()) \
        .to_vector().equal(ChainParams().to_vector())


def _states(seed, B):
    """vy = omega = 0, as tests/test_torch_models.py starts its lanes: the
    yaw dynamics are stiff and amplify libm's rounding differences."""
    rng = np.random.default_rng(seed)
    x = np.zeros((B, 6), np.float32)
    x[:, :2] = rng.uniform(-1.0, 1.0, (B, 2))
    x[:, 2] = rng.uniform(-3.0, 3.0, B)
    x[:, 3] = rng.uniform(0.2, 1.5, B)
    return x


def test_euler_step_matches_jax():
    x = _states(3, 5)
    u = np.random.default_rng(4).uniform(-0.3, 0.3, (5, 2)).astype(
        np.float32)
    ref = jax.vmap(lambda xi, ui: jintegrators.euler_step(
        jbicycle.pacejka_dynamics, xi, ui, JVehicleParams(), 0.05))(
            jnp.asarray(x), jnp.asarray(u))
    got = tintegrators.euler_step(tbicycle.pacejka_dynamics,
                                  torch.as_tensor(x), torch.as_tensor(u),
                                  VehicleParams(), 0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_rollout_scan_matches_jax():
    x0 = _states(5, 3)
    us = np.random.default_rng(6).uniform(-0.3, 0.3, (3, 6, 2)).astype(
        np.float32)
    jf = jintegrators.discretize(jbicycle.pacejka_dynamics)
    ref = jax.vmap(lambda x, u: jintegrators.rollout_scan(
        jf, x, u, JVehicleParams()))(jnp.asarray(x0), jnp.asarray(us))
    tf = tintegrators.discretize(tbicycle.pacejka_dynamics)
    got = tintegrators.rollout_scan(tf, torch.as_tensor(x0),
                                    torch.as_tensor(us), VehicleParams())
    assert got.shape == (3, 6, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert torch.equal(got, tintegrators.rollout(
        tf, torch.as_tensor(x0), torch.as_tensor(us), VehicleParams()))


def test_constants_and_batched_aliases():
    for name in ("PACEJKA_STATE_DIM", "SIMPLIFIED_STATE_DIM", "INPUT_DIM"):
        assert getattr(tbicycle, name) == getattr(jbicycle, name), name
    assert tgame.H_LANE == float(jgame.H_LANE)
    assert tbicycle.pacejka_dynamics_batched is tbicycle.pacejka_dynamics
    assert tbicycle.simplified_dynamics_batched \
        is tbicycle.simplified_dynamics
    assert troad.compute_errors_ocp_batched is troad.compute_errors_ocp
    assert troad.compute_errors_diag_batched \
        is troad.compute_errors_diagnostic


def test_native_available_is_a_bool_and_false_on_a_failed_build(
        tmp_path, monkeypatch):
    assert isinstance(tns.native_available(), bool)
    bad = tmp_path / "scenario_gen.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tns, "SRC", str(bad))
    monkeypatch.setattr(tns, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tns, "_lib", None)
    assert tns.native_available() is False
    with pytest.raises((RuntimeError, OSError)):
        tns.generate_scenarios(0, 2, device="cpu")


def _stat(path):
    return os.stat(path).st_mtime_ns, open(path, "rb").read()


def test_perfdb_round_trip_writes_only_its_own_files(tmp_path,
                                                     monkeypatch):
    results = tmp_path / ".perf_results_torch.json"
    md = tmp_path / "build" / "mpc_tpu_torch" / "perf_records.md"
    assert perfdb.RESULTS_PATH == os.path.join(REPO,
                                               ".perf_results_torch.json")
    assert perfdb.MD_PATH == os.path.join(REPO, "build", "mpc_tpu_torch",
                                          "perf_records.md")
    guarded = [os.path.join(REPO, f) for f in ("PERF.md",
                                               ".perf_results.json")]
    before = [_stat(p) for p in guarded]
    monkeypatch.setattr(perfdb, "RESULTS_PATH", str(results))
    monkeypatch.setattr(perfdb, "MD_PATH", str(md))
    assert perfdb.load() == {}
    perfdb.record("b_second", {"config": "Second", "solves_per_s": 2.5})
    out = perfdb.record("a_first", {"config": "First", "wall_s": 1.0,
                                    "device": "NVIDIA H100, 700.00 W"})
    assert perfdb.load() == out == json.loads(results.read_text())
    stamp = "cpu" if not torch.cuda.is_available() else \
        perfdb.device_label("cuda")
    assert out["b_second"]["device"] == stamp
    assert out["a_first"]["device"] == "NVIDIA H100, 700.00 W"
    assert set(out["a_first"]) == {"config", "wall_s", "device", "recorded"}
    text = md.read_text()
    assert text.index("## First") < text.index("## Second")
    assert "- solves_per_s: 2.5" in text and "config" not in text
    perfdb.record("a_first", {"config": "First again"}, write_md=False)
    assert perfdb.load()["a_first"]["config"] == "First again"
    assert "First again" not in md.read_text()
    assert perfdb.write_perf_md() == str(md)
    assert "## First again" in md.read_text()
    assert [_stat(p) for p in guarded] == before
    assert perfdb.device_label("cpu") == "cpu"


def test_top_level_names_match_jax():
    import mpc_tpu
    import mpc_tpu_torch

    def names(mod):
        return {k for k, v in vars(mod).items()
                if not k.startswith("_") and not inspect.ismodule(v)}

    assert names(mpc_tpu_torch) == names(mpc_tpu) == {
        "AlmConfig", "MpcConfig", "PanocConfig", "ChainParams",
        "VehicleParams"}
    for k in names(mpc_tpu):
        ours, ref = getattr(mpc_tpu_torch, k), getattr(mpc_tpu, k)
        assert ours.__module__.startswith("mpc_tpu_torch."), k
        assert [f.name for f in dataclasses.fields(ours)] \
            == [f.name for f in dataclasses.fields(ref)], k


@pytest.mark.parametrize("name", ["vehicle_mpc", "hanging_chain",
                                  "lane_change_game", "scenario_suite",
                                  "profile_config2_phases", "exp_mfu",
                                  "profile_config2", "exp_shift_warm",
                                  "entry"])
def test_entry_points_run_on_the_card_by_default(name):
    import importlib
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would use it")
    if name == "entry":
        from mpc_tpu_torch.entry import dryrun_multichip, entry
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun_multichip(1)
        return
    mod = importlib.import_module(f"mpc_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
