"""The port's loader of the native scenario generator
(mpc_tpu_torch/io/native_scenarios.py) against the JAX package's: the same
source and flags, so the same bits. It needs a C++ compiler and skips
without one; the parity tests of the suites draw their scenarios from JAX's
``random_scenarios`` instead, so no other test needs it.
"""

import shutil

import numpy as np
import pytest
import torch

from mpc_tpu_torch.io import native_scenarios as tns

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ compiler (g++)")


@pytest.mark.parametrize("seed,batch,size,n_obs", [(0, 32, 100, 2),
                                                   (7, 5, 40, 3)])
def test_port_loader_matches_the_jax_packages_bits(seed, batch, size, n_obs):
    from mpc_tpu.io import native_scenarios as jns
    if not jns.native_available():
        pytest.skip("the JAX package's loader could not build the generator")
    ref = jns.generate_scenarios(seed, batch, size, n_obs)
    got = tns.generate_scenarios(seed, batch, size, n_obs, device="cpu")
    for name in ("y0", "centerline", "obstacles"):
        t = getattr(got, name)
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(ref,
                                                                    name)))


def test_thread_count_invariance_and_prefetcher():
    a = tns.generate_scenarios(3, 16, 32, n_threads=1, device="cpu")
    b = tns.generate_scenarios(3, 16, 32, n_threads=4, device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    pf = tns.ScenarioPrefetcher(seed=0, batch=4, size=32, device="cpu")
    first, second = pf.next(), pf.next()
    assert torch.equal(first.centerline, tns.generate_scenarios(
        0, 4, 32, device="cpu").centerline)
    assert not torch.equal(first.centerline, second.centerline)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "scenario_gen.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tns, "SRC", str(bad))
    monkeypatch.setattr(tns, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tns, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tns.generate_scenarios(0, 2, device="cpu")
