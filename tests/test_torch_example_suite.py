"""The port's scenario-suite demo (mpc_tpu_torch/examples/
scenario_suite.py) against the JAX package's examples/scenario_suite.py,
both run as a user runs them (``main()``, the JAX script loaded from its
path, its stdout captured), at ``--batch 4 --n-sim 2 --segment 1`` on the
native generator's scenarios (both packages build it from
native/scenario_gen.cpp with the same flags, so the same bits): the JSON
keys, ``converged_fraction`` and ``nan_scenarios`` equal,
``mean_final_speed`` within 1e-3. Then a run stopped after one segment
and resumed from its checkpoint ends where the straight run ends. It needs
a C++ compiler and skips without one, as
tests/test_torch_native_scenarios.py does. The JAX script runs in a thread
beside the port's three runs.
"""

import concurrent.futures
import importlib.util
import json
import os
import shutil
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from mpc_tpu_torch.examples import scenario_suite
from mpc_tpu_torch.io.native_scenarios import native_available

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ compiler (g++)")

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--batch", "4", "--n-sim", "2", "--segment", "1"]


def run_jax_example(name, argv):
    """Run the JAX package's ``examples/<name>.py`` ``main()`` with
    ``argv``; returns its printed lines."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lines = []
    mod.print = lambda *a, **k: lines.append(" ".join(map(str, a)))
    with mock.patch.object(sys, "argv", [name, *argv]):
        mod.main()
    return lines


def test_scenario_suite_matches_the_jax_script_and_resumes(tmp_path):
    if not native_available():
        pytest.skip("the native scenario generator does not build here")
    ck = str(tmp_path / "suite.npz")
    cpu = ["--device", "cpu"]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_lines = pool.submit(run_jax_example, "scenario_suite", ARGV)
        straight = scenario_suite.main(ARGV + cpu)
        stopped = scenario_suite.main(
            ["--batch", "4", "--n-sim", "1", "--segment", "1",
             "--checkpoint", ck] + cpu)
        resumed = scenario_suite.main(ARGV + ["--checkpoint", ck] + cpu)
        lines = jax_lines.result()
    assert lines[0] == "native generator: True"
    ref = json.loads(lines[1])
    assert set(ref) <= set(straight)
    assert straight["converged_fraction"] == ref["converged_fraction"]
    assert straight["nan_scenarios"] == ref["nan_scenarios"] == 0
    np.testing.assert_allclose(straight["mean_final_speed"],
                               ref["mean_final_speed"], rtol=0, atol=1e-3)

    assert stopped["converged"].shape == (4, 1)
    assert resumed["converged"].shape == (4, 1)
    np.testing.assert_array_equal(resumed["converged"],
                                  straight["converged"][:, 1:])
    np.testing.assert_array_equal(resumed["final_states"],
                                  straight["final_states"])
