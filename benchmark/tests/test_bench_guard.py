"""A run refuses to print its result where ``jax``, ``jaxlib``, ``flax``
or the JAX package ``mpc_tpu`` is among its top-level module names,
compared as whole names; the harness and the program load none of them;
without a card the command exits 2 with no result."""

import os
import subprocess
import sys
import types

import pytest

from benchmark import run
from benchmark.core import spec


def test_the_harness_and_the_program_load_no_jax():
    """Every module of the benchmark, each piece found by name included,
    and the program they import."""
    code = ("import glob, os\n"
            "import benchmark.run as r, benchmark.control\n"
            "from benchmark.core import check, trace, window\n"
            "from benchmark.core import spec\n"
            "for kind in ('programs', 'checks', 'loops', 'generators',\n"
            "             'roads', 'metrics'):\n"
            "    for p in glob.glob(os.path.join(spec.ROOT, 'benchmark',\n"
            "                                    kind, '*.py')):\n"
            "        name = os.path.basename(p)[:-3]\n"
            "        if name != '__init__':\n"
            "            spec.load(kind, name)\n"
            "print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("name,found", [
    ("jax", True), ("jaxlib.xla", True), ("flax", True),
    ("mpc_tpu.solver", True), ("mpc_tpu_torch_extra", False),
    ("jaxtyping", False)])
def test_whole_top_level_names(monkeypatch, name, found):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name.split(".")[0] in run.forbidden_modules()) is found


def test_a_forbidden_module_stops_the_result(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    res = {"correct": True, "check": {}}
    assert run.emit(res) == 3
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err


def test_without_a_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "vehicle_n12.straight_b16384", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=spec.ROOT, env=env, capture_output=True,
        text=True)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "vehicle_n12.straight_b16384", "--seed", "5", "--seconds", "1",
         "--trace", "1"], cwd=spec.ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-2000:]
    import json
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
