"""A new configuration, traffic mix, cell and per-layer metric are new
files and new BENCHMARK.json entries, and so is a new kind of any of them:
a road, a generator, a loop, a program or a check. The harness finds each
by its name, and no file that was there changes."""

import hashlib
import json
import os
import shutil

import numpy as np
import pytest

from benchmark import run
from benchmark.core import spec
from benchmark.tests.conftest import tiny


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        if "__pycache__" in d:
            continue
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


#: new kinds, each a file that the new configuration or mix names; each
#: records that it ran and hands on to the kind it extends
KINDS = {
    "roads/wave.py": (
        "import numpy as np\n\n\n"
        "def points(spec):\n"
        "    x = spec['start'] + spec['spacing'] * np.arange(spec['points'])\n"
        "    return np.stack([x, spec['amplitude'] * np.sin(x)],\n"
        "                    axis=1).astype(np.float32)\n"),
    "generators/fleet_logged.py": (
        "from benchmark.generators import fleet\n\nCALLS = []\n\n\n"
        "def make(traffic, root):\n"
        "    CALLS.append(traffic['road']['kind'])\n"
        "    return fleet.make(traffic, root)\n"),
    "loops/closed_loop_logged.py": (
        "from benchmark.loops import closed_loop\n\nCALLS = []\n"
        "replay = closed_loop.replay\n\n\n"
        "def episode(*args, **kwargs):\n"
        "    CALLS.append(1)\n"
        "    return closed_loop.episode(*args, **kwargs)\n"),
    "programs/vehicle_mpc_m6.py": (
        "import copy\n\n"
        "from benchmark.programs import vehicle_mpc as base\n\n"
        "set_precision, control, FAULTS = (base.set_precision, base.control,\n"
        "                                  base.FAULTS)\n\n\n"
        "def build(cfg, traffic, device):\n"
        "    cfg = copy.deepcopy(cfg)\n"
        "    cfg['panoc']['lbfgs_memory'] = 6\n"
        "    prog = base.build(cfg, traffic, device)\n"
        "    prog.memory = 6\n"
        "    return prog\n"),
    "checks/vehicle_plan_counted.py": (
        "from benchmark.checks import vehicle_plan\n\n\n"
        "def judge(cfg, traffic, steps, seed, device):\n"
        "    out = vehicle_plan.judge(cfg, traffic, steps, seed, device)\n"
        "    d = out['detail']\n"
        "    out['numbers']['unjudged_share'] = (1 - d['judged']\n"
        "                                        / d['sampled'])\n"
        "    return out\n"),
    "metrics/lane_iters_total.py": (
        "UNIT = 'iters'\n\n\n"
        "def read(run):\n"
        "    return float(run.lane_iters.sum())\n"),
}


@pytest.fixture
def grown(tmp_path):
    """A copy of the benchmark with one more configuration, mix, cell and
    metric, and a new kind of each piece, added as files and entries
    only."""
    root = str(tmp_path)
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root)
    bench = spec.benchmark()
    b = os.path.join(root, "benchmark")
    for rel, text in KINDS.items():
        with open(os.path.join(b, rel), "w") as f:
            f.write(text)
    cfg = spec.load_json(os.path.join(b, "configs", "vehicle_n12.json"))
    cfg.update(name="vehicle_n8", n_horiz=8, program="vehicle_mpc_m6",
               check="vehicle_plan_counted")
    with open(os.path.join(b, "configs", "vehicle_n8.json"), "w") as f:
        json.dump(cfg, f)
    mix = spec.load_json(os.path.join(b, "traffic", "straight_b16384.json"))
    mix.update(batch=64, generator="fleet_logged", loop="closed_loop_logged",
               road={"kind": "wave", "points": 100, "spacing": 0.1,
                     "start": -0.1, "amplitude": 0.05})
    with open(os.path.join(b, "traffic", "wave_b64.json"), "w") as f:
        json.dump(mix, f)
    name = "vehicle_n8.wave_b64"
    limits = spec.load_json(os.path.join(
        b, "limits", "vehicle_n12.straight_b16384.json"))
    limits["unjudged_share"] = 1.0
    with open(os.path.join(b, "limits", f"{name}.json"), "w") as f:
        json.dump(limits, f)
    bench["configs"].append({"name": "vehicle_n8", "source": "x",
                             "file": "benchmark/configs/vehicle_n8.json",
                             "reduced": ["n_horiz"], "why": "a test"})
    bench["workloads"].append({"name": name, "config": "vehicle_n8",
                               "traffic": "wave_b64", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "lane_iters_total", "unit": "iters",
                               "better": "lower",
                               "source": "program_counter",
                               "layer": "PANOC: solver/panoc.py",
                               "moves": "solves_per_s", "workloads": [name]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root, name, before


def test_new_files_are_found_by_name(grown):
    root, name, before = grown
    c = spec.cell(name, root=root)
    assert c.cfg["n_horiz"] == 8 and c.traffic["batch"] == 64
    assert [m["name"] for m in c.per_layer][-1] == "lane_iters_total"
    tiny(c)
    prog = c.program().build(c.cfg, c.traffic, "cpu")
    assert prog.memory == 6
    res = run.measure(c, 99, 0.0, True, "cpu", prog=prog)
    assert res["correct"], res["check"]
    assert "lane_iters_total" in res["metrics"]
    assert "unjudged_share" in res["check"]
    logged = spec.load("generators", "fleet_logged", root)
    assert set(logged.CALLS) == {"wave"}
    assert len(spec.load("loops", "closed_loop_logged", root).CALLS) == 2
    road = c.generator().make(c.traffic, root)[0]["centerline"]
    np.testing.assert_allclose(road[:, 1], 0.05 * np.sin(road[:, 0]),
                               atol=1e-6)
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())


def test_every_named_piece_exists():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        c = spec.cell(w["name"])
        for piece in (c.program, c.check, c.loop, c.generator):
            assert piece() is not None
        assert spec.load("roads", c.traffic["road"]["kind"]) is not None
        for m in c.end_to_end + c.per_layer:
            assert spec.metric_reader(m["name"]).UNIT == m["unit"]
