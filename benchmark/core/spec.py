"""Finds the pieces of a cell by the names in ``BENCHMARK.json`` and in the
cell's files. Nothing here names a cell, a configuration, a mix or a kind
of either: each piece is a file, found by its name.

- the configuration: the entry's ``file``; it names its ``program``
  (``benchmark/programs/<program>.py``: builds the system under test and
  its control) and its ``check`` (``benchmark/checks/<check>.py``: judges
  what the timed path produced against a plain reference);
- the traffic mix: ``benchmark/traffic/<traffic>.json``; it names its
  ``generator`` (``benchmark/generators/<generator>.py``: the inputs, from
  the mix's parameters), its ``loop`` (``benchmark/loops/<loop>.py``: one
  episode of the timed path) and, where it has one, its road's ``kind``
  (``benchmark/roads/<kind>.py``);
- the cell's limits: ``benchmark/limits/<cell>.json``;
- each metric's reader: ``benchmark/metrics/<metric>.py``.

A new cell, configuration, mix, metric, or kind of any of them is a new
file and a new entry.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def load(kind: str, name: str, root: str = ROOT):
    """The module ``benchmark/<kind>/<name>.py`` under ``root``, loaded by
    its path (so a name need not be a Python identifier) once a process."""
    path = os.path.join(root, "benchmark", kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} named {name!r}: {path}")
    root = os.path.abspath(root)
    prefix = "benchmark" if root == ROOT else \
        "_bench_" + hashlib.sha1(root.encode()).hexdigest()[:8]
    modname = f"{prefix}.{kind}.{name.replace('.', '_')}"
    mod = sys.modules.get(modname)
    if mod is not None and os.path.abspath(getattr(mod, "__file__", "")) \
            == os.path.abspath(path):
        return mod
    mod_spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[modname] = mod
    mod_spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    root: str
    name: str
    chips: int
    cfg: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    def program(self):
        return load("programs", self.cfg["program"], self.root)

    def check(self):
        return load("checks", self.cfg["check"], self.root)

    def loop(self):
        return load("loops", self.traffic["loop"], self.root)

    def generator(self):
        return load("generators", self.traffic["generator"], self.root)


def _applies(metric: dict, name: str) -> bool:
    return name in metric.get("workloads", [name])


def cell(name: str, bench: dict = None, root: str = ROOT) -> Cell:
    bench = bench or benchmark(root)
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = wl[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    bench_dir = os.path.join(root, "benchmark")
    cfg = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic",
                                     f"{w['traffic']}.json"))
    limits = load_json(os.path.join(bench_dir, "limits", f"{name}.json"))
    return Cell(root, name, w["chips"], cfg, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def metric_reader(name: str, root: str = ROOT):
    """The module ``benchmark/metrics/<name>.py``."""
    return load("metrics", name, root)
