"""Recorded measurements of the port (port of mpc_tpu/utils/perfdb.py).

The layout is the JAX module's: one JSON object keyed by section id, each
value a flat dict whose ``config`` field is the section's title and whose
other fields become bullet lines of the rendering. :func:`record` stamps
``device`` (the card's name and power limit as nvidia-smi reports them, or
``"cpu"``) and ``recorded`` (the date) where the result does not name them.

The port's records go to ``.perf_results_torch.json`` at the repository's
root, and their rendering to ``build/mpc_tpu_torch/perf_records.md``
(git-ignored). Unlike the JAX module, this one writes neither ``PERF.md``,
which is kept by hand, nor the JAX package's ``.perf_results.json``.
Importing it imports no torch.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RESULTS_PATH = os.path.join(REPO, ".perf_results_torch.json")
MD_PATH = os.path.join(REPO, "build", "mpc_tpu_torch", "perf_records.md")


def gpu_info() -> dict:
    """Name and power limit of the first card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    first = out.splitlines()[0]
    name, power = (s.strip() for s in first.rsplit(",", 1))
    return {"nvidia_smi": first, "name": name, "power_limit": power}


def device_label(device=None) -> str:
    """``"<name>, <power limit>"`` of the card for a CUDA device, ``"cpu"``
    for the CPU; ``None`` is the card where there is one."""
    import torch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if torch.device(device).type != "cuda":
        return "cpu"
    return gpu_info()["nvidia_smi"]


def load() -> dict:
    """Every record, ``{}`` before the first."""
    if os.path.exists(RESULTS_PATH):
        with open(RESULTS_PATH) as f:
            return json.load(f)
    return {}


def record(key: str, result: dict, write_md: bool = True) -> dict:
    """Store ``result`` under ``key`` (replacing an earlier record of that
    key) and, with ``write_md``, render every record; returns them all."""
    results = load()
    result = dict(result)
    if "device" not in result:
        result["device"] = device_label()
    result.setdefault("recorded", time.strftime("%Y-%m-%d"))
    results[key] = result
    tmp = f"{RESULTS_PATH}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1)
    os.replace(tmp, RESULTS_PATH)
    if write_md:
        write_perf_md(results)
    return results


def write_perf_md(results: Optional[dict] = None) -> str:
    """Render the records (``None``: those on disk) to :data:`MD_PATH`, one
    section per key in sorted order; returns the path."""
    if results is None:
        results = load()
    lines = ["# mpc_tpu_torch: recorded measurements", "",
             "Rendered from `.perf_results_torch.json` by",
             "`mpc_tpu_torch/utils/perfdb.py`; each section names the",
             "device it was measured on.", ""]
    for key in sorted(results):
        r = results[key]
        lines.append(f"## {r.get('config', key)}")
        lines.extend(f"- {k}: {v}" for k, v in r.items() if k != "config")
        lines.append("")
    os.makedirs(os.path.dirname(MD_PATH), exist_ok=True)
    with open(MD_PATH, "w") as f:
        f.write("\n".join(lines))
    return MD_PATH
