"""The port's runnable demos and measurement scripts, the counterparts of
the repository's
``examples/{vehicle_mpc,hanging_chain,lane_change_game,scenario_suite}.py``
and ``examples/{profile_config2_phases,exp_mfu,profile_config2,
exp_shift_warm}.py``:

    python -m mpc_tpu_torch.examples.<name> [options] [--device D]

Each runs on the card unless ``--device`` names another device
(``--device cpu``), prints a line naming the device, then what the JAX
script prints, and has a ``main(argv=None) -> dict`` that returns the
printed JSON object's fields together with the arrays behind them.
"""

from __future__ import annotations

import argparse

import torch

from mpc_tpu_torch.control.mpc import resolve_device
from mpc_tpu_torch.utils.perfdb import device_label


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the card)")


def start(device) -> torch.device:
    """The device a demo runs on (the card unless ``device`` names another;
    without a card a default run raises), announced on its own line."""
    dev = resolve_device(device)
    print(f"device: {device_label(dev)}")
    return dev


def sync(dev: torch.device) -> None:
    """Wait for the device's queued work, so that a host clock times it."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
