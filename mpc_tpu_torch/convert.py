"""Carry parameters and state across from the JAX package.

The port never imports jax: these functions take the JAX objects' leaves as
numpy arrays (``np.asarray(leaf)``), so a test can run the same scenario
through both packages and compare them step for step.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from mpc_tpu_torch.control.mpc import MpcCarry
from mpc_tpu_torch.models.params import KERNEL_PARAM_FIELDS, VehicleParams


def vehicle_params_from_numpy(leaves: Mapping[str, np.ndarray]) -> VehicleParams:
    """``VehicleParams`` from the JAX ``VehicleParams`` fields as numpy
    scalars (e.g. ``{f: np.asarray(getattr(p, f)) for f in fields}``).
    Every field must be a scalar: the port shares one parameter set across
    all lanes."""
    kwargs = {}
    for f in KERNEL_PARAM_FIELDS:
        if f not in leaves:
            continue
        a = np.asarray(leaves[f])
        if a.size != 1:
            raise ValueError(f"vehicle_params_from_numpy: field {f!r} has "
                             f"shape {a.shape}; only shared scalars are "
                             "supported")
        kwargs[f] = float(a.reshape(()))
    return VehicleParams(**kwargs)


def carry_from_numpy(leaves: Mapping[str, np.ndarray], device=None) -> MpcCarry:
    """``MpcCarry`` from the JAX ``MpcCarry`` leaves as numpy arrays with a
    leading lane axis (``{k: np.asarray(v) for k, v in carry._asdict()}``)."""
    # np.array copies: the leaves of a JAX array are read-only views
    def f32(k):
        return torch.as_tensor(np.array(leaves[k], np.float32), device=device)

    def i32(k):
        return torch.as_tensor(np.array(leaves[k], np.int32), device=device)

    return MpcCarry(U=f32("U"), lam=f32("lam"), sigma=f32("sigma"),
                    gamma=f32("gamma"), tot_it=i32("tot_it"),
                    failures=i32("failures"))


def centerline_from_numpy(cl: np.ndarray, device=None) -> torch.Tensor:
    """A centerline (S, 2) as a float32 tensor."""
    return torch.as_tensor(np.array(cl, np.float32), device=device)
