"""Carry parameters and state across from the JAX package.

The port never imports jax: these functions take the JAX objects' leaves as
numpy arrays (``np.asarray(leaf)``), so a test can run the same scenario
through both packages and compare them step for step.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from mpc_tpu_torch.control.event_triggered import EtcCarry
from mpc_tpu_torch.control.mpc import MpcCarry
from mpc_tpu_torch.models.params import (KERNEL_PARAM_FIELDS, ChainParams,
                                          VehicleParams)


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


def chain_params_from_numpy(leaves: Mapping[str, np.ndarray]) -> ChainParams:
    """``ChainParams`` from the JAX ``ChainParams`` fields ``m``, ``D``,
    ``L`` as numpy scalars (shared by every lane)."""
    kwargs = {}
    for f in ("m", "D", "L"):
        a = np.asarray(leaves[f])
        if a.size != 1:
            raise ValueError(f"chain_params_from_numpy: field {f!r} has "
                             f"shape {a.shape}; only shared scalars are "
                             "supported")
        kwargs[f] = float(a.reshape(()))
    return ChainParams(**kwargs)


def _leaf_readers(leaves, device):
    """Readers of one leaf as a float32 and as an int32 tensor; np.array
    copies, since the leaves of a JAX array are read-only views."""
    def f32(k):
        return torch.as_tensor(np.array(leaves[k], np.float32), device=device)

    def i32(k):
        return torch.as_tensor(np.array(leaves[k], np.int32), device=device)

    return f32, i32


def carry_from_numpy(leaves: Mapping[str, np.ndarray], device=None) -> MpcCarry:
    """``MpcCarry`` from the JAX ``MpcCarry`` leaves as numpy arrays with a
    leading lane axis (``{k: np.asarray(v) for k, v in carry._asdict()}``)."""
    f32, i32 = _leaf_readers(leaves, device)
    return MpcCarry(U=f32("U"), lam=f32("lam"), sigma=f32("sigma"),
                    gamma=f32("gamma"), tot_it=i32("tot_it"),
                    failures=i32("failures"))


def etc_carry_from_numpy(leaves: Mapping[str, np.ndarray],
                         device=None) -> EtcCarry:
    """``EtcCarry`` from the JAX ``EtcCarry`` leaves as numpy arrays with a
    leading lane axis."""
    f32, i32 = _leaf_readers(leaves, device)
    return EtcCarry(U=f32("U"), lam=f32("lam"), xs_pred=f32("xs_pred"),
                    k=i32("k"), tot_solves=i32("tot_solves"),
                    tot_it=i32("tot_it"))


def centerline_from_numpy(cl: np.ndarray, device=None) -> torch.Tensor:
    """A centerline (S, 2) as a float32 tensor."""
    return torch.as_tensor(np.array(cl, np.float32), device=device)


def scenario_batch_from_numpy(y0: np.ndarray, centerline: np.ndarray,
                              obstacles: np.ndarray, device=None):
    """A port ``ScenarioBatch`` from the JAX ``ScenarioBatch`` leaves as
    numpy arrays (``np.asarray(sc.y0)`` etc.): y0 (B, 6), centerline
    (B, S, 2), obstacles (B, K, 4)."""
    from mpc_tpu_torch.sim.scenarios import ScenarioBatch

    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    return ScenarioBatch(y0=f32(y0), centerline=f32(centerline),
                         obstacles=f32(obstacles))


def ego_from_numpy(x: np.ndarray, v: np.ndarray, lane: np.ndarray,
                   device=None):
    """A port ``Ego`` (fields (B,)) from the JAX ``Ego`` leaves as numpy
    arrays; a scalar JAX ego becomes a batch of one."""
    from mpc_tpu_torch.decision.game_theory import Ego

    def t(a, dtype):
        return torch.as_tensor(np.array(a, dtype).reshape(-1), device=device)

    return Ego(x=t(x, np.float32), v=t(v, np.float32),
               lane=t(lane, np.int32))


def cars_from_numpy(x: np.ndarray, v: np.ndarray, lane: np.ndarray,
                    mask: np.ndarray, device=None):
    """A port ``Cars`` (fields (B, M)) from the JAX ``Cars`` leaves as numpy
    arrays; the cars of a single JAX scenario (M,) become a batch of one."""
    from mpc_tpu_torch.decision.game_theory import Cars

    def t(a, dtype):
        a = np.array(a, dtype)
        return torch.as_tensor(a.reshape((1, -1)) if a.ndim == 1 else a,
                               device=device)

    return Cars(x=t(x, np.float32), v=t(v, np.float32),
                lane=t(lane, np.int32), mask=t(mask, bool))
