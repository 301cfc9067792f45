"""Typed configuration: a copy of ``mpc_tpu/config.py`` with the same defaults.

``mpc_tpu.config`` cannot be reused here: importing anything under
``mpc_tpu`` imports jax (``mpc_tpu/__init__.py``). The field comments of the
reference explain each default; ``tests/test_torch_models.py`` holds the two
copies equal field by field.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PanocConfig:
    """Inner PANOC(+L-BFGS) solver configuration (mpc_tpu/config.py:14-63)."""
    max_iter: int = 1000
    lbfgs_memory: int = 12
    alpha: float = 0.95              # gamma = alpha / L
    # line-search grid over x(tau) = u - (1-tau) r + tau d; tau=0 (the
    # forward-backward step) is always evaluated as well
    taus: tuple = (1.0, 0.25, 1.0 / 16.0, 1.0 / 64.0)
    gamma_min: float = 1e-12
    max_gamma_backtracks: int = 60   # implicit via gamma_min; kept for parity
    tr_mult: float = 1e5             # ||d|| <= tr_mult * ||r||
    lbfgs_min_step_mult: float = 0.0
    crit_floor_mult: float = 4.0
    plateau_iters: int = 40
    trace: bool = False


@dataclasses.dataclass(frozen=True)
class AlmConfig:
    """Outer augmented-Lagrangian loop configuration (mpc_tpu/config.py:66-91)."""
    eps: float = 1e-6
    delta: float = 1e-4
    sigma_0: float = 1e5
    max_iter: int = 20
    eps_0: float = 1e-1
    rho_eps: float = 1e-1
    penalty_factor: float = 10.0
    theta: float = 0.25
    sigma_max: float = 1e9
    lam_max: float = 1e9
    trace: bool = False


@dataclasses.dataclass(frozen=True)
class MpcConfig:
    """Vehicle MPC configuration (mpc_tpu/config.py:94-101)."""
    n_horiz: int = 12
    ts: float = 0.05
    v_ref: float = 1.0
    centerline_size: int = 100
    n_sim: int = 400
