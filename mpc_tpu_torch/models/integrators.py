"""Fixed-step RK4 discretisation (port of mpc_tpu/models/integrators.py).

``discretize`` performs ``substeps`` classical RK4 steps of size
``ts / substeps`` (CasADi's "rk" with 4 finite elements), on lane-batched
states ``(B, state_dim)`` and inputs ``(B, input_dim)``.
"""

from __future__ import annotations

from typing import Callable

import torch

DEFAULT_TS = 0.05
DEFAULT_SUBSTEPS = 4


def rk4_step(f: Callable, x: torch.Tensor, u: torch.Tensor, p,
             h: float) -> torch.Tensor:
    """One classical RK4 step of size h with zero-order-hold input."""
    k1 = f(x, u, p)
    k2 = f(x + 0.5 * h * k1, u, p)
    k3 = f(x + 0.5 * h * k2, u, p)
    k4 = f(x + h * k3, u, p)
    return x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def euler_step(f: Callable, x: torch.Tensor, u: torch.Tensor, p,
               h: float) -> torch.Tensor:
    """One forward-Euler step (mpc_tpu/models/integrators.py:52-54)."""
    return x + h * f(x, u, p)


def discretize(f: Callable, ts: float = DEFAULT_TS,
               substeps: int = DEFAULT_SUBSTEPS) -> Callable:
    """Build ``f_d(x, u, p) -> x_next`` from a continuous ODE ``f(x, u, p)``."""
    h = ts / substeps

    def f_d(x, u, p):
        for _ in range(substeps):
            x = rk4_step(f, x, u, p, h)
        return x

    return f_d


def rollout(f_d: Callable, x0: torch.Tensor, us: torch.Tensor,
            p) -> torch.Tensor:
    """N-step rollout of ``us`` (B, N, input_dim) from ``x0`` (B, sd).

    Returns the states after each input, (B, N, sd) — the convention of
    ``mpc_tpu.models.integrators.rollout``.
    """
    xs = []
    x = x0
    for k in range(us.shape[1]):
        x = f_d(x, us[:, k], p)
        xs.append(x)
    return torch.stack(xs, dim=1)


def rollout_scan(f_d: Callable, x0: torch.Tensor, us: torch.Tensor,
                 p) -> torch.Tensor:
    """:func:`rollout` under the JAX package's other name
    (mpc_tpu/models/integrators.py:77-84). There ``rollout`` is a jitted
    entry point and ``rollout_scan`` its untraced body for use inside a
    larger jitted program; torch traces nothing, so the two are one."""
    return rollout(f_d, x0, us, p)
