"""A fleet on one shared road: ``batch`` initial states drawn from the
mix's ``pool_seed``, float32, on the road of kind ``road.kind``
(``benchmark/roads/<kind>.py``).

Each state component is ``base + U(lo, hi)``: ``base`` a number
(``value``, default 0) or the road's ``start_x``, ``start_y`` or
``start_heading`` (of its first segment), the uniform draws component by
component in one generator (``initial_state``, in the state's order).
"""

from __future__ import annotations

import numpy as np

from benchmark.core import seeds, spec


def road(traffic: dict, root: str = spec.ROOT) -> np.ndarray:
    """The mix's shared road, (S, 2) float32."""
    return spec.load("roads", traffic["road"]["kind"], root).points(
        traffic["road"])


def initial_states(traffic: dict, cl: np.ndarray,
                   stream: np.random.SeedSequence) -> np.ndarray:
    """(batch, state_dim) float32 initial states drawn from ``stream``."""
    rng = np.random.default_rng(stream)
    B = traffic["batch"]
    d0 = cl[1].astype(np.float64) - cl[0]
    bases = {"start_x": float(cl[0, 0]), "start_y": float(cl[0, 1]),
             "start_heading": float(np.arctan2(d0[1], d0[0]))}
    cols = []
    for comp in traffic["initial_state"]:
        base = bases[comp["base"]] if "base" in comp \
            else float(comp.get("value", 0.0))
        col = np.full(B, base)
        if "uniform" in comp:
            col = col + rng.uniform(*comp["uniform"], B)
        cols.append(col)
    return np.stack(cols, axis=1).astype(np.float32)


def make(traffic: dict, root: str = spec.ROOT):
    """``(shared, lanes)``: ``{"centerline": (S, 2)}`` and ``{"y0": (B,
    state_dim)}``, the lanes in the order the pool drew them."""
    cl = road(traffic, root)
    return ({"centerline": cl},
            {"y0": initial_states(traffic, cl,
                                  seeds.seed_seq(traffic["pool_seed"]))})
