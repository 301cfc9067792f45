"""The hanging chain, the port's second model family, lane-batched (port of
mpc_tpu/models/chain.py; the reference's alpaqa demo).

N balls joined by springs, anchored at the origin; the free end (ball N+1)
is velocity-controlled. A state (B, state_dim) is

  y = [y1 (d*N ball positions), y2 (d*N ball velocities), y3 (d free-end
  position)]

and an input (B, d) the free end's velocity. The spring forces of all
segments are one tensor op over a (B, N+1, d) stack.
"""

from __future__ import annotations

import dataclasses

import torch

from mpc_tpu_torch.models.params import ChainParams


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """The chain's topology: ``n_balls`` balls in ``dim`` dimensions."""
    n_balls: int = 6
    dim: int = 2

    @property
    def state_dim(self) -> int:
        return 2 * self.dim * self.n_balls + self.dim

    @property
    def input_dim(self) -> int:
        return self.dim

    def gravity(self, device=None) -> torch.Tensor:
        g = [0.0, 0.0, -9.81] if self.dim == 3 else [0.0, -9.81]
        return torch.tensor(g, dtype=torch.float32, device=device)

    def x_end(self, device=None) -> torch.Tensor:
        """The free end's reference position e1."""
        e1 = torch.zeros((self.dim,), dtype=torch.float32, device=device)
        e1[0] = 1.0
        return e1

    def initial_state(self, batch: int = 1, device=None) -> torch.Tensor:
        """(batch, state_dim): the balls spread along x in (0, 1), at rest,
        the free end at e1 (mpc_tpu/models/chain.py:50-56)."""
        n, d = self.n_balls, self.dim
        y1 = torch.zeros((n, d), dtype=torch.float32)
        y1[:, 0] = torch.arange(1, n + 1, dtype=torch.float32) / (n + 1)
        y = torch.cat([y1.reshape(-1), torch.zeros((n * d,)),
                       self.x_end()])
        return y.to(device).expand(batch, -1).clone()


def chain_dynamics(spec: ChainSpec):
    """The continuous ODE ``f(y (B, sd), u (B, d), p: ChainParams) -> y'``
    (mpc_tpu/models/chain.py:59-83):

      F_ab = D (1 - L / ||xb - xa||) (xb - xa)
      ball i's acceleration = (F_{i,i+1} - F_{i-1,i}) / m + g
    """
    n, d = spec.n_balls, spec.dim
    cache = {}

    def f(y, u, p: ChainParams):
        g = cache.get(y.device)
        if g is None:
            g = cache[y.device] = spec.gravity(y.device)
        B = y.shape[0]
        y1 = y[:, : n * d].reshape(B, n, d)
        y2 = y[:, n * d: 2 * n * d]
        y3 = y[:, 2 * n * d:]
        # segments anchor -> ball 1 -> ... -> ball N -> free end
        pts = torch.cat([torch.zeros_like(y3)[:, None], y1, y3[:, None]],
                        dim=1)
        seg = pts[:, 1:] - pts[:, :-1]
        dist = torch.linalg.vector_norm(seg, dim=2, keepdim=True)
        force = p.D * (1.0 - p.L / dist) * seg
        accel = (force[:, 1:] - force[:, :-1]) / p.m + g
        return torch.cat([y2, accel.reshape(B, n * d), u], dim=1)

    return f


def chain_state_to_pos(spec: ChainSpec, y: torch.Tensor):
    """The positions (B, N+2) of the anchor, the balls and the free end,
    as x, y, z (z zero in 2-D) (mpc_tpu/models/chain.py:86-95)."""
    n, d = spec.n_balls, spec.dim
    B = y.shape[0]
    pts = torch.cat([torch.zeros((B, 1, d), dtype=y.dtype, device=y.device),
                     y[:, : n * d].reshape(B, n, d),
                     y[:, None, 2 * n * d:]], dim=1)
    if d == 2:
        return pts[..., 0], pts[..., 1], torch.zeros_like(pts[..., 0])
    return pts[..., 0], pts[..., 1], pts[..., 2]
