"""Two-car game-theoretic MPC: the decision layer driving the control layer
(port of mpc_tpu/sim/two_car.py), batched over scenario pairs.

Each step of the closed loop, for every pair:

1. both cars' lane payoffs against the other's current lane, iterated by
   best response (``n_rounds`` rounds);
2. each car's chosen lane picks its road, the line of that lane;
3. one warm-started MPC solve per car toward its road;
4. both plants advance one step.

The reference ``vmap``-s a ``lax.scan`` over pairs and calls its controller
once per car. Here the loop over time is a host loop, and both cars' solves
are one controller step over 2B lanes (car A's lanes, then car B's), each
lane on its own road: the lanes are independent, and a lane whose solve has
ended is frozen, so this equals the two calls lane by lane with half the
launches.

Geometry: a straight two-lane road along +x, lane centers at y = 0 (lane 1)
and y = LANE_OFFSET (lane 2). The decision layer's road-scale gaps (metres)
map onto the RC-car world through DECISION_SCALE.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from mpc_tpu_torch.control.mpc import MpcCarry, MpcController
from mpc_tpu_torch.decision.game_theory import Cars, Ego, lane_payoffs
from mpc_tpu_torch.ops.road import straight_centerline

LANE_OFFSET = 0.35        # lane-2 lateral offset in the RC world (metres)
DECISION_SCALE = 50.0     # decision-layer metres per RC-world metre


class TwoCarState(NamedTuple):
    y_a: torch.Tensor      # (B, 6) car A's plant state
    y_b: torch.Tensor      # (B, 6) car B's plant state
    lane_a: torch.Tensor   # (B,) int32 current lane of A
    lane_b: torch.Tensor
    carry_a: MpcCarry      # A's warm start, B lanes
    carry_b: MpcCarry


class TwoCarOut(NamedTuple):
    ys_a: torch.Tensor     # (B, n_sim, 6)
    ys_b: torch.Tensor
    lanes_a: torch.Tensor  # (B, n_sim) int32
    lanes_b: torch.Tensor
    state: TwoCarState


def _lane_centerline(size: int = 100, device=None) -> torch.Tensor:
    """The two lanes' lines (2, size, 2)."""
    base = straight_centerline(size, device=device)
    lane2 = base.clone()
    lane2[:, 1] += LANE_OFFSET
    return torch.stack([base, lane2])


def _best_response_pair(y_a, y_b, lane_a, lane_b, n_rounds: int = 3):
    """Iterated best response between the two cars of each pair
    (decision-layer units): states (B, 6), lanes (B,) int32 -> the lanes
    (B,) after ``n_rounds`` rounds."""
    def to_dec(y):
        # road-scale longitudinal position and speed
        return y[:, 0] * DECISION_SCALE, torch.clamp(
            torch.sqrt(y[:, 3] ** 2 + y[:, 4] ** 2) * DECISION_SCALE,
            min=1e-3)

    xa, va = to_dec(y_a)
    xb, vb = to_dec(y_b)
    ones = torch.ones((y_a.shape[0], 1), dtype=torch.bool, device=y_a.device)

    def respond(x, v, lane, ox, ov, olane):
        p = lane_payoffs(Ego(x=x, v=v, lane=lane),
                         Cars(x=ox[:, None], v=ov[:, None],
                              lane=olane[:, None], mask=ones))
        return torch.where(p[:, 1] > p[:, 0], 2, 1).to(torch.int32)

    la, lb = lane_a, lane_b
    for _ in range(n_rounds):
        la, lb = respond(xa, va, la, xb, vb, lb), \
            respond(xb, vb, lb, xa, va, la)
    return la, lb


def _split(c: MpcCarry, n: int):
    return (type(c)(*(t[:n] for t in c)), type(c)(*(t[n:] for t in c)))


def make_two_car_game(controller: MpcController, f_d: Callable, params,
                      n_sim: int, size: int = 100, n_rounds: int = 3):
    """Build the two-car closed loop ``run(y0_a, y0_b, lane_a0=1,
    lane_b0=2) -> TwoCarOut`` over B pairs: ``y0_a``, ``y0_b`` (B, 6), both
    cars starting in the given lanes (mpc_tpu/sim/two_car.py:91-129)."""
    lanes_cl = _lane_centerline(size, device=controller.device)

    @torch.no_grad()
    def run(y0_a, y0_b, lane_a0=1, lane_b0=2) -> TwoCarOut:
        B = y0_a.shape[0]
        dev = y0_a.device
        la = torch.full((B,), lane_a0, dtype=torch.int32, device=dev)
        lb = torch.full((B,), lane_b0, dtype=torch.int32, device=dev)
        carry = controller.init_carry(2 * B, device=dev, dtype=y0_a.dtype)
        y = torch.cat([y0_a, y0_b])
        ys, lanes_a, lanes_b = [], [], []
        for _ in range(n_sim):
            la, lb = _best_response_pair(y[:B], y[B:], la, lb, n_rounds)
            road = torch.cat([la, lb]).long() - 1
            out = controller.step(carry, {
                "y0": y, "p": params, "centerline": lanes_cl[road]})
            y = f_d(y, out.u0, params)
            carry = out.carry
            ys.append(y)
            lanes_a.append(la)
            lanes_b.append(lb)
        ys = torch.stack(ys, dim=1)
        carry_a, carry_b = _split(carry, B)
        st = TwoCarState(y[:B], y[B:], la, lb, carry_a, carry_b)
        return TwoCarOut(ys[:B], ys[B:], torch.stack(lanes_a, dim=1),
                         torch.stack(lanes_b, dim=1), st)

    return run
