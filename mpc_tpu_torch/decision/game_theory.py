"""Game-theoretic lane-change decision layer, batch-native (port of
mpc_tpu/decision/game_theory.py).

Every function takes a batch of scenarios: ego fields (B,), car fields
(B, M) with an active mask, so the reference's ``lane_payoffs_batched``
(a ``vmap`` of ``lane_payoffs``) is :func:`lane_payoffs` itself. The
reference's semantics are transcribed exactly, its operator precedence
included: ``v - cv * TLC / 2 + CAR_L`` parses as ``v - (cv TLC / 2) + L``
and the same-lane follow distance ``Q1 * v + TD`` adds TD un-multiplied.
These are mirrored, not fixed.

Constants that the reference computes in float32 on the device (the sine
of the maximum heading, log 2) are computed here in float32 as well, so
that payoffs round alike.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# Reference Car defaults (mpc_tpu/decision/game_theory.py:29-45).
CAR_L = 4.2
CAR_W = 1.8
SEG_L = 3.0
THETA_MAX = 3.2 / 180.0 * math.pi
TLC = 5.17
TD = 1.2
TI = 0.15
TAU = 0.9
A_MAX = 7.0
H_LANE = 3.75
LF = 1.0
Q1, Q2 = 0.65, 0.35
W_SAFETY, W_VELOCITY = 0.6, 0.4
BIG = 1e9


def _f32(fn, x: float, like: torch.Tensor) -> torch.Tensor:
    """``fn`` of a Python float taken in float32 on ``like``'s device, as
    ``jnp.sin(THETA_MAX)`` is."""
    return fn(torch.tensor(x, dtype=torch.float32, device=like.device))


class Cars(NamedTuple):
    """Up to M surrounding vehicles per scenario, structure of arrays."""
    x: torch.Tensor      # (B, M)
    v: torch.Tensor      # (B, M)
    lane: torch.Tensor   # (B, M) int32, 1 or 2
    mask: torch.Tensor   # (B, M) bool

    @staticmethod
    def from_lists(xs, vs, lanes, max_cars=None, device=None) -> "Cars":
        """One scenario (B = 1) of ``len(xs)`` cars, padded with inactive
        cars to ``max_cars``."""
        n = len(xs)
        pad = (n if max_cars is None else max_cars) - n

        def row(vals, dtype):
            return torch.tensor([list(vals)], dtype=dtype, device=device)

        return Cars(x=row(list(xs) + [0.0] * pad, torch.float32),
                    v=row(list(vs) + [0.0] * pad, torch.float32),
                    lane=row(list(lanes) + [0] * pad, torch.int32),
                    mask=row([True] * n + [False] * pad, torch.bool))


class Ego(NamedTuple):
    x: torch.Tensor      # (B,)
    v: torch.Tensor      # (B,)
    lane: torch.Tensor   # (B,) int32


def safety_distance(ego: Ego, cx, cv, clane, target_lane):
    """Piecewise safety distance S00/S01/S02/S03 of each car (B, M)
    (mpc_tpu/decision/game_theory.py:72-101); ``target_lane`` (B,)."""
    v, x = ego.v[:, None], ego.x[:, None]
    lane, target = ego.lane[:, None], target_lane[:, None]
    dv = v - cv
    sin_t = _f32(torch.sin, THETA_MAX, v)

    # same lane branches
    s_follow = (Q1 * v + TD
                + Q2 * (dv * TAU + TI / 2 + dv ** 2 / (2 * A_MAX)) + SEG_L)
    s01_fast = v - cv * TLC / 2 + CAR_L + CAR_W / 2 * sin_t
    s01_slow = Q1 * v * TD + SEG_L
    same_not_behind = torch.where(
        target == lane, s_follow, torch.where(v > cv, s01_fast, s01_slow))
    same = torch.where(x > cx, torch.abs(x - cx), same_not_behind)

    # different lane branches
    s02_fast = (v - cv * TLC / 2 + CAR_L - CAR_W / 2 * sin_t
                + Q1 * v * TD
                + Q2 * (dv * TAU + TI / 2 + dv ** 2 / (2 * A_MAX)))
    s02 = torch.where(v > cv, s02_fast, Q1 * v * TD + SEG_L)
    s03_slow = ((cv - v) * 3 / 4 * TLC + CAR_L + Q1 * cv * TD
                + Q2 * ((cv - v) * TAU + TI / 2
                        + (cv - v) ** 2 / (2 * A_MAX)))
    s03 = torch.where(v < cv, s03_slow, Q1 * cv * TD + SEG_L)
    diff = torch.where(x < cx, s02, s03)

    return torch.where(lane == clane, same, diff)


def safety_payoff(ego: Ego, cars: Cars, target_lane):
    """Min-over-cars banded payoff (B,) (mpc_tpu/decision/game_theory.py:
    104-119): 1 outside the safety distance, -1 within the car length,
    log-interpolated between."""
    sk = safety_distance(ego, cars.x, cars.v, cars.lane, target_lane)
    dk = torch.abs(ego.x[:, None] - cars.x)
    t = torch.where(dk >= torch.abs(sk), 1.0, float("nan"))
    t = torch.where(dk <= SEG_L, -1.0, t)
    mid = (SEG_L < dk) & (dk < torch.abs(sk))
    t = torch.where(mid, torch.log(dk / sk + 1.0)
                    / _f32(torch.log, 2.0, dk), t)
    t = torch.nan_to_num(t, nan=1.0)
    # skip cars in another lane when staying in lane
    skip = (ego.lane[:, None] != cars.lane) \
        & (ego.lane[:, None] == target_lane[:, None])
    consider = cars.mask & ~skip
    return torch.where(consider, t, 1.0).amin(dim=1)


def _gather(a, i):
    return a.gather(1, i[:, None]).squeeze(1)


def _car_in_front(ego: Ego, cars: Cars, target_lane):
    """Nearest active car ahead in ``target_lane``: (exists, its speed)."""
    ahead = cars.mask & (cars.lane == target_lane[:, None]) \
        & (cars.x > ego.x[:, None])
    xf = torch.where(ahead, cars.x, BIG)
    return ahead.any(dim=1), _gather(cars.v, torch.argmin(xf, dim=1))


def _car_behind(ego: Ego, cars: Cars):
    """Nearest active lane-2 car behind ego (the reference hardcodes lane
    2): (exists, index)."""
    behind = cars.mask & (cars.lane == 2) & (cars.x < ego.x[:, None])
    xb = torch.where(behind, cars.x, -BIG)
    return behind.any(dim=1), torch.argmax(xb, dim=1)


def velocity_payoff(ego: Ego, cars: Cars, target_lane):
    """(v_front - v) / v banded to [-1, 1] (B,)
    (mpc_tpu/decision/game_theory.py:139-145)."""
    exists, vf = _car_in_front(ego, cars, target_lane)
    p = torch.where(vf == 0.0, -1.0,
                    torch.where(vf >= 2 * ego.v, 1.0, (vf - ego.v) / ego.v))
    return torch.where(exists, p, 1.0)


def comfort_payoff(ego: Ego, cars: Cars, target_lane):
    """Sigmoid of the Bezier time to collision avoidance (B,)
    (mpc_tpu/decision/game_theory.py:148-166). Computed for parity with the
    API, and, as in the reference, not part of the total payoff."""
    exists, vf = _car_in_front(ego, cars, torch.ones_like(target_lane))
    ahead = cars.mask & (cars.lane == 1) & (cars.x > ego.x[:, None])
    xf = torch.where(ahead, cars.x, BIG)
    d1 = _gather(xf, torch.argmin(xf, dim=1)) - ego.x
    li = LF + SEG_L
    di = li * torch.cos(torch.atan2(ego.x.new_tensor(CAR_W),
                                    ego.x.new_tensor(2 * LF)) - THETA_MAX)
    tc1 = d1 / (ego.v - vf)
    px2 = ego.v * tc1 - di
    tca = px2 / (ego.v - vf)
    p = 2.0 / (1.0 + torch.exp(-tca)) - 2.0
    applies = (target_lane == 2) & exists & (ego.v > vf)
    return torch.where(applies, p, 0.0)


def total_payoff(ego: Ego, cars: Cars, target_lane, a=W_SAFETY,
                 b=W_VELOCITY):
    """``a * safety + b * velocity`` (B,) plus the rear lane-2 car's payoff
    with a ghost ego inserted when changing lane
    (mpc_tpu/decision/game_theory.py:169-185)."""
    total = (a * safety_payoff(ego, cars, target_lane)
             + b * velocity_payoff(ego, cars, target_lane))

    exists, bi = _car_behind(ego, cars)
    M = cars.x.shape[1]
    # the rear car's world: every other car, and a ghost copy of ego in
    # lane 2 when ego changes lane
    mask_wo_behind = cars.mask & (torch.arange(M, device=bi.device)[None, :]
                                  != bi[:, None])
    ghost = target_lane == 2
    ext = Cars(
        x=torch.cat([cars.x, ego.x[:, None]], dim=1),
        v=torch.cat([cars.v, ego.v[:, None]], dim=1),
        lane=torch.cat([cars.lane, torch.full_like(cars.lane[:, :1], 2)],
                       dim=1),
        mask=torch.cat([mask_wo_behind, ghost[:, None]], dim=1))
    rear = Ego(x=_gather(cars.x, bi), v=_gather(cars.v, bi),
               lane=_gather(cars.lane, bi))
    two = torch.full_like(target_lane, 2)
    total_behind = (a * safety_payoff(rear, ext, two)
                    + b * velocity_payoff(rear, ext, two))
    return total + torch.where(exists, total_behind, 0.0)


def lane_payoffs(ego: Ego, cars: Cars) -> torch.Tensor:
    """Payoff (B, 2) of staying (lane 1) and of changing (lane 2)."""
    one = torch.ones_like(ego.lane)
    return torch.stack([total_payoff(ego, cars, one),
                        total_payoff(ego, cars, 2 * one)], dim=1)


#: the reference's ``vmap`` of :func:`lane_payoffs`: the same function here
lane_payoffs_batched = lane_payoffs


def decision_rollout(ego: Ego, cars: Cars, n_steps: int = 50,
                     dt: float = 0.1):
    """Constant-velocity decision rollout (mpc_tpu/decision/game_theory.py:
    200-213): per step the lane payoffs, then every car moves. Returns the
    payoffs (B, n_steps, 2) and the change flags ``payoff(2) > payoff(1)``
    (B, n_steps)."""
    payoffs = []
    for _ in range(n_steps):
        payoffs.append(lane_payoffs(ego, cars))
        ego = ego._replace(x=ego.x + ego.v * dt)
        cars = cars._replace(x=cars.x + cars.v * dt)
    p = torch.stack(payoffs, dim=1)
    return p, p[..., 1] > p[..., 0]


def iterated_best_response(egos: Ego, cars_list: Cars, n_rounds: int = 3):
    """Iterated best response of A agents (mpc_tpu/decision/game_theory.py:
    216-244): each round every agent picks its lane against its view of
    the others, ``cars_list`` (A, M). ``egos`` fields are (A,); their
    lanes start the iteration. Returns the final lanes (A,) int32 and the
    lanes after each round (A, n_rounds)."""
    lanes, hist = egos.lane, []
    for _ in range(n_rounds):
        p = lane_payoffs(Ego(x=egos.x, v=egos.v, lane=lanes), cars_list)
        lanes = torch.where(p[:, 1] > p[:, 0], 2, 1).to(torch.int32)
        hist.append(lanes)
    return lanes, torch.stack(hist, dim=1)


# ---------------------------------------------------------------------------
# Reference scenario fixtures (mpc_tpu/decision/game_theory.py:247-268), each
# a batch of one
# ---------------------------------------------------------------------------

def _ego(device=None):
    return Ego(x=torch.tensor([0.0], device=device),
               v=torch.tensor([10.0], device=device),
               lane=torch.tensor([1], dtype=torch.int32, device=device))


def scenario_1(device=None):
    return _ego(device), Cars.from_lists([50.0, 10.0, -20.0, -30.0],
                                         [0.0, 15.0, 15.0, 15.0],
                                         [1, 2, 2, 2], device=device)


def scenario_2(device=None):
    return _ego(device), Cars.from_lists([50.0, 10.0, -8.0, -25.0],
                                         [0.0, 15.0, 15.0, 15.0],
                                         [1, 2, 2, 2], device=device)


def scenario_3(device=None):
    return _ego(device), Cars.from_lists([50.0, 10.0, -8.0, -18.0],
                                         [0.0, 15.0, 15.0, 15.0],
                                         [1, 2, 2, 2], device=device)
