"""Judges what a vehicle MPC's closed loop produced
(``benchmark/loops/closed_loop.py``) by the float64 plain reference
(``benchmark/reference/vehicle.py``): a sample of the window's
lane-solves, drawn from the seed once the window has closed.

Per step: ``lanes_per_step`` lanes drawn at random and the step's slowest
lane. For each sampled lane-solve that the program flagged converged:
- ``psi_gap``: the cost the program returned for its plan against the
  reference's cost of that plan, |psi - psi64| / psi64;
- ``crit_ratio``: whether the plan is a solution. PANOC's fixed-point
  residual of the plan, ||u - Pi_C(u - gamma grad64)|| / gamma, from the
  reference's gradient at the plan and the program's step size, over what
  the configuration allows a converged solve
  (``reference.vehicle.criterion_allowance``). A flagged lane with no
  finite positive step size reads infinity;
- and, for every sampled lane whose states are finite and, on the Pacejka
  model, move forward (``reference.vehicle.VX_MIN``) before and after the
  step, ``plant_gap``: the program's next state against the reference's
  plant step from the same state under the plan's first input,
  max |y_next - y_next64| / (1 + max |y|).
The first two leave out lanes whose cost the reference cannot pin down to
float32's rounding: a stage whose nearest road point is a near tie, a cost
that the reference's own float32 evaluation misses by more than
``COND_TOL`` of it, or one that moves by more than that when the plan and
the initial state are moved by ``COND_STEP`` of themselves (three draws).
The cost has jumps (the nearest point's switch, ``sign(vx)`` of a car
braking through a standstill, ``atan2``'s branch cut when it reverses),
and a lane that rounding can carry across one is judged by neither side;
``detail.ambiguous`` counts them. Over the whole window:
- ``unconverged_share``: the lane-solves that ended unconverged or with a
  non-finite next state, over all.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.core import seeds
from benchmark.reference import vehicle as ref

BLOCK = 8192
COND_STEP = 1e-6
COND_TOL = 1e-5


def draw_sample(traffic: dict, steps, seed: int) -> list:
    """``[(step index, lanes (np.int64))]``, drawn from the seed's sample
    stream."""
    rng = np.random.default_rng(seeds.sample_stream(seed))
    k = traffic["sample"]["lanes_per_step"]
    out = []
    for i, s in enumerate(steps):
        B = s.y.shape[0]
        lanes = [rng.choice(B, min(k, B), replace=False),
                 [int(torch.argmax(s.iters))]]
        out.append((i, np.unique(np.concatenate(lanes)).astype(np.int64)))
    return out


def failed(steps) -> tuple:
    """``(attempted, failed)`` lane-solves over the steps: failed where the
    flag is False or the next state is not finite."""
    bad = [(~s.result.converged | ~torch.isfinite(s.y_next).all(dim=1)).sum()
           for s in steps]
    att = sum(s.y.shape[0] for s in steps)
    return att, int(torch.stack(bad).sum()) if bad else 0


def gather(steps, sample, device) -> dict:
    """The sampled lanes' inputs and the program's answers, on ``device``."""
    cols = {k: [] for k in ("y", "y_next", "u", "psi", "conv", "gamma",
                            "road")}
    for i, lanes in sample:
        s = steps[i]
        idx = torch.as_tensor(lanes, device=s.y.device)
        r = s.result
        for k, t in (("y", s.y), ("y_next", s.y_next), ("u", r.u),
                     ("psi", r.psi), ("conv", r.converged),
                     ("gamma", r.gamma)):
            cols[k].append(t[idx])
        road = s.inputs["centerline"]
        cols["road"].append(road[idx] if road.dim() == 3
                            else road.expand(len(lanes), *road.shape))
    return {k: torch.cat(v).to(device) for k, v in cols.items()}


def judge(cfg: dict, traffic: dict, steps, seed: int, device) -> dict:
    """The four numbers and the counts behind them."""
    att, n_failed = failed(steps)
    sample = draw_sample(traffic, steps, seed)
    g = gather(steps, sample, device)
    psi_gap = crit_ratio = plant_gap = 0.0
    n = g["u"].shape[0]
    judged = ambiguous = 0
    worst = None
    gen = torch.Generator(device="cpu").manual_seed(
        int(seeds.sample_stream(seed).generate_state(1)[0]))
    for a in range(0, n, BLOCK):
        b = slice(a, a + BLOCK)
        u = g["u"][b].double()
        y = g["y"][b].double()
        road = g["road"][b]
        psi64, grad64, amb = ref.cost_and_grad(cfg, u, y, road)
        psi32, amb32 = ref.cost(cfg, g["u"][b].float(), g["y"][b].float(),
                                road.double(), ref.F32)
        amb |= amb32 | ((psi32.double() - psi64).abs()
                        > COND_TOL * psi64.abs())
        for _ in range(3):
            su, sy = (torch.randint(0, 2, t.shape, generator=gen)
                      .to(t.device, t.dtype) * 2 - 1 for t in (u, y))
            psi_p, amb_p = ref.cost(cfg, u * (1 + COND_STEP * su),
                                    y * (1 + COND_STEP * sy),
                                    road.double())
            amb |= amb_p | ((psi_p - psi64).abs() > COND_TOL * psi64.abs())
        conv = g["conv"][b]
        ok = conv & ~amb & torch.isfinite(u).all(dim=1)
        judged += int(ok.sum())
        ambiguous += int((conv & amb).sum())
        if ok.any():
            psi = g["psi"][b].double()
            gap = (psi - psi64).abs() / psi64.abs()
            gap = torch.where(torch.isfinite(gap), gap,
                              torch.full_like(gap, math.inf))
            gamma = g["gamma"][b].double()
            good = torch.isfinite(gamma) & (gamma > 0)
            gsafe = torch.where(good, gamma, torch.ones_like(gamma))
            crit = ref.criterion(cfg, u, grad64, gsafe) \
                / ref.criterion_allowance(cfg, u, gsafe)
            crit = torch.where(good, crit, torch.full_like(crit, math.inf))
            gap = torch.where(ok, gap, torch.zeros_like(gap))
            i = int(torch.argmax(gap))
            if float(gap[i]) >= psi_gap:
                psi_gap = float(gap[i])
                worst = {"lane_in_sample": a + i,
                         "psi": float(g["psi"][b][i]),
                         "psi64": float(psi64[i]),
                         "y": y[i].tolist(), "u": u[i].tolist()}
            crit_ratio = max(crit_ratio, float(crit[ok].max()))
        yn = g["y_next"][b].double()
        fin = torch.isfinite(yn).all(dim=1) & torch.isfinite(u).all(dim=1)
        if cfg["model"] == "pacejka":
            fin &= (y[:, 3] > ref.VX_MIN) & (yn[:, 3] > ref.VX_MIN)
        if fin.any():
            y64 = ref.plant(cfg, y[fin], u[fin][:, :2])
            err = (yn[fin] - y64).abs().amax(dim=1) \
                / (1.0 + y[fin].abs().amax(dim=1))
            plant_gap = max(plant_gap, float(err.max()))
    return {"numbers": {"psi_gap": psi_gap, "crit_ratio": crit_ratio,
                        "plant_gap": plant_gap,
                        "unconverged_share": n_failed / att},
            "attempted": att, "failed": n_failed,
            "detail": {"sampled": n, "judged": judged,
                       "ambiguous": ambiguous, "worst_psi_lane": worst}}
