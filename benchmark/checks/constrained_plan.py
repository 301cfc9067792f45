"""Judges what a state-constrained vehicle MPC's closed loop produced
(``benchmark/loops/closed_loop.py``) by the float64 plain reference
(``benchmark/reference/constrained.py``): a sample of the window's
lane-solves, drawn from the seed once the window has closed, as
``checks/vehicle_plan.py`` draws it (per step ``lanes_per_step`` lanes at
random and the step's slowest lane).

For each sampled lane-solve that the program flagged converged, at the
plan it returned and under the multipliers and penalties its last inner
solve minimised under (``result.inner_lam``, ``result.inner_sigma``):
- ``psi_gap``: the AL objective the program returned against the
  reference's, |psi - psi64| / psi64;
- ``crit_ratio``: whether the plan is a KKT point. The residual
  ||u - Pi_C(u - gamma (grad f + J_g^T lam+))|| / gamma, from the
  reference's gradients, the multipliers lam+ that the inner solve hands
  on, and the step size of the last inner solve (``result.inner_gamma``),
  over what the configuration allows a converged solve
  (``reference.vehicle.criterion_allowance``). A flagged lane with no
  finite positive step size reads infinity;
- ``violation_ratio``: ||e64||_inf / delta, the violation
  e = g - Pi_D(g + lam / sigma) that a converged solve keeps within the
  configuration's ``alm.delta``;
- and, for every sampled lane whose states are finite and move forward
  before and after the step, ``plant_gap`` as ``checks/vehicle_plan.py``
  reads it.
The first three leave out the lanes whose AL objective the reference
cannot pin down to float32's rounding: those that ``checks/vehicle_plan.py``
leaves out for the cost's near ties and standstills, and those whose
objective jumps under a move of ``COND_STEP`` (``detail.ambiguous`` counts
them). Over the whole window:
- ``unconverged_share``: the lane-solves that ended unconverged or with a
  non-finite next state, over all.

``detail.active_share``: the sampled lane-solves whose final multipliers
(``result.lam``) hold one above 0, a bounded constraint that binds.
"""

from __future__ import annotations

import math

import torch

from benchmark.checks import vehicle_plan as vp
from benchmark.core import seeds
from benchmark.reference import constrained as cref
from benchmark.reference import vehicle as ref

BLOCK = 2048
COND_STEP = vp.COND_STEP
COND_TOL = vp.COND_TOL

FIELDS = (("u", "u"), ("psi", "psi"), ("conv", "converged"),
          ("gamma", "inner_gamma"), ("lam_in", "inner_lam"),
          ("sigma_in", "inner_sigma"), ("lam", "lam"))


def gather(steps, sample, device) -> dict:
    """The sampled lanes' inputs and the program's answers, on ``device``."""
    cols = {k: [] for k in ("y", "y_next", "road") + tuple(f[0]
                                                           for f in FIELDS)}
    for i, lanes in sample:
        s = steps[i]
        idx = torch.as_tensor(lanes, device=s.y.device)
        cols["y"].append(s.y[idx])
        cols["y_next"].append(s.y_next[idx])
        for k, field in FIELDS:
            cols[k].append(getattr(s.result, field)[idx])
        road = s.inputs["centerline"]
        cols["road"].append(road.expand(len(lanes), *road.shape))
    return {k: torch.cat(v).to(device) for k, v in cols.items()}


def _ambiguous(cfg, g, b, psi64, amb, gen):
    """``amb`` with the lanes whose AL objective the reference's own float32
    evaluation misses by more than ``COND_TOL`` of it, or that jumps when
    the plan and the initial state move by ``COND_STEP`` of themselves
    (three draws): a change beyond ``COND_TOL`` of it from the first-order
    change its gradients predict. The objective is smooth but for the
    cost's jumps (``checks/vehicle_plan.py``); a smooth lane with a small
    objective moves by more than ``COND_TOL`` of it without a jump."""
    u, y = g["u"][b].double(), g["y"][b].double()
    road = g["road"][b].double()
    lam, sigma = g["lam_in"][b].double(), g["sigma_in"][b].double()
    psi32, amb32 = cref.al_objective(cfg, g["u"][b].float(),
                                     g["y"][b].float(), road,
                                     lam.float(), sigma.float(), ref.F32)
    tol = COND_TOL * psi64.abs()
    amb = amb | amb32 | ((psi32.double() - psi64).abs() > tol)
    with torch.enable_grad():
        u_, y_ = u.requires_grad_(True), y.requires_grad_(True)
        psi, _ = cref.al_objective(cfg, u_, y_, road, lam, sigma)
        gu, gy = torch.autograd.grad(psi.sum(), (u_, y_))
    u, y = u.detach(), y.detach()
    for _ in range(3):
        su, sy = (torch.randint(0, 2, t.shape, generator=gen)
                  .to(t.device, t.dtype) * 2 - 1 for t in (u, y))
        du, dy = COND_STEP * su * u, COND_STEP * sy * y
        psi_p, amb_p = cref.al_objective(cfg, u + du, y + dy, road, lam,
                                         sigma)
        lin = psi64 + (gu * du).sum(dim=1) + (gy * dy).sum(dim=1)
        amb = amb | amb_p | ((psi_p - lin).abs() > tol)
    return amb


def judge(cfg: dict, traffic: dict, steps, seed: int, device) -> dict:
    """The five numbers and the counts behind them."""
    att, n_failed = vp.failed(steps)
    sample = vp.draw_sample(traffic, steps, seed)
    g = gather(steps, sample, device)
    psi_gap = crit_ratio = viol_ratio = plant_gap = 0.0
    n = g["u"].shape[0]
    judged = ambiguous = active = 0
    worst = None
    gen = torch.Generator(device="cpu").manual_seed(
        int(seeds.sample_stream(seed).generate_state(1)[0]))
    delta = cfg["alm"]["delta"]
    for a in range(0, n, BLOCK):
        b = slice(a, a + BLOCK)
        u, y = g["u"][b].double(), g["y"][b].double()
        road = g["road"][b].double()
        lam_in, sigma_in = g["lam_in"][b].double(), g["sigma_in"][b].double()
        active += int((g["lam"][b] > 0).any(dim=1).sum())
        psi64, amb = cref.al_objective(cfg, u, y, road, lam_in, sigma_in)
        amb = _ambiguous(cfg, g, b, psi64, amb, gen)
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
            grad, _, e = cref.kkt(cfg, u, y, road, lam_in, sigma_in)
            crit = cref.kkt_residual(cfg, u, grad, gsafe) \
                / ref.criterion_allowance(cfg, u, gsafe)
            crit = torch.where(good, crit, torch.full_like(crit, math.inf))
            viol = e.abs().amax(dim=1) / delta
            viol = torch.where(torch.isfinite(viol), viol,
                               torch.full_like(viol, math.inf))
            gap = torch.where(ok, gap, torch.zeros_like(gap))
            i = int(torch.argmax(gap))
            if float(gap[i]) >= psi_gap:
                psi_gap = float(gap[i])
                worst = {"lane_in_sample": a + i,
                         "psi": float(g["psi"][b][i]),
                         "psi64": float(psi64[i]),
                         "y": y[i].tolist()}
            crit_ratio = max(crit_ratio, float(crit[ok].max()))
            viol_ratio = max(viol_ratio, float(viol[ok].max()))
        yn = g["y_next"][b].double()
        fin = torch.isfinite(yn).all(dim=1) & torch.isfinite(u).all(dim=1) \
            & (y[:, 3] > ref.VX_MIN) & (yn[:, 3] > ref.VX_MIN)
        if fin.any():
            y64 = ref.plant(cfg, y[fin], u[fin][:, :2])
            err = (yn[fin] - y64).abs().amax(dim=1) \
                / (1.0 + y[fin].abs().amax(dim=1))
            plant_gap = max(plant_gap, float(err.max()))
    return {"numbers": {"psi_gap": psi_gap, "crit_ratio": crit_ratio,
                        "violation_ratio": viol_ratio,
                        "plant_gap": plant_gap,
                        "unconverged_share": n_failed / att},
            "attempted": att, "failed": n_failed,
            "detail": {"sampled": n, "judged": judged,
                       "ambiguous": ambiguous,
                       "active_share": active / n if n else 0.0,
                       "worst_psi_lane": worst}}
