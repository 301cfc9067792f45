"""Plain reference of the state-constrained vehicle OCP that the benchmark
judges the program by: the constraints, the shifted-penalty augmented
Lagrangian of one inner solve, its violation and the KKT residual, written
from the configuration's equations in plain PyTorch.

It imports nothing of the program; the cost, the plant and the input box
are ``benchmark/reference/vehicle.py``'s, in the same precisions
(``vehicle.F64`` the judge, ``F32``, ``TF32`` the control).

Constraints of a plan ``u`` from ``y0``: for the state ``x_k`` after each
of the N inputs, ``g_{6k+i} = x_{k,i}^2 - offsets_i`` (stage-major), in
``D = [lower, upper]`` (``lower`` null is -inf). An inner solve under
multipliers ``lam`` and penalties ``sigma`` (each (B, 6N)) minimises

    psi = f + 1/2 sum_j sigma_j (zeta_j - Pi_D(zeta_j))^2,
    zeta = g + lam / sigma,

and hands on ``lam+ = sigma (zeta - Pi_D(zeta))``; its violation is
``e = g - Pi_D(zeta)``. Where a penalty is 0 (a lane with no AL state, as
on an OCP whose D is unbounded) the shift ``lam / sigma`` reads 0: the
term vanishes and ``e`` is the bare violation ``g - Pi_D(g)``.
"""

from __future__ import annotations

import torch

from benchmark.reference import vehicle as ref
from benchmark.reference.vehicle import F64, Arith


def bounds(cfg: dict, m: int, device, dtype=torch.float64):
    """``(lower (m,), upper (m,))`` of D."""
    c = cfg["constraints"]
    lo = -float("inf") if c["lower"] is None else float(c["lower"])
    up = float("inf") if c["upper"] is None else float(c["upper"])
    return (torch.full((m,), lo, dtype=dtype, device=device),
            torch.full((m,), up, dtype=dtype, device=device))


def constraints(cfg: dict, u: torch.Tensor, y0: torch.Tensor,
                a: Arith = F64) -> torch.Tensor:
    """``g`` (B, 6N) of the plans ``u`` (B, 2N) from ``y0`` (B, 6)."""
    r = a.r
    offs = cfg["constraints"]["offsets"]
    x, gs = y0, []
    for k in range(cfg["n_horiz"]):
        x = ref.plant(cfg, x, u[:, 2 * k: 2 * k + 2], a)
        # the offsets as numbers: no host-to-device copy, so that the
        # control's fan can run from a CUDA graph
        gs += [r(r(x[:, i] * x[:, i]) - o) for i, o in enumerate(offs)]
    return torch.stack(gs, dim=1)


def al_terms(cfg: dict, g, lam, sigma, a: Arith = F64):
    """``(zeta - Pi_D(zeta), e)`` of constraint values ``g`` under ``lam``
    and ``sigma``: the AL residual and the violation."""
    r = a.r
    lo, up = bounds(cfg, g.shape[1], g.device, g.dtype)
    shift = torch.where(sigma > 0, r(lam / torch.where(
        sigma > 0, sigma, torch.ones_like(sigma))), torch.zeros_like(lam))
    zeta = r(g + shift)
    zhat = torch.clamp(zeta, lo, up)
    return r(zeta - zhat), r(g - zhat)


def al_objective(cfg: dict, u, y0, road, lam, sigma, a: Arith = F64):
    """``(psi (B,), ambiguous (B,))``: the AL objective of one inner solve
    at the plans ``u``, with ``vehicle.cost``'s flags of the lanes whose
    cost float32 rounding can move."""
    r = a.r
    f, amb = ref.cost(cfg, u, y0, road, a)
    res, _ = al_terms(cfg, constraints(cfg, u, y0, a), lam, sigma, a)
    pen = r(r(sigma * r(res * res)).sum(dim=1) * 0.5)
    return r(f + pen), amb


def al_objective_and_grad(cfg: dict, u, y0, road, lam, sigma,
                          a: Arith = F64):
    """``(psi (B,), grad (B, 2N), ambiguous (B,))`` in the precision ``a``
    (the inputs are cast to it)."""
    with torch.enable_grad():
        u_ = u.detach().to(a.dtype).requires_grad_(True)
        psi, amb = al_objective(
            cfg, u_, y0.detach().to(a.dtype),
            road.detach().to(torch.float64), lam.detach().to(a.dtype),
            sigma.detach().to(a.dtype), a)
        (grad,) = torch.autograd.grad(psi.sum(), u_)
    return psi.detach(), grad, amb


def kkt(cfg: dict, u, y0, road, lam, sigma):
    """In float64 at the plans ``u`` of an inner solve under ``lam`` and
    ``sigma``: ``(grad (B, 2N), lam_plus (B, 6N), e (B, 6N))``, with
    ``grad = grad f + J_g^T lam_plus`` the gradient of the Lagrangian at
    the multipliers the solve hands on."""
    u, y0 = u.double(), y0.double()
    lam, sigma = lam.double(), sigma.double()
    road = road.double()
    with torch.no_grad():
        res, e = al_terms(cfg, constraints(cfg, u, y0), lam, sigma)
        lam_plus = sigma * res
    with torch.enable_grad():
        u_ = u.detach().requires_grad_(True)
        f, _ = ref.cost(cfg, u_, y0, road)
        lagr = f + (lam_plus * constraints(cfg, u_, y0)).sum(dim=1)
        (grad,) = torch.autograd.grad(lagr.sum(), u_)
    return grad, lam_plus, e


def kkt_residual(cfg: dict, u, grad, gamma) -> torch.Tensor:
    """``||u - Pi_C(u - gamma grad)|| / gamma`` (the 2-norm): with
    ``grad`` from :func:`kkt`, the KKT residual of the plan over the input
    box C at the inner solve's step size."""
    return ref.criterion(cfg, u, grad, gamma)
