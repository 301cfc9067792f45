"""Plain reference of the vehicle MPC that the benchmark judges the program
by: the plant, the OCP's cost and gradient, and PANOC's optimality test,
written from the configuration's equations in plain PyTorch.

It imports nothing of the program. Everything the program derives from the
inputs (road tables, parameter vectors) is worked out again here from the
configuration file and the raw roads.

Three precisions:
- float64, the judge (``Arith(None)``);
- float32 (``Arith("f32")``), which the judge uses to find the lanes whose
  cost float32 rounding alone moves;
- the control: float32 tensors with every operation's result rounded to
  TF32's 10-bit mantissa, forward and backward (``Arith("tf32")``). It is
  the nearest precision below the float32 (TF32 off) that the
  configurations state.

Models (states after each input; inputs ``[d, delta]``):
- ``pacejka``: ``[x, y, phi, vx, vy, omega]``, the dynamic single-track
  model with Pacejka lateral tyre forces;
- ``simplified``: ``[x, y, phi, v]``, the kinematic bicycle.

Cost of a plan ``u = [d0, delta0, d1, delta1, ...]`` from ``y0``: the sum
over the N stages of the state after each input, with the road errors at
the nearest of the road's points ``0 .. S-2`` (previous point clamped at
index 0, first index on a tie, the selection held constant for the
gradient):

    c0 (speed - v_ref)^2 + c1 cte^2 + c2 pos_err^2 + c3 head_err^2
        + c4 delta^2 + c5 d^2

with ``cte = cross(pos - prev, nearest - prev)``,
``pos_err = cross(pos - nearest, next - nearest)``, ``head_err`` the road's
heading ``atan2(next - nearest)`` less ``phi`` wrapped to [-pi, pi), and
speed ``sqrt(vx^2 + vy^2)`` (Pacejka) or ``|v|`` (kinematic).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

STATE_DIM = {"pacejka": 6, "simplified": 4}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round a float32 tensor to TF32 (10 mantissa bits), to nearest:
    Veltkamp's split at 2^13 + 1, three operations (the same bits as
    masking the mantissa after adding half its last kept place)."""
    t = x * 8193.0
    return t - (t - x)


class _Tf32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return tf32_round(x)

    @staticmethod
    def backward(ctx, g):
        return tf32_round(g)


class Arith:
    """The precision a reference computation runs in: ``r(x)`` rounds one
    operation's result (the identity in float64)."""

    def __init__(self, mode: Optional[str] = None):
        if mode not in (None, "f32", "tf32"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode
        self.dtype = torch.float64 if mode is None else torch.float32

    def r(self, x: torch.Tensor) -> torch.Tensor:
        return _Tf32.apply(x) if self.mode == "tf32" else x


F64 = Arith(None)
F32 = Arith("f32")
TF32 = Arith("tf32")


def pacejka(x, u, P, a: Arith):
    """The Pacejka single-track ODE, (B, 6) states, (B, 2) inputs."""
    r = a.r
    d, delta = u[:, 0], u[:, 1]
    phi, vx, vy, om = x[:, 2], x[:, 3], x[:, 4], x[:, 5]
    lf, lr, m, iz = P["axis_front"], P["axis_rear"], P["mass"], P["inertia"]
    af = r(r(-torch.atan2(r(r(om * lf) + vy), vx)) + delta)
    ar = r(torch.atan2(r(r(om * lr) - vy), vx))
    frx = r(r(r(r(P["cm1"] - r(P["cm2"] * vx)) * d)
              - r(P["cr0"] * torch.sign(vx)))
            - r(r(P["cr2"] * vx) * vx))
    ffy = r(P["df"] * r(torch.sin(r(P["cf"] * r(torch.atan(
        r(P["bf"] * af)))))))
    fry = r(P["dr"] * r(torch.sin(r(P["cr"] * r(torch.atan(
        r(P["br"] * ar)))))))
    cp, sp = r(torch.cos(phi)), r(torch.sin(phi))
    cd, sd = r(torch.cos(delta)), r(torch.sin(delta))
    return torch.stack([
        r(r(vx * cp) - r(vy * sp)),
        r(r(vx * sp) + r(vy * cp)),
        om,
        r(r(r(frx - r(ffy * sd)) + r(r(m * vy) * om)) / m),
        r(r(r(fry + r(ffy * cd)) - r(r(m * vx) * om)) / m),
        r(r(r(r(ffy * lf) * cd) - r(fry * lr)) / iz),
    ], dim=1)


def kinematic(x, u, P, a: Arith):
    """The kinematic bicycle ODE, (B, 4) states, (B, 2) inputs."""
    r = a.r
    d, delta = u[:, 0], u[:, 1]
    phi, v = x[:, 2], x[:, 3]
    lf, lr = P["axis_front"], P["axis_rear"]
    beta = r(torch.atan2(r(lf * r(torch.tan(delta))),
                         torch.full_like(delta, lf + lr)))
    pb = r(phi + beta)
    return torch.stack([
        r(v * r(torch.cos(pb))),
        r(v * r(torch.sin(pb))),
        r(r(v * r(torch.sin(beta))) / lr),
        r(r(P["acceleration"] * d) - r(P["friction"] * v)),
    ], dim=1)


ODES = {"pacejka": pacejka, "simplified": kinematic}


def plant(cfg: dict, x: torch.Tensor, u: torch.Tensor,
          a: Arith = F64) -> torch.Tensor:
    """One control interval: ``substeps`` classical RK4 steps of
    ``ts / substeps`` under the zero-order-held input."""
    f, P = ODES[cfg["model"]], cfg["params"]
    h = cfg["ts"] / cfg["substeps"]
    r = a.r
    for _ in range(cfg["substeps"]):
        k1 = f(x, u, P, a)
        k2 = f(r(x + r(0.5 * h * k1)), u, P, a)
        k3 = f(r(x + r(0.5 * h * k2)), u, P, a)
        k4 = f(r(x + r(h * k3)), u, P, a)
        x = r(x + r((h / 6.0) * r(r(r(k1 + r(2.0 * k2)) + r(2.0 * k3))
                                  + k4)))
    return x


def _wrap(angle):
    return torch.remainder(angle + math.pi, 2.0 * math.pi) - math.pi


def _gather(road, idx):
    """Points ``idx`` (B,) of a shared (S, 2) or per-lane (B, S, 2) road."""
    if road.dim() == 2:
        return road[idx]
    return road[torch.arange(idx.shape[0], device=idx.device), idx]


def _cross(a, b):
    return a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]


#: a Pacejka lane is ambiguous where a stage's forward speed falls to this
#: (m/s) or below: ``sign(vx)`` jumps at 0 and the slip angles'
#: ``atan2(., vx)`` has its branch cut for vx < 0, so a car braking through
#: a standstill or reversing follows whichever side rounding picks
VX_MIN = 0.01

#: a stage is ambiguous where its position lies within this distance
#: (times 1 + |pos|) of the bisector between its nearest road point and the
#: runner-up: rounding may select either, and the cost jumps between them
TIE_SLACK = 3e-5


def cost(cfg: dict, u: torch.Tensor, y0: torch.Tensor, road: torch.Tensor,
         a: Arith = F64):
    """``(psi (B,), ambiguous (B,) bool)``: the OCP's cost of the plans
    ``u`` (B, 2N) from ``y0`` (B, sd) on ``road`` (S, 2) or (B, S, 2), and
    whether any stage's nearest point is a near tie or, on the Pacejka
    model, any stage's forward speed is at or below ``VX_MIN``."""
    r = a.r
    N, c, v_ref = cfg["n_horiz"], cfg["weights"], cfg["v_ref"]
    S = road.shape[-2]
    cand = road[..., : S - 1, :]
    x = y0
    tot = torch.zeros(u.shape[0], dtype=u.dtype, device=u.device)
    amb = torch.zeros(u.shape[0], dtype=torch.bool, device=u.device)
    for k in range(N):
        uk = u[:, 2 * k: 2 * k + 2]
        x = plant(cfg, x, uk, a)
        pos = x[:, :2]
        with torch.no_grad():
            if cfg["model"] == "pacejka":
                amb |= x[:, 3].detach() <= VX_MIN
            p = pos.detach().to(road.dtype)
            d2 = ((cand - p[:, None, :]) ** 2).sum(dim=-1)
            two = torch.topk(d2, 2, dim=1, largest=False)
            idx = torch.argmin(d2, dim=1)
            seg = torch.linalg.vector_norm(
                _gather(road, two.indices[:, 1]) - _gather(road, idx), dim=1)
            slack = 2.0 * TIE_SLACK * (1.0 + torch.linalg.vector_norm(p, dim=1))
            amb |= (two.values[:, 1] - two.values[:, 0]) < slack * seg
            nearest = _gather(road, idx).to(u.dtype)
            prev = _gather(road, torch.clamp(idx - 1, min=0)).to(u.dtype)
            nxt = _gather(road, idx + 1).to(u.dtype)
            desired = torch.atan2(nxt[:, 1] - nearest[:, 1],
                                  nxt[:, 0] - nearest[:, 0])
        dp, dn = r(pos - prev), r(pos - nearest)
        cte = r(_cross(dp, r(nearest - prev)))
        pos_err = r(_cross(dn, r(nxt - nearest)))
        head = r(_wrap(r(desired - x[:, 2])))
        if x.shape[1] >= 5:
            speed = r(torch.sqrt(r(r(x[:, 3] ** 2) + r(x[:, 4] ** 2))))
        else:
            speed = r(torch.abs(x[:, 3]))
        terms = (c[0] * r((speed - v_ref) ** 2), c[1] * r(cte ** 2),
                 c[2] * r(pos_err ** 2), c[3] * r(head ** 2),
                 c[4] * r(uk[:, 1] ** 2), c[5] * r(uk[:, 0] ** 2))
        for t in terms:
            tot = r(tot + r(t))
    return tot, amb


def cost_and_grad(cfg: dict, u: torch.Tensor, y0: torch.Tensor,
                  road: torch.Tensor, a: Arith = F64):
    """``(psi (B,), grad (B, 2N), ambiguous (B,))`` in the precision ``a``
    (the inputs are cast to it)."""
    with torch.enable_grad():
        u_ = u.detach().to(a.dtype).requires_grad_(True)
        psi, amb = cost(cfg, u_, y0.detach().to(a.dtype),
                        road.detach().to(torch.float64), a)
        (grad,) = torch.autograd.grad(psi.sum(), u_)
    return psi.detach(), grad, amb


def input_limits(cfg: dict, n: int, device, dtype=torch.float64):
    """The input box ``|d| <= max_drive``, ``|delta| <= max_steer`` of a
    plan of ``n`` entries."""
    P = cfg["params"]
    lim = torch.tensor([P["max_drive"], P["max_steer"]], dtype=dtype,
                       device=device)
    return lim.repeat(n // 2)


def criterion(cfg: dict, u: torch.Tensor, grad: torch.Tensor,
              gamma: torch.Tensor) -> torch.Tensor:
    """PANOC's fixed-point residual ``||u - Pi_C(u - gamma grad)|| / gamma``
    (the 2-norm), the quantity its tolerance bounds."""
    lim = input_limits(cfg, u.shape[1], u.device, u.dtype)
    g = gamma[:, None]
    u_hat = torch.clamp(u - g * grad, -lim, lim)
    return torch.linalg.vector_norm(u - u_hat, dim=1) / gamma


def criterion_allowance(cfg: dict, u: torch.Tensor,
                        gamma: torch.Tensor) -> torch.Tensor:
    """What the configuration lets a converged solve's residual be: the
    tolerance ``eps``, or, for a solve that ran out of progress, the
    float32 stagnation floor ``crit_floor_mult * eps_f32 * (1 + ||u||) /
    gamma``, whichever is larger."""
    eps_f = 2.0 ** -23
    floor = cfg["panoc"]["crit_floor_mult"] * eps_f \
        * (1.0 + torch.linalg.vector_norm(u, dim=1)) / gamma
    return torch.clamp(floor, min=cfg["alm"]["eps"])
