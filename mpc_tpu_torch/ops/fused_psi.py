"""The PANOC candidate fan: value and gradient of the vehicle OCP cost at E
independent evaluation lanes (port of mpc_tpu/ops/fused_psi.py, kernels
K1-K3).

For each lane e (E = scenarios x candidates): an N-stage rollout of
``substeps`` RK4 steps of the vehicle ODE from ``y0[e]`` under
``u[e] = [d0, delta0, d1, delta1, ...]``; at each stage the nearest of the
S-1 centerline candidates with its previous/next points (``make_cltab``);
the tracking stage cost; ``psi[e]``, the sum of stage costs; and
``grad[e] = d psi[e] / d u[e]``. The three variants of the TPU kernel
(``_eval_pallas``) are:

- K1, ``model="pacejka"``: the 6-state Pacejka single-track model;
- K2, ``model="simplified"``: the 4-state kinematic bicycle
  ``[x, y, phi, v]``, whose speed term is ``|v|``;
- K3, the Pacejka fan plus the augmented-Lagrangian penalty of the bounded
  state constraints: after each stage's cost, for each state component i,
  ``0.5 sigma (zeta - clip(zeta, d_lo, d_up))^2`` with
  ``zeta = x_i^2 - off_i + lam / sigma`` (mpc_tpu/ops/fused_psi.py:243-249).

Three implementations of the same function live here:

- :func:`fan_value_and_grad_reference`, the plain PyTorch version
  (structure-of-arrays rollout, gradient by autograd of the lane sum). It is
  the CPU path and the oracle the kernels are held to.
- :func:`_fan_phased_transcription`, the algorithm of the phased kernel of
  ``csrc/fused_psi.cu`` in its three variants, transcribed into batched
  torch so that every partial derivative is checked against autograd on the
  CPU. Used only by the tests.
- The wrappers :func:`fan_value_and_grad` (K1),
  :func:`kin_fan_value_and_grad` (K2) and :func:`al_fan_value_and_grad`
  (K3): each checks its inputs, runs the plain version for a CPU tensor, and
  launches its CUDA kernel for a CUDA tensor (or raises). K1 and K2 are the
  phased kernel, which hands its phases on in shared memory; K3 runs the
  same phases as three kernels that hand on through a device scratch the
  wrapper allocates (:func:`al_scratch_floats`). Each wrapper counts its
  calls on the card in its ``launches`` attribute, one a call.

The reference's polynomial arctan exists only because the TPU compiler has
no atan lowering; every version here uses the native ``atan2``/``atan``.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence

import torch

from mpc_tpu_torch.kernels.build import check_operand
from mpc_tpu_torch.models.params import KERNEL_PARAM_FIELDS, VehicleParams
from mpc_tpu_torch.ops.costs import DEFAULT_VEHICLE_WEIGHTS
from mpc_tpu_torch.ops.road import wrap_to_pi

#: the kernels' limit on the horizon (csrc/fused_psi.cu MAX_N); their
#: shared memory is limited by the card, which ``phased_plan`` asks
KERNEL_MAX_HORIZON = 64
#: cudaErrorInvalidValue, which a launcher returns for a shape it refuses
_CUDA_ERROR_INVALID_VALUE = 1


def make_cltab(centerline: torch.Tensor) -> torch.Tensor:
    """The (S-1, 6) selection table ``[nearest, previous, next]`` (x, y each)
    per candidate index: candidates 0..S-2, previous clamped at 0
    (mpc_tpu/ops/fused_psi.py:158-166). A (R, S, 2) stack of roads gives
    the (R, S-1, 6) stack of their tables."""
    head = centerline[..., :-1, :]
    prev = torch.cat([centerline[..., :1, :], centerline[..., :-2, :]],
                     dim=-2)
    nxt = centerline[..., 1:, :]
    return torch.cat([head, prev, nxt], dim=-1).contiguous()


def road_stride(cltab: torch.Tensor, E: int) -> int:
    """The road stride of E lanes on ``cltab``: 0 for one shared (S-1, 6)
    table; K = E / R for a (R, S-1, 6) stack, whose road r is read by the K
    adjacent lanes r K .. r K + K - 1 (one scenario's candidates). A stack
    must hold E / R lanes per road, a whole number; else ValueError."""
    if not isinstance(cltab, torch.Tensor) or cltab.dim() not in (2, 3) \
            or cltab.shape[-1] != 6:
        raise ValueError("fan: cltab must be (S-1, 6) or (R, S-1, 6)")
    return _lanes_per_road(E, cltab.shape[0]) if cltab.dim() == 3 else 0


def _lanes_per_road(E: int, R: int) -> int:
    if R < 1 or E % R:
        raise ValueError(f"fan: {E} lanes on {R} roads: each road must "
                         f"take the same whole number of lanes")
    return max(E // R, 1)


def _lane_tables(cltab: torch.Tensor, E: int):
    """The table each of E lanes reads: the shared (S-1, 6) table as it is,
    or, from a (R, S-1, 6) stack, road ``e // (E / R)`` for lane e as an
    (E, S-1, 6) tensor."""
    K = road_stride(cltab, E)
    if not K:
        return cltab
    return cltab[torch.arange(E, device=cltab.device) // K]


class _Params:
    """Named view of the (24,) kernel parameter vector."""

    def __init__(self, pvec: torch.Tensor):
        for i, f in enumerate(KERNEL_PARAM_FIELDS):
            setattr(self, f, pvec[i])


# ---------------------------------------------------------------------------
# Plain version: structure-of-arrays forward, autograd backward
# ---------------------------------------------------------------------------

def _pacejka_deriv(x, d, delta, p):
    """Pacejka single-track ODE on (E,) component vectors."""
    return _pacejka_deriv_cs(x, d, delta, torch.cos(delta), torch.sin(delta),
                             p)


def _pacejka_deriv_cs(x, d, delta, cos_d, sin_d, p):
    """:func:`_pacejka_deriv` with ``cos(delta)``, ``sin(delta)`` given, so
    that a stage computes them once for its 4 x substeps evaluations (the
    same values, so the same bits)."""
    px, py, phi, vx, vy, omega = x
    lf, lr, m, iz = p.axis_front, p.axis_rear, p.mass, p.inertia
    af = -torch.atan2(omega * lf + vy, vx) + delta
    ar = torch.atan2(omega * lr - vy, vx)
    frx = (p.cm1 - p.cm2 * vx) * d - p.cr0 * torch.sign(vx) - p.cr2 * vx * vx
    ffy = p.df * torch.sin(p.cf * torch.atan(p.bf * af))
    fry = p.dr * torch.sin(p.cr * torch.atan(p.br * ar))
    cos_phi, sin_phi = torch.cos(phi), torch.sin(phi)
    return (
        vx * cos_phi - vy * sin_phi,
        vx * sin_phi + vy * cos_phi,
        omega,
        (frx - ffy * sin_d + m * vy * omega) / m,
        (fry + ffy * cos_d - m * vx * omega) / m,
        (ffy * lf * cos_d - fry * lr) / iz,
    )


def _kinematic_deriv(x, d, delta, p):
    """Kinematic bicycle ODE on (E,) component vectors
    (mpc_tpu/ops/fused_psi.py:127-137)."""
    px, py, phi, v = x
    lf, lr = p.axis_front, p.axis_rear
    beta = torch.atan2(lf * torch.tan(delta), lf + lr)
    return (
        v * torch.cos(phi + beta),
        v * torch.sin(phi + beta),
        v * torch.sin(beta) / lr,
        p.acceleration * d - p.friction * v,
    )


def _rk4_substeps(deriv, x, d, delta, p, h, substeps):
    for _ in range(substeps):
        k1 = deriv(x, d, delta, p)
        x2 = tuple(xi + 0.5 * h * ki for xi, ki in zip(x, k1))
        k2 = deriv(x2, d, delta, p)
        x3 = tuple(xi + 0.5 * h * ki for xi, ki in zip(x, k2))
        k3 = deriv(x3, d, delta, p)
        x4 = tuple(xi + h * ki for xi, ki in zip(x, k3))
        k4 = deriv(x4, d, delta, p)
        x = tuple(xi + (h / 6.0) * (a + 2 * b + 2 * c + e)
                  for xi, a, b, c, e in zip(x, k1, k2, k3, k4))
    return x


def _nearest(px, py, tab):
    """Index (E,) of the nearest candidate; first index wins a tie. ``tab``
    is the shared (S-1, 6) table or the lanes' (E, S-1, 6) tables."""
    dx = px[:, None] - tab[..., 0]
    dy = py[:, None] - tab[..., 1]
    return torch.argmin(dx * dx + dy * dy, dim=1)


def _selected(tab, idx):
    """The rows ``tab[idx]`` of each lane's table, as 6 (E,) components."""
    if tab.dim() == 2:
        return tab[idx].unbind(dim=1)
    return tab[torch.arange(idx.shape[0], device=idx.device), idx].unbind(dim=1)


def _speed(x):
    """``sqrt(vx^2 + vy^2)`` for the Pacejka state, ``|v|`` for the
    kinematic one (mpc_tpu/ops/fused_psi.py:191-194)."""
    if len(x) >= 5:
        return torch.sqrt(x[3] ** 2 + x[4] ** 2)
    return torch.abs(x[3])


def _stage_terms(x, pts):
    """cte, pos_error, heading_error and speed of a state against its
    selected points ``pts = (nx, ny, pvx, pvy, nxx, nxy)``."""
    px, py, phi = x[:3]
    nx, ny, pvx, pvy, nxx, nxy = pts
    cte = (px - pvx) * (ny - pvy) - (py - pvy) * (nx - pvx)
    desired = torch.atan2(nxy - ny, nxx - nx)
    heading_error = wrap_to_pi(desired - phi)
    pos_error = (px - nx) * (nxy - ny) - (py - ny) * (nxx - nx)
    return cte, pos_error, heading_error, _speed(x)


def _stage_cost(x, d, delta, pts, v_ref, c):
    cte, pos_error, heading_error, speed = _stage_terms(x, pts)
    return (c[0] * (speed - v_ref) ** 2
            + c[1] * cte ** 2
            + c[2] * pos_error ** 2
            + c[3] * heading_error ** 2
            + c[4] * delta ** 2
            + c[5] * d ** 2)


def _al_residuals(x, k, al):
    """Per state component i of stage k: ``(sigma_j, zeta_j - zhat_j)`` of
    the constraint ``j = k * sd + i`` (mpc_tpu/ops/fused_psi.py:244-249)."""
    lam, sigma, offs, d_lo, d_up = al
    sd = len(x)
    for i in range(sd):
        j = k * sd + i
        g = x[i] * x[i] - offs[i]
        zeta = g + lam[:, j] / sigma[:, j]
        zhat = torch.clamp(zeta, d_lo[j], d_up[j])
        yield sigma[:, j], zeta - zhat


def _fan_total(u, y0, cltab, pvec, n_horiz, substeps, h, v_ref, weights,
               model, al):
    deriv, sd = _MODELS[model]
    p = _Params(pvec)
    tab = _lane_tables(cltab, u.shape[0])
    x = tuple(y0[:, i] for i in range(sd))
    tot = torch.zeros(u.shape[0], dtype=u.dtype, device=u.device)
    for k in range(n_horiz):
        d, delta = u[:, 2 * k], u[:, 2 * k + 1]
        x = _rk4_substeps(deriv, x, d, delta, p, h, substeps)
        pts = _selected(tab, _nearest(x[0], x[1], tab))
        tot = tot + _stage_cost(x, d, delta, pts, v_ref, weights)
        if al is not None:
            # the stage's six penalties after its cost, in the reference's
            # order, so that the kernel can round as this sum does
            for s, r in _al_residuals(x, k, al):
                tot = tot + 0.5 * s * r ** 2
    return tot


def fan_value_and_grad_reference(u: torch.Tensor, y0: torch.Tensor,
                                 cltab: torch.Tensor, pvec: torch.Tensor,
                                 n_horiz: int, substeps: int, h: float,
                                 v_ref: float,
                                 weights: Sequence[float],
                                 model: str = "pacejka",
                                 al: Optional[tuple] = None):
    """Plain PyTorch fan: ``(psi (E,), grad (E, 2N))``.

    ``u`` (E, 2N), ``y0`` (E, sd) with sd = 6 for ``model="pacejka"`` and 4
    for ``"simplified"``, ``cltab`` from :func:`make_cltab`: (S-1, 6), one
    road for every lane, or (R, S-1, 6), one road for each K = E / R
    adjacent lanes (:func:`road_stride`: the K candidates of one scenario
    share its road). ``pvec`` (24,) from
    ``VehicleParams.to_kernel_vec``. ``al = (lam (E, m),
    sigma (E, m), offsets (sd,), d_lo (m,), d_up (m,))``, m = sd * N
    stage-major, adds the augmented-Lagrangian penalty. The SoA analogue of
    ``_batched_total_cost`` + ``_eval_xla`` (mpc_tpu/ops/fused_psi.py:204-294);
    the gradient is autograd of the lane sum (lanes are independent), with
    the nearest-point selection held constant.
    """
    road_stride(cltab, u.shape[0])
    cltab, pvec, y0 = cltab.detach(), pvec.detach(), y0.detach()
    if al is not None:
        al = tuple(a.detach() for a in al)
    with torch.enable_grad():
        u_ = u.detach().requires_grad_(True)
        psi = _fan_total(u_, y0, cltab, pvec, n_horiz, substeps, h, v_ref,
                         weights, model, al)
        (grad,) = torch.autograd.grad(psi.sum(), u_)
    return psi.detach(), grad


#: model -> (ODE, state dimension)
_MODELS = {"pacejka": (_pacejka_deriv, 6),
           "simplified": (_kinematic_deriv, 4)}


def _stage_cost_vjp(x, pts, v_ref, c):
    """Gradient of one stage cost w.r.t. the state after the stage, with the
    selected points held constant (the inputs' terms ``2 c5 d``,
    ``2 c4 delta`` are added by the adjoint). The wrap to [-pi, pi) has
    derivative 1; ``|v|`` has derivative sign(v), 0 at 0."""
    px, py = x[0], x[1]
    nx, ny, pvx, pvy, nxx, nxy = pts
    cte, pos_error, heading_error, speed = _stage_terms(x, pts)
    c_cte = 2.0 * c[1] * cte
    c_pe = 2.0 * c[2] * pos_error
    g_px = c_cte * (ny - pvy) + c_pe * (nxy - ny)
    g_py = -c_cte * (nx - pvx) - c_pe * (nxx - nx)
    g_phi = -2.0 * c[3] * heading_error
    zero = torch.zeros_like(px)
    if len(x) >= 5:
        gs = 2.0 * c[0] * (speed - v_ref) / speed
        g_speed = (gs * x[3], gs * x[4], zero)
    else:
        g_speed = (2.0 * c[0] * (speed - v_ref) * torch.sign(x[3]),)
    return (g_px, g_py, g_phi) + g_speed


# ---------------------------------------------------------------------------
# The phased algorithm of K1, K2 and K3, transcribed line by line into
# csrc/fused_psi.cu: K1 and K2 run its phases in one kernel
# (fused_psi_fan_phased), K3 in three (fused_psi_fan_rollout, _stages and
# _adjoint)
# ---------------------------------------------------------------------------

def _lin(*pairs):
    """``sum(a * t)`` over the pairs whose ``t`` is not None. A tangent
    entry that is None is known to be 0 and multiplies nothing: at a
    standstill (vx = vy = omega = 0) the slip angles' derivatives are 0/0,
    and 0 * NaN would poison a column that does not depend on them."""
    terms = [a * t for a, t in pairs if t is not None]
    return sum(terms[1:], terms[0]) if terms else 0.0


def _plus(a, b):
    """``a + b`` where ``a`` may be None (0)."""
    return b if a is None else a + b


def _pacejka_stage(delta, p):
    """The Pacejka ODE's per-stage constants ``(cos(delta), sin(delta))``,
    computed once for the stage's 4 x substeps evaluations (the same
    values, so the same bits)."""
    return torch.cos(delta), torch.sin(delta)


def _pacejka_point(x, d, delta, st, p):
    """The Pacejka ODE ``k`` at one evaluation point and the partial
    derivatives its tangents need, each computed once for all of them:
    ``f`` = d ffy / d(vx, vy, omega), ``f_dl`` = d ffy / d delta, ``r`` =
    d fry / d(vx, vy, omega), ``x_vx``, ``x_d`` = d frx / d(vx, d)."""
    px, py, phi, vx, vy, omega = x
    cos_d, sin_d = st
    a1 = omega * p.axis_front + vy
    a2 = omega * p.axis_rear - vy
    bfa = p.bf * (-torch.atan2(a1, vx) + delta)
    bra = p.br * torch.atan2(a2, vx)
    ta_f, ta_r = torch.atan(bfa), torch.atan(bra)
    f_dl = p.df * torch.cos(p.cf * ta_f) * p.cf * p.bf / (1.0 + bfa * bfa)
    s1 = f_dl / (vx * vx + a1 * a1)
    s2 = p.dr * torch.cos(p.cr * ta_r) * p.cr * p.br / (1.0 + bra * bra) \
        / (vx * vx + a2 * a2)
    return dict(
        k=_pacejka_deriv_cs(x, d, delta, cos_d, sin_d, p),
        cos_phi=torch.cos(phi), sin_phi=torch.sin(phi), vx=vx, vy=vy,
        om=omega, ffy=p.df * torch.sin(p.cf * ta_f),
        f=(s1 * a1, -s1 * vx, -s1 * vx * p.axis_front), f_dl=f_dl,
        r=(-s2 * a2, -s2 * vx, s2 * vx * p.axis_rear),
        x_vx=-p.cm2 * d - 2.0 * p.cr2 * vx, x_d=p.cm1 - p.cm2 * vx)


def _pacejka_tangent(q, st, p, t, j):
    """Derivative of ``k`` at the point ``q`` of the stage with constants
    ``st`` along tangent column ``j``: ``t = (t_phi, t_vx, t_vy, t_omega)``
    of the point (px, py enter nothing); column 4 also moves d by 1, column
    5 delta by 1. For k3 = (frx - ffy sin_d + m vy omega) / m the last
    term's derivative is vy t_omega + omega t_vy, and so on."""
    tphi, tvx, tvy, tom = t
    cos_d, sin_d = st
    lf, lr = p.axis_front, p.axis_rear
    tffy = _lin(*zip(q["f"], (tvx, tvy, tom)))
    tfry = _lin(*zip(q["r"], (tvx, tvy, tom)))
    tfrx = _lin((q["x_vx"], tvx))
    if j == 4:
        tfrx = tfrx + q["x_d"]
    if j == 5:
        tffy = tffy + q["f_dl"]
    n3 = tfrx - sin_d * tffy
    n4 = tfry + cos_d * tffy
    n5 = lf * cos_d * tffy - lr * tfry
    if j == 5:
        n3 = n3 - q["ffy"] * cos_d
        n4 = n4 - q["ffy"] * sin_d
        n5 = n5 - lf * q["ffy"] * sin_d
    k = q["k"]
    return (_lin((q["cos_phi"], tvx), (-q["sin_phi"], tvy), (-k[1], tphi)),
            _lin((q["sin_phi"], tvx), (q["cos_phi"], tvy), (k[0], tphi)),
            0.0 if tom is None else tom,
            n3 * (1.0 / p.mass) + _lin((q["vy"], tom), (q["om"], tvy)),
            n4 * (1.0 / p.mass) - _lin((q["vx"], tom), (q["om"], tvx)),
            n5 * (1.0 / p.inertia))


def _kinematic_stage(delta, p):
    """The kinematic ODE's per-stage constants ``(beta, sin(beta),
    cos(beta), beta')``: the slip angle ``beta = atan2(lf tan(delta),
    lf + lr)``, computed once for the stage's 4 x substeps evaluations as
    :func:`_kinematic_deriv` computes it in each (the same values, so the
    same bits), and, with lf + lr > 0, ``beta' = d beta / d delta =
    lf (lf + lr) (1 + tan^2 delta) / ((lf + lr)^2 + lf^2 tan^2 delta)``."""
    lf, lr = p.axis_front, p.axis_rear
    ll = lf + lr
    t = torch.tan(delta)
    ty = lf * t
    beta = torch.atan2(ty, ll)
    return (beta, torch.sin(beta), torch.cos(beta),
            ll / (ll * ll + ty * ty) * lf * (1.0 + t * t))


def _kinematic_point(x, d, delta, st, p):
    """The kinematic ODE ``k`` at one evaluation point, in
    :func:`_kinematic_deriv`'s operation order, and the terms its tangents
    need beside the stage's constants."""
    px, py, phi, v = x
    beta, sin_b, _, _ = st
    pb = phi + beta
    cos_pb, sin_pb = torch.cos(pb), torch.sin(pb)
    return dict(
        k=(v * cos_pb, v * sin_pb, v * sin_b / p.axis_rear,
           p.acceleration * d - p.friction * v),
        cos_pb=cos_pb, sin_pb=sin_pb, v=v)


def _kinematic_tangent(q, st, p, t, j):
    """Derivative of ``k`` at the point ``q`` of the stage with constants
    ``st`` along tangent column ``j``: ``t = (t_phi, t_v)`` of the point (px, py enter nothing); column 2 also
    moves d by 1, column 3 delta by 1 and with it beta by beta'. With
    pb = phi + beta: dk0 = cos(pb) t_v - v sin(pb) (t_phi + beta'),
    dk1 = sin(pb) t_v + v cos(pb) (t_phi + beta'),
    dk2 = (sin(beta) t_v + v cos(beta) beta') / lr, dk3 = -fr t_v + acc,
    where beta' enters only column 3 and acc only column 2."""
    tphi, tv = t
    _, sin_b, cos_b, db = st
    k = q["k"]
    tpb = _plus(tphi, db) if j == 3 else tphi    # of the angle pb
    n2 = _lin((sin_b, tv))
    if j == 3:
        n2 = n2 + q["v"] * cos_b * db
    dk3 = _lin((-p.friction, tv))
    if j == 2:
        dk3 = dk3 + p.acceleration
    return (_lin((q["cos_pb"], tv), (-k[1], tpb)),
            _lin((q["sin_pb"], tv), (k[0], tpb)),
            n2 / p.axis_rear, dk3)


#: model -> (per-stage constants, evaluation point, tangent): the phased
#: kernel's model struct (M::stage, M::point, M::tangent)
_PHASED = {"pacejka": (_pacejka_stage, _pacejka_point, _pacejka_tangent),
           "simplified": (_kinematic_stage, _kinematic_point,
                          _kinematic_tangent)}


def _stage_linearisation(model, xs, d, delta, p, h, substeps):
    """A stage recomputed from its start state ``xs`` with its Jacobian in
    forward mode: ``T[j]`` (sd components) is the derivative of the stage's
    end state along column j: j < NX = sd - 2 the start state's component
    j + 2 (Pacejka phi, vx, vy, omega; kinematic phi, v), NX the input d,
    NX + 1 delta. The start state's px and py move the end state one for
    one and enter nothing else, so they need no column. Each evaluation
    point's transcendental terms are computed once (the model's point
    function) and applied to all sd columns."""
    stage, point, tangent = _PHASED[model]
    sd = len(xs)
    hh, h6 = 0.5 * h, h / 6.0
    st = stage(delta, p)
    # the start tangents: unit columns for the state, zero for the inputs
    T = [tuple(1.0 if r == j + 2 else None for r in range(sd))
         for j in range(sd)]
    x = xs
    for _ in range(substeps):
        P = [col[2:] for col in T]
        xa, acc, S = x, None, [None] * sd
        for w, c in ((1.0, hh), (2.0, hh), (2.0, h), (1.0, None)):
            q = point(xa, d, delta, st, p)
            dks = [tangent(q, st, p, P[j], j) for j in range(sd)]
            acc = q["k"] if acc is None \
                else tuple(a + w * b for a, b in zip(acc, q["k"]))
            S = [tuple(_plus(s, w * b) for s, b in zip(
                (None,) * sd if S[j] is None else S[j], dks[j]))
                for j in range(sd)]
            if c is not None:
                xa = tuple(xi + c * ki for xi, ki in zip(x, q["k"]))
                P = [tuple(_plus(T[j][r], c * dks[j][r])
                           for r in range(2, sd)) for j in range(sd)]
        x = tuple(xi + h6 * a for xi, a in zip(x, acc))
        T = [tuple(_plus(t, h6 * s) for t, s in zip(T[j], S[j]))
             for j in range(sd)]
    return T


def _fan_phased_transcription(u, y0, cltab, pvec, n_horiz, substeps, h,
                              v_ref, weights, model="pacejka", al=None):
    """The fan kernels' phased algorithm in batched torch, no autograd: K1
    (``model="pacejka"``), K2 (``"simplified"``) and K3 (Pacejka with
    ``al``); ``cltab`` as in :func:`fan_value_and_grad_reference`.

    Phase 1, serial over stages: roll out the states, keeping the N + 1
    stage boundary states and nothing else (the model's per-stage constants
    computed once per stage). Phase 2, independent per stage: from the
    stored end state the nearest-point index, the stage cost and its state
    gradient, and the AL penalties with their gradient ``sigma r 2 x_i``;
    from the stored start state the stage's Jacobians ``A_k`` (d x_{k+1} /
    d x_k) and ``B_k`` (d x_{k+1} / d (d_k, delta_k)) in forward mode
    (:func:`_stage_linearisation`). Phase 3, serial over stages: psi summed
    in the plain version's order (stage cost, then its penalties, stage by
    stage), so it is bit-identical; then from k = N-1 down to 0, with
    ``v = lam + g_k``: ``grad_k = B_k^T v + (2 c5 d_k, 2 c4 delta_k)`` and
    ``lam = A_k^T v``.
    """
    if model not in _PHASED:
        raise ValueError(f"unknown model {model!r}")
    stage, point, _ = _PHASED[model]
    sd = _MODELS[model][1]
    nx = sd - 2
    p = _Params(pvec)
    tab = _lane_tables(cltab, u.shape[0])
    # phase 1
    xs = [tuple(y0[:, i] for i in range(sd))]
    for k in range(n_horiz):
        d, delta = u[:, 2 * k], u[:, 2 * k + 1]
        st = stage(delta, p)
        xs.append(_rk4_substeps(
            lambda x_, d_, dl_, p_: point(x_, d_, dl_, st, p_)["k"],
            xs[-1], d, delta, p, h, substeps))
    # phase 2: each stage reads only xs[k] and xs[k + 1]
    costs, pens, gs, Ts = [], [], [], []
    for k in range(n_horiz):
        d, delta = u[:, 2 * k], u[:, 2 * k + 1]
        xe = xs[k + 1]
        pts = _selected(tab, _nearest(xe[0], xe[1], tab))
        costs.append(_stage_cost(xe, d, delta, pts, v_ref, weights))
        g = _stage_cost_vjp(xe, pts, v_ref, weights)
        pen = []
        if al is not None:
            res = list(_al_residuals(xe, k, al))
            pen = [0.5 * s * r ** 2 for s, r in res]
            g = tuple(gi + s * r * (2.0 * xi)
                      for gi, xi, (s, r) in zip(g, xe, res))
        pens.append(pen)
        gs.append(g)
        Ts.append(_stage_linearisation(model, xs[k], d, delta, p, h,
                                       substeps))
    # phase 3
    psi = torch.zeros(u.shape[0], dtype=u.dtype, device=u.device)
    for cost, pen in zip(costs, pens):
        psi = psi + cost
        for term in pen:
            psi = psi + term
    grad = torch.zeros_like(u)
    lam = (0.0,) * sd
    for k in reversed(range(n_horiz)):
        v = tuple(a + b for a, b in zip(lam, gs[k]))
        T = Ts[k]
        grad[:, 2 * k] = _lin(*zip(T[nx], v)) + 2.0 * weights[5] * u[:, 2 * k]
        grad[:, 2 * k + 1] = _lin(*zip(T[nx + 1], v)) \
            + 2.0 * weights[4] * u[:, 2 * k + 1]
        lam = (v[0], v[1]) + tuple(_lin(*zip(T[j], v)) for j in range(nx))
    return psi, grad


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def al_scratch_floats(E: int, n_horiz: int) -> int:
    """The floats of the device scratch through which K3's kernels hand a
    lane's intermediates on (``csrc/fused_psi.cu``, ``scratch_layout``): 55
    N + 6 planes (the N + 1 boundary states and each stage's Jacobian,
    state gradient, cost and penalties, 6 states), each of E floats rounded
    up to 32."""
    return (55 * n_horiz + 6) * (-(-E // 32) * 32)


def _check(name, t, shape, device):
    check_operand("fan", name, t, shape, device)


def _fan(wrapper, model, u, y0, cltab, pvec, n_horiz, substeps, h, v_ref,
         weights, al=None):
    """Check the inputs, then run the plain version (CPU tensor) or launch
    the kernel of ``model`` and ``al`` (CUDA tensor), counting the launch on
    ``wrapper.launches``. Per-lane roads (a 3-D ``cltab``) are taken by K1
    alone, which counts them on ``wrapper.road_launches`` too; K2 and K3
    raise on them."""
    if not isinstance(u, torch.Tensor) or u.dim() != 2:
        raise ValueError("fan: u must be a 2-D tensor (E, 2N)")
    E = u.shape[0]
    dev = u.device
    sd = _MODELS[model][1]
    if len(weights) != 6:
        raise ValueError("fan: weights must have 6 entries")
    _check("u", u, (E, 2 * n_horiz), dev)
    _check("y0", y0, (E, sd), dev)
    if isinstance(cltab, torch.Tensor) and cltab.dim() == 3 \
            and (model != "pacejka" or al is not None):
        raise NotImplementedError(
            "fan: per-lane roads are ported for K1 only; no path of the "
            "port gives K2 or K3 one road per lane")
    rs = road_stride(cltab, E)
    _check("cltab", cltab, cltab.shape, dev)
    _check("pvec", pvec, (len(KERNEL_PARAM_FIELDS),), dev)
    n_cl = cltab.shape[-2]
    if n_cl < 1:
        raise ValueError("fan: cltab needs at least one row")
    m = 0
    if al is not None:
        m = sd * n_horiz
        for name, t, shape in zip(("lam", "sigma", "offsets", "d_lo", "d_up"),
                                  al, ((E, m), (E, m), (sd,), (m,), (m,))):
            _check(name, t, shape, dev)

    if dev.type == "cpu":
        return fan_value_and_grad_reference(u, y0, cltab, pvec, n_horiz,
                                            substeps, h, v_ref, weights,
                                            model, al)
    if dev.type != "cuda":
        raise RuntimeError(f"fan: no kernel for {dev.type}")
    if not 1 <= n_horiz <= KERNEL_MAX_HORIZON:
        raise ValueError(f"fan: the kernel takes 1 <= N <= "
                         f"{KERNEL_MAX_HORIZON}, got {n_horiz}")
    if substeps < 1:
        raise ValueError(f"fan: the kernel takes substeps >= 1, got "
                         f"{substeps}")

    psi = torch.empty((E,), dtype=torch.float32, device=dev)
    grad = torch.empty((E, 2 * n_horiz), dtype=torch.float32, device=dev)
    if E == 0:
        return psi, grad
    from mpc_tpu_torch.kernels.build import load_fused_psi
    lib = load_fused_psi()
    common = (E, n_horiz, n_cl, substeps, float(h), float(v_ref),
              *(float(w) for w in weights))
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if al is not None:
            n_scratch = al_scratch_floats(E, n_horiz)
            scratch = torch.empty((n_scratch,), dtype=torch.float32,
                                  device=dev)
            rc = lib.mpc_fused_psi_fan_al(
                u.data_ptr(), y0.data_ptr(), cltab.data_ptr(),
                pvec.data_ptr(), *(t.data_ptr() for t in al),
                psi.data_ptr(), grad.data_ptr(), scratch.data_ptr(),
                n_scratch, *common, stream)
        elif model == "pacejka":
            rc = lib.mpc_fused_psi_fan(
                u.data_ptr(), y0.data_ptr(), cltab.data_ptr(),
                pvec.data_ptr(), psi.data_ptr(), grad.data_ptr(), *common,
                rs, stream)
        else:
            rc = lib.mpc_fused_psi_fan_kin(
                u.data_ptr(), y0.data_ptr(), cltab.data_ptr(),
                pvec.data_ptr(), psi.data_ptr(), grad.data_ptr(), *common,
                stream)
        if rc != 0:
            # a shape the kernel's shared memory cannot hold raises
            # ValueError here; anything else is a launch failure
            if al is None:
                phased_plan(E, n_horiz, n_cl, model,
                            cltab.shape[0] if rs else 0)
            elif rc == _CUDA_ERROR_INVALID_VALUE:
                # the shapes are checked above, so K3's stage terms cannot
                # stage the road table and the bounds in shared memory
                raise ValueError(f"fan: K3 at N={n_horiz} with a {n_cl}-row "
                                 f"centerline table does not fit the "
                                 f"kernel's shared memory (cudaError {rc})")
    if rc != 0:
        raise RuntimeError(f"fan: CUDA kernel launch failed with "
                           f"cudaError {rc}")
    wrapper.launches += 1
    if rs:
        wrapper.road_launches += 1
    return psi, grad


def phased_plan(E: int, n_horiz: int, n_cl: int, model: str,
                roads: int = 0) -> tuple:
    """``(lanes per block, shared-memory bytes)`` of the phased kernel for
    ``model`` (K1 ``"pacejka"``, K2 ``"simplified"``) for E lanes on one
    shared road (``roads`` 0) or on ``roads`` roads of E / roads lanes each
    (a block stages each road its lanes read) on the current CUDA device,
    as its launcher picks them; ValueError if the shape does not fit the
    device's shared memory even at one lane per block."""
    from mpc_tpu_torch.kernels.build import load_fused_psi
    lanes, smem = ctypes.c_int(0), ctypes.c_int(0)
    rs = _lanes_per_road(E, roads) if roads else 0
    rc = load_fused_psi().mpc_fused_psi_fan_plan(
        _MODELS[model][1], E, n_horiz, n_cl, rs,
        ctypes.byref(lanes), ctypes.byref(smem))
    if rc != 0:
        raise ValueError(f"fan: N={n_horiz} with a {n_cl}-row centerline "
                         f"table does not fit the kernel's shared memory "
                         f"(cudaError {rc})")
    return lanes.value, smem.value


def fan_value_and_grad(u: torch.Tensor, y0: torch.Tensor, cltab: torch.Tensor,
                       pvec: torch.Tensor, n_horiz: int, substeps: int,
                       h: float, v_ref: float,
                       weights: Sequence[float] = DEFAULT_VEHICLE_WEIGHTS):
    """K1, the Pacejka fan: ``(psi (E,), grad (E, 2N))`` for ``y0`` (E, 6),
    on one shared road (``cltab`` (S-1, 6)) or on one road per scenario
    (``cltab`` (R, S-1, 6), each road read by E / R adjacent lanes).

    On a CPU tensor this is :func:`fan_value_and_grad_reference`. On a CUDA
    tensor it launches the hand-written kernel (``csrc/fused_psi.cu``) or
    raises: there is no fallback. ``launches`` counts the launches of both
    forms, ``road_launches`` those on a (R, S-1, 6) table.
    """
    return _fan(fan_value_and_grad, "pacejka", u, y0, cltab, pvec, n_horiz,
                substeps, h, v_ref, weights)


def kin_fan_value_and_grad(u: torch.Tensor, y0: torch.Tensor,
                           cltab: torch.Tensor, pvec: torch.Tensor,
                           n_horiz: int, substeps: int, h: float,
                           v_ref: float,
                           weights: Sequence[float] = DEFAULT_VEHICLE_WEIGHTS):
    """K2, the kinematic-bicycle fan: as :func:`fan_value_and_grad` with
    ``y0`` (E, 4) ``[x, y, phi, v]``, on a shared road only."""
    return _fan(kin_fan_value_and_grad, "simplified", u, y0, cltab, pvec,
                n_horiz, substeps, h, v_ref, weights)


def al_fan_value_and_grad(u: torch.Tensor, y0: torch.Tensor,
                          cltab: torch.Tensor, pvec: torch.Tensor,
                          lam: torch.Tensor, sigma: torch.Tensor,
                          offsets: torch.Tensor, d_lo: torch.Tensor,
                          d_up: torch.Tensor, n_horiz: int, substeps: int,
                          h: float, v_ref: float,
                          weights: Sequence[float] = DEFAULT_VEHICLE_WEIGHTS):
    """K3, the Pacejka fan plus the augmented-Lagrangian penalty of the
    state constraints ``x_i^2 - offsets_i in [d_lo, d_up]``: ``lam``,
    ``sigma`` (E, 6N) per lane, ``offsets`` (6,), ``d_lo``, ``d_up`` (6N,),
    stage-major. A shared road only. On the card, three kernels through a
    scratch of ``al_scratch_floats(E, N)`` floats; ``launches`` counts the
    call once."""
    return _fan(al_fan_value_and_grad, "pacejka", u, y0, cltab, pvec,
                n_horiz, substeps, h, v_ref, weights,
                al=(lam, sigma, offsets, d_lo, d_up))


#: kernel launches (K3: calls) since each count was last reset
fan_value_and_grad.launches = 0
fan_value_and_grad.road_launches = 0
kin_fan_value_and_grad.launches = 0
al_fan_value_and_grad.launches = 0


# ---------------------------------------------------------------------------
# OCP-level builders
# ---------------------------------------------------------------------------

def fan_params(centerline: torch.Tensor, p: VehicleParams):
    """``(cltab, pvec)`` for a road (S, 2) or a stack of roads (R, S, 2) and
    a parameter set, on the road's device."""
    return make_cltab(centerline), p.to_kernel_vec(device=centerline.device)


def make_vehicle_cost_multi(n_horiz: int, ts: float = 0.05,
                            substeps: int = 4, v_ref: float = 1.0,
                            weights=DEFAULT_VEHICLE_WEIGHTS,
                            model: str = "pacejka") -> Callable:
    """Build ``cost_multi(cands (B, K, n), y0 (B, sd), cltab, pvec)
    -> (psi (B, K), grad (B, K, n))``: every (scenario x candidate) pair is
    one evaluation lane of the model's fan (E = B*K, a scenario's K
    candidates adjacent): K1 for ``model="pacejka"``, K2 for
    ``"simplified"``.

    ``cltab, pvec = fan_params(centerline, p)``; compute them once per solve.
    A (B, S-1, 6) ``cltab`` gives each scenario's K candidates its road
    (K1 only).
    """
    if model not in _MODELS:
        raise ValueError(f"unknown model {model!r}")
    h = ts / substeps
    weights = tuple(float(w) for w in weights)

    def cost_multi(cands, y0, cltab, pvec):
        fan = fan_value_and_grad if model == "pacejka" \
            else kin_fan_value_and_grad
        B, K, n = cands.shape
        y0e = y0.repeat_interleave(K, dim=0).contiguous()
        psi, grad = fan(cands.reshape(B * K, n).contiguous(), y0e, cltab,
                        pvec, n_horiz, substeps, h, v_ref, weights)
        return psi.reshape(B, K), grad.reshape(B, K, n)

    return cost_multi


def make_vehicle_al_multi(n_horiz: int, offsets, d_lo, d_up,
                          ts: float = 0.05, substeps: int = 4,
                          v_ref: float = 1.0,
                          weights=DEFAULT_VEHICLE_WEIGHTS,
                          device=None) -> Callable:
    """Build ``al_multi(cands (B, K, n), y0 (B, 6), cltab, pvec, lam (B, m),
    sigma (B, m)) -> (psi (B, K), grad (B, K, n))`` for the state-constrained
    Pacejka OCP: each lane's ``lam`` and ``sigma`` are repeated for its K
    candidates (mpc_tpu/ops/fused_psi.py:471-544), and every pair is one
    evaluation lane of K3. ``offsets`` (6,), ``d_lo`` and ``d_up`` (6N,) are
    fixed when the evaluator is built, as in the reference."""
    h = ts / substeps
    weights = tuple(float(w) for w in weights)

    def const(a):
        return torch.as_tensor(a, dtype=torch.float32,
                               device=device).contiguous()

    consts = (const(offsets), const(d_lo), const(d_up))

    def al_multi(cands, y0, cltab, pvec, lam, sigma):
        B, K, n = cands.shape

        def per_lane(a):                    # (B, d) -> (B*K, d)
            return a.repeat_interleave(K, dim=0).contiguous()

        psi, grad = al_fan_value_and_grad(
            cands.reshape(B * K, n).contiguous(), per_lane(y0), cltab, pvec,
            per_lane(lam), per_lane(sigma), *consts, n_horiz, substeps, h,
            v_ref, weights)
        return psi.reshape(B, K), grad.reshape(B, K, n)

    return al_multi
