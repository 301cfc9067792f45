"""The PANOC candidate fan: value and gradient of the vehicle OCP cost at E
independent evaluation lanes (port of mpc_tpu/ops/fused_psi.py, kernel K1).

For each lane e (E = scenarios x candidates): an N-stage rollout of
``substeps`` RK4 steps of the Pacejka ODE from ``y0[e]`` under
``u[e] = [d0, delta0, d1, delta1, ...]``; at each stage the nearest of the
S-1 centerline candidates with its previous/next points (``make_cltab``);
the tracking stage cost; ``psi[e]``, the sum of stage costs; and
``grad[e] = d psi[e] / d u[e]``.

Three implementations of the same function live here:

- :func:`fan_value_and_grad_reference`, the plain PyTorch version
  (structure-of-arrays rollout, gradient by autograd of the lane sum). It is
  the CPU path and the oracle the kernel is held to.
- :func:`_fan_adjoint_transcription`, the hand-written adjoint that
  ``csrc/fused_psi.cu`` implements, transcribed into batched torch so that
  every partial derivative is checked against autograd on the CPU. Used
  only by the tests.
- :func:`fan_value_and_grad`, the wrapper: it checks its inputs, runs the
  plain version for a CPU tensor, and launches the CUDA kernel for a CUDA
  tensor (or raises). It counts its kernel launches in
  ``fan_value_and_grad.launches``.

The reference's polynomial arctan exists only because the TPU compiler has
no atan lowering; every version here uses the native ``atan2``/``atan``.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Sequence

import torch

from mpc_tpu_torch.models.params import KERNEL_PARAM_FIELDS, VehicleParams
from mpc_tpu_torch.ops.costs import DEFAULT_VEHICLE_WEIGHTS
from mpc_tpu_torch.ops.road import wrap_to_pi

#: limits of the kernel's per-thread buffers (csrc/fused_psi.cu MAX_N/MAX_SUB)
KERNEL_MAX_HORIZON = 64
KERNEL_MAX_SUBSTEPS = 8
#: the centerline table must fit the default 48 KB of shared memory
KERNEL_MAX_CL_ROWS = (48 * 1024 // 4 - len(KERNEL_PARAM_FIELDS)) // 6


def make_cltab(centerline: torch.Tensor) -> torch.Tensor:
    """The (S-1, 6) selection table ``[nearest, previous, next]`` (x, y each)
    per candidate index: candidates 0..S-2, previous clamped at 0
    (mpc_tpu/ops/fused_psi.py:158-166)."""
    head = centerline[:-1]
    prev = torch.cat([centerline[:1], centerline[:-2]], dim=0)
    nxt = centerline[1:]
    return torch.cat([head, prev, nxt], dim=1).contiguous()


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
    px, py, phi, vx, vy, omega = x
    lf, lr, m, iz = p.axis_front, p.axis_rear, p.mass, p.inertia
    af = -torch.atan2(omega * lf + vy, vx) + delta
    ar = torch.atan2(omega * lr - vy, vx)
    frx = (p.cm1 - p.cm2 * vx) * d - p.cr0 * torch.sign(vx) - p.cr2 * vx * vx
    ffy = p.df * torch.sin(p.cf * torch.atan(p.bf * af))
    fry = p.dr * torch.sin(p.cr * torch.atan(p.br * ar))
    cos_phi, sin_phi = torch.cos(phi), torch.sin(phi)
    cos_d, sin_d = torch.cos(delta), torch.sin(delta)
    return (
        vx * cos_phi - vy * sin_phi,
        vx * sin_phi + vy * cos_phi,
        omega,
        (frx - ffy * sin_d + m * vy * omega) / m,
        (fry + ffy * cos_d - m * vx * omega) / m,
        (ffy * lf * cos_d - fry * lr) / iz,
    )


def _rk4_substeps(x, d, delta, p, h, substeps):
    for _ in range(substeps):
        k1 = _pacejka_deriv(x, d, delta, p)
        x2 = tuple(xi + 0.5 * h * ki for xi, ki in zip(x, k1))
        k2 = _pacejka_deriv(x2, d, delta, p)
        x3 = tuple(xi + 0.5 * h * ki for xi, ki in zip(x, k2))
        k3 = _pacejka_deriv(x3, d, delta, p)
        x4 = tuple(xi + h * ki for xi, ki in zip(x, k3))
        k4 = _pacejka_deriv(x4, d, delta, p)
        x = tuple(xi + (h / 6.0) * (a + 2 * b + 2 * c + e)
                  for xi, a, b, c, e in zip(x, k1, k2, k3, k4))
    return x


def _nearest(px, py, cltab):
    """Index (E,) of the nearest candidate; first index wins a tie."""
    dx = px[:, None] - cltab[None, :, 0]
    dy = py[:, None] - cltab[None, :, 1]
    return torch.argmin(dx * dx + dy * dy, dim=1)


def _stage_terms(x, pts):
    """cte, pos_error, heading_error and speed of a state against its
    selected points ``pts = (nx, ny, pvx, pvy, nxx, nxy)``."""
    px, py, phi, vx, vy = x[:5]
    nx, ny, pvx, pvy, nxx, nxy = pts
    cte = (px - pvx) * (ny - pvy) - (py - pvy) * (nx - pvx)
    desired = torch.atan2(nxy - ny, nxx - nx)
    heading_error = wrap_to_pi(desired - phi)
    pos_error = (px - nx) * (nxy - ny) - (py - ny) * (nxx - nx)
    speed = torch.sqrt(vx ** 2 + vy ** 2)
    return cte, pos_error, heading_error, speed


def _stage_cost(x, d, delta, pts, v_ref, c):
    cte, pos_error, heading_error, speed = _stage_terms(x, pts)
    return (c[0] * (speed - v_ref) ** 2
            + c[1] * cte ** 2
            + c[2] * pos_error ** 2
            + c[3] * heading_error ** 2
            + c[4] * delta ** 2
            + c[5] * d ** 2)


def _fan_total(u, y0, cltab, pvec, n_horiz, substeps, h, v_ref, weights):
    p = _Params(pvec)
    x = tuple(y0[:, i] for i in range(6))
    tot = torch.zeros(u.shape[0], dtype=u.dtype, device=u.device)
    for k in range(n_horiz):
        d, delta = u[:, 2 * k], u[:, 2 * k + 1]
        x = _rk4_substeps(x, d, delta, p, h, substeps)
        idx = _nearest(x[0], x[1], cltab)
        pts = cltab[idx].unbind(dim=1)
        tot = tot + _stage_cost(x, d, delta, pts, v_ref, weights)
    return tot


def fan_value_and_grad_reference(u: torch.Tensor, y0: torch.Tensor,
                                 cltab: torch.Tensor, pvec: torch.Tensor,
                                 n_horiz: int, substeps: int, h: float,
                                 v_ref: float,
                                 weights: Sequence[float]):
    """Plain PyTorch fan: ``(psi (E,), grad (E, 2N))``.

    ``u`` (E, 2N), ``y0`` (E, 6), ``cltab`` (S-1, 6) from :func:`make_cltab`,
    ``pvec`` (24,) from ``VehicleParams.to_kernel_vec``. The SoA analogue of
    ``_batched_total_cost`` + ``_eval_xla`` (mpc_tpu/ops/fused_psi.py:204-294);
    the gradient is autograd of the lane sum (lanes are independent), with
    the nearest-point selection held constant.
    """
    cltab, pvec, y0 = cltab.detach(), pvec.detach(), y0.detach()
    with torch.enable_grad():
        u_ = u.detach().requires_grad_(True)
        psi = _fan_total(u_, y0, cltab, pvec, n_horiz, substeps, h, v_ref,
                         weights)
        (grad,) = torch.autograd.grad(psi.sum(), u_)
    return psi.detach(), grad


# ---------------------------------------------------------------------------
# Hand-written adjoint, transcribed line by line into csrc/fused_psi.cu
# ---------------------------------------------------------------------------

def _pacejka_vjp(x, d, delta, p, mu):
    """Cotangent ``mu`` (6 components) pulled back through the Pacejka ODE at
    ``(x, d, delta)``: returns ``(g_x (6 components), g_d, g_delta)``.
    ``sign(vx)`` has derivative 0."""
    px, py, phi, vx, vy, w = x
    lf, lr, m, iz = p.axis_front, p.axis_rear, p.mass, p.inertia
    a1 = w * lf + vy
    a2 = w * lr - vy
    af = -torch.atan2(a1, vx) + delta
    ar = torch.atan2(a2, vx)
    bfa = p.bf * af
    bra = p.br * ar
    ta_f = torch.atan(bfa)
    ta_r = torch.atan(bra)
    ffy = p.df * torch.sin(p.cf * ta_f)
    cos_phi, sin_phi = torch.cos(phi), torch.sin(phi)
    cos_d, sin_d = torch.cos(delta), torch.sin(delta)

    q3, q4, q5 = mu[3] / m, mu[4] / m, mu[5] / iz
    g_phi = mu[0] * (-vx * sin_phi - vy * cos_phi) \
        + mu[1] * (vx * cos_phi - vy * sin_phi)
    g_vx = mu[0] * cos_phi + mu[1] * sin_phi
    g_vy = -mu[0] * sin_phi + mu[1] * cos_phi
    g_w = mu[2]
    # f3 = (frx - ffy sin_d + m vy w) / m ; f4 = (fry + ffy cos_d - m vx w) / m
    # f5 = (ffy lf cos_d - fry lr) / iz
    g_frx = q3
    g_ffy = -q3 * sin_d + q4 * cos_d + q5 * lf * cos_d
    g_fry = q4 - q5 * lr
    g_vy = g_vy + q3 * m * w
    g_w = g_w + q3 * m * vy - q4 * m * vx
    g_vx = g_vx - q4 * m * w
    g_delta = -ffy * (q3 * cos_d + q4 * sin_d + q5 * lf * sin_d)
    # frx = (cm1 - cm2 vx) d - cr0 sign(vx) - cr2 vx^2
    g_d = g_frx * (p.cm1 - p.cm2 * vx)
    g_vx = g_vx + g_frx * (-p.cm2 * d - 2.0 * p.cr2 * vx)
    # ffy = df sin(cf atan(bf af)) ; fry = dr sin(cr atan(br ar))
    g_af = g_ffy * p.df * torch.cos(p.cf * ta_f) * p.cf * p.bf \
        / (1.0 + bfa * bfa)
    g_ar = g_fry * p.dr * torch.cos(p.cr * ta_r) * p.cr * p.br \
        / (1.0 + bra * bra)
    # af = -atan2(a1, vx) + delta ; ar = atan2(a2, vx)
    r1 = vx * vx + a1 * a1
    r2 = vx * vx + a2 * a2
    g_delta = g_delta + g_af
    g_a1 = -g_af * vx / r1
    g_vx = g_vx + g_af * a1 / r1
    g_a2 = g_ar * vx / r2
    g_vx = g_vx - g_ar * a2 / r2
    # a1 = w lf + vy ; a2 = w lr - vy
    g_w = g_w + g_a1 * lf + g_a2 * lr
    g_vy = g_vy + g_a1 - g_a2
    zero = torch.zeros_like(px)
    return (zero, zero, g_phi, g_vx, g_vy, g_w), g_d, g_delta


def _stage_cost_vjp(x, d, delta, pts, v_ref, c):
    """Gradient of one stage cost w.r.t. the state after the stage and the
    stage's inputs, with the selected points held constant. The wrap to
    [-pi, pi) has derivative 1."""
    px, py, phi, vx, vy, w = x
    nx, ny, pvx, pvy, nxx, nxy = pts
    cte, pos_error, heading_error, speed = _stage_terms(x, pts)
    c_cte = 2.0 * c[1] * cte
    c_pe = 2.0 * c[2] * pos_error
    g_px = c_cte * (ny - pvy) + c_pe * (nxy - ny)
    g_py = -c_cte * (nx - pvx) - c_pe * (nxx - nx)
    g_phi = -2.0 * c[3] * heading_error
    gs = 2.0 * c[0] * (speed - v_ref) / speed
    zero = torch.zeros_like(px)
    return ((g_px, g_py, g_phi, gs * vx, gs * vy, zero),
            2.0 * c[5] * d, 2.0 * c[4] * delta)


def _fan_adjoint_transcription(u, y0, cltab, pvec, n_horiz, substeps, h,
                               v_ref, weights):
    """The kernel's algorithm in batched torch, no autograd.

    Forward sweep: store each stage's start state and argmin index, sum the
    stage costs. Reverse sweep, stage N-1 down to 0: recompute the stage's
    RK4 substeps from its start state keeping the four evaluation points of
    each substep; add the stage cost's state gradient to the adjoint; pull
    the adjoint back through the substeps in reverse, accumulating the
    gradients w.r.t. ``d_k`` and ``delta_k``.
    """
    p = _Params(pvec)
    hh, h6 = 0.5 * h, h / 6.0
    x = tuple(y0[:, i] for i in range(6))
    starts, idxs = [], []
    psi = torch.zeros(u.shape[0], dtype=u.dtype, device=u.device)
    for k in range(n_horiz):
        d, delta = u[:, 2 * k], u[:, 2 * k + 1]
        starts.append(x)
        x = _rk4_substeps(x, d, delta, p, h, substeps)
        idx = _nearest(x[0], x[1], cltab)
        idxs.append(idx)
        psi = psi + _stage_cost(x, d, delta, cltab[idx].unbind(dim=1),
                                v_ref, weights)

    grad = torch.zeros_like(u)
    lam = tuple(torch.zeros_like(psi) for _ in range(6))
    for k in reversed(range(n_horiz)):
        d, delta = u[:, 2 * k], u[:, 2 * k + 1]
        xs = starts[k]
        points = []
        for _ in range(substeps):
            k1 = _pacejka_deriv(xs, d, delta, p)
            x2 = tuple(a + hh * b for a, b in zip(xs, k1))
            k2 = _pacejka_deriv(x2, d, delta, p)
            x3 = tuple(a + hh * b for a, b in zip(xs, k2))
            k3 = _pacejka_deriv(x3, d, delta, p)
            x4 = tuple(a + h * b for a, b in zip(xs, k3))
            k4 = _pacejka_deriv(x4, d, delta, p)
            points.append((xs, x2, x3, x4))
            xs = tuple(a + h6 * (b1 + 2 * b2 + 2 * b3 + b4)
                       for a, b1, b2, b3, b4 in zip(xs, k1, k2, k3, k4))
        g_x, g_d, g_delta = _stage_cost_vjp(
            xs, d, delta, cltab[idxs[k]].unbind(dim=1), v_ref, weights)
        lam = tuple(a + b for a, b in zip(lam, g_x))
        for xa, x2, x3, x4 in reversed(points):
            lk1 = tuple(h6 * a for a in lam)
            lk2 = tuple(2.0 * a for a in lk1)
            lk3 = lk2
            lx = lam
            gx, gd_, gdl = _pacejka_vjp(x4, d, delta, p, lk1)   # k4: weight h/6
            lx = tuple(a + b for a, b in zip(lx, gx))
            lk3 = tuple(a + h * b for a, b in zip(lk3, gx))
            g_d, g_delta = g_d + gd_, g_delta + gdl
            gx, gd_, gdl = _pacejka_vjp(x3, d, delta, p, lk3)
            lx = tuple(a + b for a, b in zip(lx, gx))
            lk2 = tuple(a + hh * b for a, b in zip(lk2, gx))
            g_d, g_delta = g_d + gd_, g_delta + gdl
            gx, gd_, gdl = _pacejka_vjp(x2, d, delta, p, lk2)
            lx = tuple(a + b for a, b in zip(lx, gx))
            lk1 = tuple(a + hh * b for a, b in zip(lk1, gx))
            g_d, g_delta = g_d + gd_, g_delta + gdl
            gx, gd_, gdl = _pacejka_vjp(xa, d, delta, p, lk1)
            lam = tuple(a + b for a, b in zip(lx, gx))
            g_d, g_delta = g_d + gd_, g_delta + gdl
        grad[:, 2 * k] = g_d
        grad[:, 2 * k + 1] = g_delta
    return psi, grad


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def _check(name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"fan_value_and_grad: {name} must be a tensor")
    if t.dtype != torch.float32:
        raise TypeError(f"fan_value_and_grad: {name} must be float32, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fan_value_and_grad: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"fan_value_and_grad: {name} is on {t.device}, "
                         f"u is on {device}")
    if not t.is_contiguous():
        raise ValueError(f"fan_value_and_grad: {name} must be contiguous")


def fan_value_and_grad(u: torch.Tensor, y0: torch.Tensor, cltab: torch.Tensor,
                       pvec: torch.Tensor, n_horiz: int, substeps: int,
                       h: float, v_ref: float,
                       weights: Sequence[float] = DEFAULT_VEHICLE_WEIGHTS):
    """Fan value and gradient ``(psi (E,), grad (E, 2N))``.

    On a CPU tensor this is :func:`fan_value_and_grad_reference`. On a CUDA
    tensor it launches the hand-written kernel (``csrc/fused_psi.cu``) or
    raises: there is no fallback.
    """
    if not isinstance(u, torch.Tensor) or u.dim() != 2:
        raise ValueError("fan_value_and_grad: u must be a 2-D tensor (E, 2N)")
    E = u.shape[0]
    dev = u.device
    if len(weights) != 6:
        raise ValueError("fan_value_and_grad: weights must have 6 entries")
    _check("u", u, (E, 2 * n_horiz), dev)
    _check("y0", y0, (E, 6), dev)
    if cltab.dim() != 2:
        raise ValueError("fan_value_and_grad: cltab must be (S-1, 6)")
    _check("cltab", cltab, (cltab.shape[0], 6), dev)
    _check("pvec", pvec, (len(KERNEL_PARAM_FIELDS),), dev)
    if cltab.shape[0] < 1:
        raise ValueError("fan_value_and_grad: cltab needs at least one row")

    if dev.type == "cpu":
        return fan_value_and_grad_reference(u, y0, cltab, pvec, n_horiz,
                                            substeps, h, v_ref, weights)
    if dev.type != "cuda":
        raise RuntimeError(f"fan_value_and_grad: no kernel for {dev.type}")
    if not 1 <= n_horiz <= KERNEL_MAX_HORIZON:
        raise ValueError(f"fan_value_and_grad: kernel takes 1 <= N <= "
                         f"{KERNEL_MAX_HORIZON}, got {n_horiz}")
    if not 1 <= substeps <= KERNEL_MAX_SUBSTEPS:
        raise ValueError(f"fan_value_and_grad: kernel takes 1 <= substeps <= "
                         f"{KERNEL_MAX_SUBSTEPS}, got {substeps}")
    if cltab.shape[0] > KERNEL_MAX_CL_ROWS:
        raise ValueError(f"fan_value_and_grad: kernel takes at most "
                         f"{KERNEL_MAX_CL_ROWS} centerline rows")

    psi = torch.empty((E,), dtype=torch.float32, device=dev)
    grad = torch.empty((E, 2 * n_horiz), dtype=torch.float32, device=dev)
    if E == 0:
        return psi, grad
    from mpc_tpu_torch.kernels.build import load_fused_psi
    lib = load_fused_psi()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mpc_fused_psi_fan(
            u.data_ptr(), y0.data_ptr(), cltab.data_ptr(), pvec.data_ptr(),
            psi.data_ptr(), grad.data_ptr(),
            E, n_horiz, cltab.shape[0], substeps,
            float(h), float(v_ref), *(float(w) for w in weights),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fan_value_and_grad: CUDA kernel launch failed "
                           f"with cudaError {rc}")
    fan_value_and_grad.launches += 1
    return psi, grad


#: kernel launches since the count was last reset
fan_value_and_grad.launches = 0


# ---------------------------------------------------------------------------
# OCP-level builder
# ---------------------------------------------------------------------------

def fan_params(centerline: torch.Tensor, p: VehicleParams):
    """``(cltab, pvec)`` for a road and a parameter set, on the road's device."""
    return make_cltab(centerline), p.to_kernel_vec(device=centerline.device)


def make_vehicle_cost_multi(n_horiz: int, ts: float = 0.05,
                            substeps: int = 4, v_ref: float = 1.0,
                            weights=DEFAULT_VEHICLE_WEIGHTS,
                            model: str = "pacejka") -> Callable:
    """Build ``cost_multi(cands (B, K, n), y0 (B, 6), cltab, pvec)
    -> (psi (B, K), grad (B, K, n))``: every (scenario x candidate) pair is
    one evaluation lane of :func:`fan_value_and_grad` (E = B*K).

    ``cltab, pvec = fan_params(centerline, p)``; compute them once per solve.
    """
    if model == "simplified":
        raise NotImplementedError(
            "mpc_tpu_torch: the fused fan for the kinematic model (kernel K2) "
            "is not ported yet; see ROADMAP.md, slice 2")
    if model != "pacejka":
        raise ValueError(f"unknown model {model!r}")
    h = ts / substeps
    weights = tuple(float(w) for w in weights)

    def cost_multi(cands, y0, cltab, pvec):
        B, K, n = cands.shape
        y0e = y0.repeat_interleave(K, dim=0).contiguous()
        psi, grad = fan_value_and_grad(cands.reshape(B * K, n).contiguous(),
                                       y0e, cltab, pvec, n_horiz, substeps,
                                       h, v_ref, weights)
        return psi.reshape(B, K), grad.reshape(B, K, n)

    return cost_multi


