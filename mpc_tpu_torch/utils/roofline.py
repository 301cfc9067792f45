"""Operations, bytes and bounds of the port's hot functions on one H100: the
fan kernels K1-K3, PANOC's direction kernel P1 and the four phases of an
AL-iLQR inner iteration.

PyTorch has no counterpart of XLA's ``cost_analysis()``, which the JAX
package's ``examples/exp_mfu.py`` reads, so the work is counted here from
the shapes, by one rule:

- operations: each add, subtract, multiply, compare and select counts 1,
  and so does each transcendental function (atan2, atan, sin, cos, tan),
  square root and division, though each takes many instructions: the bound
  is a floor. A product of an (a, b) and a (b, c) matrix counts a c (2b - 1),
  a solve of a d x d system with k right-hand sides ``solve_ops(d, k)``;
- bytes: each input read once and each output written once, float32.

A function's bound is the larger of its operations over the card's
float32 rate and its bytes over the memory rate; every count below says
which of its terms it counts. Importing this module imports no torch.
"""

from __future__ import annotations

from typing import NamedTuple

#: Published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): float32
#: outside the tensor cores, and device memory
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
F32 = 4

#: Operations of a fan lane, counted from csrc/fused_psi.cu. A term that
#: depends only on a stage's inputs (d, delta) and the parameters is counted
#: once per stage (STAGE_OPS), the rest once per evaluation of
#: f(x, d, delta) (ODE_OPS):
#: - Pacejka, per evaluation 53: a1, a2 (2 + 2), the slip angles (atan2 and
#:   a subtraction; atan2), sign(vx) (2 compares, a subtraction), frx (8),
#:   the two B alpha (2), their atan (2), ffy and fry (3 + 3), cos and sin
#:   phi (2), k0 and k1 (3 + 3), k3 and k4 (6 + 6), k5 (5); per stage 2:
#:   cos and sin delta;
#: - kinematic, per evaluation 8: phi + beta, its cos and sin, v cos and
#:   v sin (2), v (sin beta / lr), fr v and acc d - fr v; per stage 6:
#:   tan delta, lf tan delta, beta = atan2(., lf + lr), sin beta,
#:   sin beta / lr, acc d.
ODE_OPS = {"pacejka": 53, "simplified": 8}
STAGE_OPS = {"pacejka": 2, "simplified": 6}
#: The former count: nothing per stage, the kinematic model's per-stage
#: terms (and lf + lr) charged to each of its 16 evaluations per stage, and
#: Pacejka's cos and sin delta left out. Its bound is printed beside the
#: bound so that earlier records stay comparable.
FORMER_ODE_OPS = {"pacejka": 53, "simplified": 15}
RK4_OPS = 13        # per state component and RK4 step: 3 stage points x 2,
                    # then k1 + 2 k2 + 2 k3 + k4 (5), times h/6, plus x
COST_OPS = 45       # one stage cost at its selected centerline points
ARGMIN_OPS = 6      # per centerline row: 2 differences, 2 squares, sum, compare
AL_OPS = 11         # one constraint's penalty 0.5 sigma (zeta - clip(zeta))^2
STATE_DIM = {"pacejka": 6, "simplified": 4}


def bound(ops: float, nbytes: float) -> tuple:
    """``(bound_ms, bound_by)``: the larger of the operations' time at the
    float32 rate and the bytes' time at the memory rate, and which."""
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes \
        else "bytes"


def lane_stage_ops(model: str = "pacejka", substeps: int = 4,
                   al: bool = False, ode_ops=None, per_stage=None) -> int:
    """One stage of one lane without the nearest-point search: the
    per-stage terms, ``substeps`` RK4 steps of 4 evaluations each, the stage
    cost and, with ``al``, one penalty per state component."""
    sd = STATE_DIM[model]
    step = 4 * (ode_ops or ODE_OPS)[model] + RK4_OPS * sd
    return ((per_stage or STAGE_OPS)[model] + substeps * step + COST_OPS
            + (sd * AL_OPS if al else 0))


def fan_ops(model, al, E, n_horiz, substeps, n_cl, ode_ops=None,
            stage_ops=None):
    """The operations of one fan call, counted by the rule above: the
    forward pass, and the gradient as one more pass over the same operations
    without the argmin (its index is held constant), the least a reverse
    sweep does. ``n_cl`` is the road table's rows, the argmin's
    candidates."""
    stage = lane_stage_ops(model, substeps, al, ode_ops, stage_ops)
    return E * n_horiz * (2 * stage + ARGMIN_OPS * n_cl)


def fan_bound(model, al, E, n_horiz, substeps, n_cl, operands, outputs):
    """``(bound_ms, bound_by, bytes, operations, former_bound_ms)`` of one
    fan call: the larger of the bytes it must move (each operand read once,
    each output written once; tensors) over the memory rate and the
    operations it must do (``fan_ops``) over the float32 rate; and the same
    bound under the former count (``FORMER_ODE_OPS``, nothing per stage)."""
    shape = (model, al, E, n_horiz, substeps, n_cl)
    ops = fan_ops(*shape)
    former_ops = fan_ops(*shape, FORMER_ODE_OPS, dict.fromkeys(STAGE_OPS, 0))
    nbytes = sum(t.numel() * t.element_size() for t in operands + outputs)
    bound_ms, bound_by = bound(ops, nbytes)
    return (bound_ms, bound_by, nbytes, ops,
            max(former_ops / PEAK_F32_FLOPS * 1e3,
                nbytes / PEAK_BYTES_PER_S * 1e3))


# ---- PANOC's direction (mpc_tpu_torch/csrc/panoc_direction.cu) ------------

def direction_ops(B: int, n: int, M: int, n_taus: int) -> int:
    """One direction call over B lanes of n inputs at L-BFGS memory M with
    ``n_taus`` taus: per coordinate the projected step (a multiply, a
    subtraction, the clamp, the residual, two compares, r fmask and r.r's
    multiply-add: 10); per ring slot and loop a dot and an update (4 n + 3,
    twice); the initial scaling (4 n + 4); the cap (2 n + 6) and the
    direction's select (2 n); the candidates (4 n per tau)."""
    per_lane = (10 * n + 2 * M * (4 * n + 3) + 4 * n + 4 + 2 * n + 6
                + 2 * n + 4 * n * n_taus)
    return B * per_lane


def direction_bound(B, n, M, n_taus, operands, outputs):
    """``(bound_ms, bound_by, bytes, operations)`` of one direction call:
    the bytes of its operands (the ring S, Y, rho, valid and head, u, g_u,
    gamma and the box) read once and its outputs written once over the
    memory rate, or its operations (``direction_ops``) over the float32
    rate, whichever is larger."""
    ops = direction_ops(B, n, M, n_taus)
    nbytes = sum(t.numel() * t.element_size() for t in operands + outputs)
    bound_ms, bound_by = bound(ops, nbytes)
    return bound_ms, bound_by, nbytes, ops


# ---- the AL-iLQR inner iteration (mpc_tpu_torch/solver/ilqr.py) -----------

class Count(NamedTuple):
    """The work of one call: operations and bytes."""
    ops: int
    bytes: int

    def bound(self) -> tuple:
        return bound(self.ops, self.bytes)


def mm(a: int, b: int, c: int) -> int:
    """An (a, b) by (b, c) matrix product: a c multiplications of b terms
    and b - 1 additions each."""
    return a * c * (2 * b - 1)


def solve_ops(d: int, k: int) -> int:
    """A d x d solve with k right-hand sides: the LU factorisation
    (sum over the pivots j of (d-j-1) divisions and 2 (d-j-1)^2 updates),
    then per right-hand side a forward and a back substitution (d^2 - d
    updates of 2 each, d divisions)."""
    lu = sum((d - j - 1) + 2 * (d - j - 1) ** 2 for j in range(d))
    return lu + k * (2 * (d * d - d) + d)


#: One input's clamp into its box: a max and a min
CLAMP_OPS = 2


def policy_ops(n: int, m: int) -> int:
    """u = clamp(u_nom - alpha ko - K (x - x_nom)) for one lane and stage:
    the deviation (n subtractions), K dx, then per input alpha ko, two
    subtractions and the clamp."""
    return n + mm(m, n, 1) + m + 2 * m + CLAMP_OPS * m


def ilqr_stage_ops(substeps: int, n_cl: int, n_c: int, m: int = 2) -> int:
    """One stage of one lane's rollout: the clamped input (``CLAMP_OPS``
    each), f_d (``lane_stage_ops``' RK4 substeps), the stage cost in residual
    form at its nearest point (``COST_OPS``, the argmin over ``n_cl``
    candidates), ``n_c`` AL penalties (``AL_OPS``) and the add into the
    lane's cost."""
    return (CLAMP_OPS * m + lane_stage_ops("pacejka", substeps, al=False)
            + ARGMIN_OPS * n_cl + n_c * AL_OPS + 1)


def ilqr_rollout(B: int, N: int, n: int = 6, m: int = 2, substeps: int = 4,
                 road_points: int = 100, n_c: int = 6) -> Count:
    """``IlqrPhases.rollout``: B lanes of N stages (``ilqr_stage_ops``,
    the argmin over the road's ``road_points - 1`` candidates). Bytes: us
    (B, N, m), y0 (B, n), the multipliers and penalties (B, N, n_c) each and
    the road (road_points, 2) read; xs (B, N+1, n) and the cost (B,)
    written."""
    ops = B * N * ilqr_stage_ops(substeps, road_points - 1, n_c, m)
    nbytes = F32 * (B * N * m + B * n + 2 * B * N * n_c + 2 * road_points
                    + B * (N + 1) * n + B)
    return Count(ops, nbytes)


def ilqr_derivatives(B: int, N: int, n: int = 6, m: int = 2,
                     substeps: int = 4, road_points: int = 100,
                     n_c: int = 6, n_res: int = 6) -> Count:
    """``IlqrPhases.derivatives``, the Gauss-Newton derivatives in forward
    mode at B N points: the primal pass once (f_d, the ``n_res`` tracking
    residuals at their nearest point, the argmin, the ``n_c`` AL residuals),
    then one tangent pass for each of the n + m directions, counted as the
    primal's operations without the argmin (the least a forward-mode pass
    does; the port runs the primal at every replica too, which this does not
    count); then Q = 2 Jx'Jx, q = 2 Jx'r, R = 2 Ju'Ju, r = 2 Ju'r and P =
    2 Ju'Jx over k = n_res + n_c residuals, each product and its doubling.
    Bytes: xs (B, N+1, n), us (B, N, m), the multipliers and penalties and
    the road read; A (n, n), B (n, m), Q (n, n), q (n), R (m, m), r (m) and
    P (m, n) per point written."""
    primal = lane_stage_ops("pacejka", substeps, al=False) + n_c * AL_OPS
    k = n_res + n_c
    products = (mm(n, k, n) + n * n + mm(n, k, 1) + n + mm(m, k, m) + m * m
                + mm(m, k, 1) + m + mm(m, k, n) + m * n)
    ops = B * N * (primal + ARGMIN_OPS * (road_points - 1)
                   + (n + m) * primal + products)
    out = n * n + n * m + n * n + n + m * m + m + m * n
    nbytes = F32 * (B * (N + 1) * n + B * N * m + 2 * B * N * n_c
                    + 2 * road_points + B * N * out)
    return Count(ops, nbytes)


def ilqr_riccati_sequential(B: int, N: int, n: int = 6,
                            m: int = 2) -> Count:
    """``IlqrPhases.lqt_solve(..., parallel=False)``: per stage, the
    regularised R (m adds), the cross terms' elimination (R^-1 P and R^-1 r,
    two solves; A~, c~, Q~, q~), the gains (B'S, Quu = R + B'S B, the
    solve for K and kff with n + 1 right-hand sides in two solves), the
    value step (Acl = A - B K, S = Q + A'S Acl, v, the symmetrisation),
    the LQT's closed-loop forward pass (u~, u, x), and Ko, ko and max|ko|.
    Bytes: A, B, Q, q, R, r, P (B, N, ...) and reg (B,) read; Ko (B, N, m,
    n), ko (B, N, m) and max|ko| (B,) written."""
    elim = (solve_ops(m, n) + solve_ops(m, 1) + mm(n, m, n) + n * n
            + mm(n, m, 1) + n + mm(n, m, n) + n * n + mm(n, m, 1) + n)
    gains = (mm(m, n, n) + mm(m, n, m) + m * m + mm(m, n, n)
             + solve_ops(m, n) + 2 * mm(m, n, 1) + m + solve_ops(m, 1))
    value = (mm(n, m, n) + n * n + 2 * mm(n, n, n) + n * n
             + 2 * mm(n, n, 1) + 3 * n + 2 * n * n)
    fwd = 2 * mm(m, n, 1) + 4 * m + mm(n, n, 1) + mm(n, m, 1) + 2 * n
    per_stage = m + elim + gains + value + fwd + m * n + m + 2 * m
    ins = n * n + n * m + n * n + n + m * m + m + m * n
    nbytes = F32 * (B * N * ins + B + B * N * (m * n + m) + B)
    return Count(B * N * per_stage, nbytes)


def ilqr_forward_fan(B: int, N: int, n: int = 6, m: int = 2,
                     substeps: int = 4, road_points: int = 100,
                     n_c: int = 6, n_alpha: int = 6) -> Count:
    """``IlqrPhases.forward``: the rollout of every lane under each of
    ``n_alpha`` step sizes, per stage the policy (``policy_ops``, its clamp
    included) and ``ilqr_stage_ops`` without the rollout's clamp. Bytes:
    xs (B, N+1, n), us (B, N, m), Ks (B, N, m, n), kos (B, N, m), the
    multipliers and penalties, the road and the step sizes read; the
    fan's xs (B, a, N+1, n), us (B, a, N, m) and costs (B, a) written."""
    stage = (policy_ops(n, m) - CLAMP_OPS * m
             + ilqr_stage_ops(substeps, road_points - 1, n_c, m))
    ops = n_alpha * B * N * stage
    nbytes = F32 * (B * (N + 1) * n + B * N * m + B * N * (m * n + m)
                    + 2 * B * N * n_c + 2 * road_points + n_alpha
                    + B * n_alpha * ((N + 1) * n + N * m + 1))
    return Count(ops, nbytes)


def launch_ms(fn, n: int = 200, warmup: int = 3) -> float:
    """Device time per call of ``fn``: ``n`` calls captured into one CUDA
    graph, whose replay is timed by CUDA events, over ``n``. The replay
    issues the launches back to back from the card's side, so the time does
    not count the host wrapper's work between launches, which on a slow
    host takes longer than a kernel at E=1 (launched from the host, the
    loop would time the host there)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()      # the first replay uploads the graph
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n
