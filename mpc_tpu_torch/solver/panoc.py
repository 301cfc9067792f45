"""PANOC inner solver with L-BFGS acceleration, lane-batched
(port of mpc_tpu/solver/panoc.py).

The reference solves one lane and is ``vmap``-ed; here every tensor carries a
leading lane axis B and each lane keeps its own L-BFGS ring, step size and
exit counters. The reference's ``lax.while_loop`` becomes a host loop over
chunks of masked iterations with one host sync per chunk (the all-lanes-done
test). Under ``jax.vmap`` a lane whose loop condition is False is frozen by
the batched while-loop itself, so the port computes ``active = cond(state)``
per lane and applies every body update, ``iters += 1`` included, only where
it holds.

The float32 safeguards of the reference are kept exactly: the QUB margin,
the trust-region cap ``tr_mult``, the stall and plateau exits and the
``crit_floor_mult`` stagnation acceptance.
"""

from __future__ import annotations

import ctypes
import functools
import time
from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from mpc_tpu_torch.config import PanocConfig
from mpc_tpu_torch.kernels.build import check_operand
from mpc_tpu_torch.solver.problem import Box, fold_lanes, project
from mpc_tpu_torch.utils.timing import span

#: masked iterations run between two all-lanes-done checks (host syncs)
_CHUNK = 4


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def _where(mask: torch.Tensor, a, b):
    """Per-lane select over (nested) NamedTuples of tensors."""
    if a is None:
        return None
    if isinstance(a, tuple):
        return type(a)(*(_where(mask, x, y) for x, y in zip(a, b)))
    return torch.where(_bcast(mask, a), a, b)


def any_lane(flags: torch.Tensor, group=None) -> bool:
    """Whether any lane's flag holds (a host sync). With ``group``, the
    process group of the ranks that hold the same lanes (a sharded solve's
    model or horizon axis), whether it holds on any of them: one scalar
    ``all_reduce(MAX)``, so that the ranks run the same number of trips
    through a masked loop whose body communicates over the group, and no
    collective pairs up with another rank's different one."""
    if group is None:
        return bool(flags.any())
    flag = flags.any().to(torch.int32).reshape(1)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return bool(flag)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=-1)


# ---------------------------------------------------------------------------
# L-BFGS ring buffer, one per lane
# ---------------------------------------------------------------------------

class LbfgsState(NamedTuple):
    S: torch.Tensor       # (B, M, n) steps s_k
    Y: torch.Tensor       # (B, M, n) residual differences y_k
    rho: torch.Tensor     # (B, M)    1 / (s_k . y_k)
    valid: torch.Tensor   # (B, M)    bool
    head: torch.Tensor    # (B,)      next write slot (int64)


def lbfgs_init(batch: int, memory: int, n: int, device=None,
               dtype=torch.float32) -> LbfgsState:
    return LbfgsState(
        S=torch.zeros((batch, memory, n), dtype=dtype, device=device),
        Y=torch.zeros((batch, memory, n), dtype=dtype, device=device),
        rho=torch.zeros((batch, memory), dtype=dtype, device=device),
        valid=torch.zeros((batch, memory), dtype=torch.bool, device=device),
        head=torch.zeros((batch,), dtype=torch.int64, device=device),
    )


def lbfgs_flush(st: LbfgsState) -> LbfgsState:
    return st._replace(valid=torch.zeros_like(st.valid),
                       head=torch.zeros_like(st.head))


def lbfgs_push(st: LbfgsState, s: torch.Tensor, y: torch.Tensor,
               min_step=0.0) -> LbfgsState:
    """Insert each lane's curvature pair at its own head slot; a lane whose
    pair fails the curvature test (or whose step is below ``min_step``)
    keeps its ring unchanged (mpc_tpu/solver/panoc.py:66-86)."""
    sy = _dot(s, y)
    sn = torch.linalg.vector_norm(s, dim=-1)
    good = (sy > 1e-10 * sn * torch.linalg.vector_norm(y, dim=-1)) \
        & (sn > min_step)
    safe_sy = torch.where(good, sy, torch.ones_like(sy))
    lanes = torch.arange(s.shape[0], device=s.device)
    h = st.head
    S, Y, rho, valid = (st.S.clone(), st.Y.clone(), st.rho.clone(),
                        st.valid.clone())
    S[lanes, h] = torch.where(good[:, None], s, st.S[lanes, h])
    Y[lanes, h] = torch.where(good[:, None], y, st.Y[lanes, h])
    rho[lanes, h] = torch.where(good, 1.0 / safe_sy, st.rho[lanes, h])
    valid[lanes, h] = good | st.valid[lanes, h]
    head = torch.where(good, (h + 1) % st.S.shape[1], h)
    return LbfgsState(S, Y, rho, valid, head)


def lbfgs_direction(st: LbfgsState, q: torch.Tensor) -> torch.Tensor:
    """Two-loop recursion per lane: ``d = -H q`` (mpc_tpu/solver/panoc.py:89-110)."""
    M = st.S.shape[1]
    lanes = torch.arange(q.shape[0], device=q.device)
    alphas = []
    for j in range(M):                       # newest -> oldest
        i = (st.head - 1 - j) % M
        m = st.valid[lanes, i]
        s_i, y_i, rho_i = st.S[lanes, i], st.Y[lanes, i], st.rho[lanes, i]
        mf = m.to(q.dtype)
        a = torch.where(m, rho_i * _dot(s_i, q), torch.zeros_like(rho_i))
        q = q - (a * mf)[:, None] * y_i
        alphas.append((s_i, y_i, rho_i, m, mf, a))

    i0 = (st.head - 1) % M
    s0, y0 = st.S[lanes, i0], st.Y[lanes, i0]
    yy = _dot(y0, y0)
    sy = _dot(s0, y0)
    h0 = torch.where(st.valid[lanes, i0] & (yy > 0),
                     sy / torch.clamp(yy, min=1e-30), torch.ones_like(yy))
    q = q * h0[:, None]

    for s_i, y_i, rho_i, m, mf, a in reversed(alphas):   # oldest -> newest
        b = torch.where(m, rho_i * _dot(y_i, q), torch.zeros_like(rho_i))
        q = q + ((a - b) * mf)[:, None] * s_i
    return -q


# ---------------------------------------------------------------------------
# The direction and the candidates: one kernel on the card
# ---------------------------------------------------------------------------

#: what the direction kernel's entry returns for a shape outside its limits
_CUDA_ERROR_INVALID_VALUE = 1


class Direction(NamedTuple):
    """What a trip's acceptance needs of its direction (B lanes, n inputs,
    T taus)."""
    cands: torch.Tensor   # (B, 1 + T, n): u_hat, then u - (1 - tau) r + tau d
    r: torch.Tensor       # (B, n) u - u_hat, the projected step's residual
    rn2: torch.Tensor     # (B,) r . r
    crit: torch.Tensor    # (B,) ||r|| / gamma
    fmask: torch.Tensor   # (B, n) 1.0 on the free coordinates, else 0.0


def direction_reference(u: torch.Tensor, g_u: torch.Tensor,
                        gamma: torch.Tensor, C: Box, lbfgs: LbfgsState,
                        tr_mult: float, taus: Sequence[float]) -> Direction:
    """The plain PyTorch version of :func:`direction`: the projected step,
    the residual and criterion, the structured L-BFGS step on the free
    coordinates under the trust cap, and the candidate fan's inputs
    (mpc_tpu/solver/panoc.py:241-281). The CPU path and the oracle the
    kernel is held to."""
    gc = gamma[:, None]
    fw = u - gc * g_u
    u_hat = project(fw, C)
    r = u - u_hat
    rn2 = _dot(r, r)
    crit = torch.sqrt(rn2) / gamma
    # Structured step: quasi-Newton only on the free coordinates.
    free = (fw > C.lower) & (fw < C.upper)
    fmask = free.to(u.dtype)
    d_free = lbfgs_direction(lbfgs, r * fmask)
    # Trust-region cap against noise-poisoned curvature pairs.
    dn = torch.linalg.vector_norm(d_free, dim=-1)
    cap = tr_mult * torch.sqrt(rn2)
    d_free = d_free * torch.clamp(
        cap / torch.clamp(dn, min=1e-30), max=1.0)[:, None]
    d = torch.where(free, d_free, -r)
    # Candidate fan: x_hat (tau=0) plus the tau grid.
    cands = torch.stack([u_hat] + [u - (1.0 - t) * r + t * d for t in taus],
                        dim=1)
    return Direction(cands, r, rn2, crit, fmask)


@functools.lru_cache(maxsize=8)
def _taus_arrays(taus: tuple):
    """The taus as the kernel takes them: ``(1 - tau)`` and ``tau``, each
    rounded to float32 from the Python float as PyTorch rounds a scalar."""
    arr = ctypes.c_float * max(1, len(taus))
    return arr(*(1.0 - t for t in taus)), arr(*taus)


def direction(u: torch.Tensor, g_u: torch.Tensor, gamma: torch.Tensor,
              C: Box, lbfgs: LbfgsState, tr_mult: float,
              taus: Sequence[float]) -> Direction:
    """A trip's direction and candidates for every lane: u, g_u (B, n),
    gamma (B,), the box C (n,), the L-BFGS ring ``lbfgs``, the trust cap's
    ``tr_mult`` and the ``taus``.

    On a CUDA ``u`` it launches the hand-written kernel
    (``csrc/panoc_direction.cu``), one launch for the whole block, and
    raises on an operand of another device, dtype (the kernel is float32),
    shape or layout, or a shape outside the limits its entry
    ``mpc_panoc_direction`` states; there is no fallback on the card. On
    the CPU it is :func:`direction_reference`. ``launches`` counts the
    kernel's launches.
    """
    if not (isinstance(u, torch.Tensor) and u.is_cuda):
        return direction_reference(u, g_u, gamma, C, lbfgs, tr_mult, taus)
    if u.dim() != 2:
        raise ValueError("direction: u must be a 2-D tensor (B, n)")
    B, n = u.shape
    M = lbfgs.S.shape[1] if lbfgs.S.dim() == 3 else -1
    dev, f32 = u.device, torch.float32
    taus = tuple(float(t) for t in taus)
    for name, t, shape, dtype in (
            ("u", u, (B, n), f32), ("g_u", g_u, (B, n), f32),
            ("gamma", gamma, (B,), f32), ("C.lower", C.lower, (n,), f32),
            ("C.upper", C.upper, (n,), f32), ("S", lbfgs.S, (B, M, n), f32),
            ("Y", lbfgs.Y, (B, M, n), f32), ("rho", lbfgs.rho, (B, M), f32),
            ("valid", lbfgs.valid, (B, M), torch.bool),
            ("head", lbfgs.head, (B,), torch.int64)):
        check_operand("direction", name, t, shape, dev, dtype)

    out = Direction(
        cands=torch.empty((B, 1 + len(taus), n), dtype=f32, device=dev),
        r=torch.empty((B, n), dtype=f32, device=dev),
        rn2=torch.empty((B,), dtype=f32, device=dev),
        crit=torch.empty((B,), dtype=f32, device=dev),
        fmask=torch.empty((B, n), dtype=f32, device=dev))
    if B == 0:
        return out
    from mpc_tpu_torch.kernels.build import load_panoc_direction
    lib = load_panoc_direction()
    one_minus, tau = _taus_arrays(taus)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mpc_panoc_direction(
            u.data_ptr(), g_u.data_ptr(), gamma.data_ptr(),
            C.lower.data_ptr(), C.upper.data_ptr(), lbfgs.S.data_ptr(),
            lbfgs.Y.data_ptr(), lbfgs.rho.data_ptr(), lbfgs.valid.data_ptr(),
            lbfgs.head.data_ptr(), *(t.data_ptr() for t in out), B, n, M,
            tr_mult, one_minus, tau, len(taus), stream)
    if rc == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"direction: the kernel does not take B={B}, n={n}, "
                         f"L-BFGS memory {M} and {len(taus)} taus (see the "
                         f"limits of mpc_panoc_direction in "
                         f"csrc/panoc_direction.cu)")
    if rc != 0:
        raise RuntimeError(f"direction: CUDA kernel launch failed with "
                           f"cudaError {rc}")
    direction.launches += 1
    return out


#: kernel launches since the count was last reset
direction.launches = 0


# ---------------------------------------------------------------------------
# PANOC
# ---------------------------------------------------------------------------

class PanocTrace(NamedTuple):
    """Per-iterate history (``PanocConfig.trace=True``): (B, max_iter)
    buffers; entries past ``iterations`` stay NaN."""
    psi: torch.Tensor
    criterion: torch.Tensor
    gamma: torch.Tensor


class SolveStats(NamedTuple):
    """Host counters of one solve, kept whether or not anything traces:
    ``trips``, the masked iterations the loop ran over the whole batch
    (``_CHUNK`` a chunk, however few lanes were still active); ``loop_s``,
    host seconds from the solve's entry to its return; ``sync_wait_s``,
    host seconds inside the all-lanes-done checks, blocked on the device;
    ``outer_passes``, the ALM outer loop's passes (``solver/alm.py``: 1 on
    its fast path; None on a bare PANOC solve).
    """
    trips: int
    loop_s: float
    sync_wait_s: float
    outer_passes: Optional[int] = None


class PanocResult(NamedTuple):
    u: torch.Tensor           # (B, n)
    psi: torch.Tensor         # (B,)
    converged: torch.Tensor   # (B,) bool
    iterations: torch.Tensor  # (B,) int32
    criterion: torch.Tensor   # (B,) final ||r||/gamma (ProjGradNorm2)
    gamma: torch.Tensor       # (B,) final step size, the warm-start carry
    trace: Any = None
    stats: Optional[SolveStats] = None


class _State(NamedTuple):
    u: torch.Tensor
    psi: torch.Tensor
    grad: torch.Tensor
    gamma: torch.Tensor
    lbfgs: LbfgsState
    iters: torch.Tensor
    converged: torch.Tensor
    criterion: torch.Tensor
    stalled: torch.Tensor
    best_crit: torch.Tensor
    plateau: torch.Tensor
    trace: Any = None


def candidate_fan(psi_vg: Callable, cands: torch.Tensor, args: Any,
                  graphs: Optional[dict] = None):
    """``(psi (B, K), grad (B, K, n))`` of ``psi_vg`` at the candidates
    ``cands`` (B, K, n) in one call over B*K lanes, lane b's K candidates
    in a row, with the per-lane tensors of ``args`` repeated K times
    (``problem.fold_lanes``). On a CUDA device, with ``graphs`` (a dict the
    caller keeps), the call is replayed from a CUDA graph of it, one per
    shape of its inputs (:class:`_FanGraph`)."""
    B, K, n = cands.shape
    flat, fargs = cands.reshape(B * K, n), fold_lanes(args, K)
    if graphs is None or not cands.is_cuda:
        psi, grad = psi_vg(flat, fargs)
    else:
        leaves, spec = _flatten(fargs)
        key = (tuple(flat.shape), spec,
               tuple((tuple(t.shape), t.dtype) for t in leaves))
        graph = graphs.get(key)
        if graph is None:
            graph = graphs[key] = _FanGraph(psi_vg, flat, leaves, spec)
        psi, grad = graph(flat, leaves)
    return psi.reshape(B, K), grad.reshape(B, K, n)


def _flatten(tree):
    """``(tensors, spec)``: the tensors of a tree of dicts, tuples and
    lists in order, and the tree with each tensor replaced by None (its
    other leaves, e.g. the vehicle parameters, kept: they key the graph)."""
    if torch.is_tensor(tree):
        return [tree], None
    if isinstance(tree, dict):
        leaves, items = [], []
        for key, v in tree.items():
            sub, spec = _flatten(v)
            leaves += sub
            items.append((key, spec))
        return leaves, ("dict", tuple(items))
    if isinstance(tree, (tuple, list)):
        leaves, specs = [], []
        for v in tree:
            sub, spec = _flatten(v)
            leaves += sub
            specs.append(spec)
        return leaves, (type(tree), tuple(specs))
    return [], ("leaf", tree)


def _unflatten(spec, leaves):
    if spec is None:
        return next(leaves)
    kind, body = spec
    if kind == "dict":
        return {key: _unflatten(sub, leaves) for key, sub in body}
    if kind == "leaf":
        return body
    return kind(_unflatten(sub, leaves) for sub in body)


class _FanGraph:
    """The unfused fan ``psi_vg(u, args)`` (its rollouts, stage costs and
    autograd's reverse sweep: some 10^4 small kernels) captured once into a
    CUDA graph over static copies of its inputs, then replayed: the inputs
    are copied in, the graph replayed, the outputs copied out. The graph
    runs the same kernels as the eager call on the same values, so its
    outputs are the eager call's; it only spares the host their launches."""

    def __init__(self, psi_vg: Callable, u: torch.Tensor, leaves, spec):
        self.u = u.clone()
        self.leaves = [t.clone() for t in leaves]
        args = _unflatten(spec, iter(self.leaves))
        side = torch.cuda.Stream(u.device)
        side.wait_stream(torch.cuda.current_stream(u.device))
        with torch.cuda.stream(side):
            for _ in range(2):           # warm-up, outside the capture
                psi_vg(self.u, args)
        torch.cuda.current_stream(u.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.psi, self.grad = psi_vg(self.u, args)

    def __call__(self, u: torch.Tensor, leaves):
        self.u.copy_(u)
        for dst, src in zip(self.leaves, leaves):
            dst.copy_(src)
        self.graph.replay()
        return self.psi.clone(), self.grad.clone()


def make_panoc_solver(psi_vg: Callable, C: Box, cfg: PanocConfig,
                      psi_vg_multi: Optional[Callable] = None,
                      progress_callback: Optional[Callable] = None,
                      group=None) -> Callable:
    """Build ``solve(u0 (B, n), tol, args, gamma_init=None) -> PanocResult``.

    ``psi_vg(u (B, n), args) -> (psi (B,), grad (B, n))`` is the value and
    gradient of the smooth objective. ``psi_vg_multi(cands (B, K, n), args)
    -> (psi (B, K), grad (B, K, n))``, when given, evaluates the candidate
    fan in one call (the fused kernel); otherwise it is
    :func:`candidate_fan`, one call of ``psi_vg`` over B*K lanes, the port
    of ``jax.vmap(psi_vg)`` over the candidates
    (mpc_tpu/solver/panoc.py:178-179), replayed from a CUDA graph on the
    card. ``progress_callback(iters, psi,
    criterion, gamma)`` is called on the host after every masked iteration
    with (B,) tensors.

    ``group``: the process group of the ranks that hold the same lanes and
    whose cost communicates over it (the model axis of
    ``parallel/sharding.py``); the all-lanes-done test is then reduced over
    it (:func:`any_lane`). A fan that communicates runs eager: gloo's
    collectives cannot be captured into a CUDA graph, and NCCL's capture
    has not been run on several cards. ``solve.fan_graph`` says whether the
    plain fan is captured (False also where the fan is ``psi_vg_multi``).
    """
    fan_graph = psi_vg_multi is None and group is None
    if psi_vg_multi is not None:
        cand_vg = psi_vg_multi
    else:
        graphs = {} if fan_graph else None

        def cand_vg(cands, args):
            return candidate_fan(psi_vg, cands, args, graphs)

    taus = tuple(float(t) for t in cfg.taus)

    def fbe(u_c, psi_c, grad_c, gamma):
        """Forward-backward envelope at each candidate; gamma is (B,)."""
        g = gamma[:, None, None]
        diff = project(u_c - g * grad_c, C) - u_c
        return psi_c + _dot(grad_c, diff) + _dot(diff, diff) / (2.0 * gamma[:, None])

    def cond(st: _State) -> torch.Tensor:
        return (~st.converged) & (st.iters < cfg.max_iter) \
            & (st.stalled < 3) & (st.plateau < cfg.plateau_iters)

    def solve(u0: torch.Tensor, tol, args, gamma_init=None) -> PanocResult:
        t_entry = time.perf_counter()
        dtype, device = u0.dtype, u0.device
        B = u0.shape[0]
        lanes = torch.arange(B, device=device)
        eps_f = torch.finfo(dtype).eps
        tol = torch.as_tensor(tol, dtype=dtype, device=device)
        with span("panoc.init"):
            u0 = project(u0, C)

            # Initial step size from a finite-difference Lipschitz
            # estimate; both points go through the candidate-fan evaluator
            # in one call.
            h = 1e-4 * (1.0 + torch.abs(u0))
            psis0, grads0 = cand_vg(torch.stack([u0, u0 + h], dim=1), args)
            # g0 contiguous: the direction kernel takes whole rows
            psi0, g0, g_h = psis0[:, 0], grads0[:, 0].contiguous(), \
                grads0[:, 1]
            L0 = torch.linalg.vector_norm(g_h - g0, dim=-1) / torch.clamp(
                torch.linalg.vector_norm(h, dim=-1), min=1e-30)
            L0 = torch.clamp(L0, 1e-8, 1e15)
            gamma0 = cfg.alpha / L0
            if gamma_init is not None:
                gamma_init = gamma_init.to(dtype)
                g_warm = torch.clamp(gamma_init, min=gamma0 / 64.0,
                                     max=gamma0)
                gamma0 = torch.where(gamma_init > 0, g_warm, gamma0)

            tr0 = None
            if cfg.trace:
                nanbuf = torch.full((B, cfg.max_iter), float("nan"),
                                    dtype=dtype, device=device)
                tr0 = PanocTrace(nanbuf, nanbuf.clone(), nanbuf.clone())
            izero = torch.zeros((B,), dtype=torch.int32, device=device)
            inf = torch.full((B,), float("inf"), dtype=dtype, device=device)
            st = _State(
                u=u0, psi=psi0, grad=g0, gamma=gamma0,
                lbfgs=lbfgs_init(B, cfg.lbfgs_memory, u0.shape[1], device,
                                 dtype),
                iters=izero, converged=torch.zeros((B,), dtype=torch.bool,
                                                   device=device),
                criterion=inf, stalled=izero, best_crit=inf, plateau=izero,
                trace=tr0)

        def body(st: _State) -> _State:
            u, psi_u, g_u, gamma = st.u, st.psi, st.grad, st.gamma
            gc = gamma[:, None]

            with span("panoc.direction"):
                cands, r, rn2, crit, fmask = direction(
                    u, g_u, gamma, C, st.lbfgs, cfg.tr_mult, taus)
                conv_now = crit <= tol

                tr = st.trace
                if cfg.trace:
                    k = torch.clamp(st.iters.long(), max=cfg.max_iter - 1)
                    bufs = []
                    for buf, val in zip(tr, (psi_u, crit, gamma)):
                        buf = buf.clone()
                        buf[lanes, k] = val
                        bufs.append(buf)
                    tr = PanocTrace(*bufs)
                if progress_callback is not None:
                    progress_callback(st.iters, psi_u, crit, gamma)
            with span("panoc.fan"):
                # the candidate fan in one call
                psis, grads = cand_vg(cands, args)
            with span("panoc.accept"):
                psi_hat = psis[:, 0]

                # Quadratic upper bound with an f32 rounding margin.
                margin = 10.0 * eps_f * (torch.abs(psi_u)
                                         + torch.abs(psi_hat)) + 1e-12
                qub_rhs = psi_u - _dot(g_u, r) + rn2 / (2.0 * gamma) + margin
                gamma_ok = (psi_hat <= qub_rhs) | (gamma <= cfg.gamma_min)

                # branch A: halve gamma, flush history, stay put
                st_shrink = st._replace(gamma=gamma * 0.5,
                                        lbfgs=lbfgs_flush(st.lbfgs))

                # branch B: take the best candidate by FBE
                phis = fbe(cands, psis, grads, gamma)
                phis = torch.where(torch.isnan(phis),
                                   torch.full_like(phis, float("inf")), phis)
                best = torch.argmin(phis, dim=1)
                u_n, psi_n, g_n = cands[lanes, best], psis[lanes, best], \
                    grads[lanes, best]

                r_n = u_n - project(u_n - gc * g_n, C)
                min_step = cfg.lbfgs_min_step_mult * eps_f \
                    * (1.0 + torch.linalg.vector_norm(u, dim=-1))
                lb_n = lbfgs_push(st.lbfgs, (u_n - u) * fmask,
                                  (r_n - r) * fmask, min_step=min_step)
                moved = (u_n != u).any(dim=-1)
                st_step = st._replace(
                    u=u_n, psi=psi_n, grad=g_n, lbfgs=lb_n,
                    stalled=torch.where(moved, torch.zeros_like(st.stalled),
                                        st.stalled + 1))

                improved = crit < st.best_crit * 0.999
                st_new = _where(gamma_ok, st_step, st_shrink)
                st_new = st_new._replace(
                    iters=st.iters + 1,
                    criterion=torch.minimum(st.criterion, crit),
                    best_crit=torch.minimum(st.best_crit, crit),
                    plateau=torch.where(improved,
                                        torch.zeros_like(st.plateau),
                                        st.plateau + 1),
                    trace=tr)
                # a lane that converges now is frozen with its criterion
                st_done = st._replace(converged=torch.ones_like(st.converged),
                                      criterion=crit, trace=tr)
                return _where(conv_now, st_done, st_new)

        # the host counts the trips (never ``body``) and times the checks
        trips, sync_wait_s = 0, 0.0
        while True:
            active = cond(st)
            t0 = time.perf_counter()
            with span("panoc.sync"):
                more = any_lane(active, group)
            sync_wait_s += time.perf_counter() - t0
            if not more:
                break
            with span("panoc.chunk"):
                for _ in range(_CHUNK):
                    active = cond(st)
                    st = _where(active, body(st), st)
            trips += _CHUNK

        # Final criterion refresh (covers the max_iter/stagnation exits) and
        # the f32-aware stagnation acceptance (mpc_tpu/solver/panoc.py:341-356).
        with span("panoc.final"):
            u_hat = project(st.u - st.gamma[:, None] * st.grad, C)
            crit = torch.linalg.vector_norm(st.u - u_hat, dim=-1) / st.gamma
            floor = cfg.crit_floor_mult * eps_f \
                * (1.0 + torch.linalg.vector_norm(st.u, dim=-1)) / st.gamma
            exhausted = (st.stalled >= 3) | (st.plateau >= cfg.plateau_iters)
            at_floor = exhausted & (crit <= floor)
            converged = st.converged | (crit <= tol) | at_floor
        return PanocResult(
            u=st.u, psi=st.psi, converged=converged,
            iterations=st.iters, criterion=crit, gamma=st.gamma,
            trace=st.trace,
            stats=SolveStats(trips, time.perf_counter() - t_entry,
                             sync_wait_s))

    solve.fan_graph = fan_graph
    return solve
