"""Hold a kernel's outputs against its plain PyTorch version: the fan
kernels (:func:`compare_fan`) and PANOC's direction (:func:`compare_direction`).

A lane passes when its psi and every gradient entry lie within the bar of
the plain version on the same inputs (``|got - ref| <= atol + rtol |ref|``
per entry; for the augmented-Lagrangian variant K3 the gradient's bar also
has a term of ``AL_LANE_RTOL`` times the lane's largest entry, see below).
Where a candidate lies far outside the input box (a car braked to a stop,
spun round, or steered to where tan(delta) blows up), ``atan2(., vx)``,
``sign(v)`` and ``tan`` make the gradient ill-conditioned, and two correct
float32 evaluations of it can differ beyond that bar. So a lane beyond the
bar is held, with the plain version's f32 result, against the plain version
of the same variant (model and augmented-Lagrangian term) run in float64 on
the same inputs, which is exact to f32 precision. If the f32 plain version
is itself beyond the bar of float64, no f32 evaluation can be held to the
bar on that lane: it is *ill-conditioned*, and excused, as is a lane where
the kernel is within the bar of float64. A lane where the plain version
meets the bar against float64 and the kernel does not is a failure.

K3's lane term. Its penalties put terms of sigma x 2 x_i (1e4 at sigma =
1e3, far more at sigma_max = 1e9) into the adjoint of every earlier stage,
where they cancel down to gradient entries of order 1. Every f32
evaluation of such an entry, the kernel's and autograd's alike, carries
rounding of a few ulp of the lane's largest entry, and whether it lands
inside ``rtol |ref_i|`` of float64 is chance: on a drawn in-box lane
(sigma <= 1e3, largest entry 1.1e4) the kernel missed that bar by an
error of 2e-3 on a small entry while autograd met it. Measured on an
NVIDIA H100 (N=40, 1280 drawn in-box lanes per penalty range, multipliers
in [0, 2]), the least lane term (:func:`lane_term_needed`) each lane needs
against float64 is, for sigma log-uniform over [1e-1, 1e3] and [1e3, 1e9]:
autograd's f32 gradient at most 8.4e-6 and 5.9e-3 (99th percentile 5.9e-6
and 4.3e-4), the kernel 8.9e-6 and 5.9e-3 (the same percentiles to two
digits), and no lane where the kernel needs more than 1e-6 and autograd
does not. The kernel against autograd needs at most 8.2e-8 and 6.5e-8 on
those lanes, and 1.7e-6 over the 56,832 lanes of 54 fans captured from the
ss_n40 path. So the term is 1e-6 (about 8 ulp of the lane's largest
entry): the rounding of a correct f32 evaluation at the lane's scale, no
more. A gradient entry of 1e-3 of the lane's scale that is off by 1% still
fails.
"""

from __future__ import annotations

import numpy as np
import torch

from mpc_tpu_torch.ops import fused_psi as fp
from mpc_tpu_torch.solver import panoc
from mpc_tpu_torch.solver.problem import Box

#: K3's gradient bar: this multiple of each lane's largest gradient entry is
#: added to the per-entry bar (see the module docstring for the readings)
AL_LANE_RTOL = 1e-6


def _excess(got, ref, rtol, atol, lane_rtol=0.0):
    """Per lane: the largest ``|got - ref| / bar``; > 1 (or NaN) is beyond
    the bar ``atol + rtol |ref| + lane_rtol max |ref|``."""
    E = got.shape[0]
    scale = ref.abs().reshape(E, -1)
    bar = atol + rtol * scale
    if lane_rtol:
        bar = bar + lane_rtol * scale.amax(dim=1, keepdim=True)
    r = (got - ref).abs().reshape(E, -1) / bar
    return r.nan_to_num(nan=float("inf")).amax(dim=1)


def lane_term_needed(got, ref, rtol, atol):
    """Per lane: the least multiple of its largest ``|ref|`` entry that,
    added to the per-entry bar ``atol + rtol |ref|``, puts every entry of
    ``got`` within the bar."""
    E = got.shape[0]
    scale = ref.abs().reshape(E, -1)
    over = ((got - ref).abs().reshape(E, -1) - atol - rtol * scale)
    need = over.clamp(min=0).amax(dim=1) \
        / scale.amax(dim=1).clamp(min=torch.finfo(scale.dtype).tiny)
    return need.nan_to_num(nan=float("inf"))


def compare_fan(psi, grad, u, y0, cltab, pvec, n_horiz, substeps, h, v_ref,
                weights, psi_tol, grad_tol, chunk=65536, model="pacejka",
                al=None) -> dict:
    """Compare a kernel's ``psi (E,)`` and ``grad (E, 2N)`` on inputs
    ``u, y0`` with the plain version of the same variant, ``chunk`` lanes at
    a time. ``model`` and ``al = (lam (E, m), sigma (E, m), offsets, d_lo,
    d_up)`` are those of :func:`fp.fan_value_and_grad_reference`, and so
    is a (R, S-1, 6) ``cltab`` of per-lane roads. With ``al``, the
    gradient's bar gains ``AL_LANE_RTOL`` times the lane's largest entry.

    Returns the counts of lanes (``lanes``, ``beyond_bar``, ``excused``,
    ``failed``), the largest absolute errors over all lanes
    (``max_abs_err_psi``, ``max_abs_err_grad``) and over the lanes within the
    bar (``max_abs_err_within_bar``), the largest error relative to the
    lane's scale over the lanes within the bar (``max_rel_err_within_bar``:
    ``|d psi| / |psi|`` and ``max |d grad| / max |grad|`` per lane), the
    largest lane term those lanes needed on top of the per-entry bar
    (``lane_term_needed``, see :func:`lane_term_needed`), and the least
    factor by which the f32 plain version misses float64's bar on an
    excused lane (``excused_plain_miss_min``).
    """
    args = (n_horiz, substeps, h, v_ref, weights)
    gtol = dict(grad_tol, lane_rtol=AL_LANE_RTOL if al is not None else 0.0)

    per_lane = cltab.dim() == 3
    if per_lane:
        # each lane's own table, so that any subset of lanes keeps its roads
        cltab = fp._lane_tables(cltab, u.shape[0])

    def lanes_cl(s):
        """The table of the lanes ``s``: one road each, or the shared one."""
        return cltab[s] if per_lane else cltab

    def lanes_al(s):
        """The AL operands of the lanes ``s`` (an index or a slice)."""
        if al is None:
            return None
        lam, sigma, *consts = al
        return (lam[s], sigma[s], *consts)

    beyond, e_psi, e_grad, e_in, e_rel, need = [], 0.0, 0.0, 0.0, 0.0, 0.0
    for a in range(0, u.shape[0], chunk):
        s = slice(a, a + chunk)
        psi_r, grad_r = fp.fan_value_and_grad_reference(
            u[s], y0[s], lanes_cl(s), pvec, *args, model=model,
            al=lanes_al(s))
        d_psi, d_grad = (psi[s] - psi_r).abs(), (grad[s] - grad_r).abs()
        e_psi = max(e_psi, float(d_psi.max()))
        e_grad = max(e_grad, float(d_grad.max()))
        over = torch.maximum(_excess(psi[s], psi_r, **psi_tol),
                             _excess(grad[s], grad_r, **gtol)) > 1.0
        ok = ~over
        if bool(ok.any()):
            e_in = max(e_in, float(d_psi[ok].max()),
                       float(d_grad[ok].max()))
            tiny = torch.finfo(psi.dtype).tiny
            rel = torch.maximum(
                d_psi / psi_r.abs().clamp(min=tiny),
                d_grad.amax(dim=1) / grad_r.abs().amax(dim=1).clamp(min=tiny))
            e_rel = max(e_rel, float(rel[ok].max()))
            need = max(need, float(lane_term_needed(
                grad[s][ok], grad_r[ok], grad_tol["rtol"],
                grad_tol["atol"]).max()))
        if bool(over.any()):
            idx = over.nonzero().squeeze(1)
            beyond.append((a + idx, psi_r[idx], grad_r[idx]))

    excused, failed, miss = 0, 0, 0.0
    if beyond:
        idx = torch.cat([b[0] for b in beyond])
        psi_r = torch.cat([b[1] for b in beyond])
        grad_r = torch.cat([b[2] for b in beyond])
        al64 = lanes_al(idx)
        if al64 is not None:
            al64 = tuple(t.double() for t in al64)
        psi_x, grad_x = fp.fan_value_and_grad_reference(
            u[idx].double(), y0[idx].double(), lanes_cl(idx).double(),
            pvec.double(), *args, model=model, al=al64)

        def dist(p32, g32):
            return torch.maximum(_excess(p32.double(), psi_x, **psi_tol),
                                 _excess(g32.double(), grad_x, **gtol))

        d_kernel, d_plain = dist(psi[idx], grad[idx]), dist(psi_r, grad_r)
        ok = (d_kernel <= 1.0) | (d_plain > 1.0)
        excused, failed = int(ok.sum()), int((~ok).sum())
        if excused:
            miss = float(d_plain[ok].min())
    return {"lanes": int(u.shape[0]),
            "beyond_bar": excused + failed, "excused": excused,
            "failed": failed, "max_abs_err_psi": e_psi,
            "max_abs_err_grad": e_grad, "max_abs_err_within_bar": e_in,
            "max_rel_err_within_bar": e_rel, "lane_term_needed": need,
            "excused_plain_miss_min": miss}


#: the direction's bar per entry. r, fmask and u_hat = cands[:, 0] are
#: elementwise and equal the plain version's bits; rn2, crit and the
#: L-BFGS candidates follow dots summed in another order, which a
#: well-conditioned ring moves by a few ulp (1e-7), a wrong slot or sign
#: by order 1
DIRECTION_TOL = dict(rtol=1e-4, atol=1e-5)


def _direction_rows(out) -> torch.Tensor:
    """A direction's outputs, one row of every entry per lane."""
    B = out.r.shape[0]
    return torch.cat([out.cands.reshape(B, -1), out.r, out.rn2[:, None],
                      out.crit[:, None], out.fmask], dim=1)


def _excess_nan(got, ref, rtol, atol):
    """:func:`_excess` with a NaN where the reference has one counted as
    met: a NaN gradient stays NaN."""
    both = torch.isnan(got) & torch.isnan(ref)
    return _excess(torch.where(both, 0.0, got), torch.where(both, 0.0, ref),
                   rtol, atol)


def compare_direction(got, u, g_u, gamma, C: Box, lbfgs, tr_mult, taus,
                      tol=DIRECTION_TOL) -> dict:
    """Compare the kernel's :class:`panoc.Direction` ``got`` on the inputs
    of :func:`panoc.direction` with the plain version on the same inputs,
    by the rule of :func:`compare_fan`: a lane beyond the bar is held, with
    the plain version's float32 result, against the plain version in
    float64, and fails only where the plain float32 version meets float64's
    bar and the kernel does not. A NaN entry must be NaN in both.

    Returns the counts of lanes (``lanes``, ``beyond_bar``, ``excused``,
    ``failed``), of entries NaN in one version alone (``nan_mismatch``),
    whether ``r``, ``fmask`` and ``cands[:, 0]`` equal the plain version's
    bits (``elementwise_equal``), and the largest absolute error of the
    lanes within the bar (``max_abs_err_within_bar``)."""
    ref = panoc.direction_reference(u, g_u, gamma, C, lbfgs, tr_mult, taus)
    rows, rows_r = _direction_rows(got), _direction_rows(ref)
    nan_mismatch = int((torch.isnan(rows) != torch.isnan(rows_r)).sum())
    elementwise_equal = all(
        torch.equal(torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))
        and torch.equal(torch.isnan(a), torch.isnan(b))
        for a, b in ((got.r, ref.r), (got.fmask, ref.fmask),
                     (got.cands[:, 0], ref.cands[:, 0])))
    over = _excess_nan(rows, rows_r, **tol) > 1.0
    ok = ~over
    err = (rows - rows_r).abs().nan_to_num(nan=0.0)
    e_in = float(err[ok].max()) if bool(ok.any()) else 0.0
    excused = failed = 0
    if bool(over.any()):
        idx = over.nonzero().squeeze(1)
        lb64 = type(lbfgs)(lbfgs.S[idx].double(), lbfgs.Y[idx].double(),
                           lbfgs.rho[idx].double(), lbfgs.valid[idx],
                           lbfgs.head[idx])
        ref64 = _direction_rows(panoc.direction_reference(
            u[idx].double(), g_u[idx].double(), gamma[idx].double(),
            Box(C.lower.double(), C.upper.double()), lb64, tr_mult, taus))
        d_kernel = _excess_nan(rows[idx].double(), ref64, **tol)
        d_plain = _excess_nan(rows_r[idx].double(), ref64, **tol)
        good = (d_kernel <= 1.0) | (d_plain > 1.0)
        excused, failed = int(good.sum()), int((~good).sum())
    return {"lanes": int(u.shape[0]), "beyond_bar": excused + failed,
            "excused": excused, "failed": failed,
            "nan_mismatch": nan_mismatch,
            "elementwise_equal": elementwise_equal,
            "max_abs_err_within_bar": e_in}


#: the ring states of :func:`drawn_direction_inputs`, given to the lanes in
#: turn: no pair yet; the first k slots filled, head at k; every slot
#: filled, head anywhere (the ring wrapped); a random set of slots valid,
#: the others holding stale pairs a thousand times larger
RING_KINDS = ("empty", "partial", "wrapped", "mixed")


def drawn_direction_inputs(B: int, n: int, M: int, seed: int, device=None,
                           bounded: bool = True, kinds=RING_KINDS,
                           nan_lanes=()):
    """Inputs of :func:`panoc.direction` drawn from ``seed``: ``(u, g_u,
    gamma, C, lbfgs)``. u in [-1.2, 1.2] and the box [-1, 1] (``bounded``;
    else unbounded), so that the projection is active on some coordinates;
    gamma log-uniform over [1e-3, 1]; lane b's ring in state
    ``kinds[b % len(kinds)]`` (``RING_KINDS``), its pairs y = A s of one
    symmetric positive definite A, rho = 1 / s.y; the gradient NaN on the
    lanes ``nan_lanes``."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-1.2, 1.2, (B, n)).astype(np.float32)
    g = rng.normal(size=(B, n)).astype(np.float32)
    g[list(nan_lanes)] = np.nan
    gamma = np.exp(rng.uniform(np.log(1e-3), 0.0, B)).astype(np.float32)
    Q = rng.normal(size=(n, n))
    A = (Q @ Q.T / n + np.eye(n)).astype(np.float32)
    S = (1e-2 * rng.normal(size=(B, M, n))).astype(np.float32)
    Y = (S.reshape(-1, n) @ A.T).reshape(B, M, n).astype(np.float32)
    rho = (1.0 / np.einsum("bmn,bmn->bm", S, Y)).astype(np.float32)
    valid = np.zeros((B, M), bool)
    head = np.zeros(B, np.int64)
    kind = np.arange(B) % len(kinds)
    for k, name in enumerate(kinds):
        lanes = np.nonzero(kind == k)[0]
        if name == "partial":
            fill = rng.integers(1, max(2, M), lanes.size)
            valid[lanes] = np.arange(M)[None, :] < fill[:, None]
            head[lanes] = fill % M
        elif name == "wrapped":
            valid[lanes] = True
            head[lanes] = rng.integers(0, M, lanes.size)
        elif name == "mixed":
            valid[lanes] = rng.random((lanes.size, M)) < 0.5
            head[lanes] = rng.integers(0, M, lanes.size)
            stale = ~valid[lanes]
            S[lanes] = np.where(stale[..., None], 1e3 * S[lanes], S[lanes])
            Y[lanes] = np.where(stale[..., None], 1e3 * Y[lanes], Y[lanes])
        elif name != "empty":
            raise ValueError(f"unknown ring state {name!r}")
    lim = np.full(n, 1.0 if bounded else np.inf, np.float32)
    t = lambda a: torch.as_tensor(a, device=device)    # noqa: E731
    C = Box(t(-lim), t(lim))
    lbfgs = panoc.LbfgsState(t(S), t(Y), t(rho), t(valid), t(head))
    return t(u), t(g), t(gamma), C, lbfgs
