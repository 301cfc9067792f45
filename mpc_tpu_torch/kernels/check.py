"""Hold the fan kernel's outputs against its plain PyTorch version.

A lane passes when its psi and every gradient entry lie within the bar of
the plain version on the same inputs (``|got - ref| <= atol + rtol |ref|``).
Where a candidate lies far outside the input box (a car braked to a stop, or
spun round), ``atan2(., vx)`` and ``sign(vx)`` make the gradient
ill-conditioned, and two correct float32 evaluations of it can differ beyond
that bar. So a lane beyond the bar is
held, with the plain version's f32 result, against the plain version run in
float64 on the same inputs, which is exact to f32 precision. If the f32
plain version is itself beyond the bar of float64, no f32 evaluation can be
held to the bar on that lane: it is *ill-conditioned*, and excused, as is a
lane where the kernel is within the bar of float64. A lane where the plain
version meets the bar against float64 and the kernel does not is a failure.
"""

from __future__ import annotations

import torch

from mpc_tpu_torch.ops import fused_psi as fp


def _excess(got, ref, rtol, atol):
    """Per lane: the largest ``|got - ref| / (atol + rtol |ref|)``; > 1 is
    beyond the bar."""
    r = ((got - ref).abs() / (atol + rtol * ref.abs())).reshape(got.shape[0], -1)
    return r.nan_to_num(nan=float("inf")).amax(dim=1)


def compare_fan(psi, grad, u, y0, cltab, pvec, n_horiz, substeps, h, v_ref,
                weights, psi_tol, grad_tol, chunk=65536) -> dict:
    """Compare the kernel's ``psi (E,)`` and ``grad (E, 2N)`` on inputs
    ``u, y0`` with the plain version, ``chunk`` lanes at a time.

    Returns the counts of lanes (``lanes``, ``beyond_bar``, ``excused``,
    ``failed``), the largest absolute errors over all lanes
    (``max_abs_err_psi``, ``max_abs_err_grad``) and over the lanes within the
    bar (``max_abs_err_within_bar``), and the least factor by which the f32
    plain version misses float64's bar on an excused lane
    (``excused_plain_miss_min``).
    """
    args = (n_horiz, substeps, h, v_ref, weights)
    beyond, e_psi, e_grad, e_in = [], 0.0, 0.0, 0.0
    for a in range(0, u.shape[0], chunk):
        s = slice(a, a + chunk)
        psi_r, grad_r = fp.fan_value_and_grad_reference(
            u[s], y0[s], cltab, pvec, *args)
        d_psi, d_grad = (psi[s] - psi_r).abs(), (grad[s] - grad_r).abs()
        e_psi = max(e_psi, float(d_psi.max()))
        e_grad = max(e_grad, float(d_grad.max()))
        over = torch.maximum(_excess(psi[s], psi_r, **psi_tol),
                             _excess(grad[s], grad_r, **grad_tol)) > 1.0
        ok = ~over
        if bool(ok.any()):
            e_in = max(e_in, float(d_psi[ok].max()),
                       float(d_grad[ok].max()))
        if bool(over.any()):
            idx = over.nonzero().squeeze(1)
            beyond.append((a + idx, psi_r[idx], grad_r[idx]))

    excused, failed, miss = 0, 0, 0.0
    if beyond:
        idx = torch.cat([b[0] for b in beyond])
        psi_r = torch.cat([b[1] for b in beyond])
        grad_r = torch.cat([b[2] for b in beyond])
        u64, y64 = u[idx].double(), y0[idx].double()
        psi_x, grad_x = fp.fan_value_and_grad_reference(
            u64, y64, cltab.double(), pvec.double(), *args)

        def dist(p32, g32):
            return torch.maximum(_excess(p32.double(), psi_x, **psi_tol),
                                 _excess(g32.double(), grad_x, **grad_tol))

        d_kernel, d_plain = dist(psi[idx], grad[idx]), dist(psi_r, grad_r)
        ok = (d_kernel <= 1.0) | (d_plain > 1.0)
        excused, failed = int(ok.sum()), int((~ok).sum())
        if excused:
            miss = float(d_plain[ok].min())
    return {"lanes": int(u.shape[0]),
            "beyond_bar": excused + failed, "excused": excused,
            "failed": failed, "max_abs_err_psi": e_psi,
            "max_abs_err_grad": e_grad, "max_abs_err_within_bar": e_in,
            "excused_plain_miss_min": miss}
