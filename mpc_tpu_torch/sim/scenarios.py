"""Randomized scenario suites: generation and end-to-end rollout (port of
mpc_tpu/sim/scenarios.py).

Every lane carries its own road: the controller's ``centerline`` is the
(B, S, 2) stack of the scenarios' roads, and the candidate fan reads lane
e's road at road stride K (``ops/fused_psi.py``). When the controller's
cost has the obstacle field (``problem.uses_obstacles``), each lane also
carries its own obstacles, ``obstacles`` (B, K, 4), as in the reference
(mpc_tpu/sim/scenarios.py:108-115). The reference's pad-shape precompile
and its cache of jitted steppers (``_TWO_TIER_CACHE``) exist only to avoid
XLA compiles and are not ported.
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from mpc_tpu_torch.control.mpc import MpcCarry, MpcController
from mpc_tpu_torch.ops.bezier import (_linspace01, bezier_curve,
                                      lane_change_control_points)
from mpc_tpu_torch.sim.closedloop import ClosedLoopOut, run_closed_loop


class ScenarioBatch(NamedTuple):
    y0: torch.Tensor          # (B, 6) initial states
    centerline: torch.Tensor  # (B, size, 2) per-scenario roads
    obstacles: torch.Tensor   # (B, n_obstacles, 4) obstacle [x, y, phi, v]


def random_scenarios(batch: int, size: int = 100, n_obstacles: int = 2,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> ScenarioBatch:
    """A batch of randomized scenarios drawn from ``generator`` (a CPU
    ``torch.Generator``; a fresh one seeded 0 when None), on ``device``.

    The same three road kinds, in equal shares, and the same distributions
    as the reference (mpc_tpu/sim/scenarios.py:30-99): a straight road
    (heading U(-0.5, 0.5), offset U(-0.5, 0.5)^2, spacing U(0.05, 0.15)), an
    arc from the origin heading +x (radius U(2, 8), span U(1.5, 2 pi), either
    direction), or the lane-change Bezier (family member i U(1, 10), scaled
    by U(0.005, 0.02) into the 1:43 car's world); the car starts at the
    road's first point, offset U(-0.05, 0.05) across it, heading along it
    +- U(0, 0.2), at speed U(0.2, 1.0); obstacles at road points
    U{size/4 .. size-2}, at rest heading 0, speed U(0, 0.5). The values
    differ from the reference's: ``jax.random`` cannot be reproduced in
    torch. Same numbers of the same kinds come from the native generator
    (``io.native_scenarios``), which both packages share.
    """
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape or (batch,),
                                           generator=generator)

    kind = torch.randint(0, 3, (batch,), generator=generator)
    t = _linspace01(size)
    # straight
    heading = uniform(-0.5, 0.5)
    offset = uniform(-0.5, 0.5, batch, 2)
    spacing = uniform(0.05, 0.15)
    s = torch.arange(size, dtype=torch.float32)[None, :] * spacing[:, None]
    direction = torch.stack([torch.cos(heading), torch.sin(heading)], dim=1)
    straight = offset[:, None, :] + s[..., None] * direction[:, None, :]
    # arc: from the origin heading +x, about (0, radius * sign)
    radius = uniform(2.0, 8.0)[:, None]
    span = uniform(1.5, 2.0 * math.pi)[:, None]
    sign = torch.where(torch.rand((batch,), generator=generator) < 0.5,
                       1.0, -1.0)[:, None]
    theta = t[None, :] * span * sign
    arc = torch.stack([radius * torch.sin(theta),
                       sign * radius * (1.0 - torch.cos(theta))], dim=2)
    # lane change
    member = uniform(1.0, 10.0)
    scale = uniform(0.005, 0.02)
    pts = lane_change_control_points(member).control_points \
        * scale[:, None, None]
    lane_change = bezier_curve(t, pts)
    cl = torch.where((kind == 0)[:, None, None], straight,
                     torch.where((kind == 1)[:, None, None], arc,
                                 lane_change))

    d0 = cl[:, 1] - cl[:, 0]
    road_heading = torch.atan2(d0[:, 1], d0[:, 0])
    lateral = uniform(-0.05, 0.05)
    normal = torch.stack([-d0[:, 1], d0[:, 0]], dim=1) \
        / torch.linalg.vector_norm(d0, dim=1, keepdim=True)
    pos = cl[:, 0] + normal * lateral[:, None]
    v0 = uniform(0.2, 1.0)
    dpsi = uniform(-0.2, 0.2)
    zero = torch.zeros((batch,))
    y0 = torch.stack([pos[:, 0], pos[:, 1], road_heading + dpsi, v0, zero,
                      zero], dim=1)
    oi = torch.randint(size // 4, size - 1, (batch, n_obstacles),
                       generator=generator)
    opos = cl[torch.arange(batch)[:, None], oi]
    obs = torch.cat([opos, torch.zeros((batch, n_obstacles, 1)),
                     uniform(0.0, 0.5, batch, n_obstacles, 1)], dim=2)
    return ScenarioBatch(y0=y0.to(device), centerline=cl.to(device),
                         obstacles=obs.to(device))


def _take(carry: MpcCarry, idx: torch.Tensor) -> MpcCarry:
    return type(carry)(*(t[idx] for t in carry))


def _put(dst: MpcCarry, idx: torch.Tensor, src: MpcCarry) -> MpcCarry:
    """``dst`` with the lanes ``idx`` replaced by ``src``, out of place:
    a carry may share tensors with the one before it."""
    return type(dst)(*(d.index_put((idx,), s) for d, s in zip(dst, src)))


def _sync(t: torch.Tensor):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _suite_param(controller, params, scenarios: ScenarioBatch,
                 idx: Optional[torch.Tensor] = None) -> dict:
    """The parameters of the scenarios' lanes (those ``idx`` when given)
    without ``y0``: the roads, and the obstacles where the controller's
    cost reads them."""
    def lanes(t):
        return t if idx is None else t[idx]

    param = {"p": params, "centerline": lanes(scenarios.centerline)}
    if controller.problem.uses_obstacles:
        param["obstacles"] = lanes(scenarios.obstacles)
    return param


def run_scenario_suite(controller: MpcController, f_d: Callable,
                       scenarios: ScenarioBatch, params,
                       n_sim: int) -> ClosedLoopOut:
    """Roll every scenario end to end (mpc_tpu/sim/scenarios.py:102-121):
    the closed loop over the batch, each lane on its own road and with its
    own obstacles where the cost reads them."""
    return run_closed_loop(controller, f_d, scenarios.y0,
                           _suite_param(controller, params, scenarios),
                           n_sim, params)


@torch.no_grad()
def run_scenario_suite_two_tier(controller: MpcController,
                                controller_cheap: MpcController,
                                f_d: Callable, scenarios: ScenarioBatch,
                                params, n_sim: int, straggler_pad: int = 64,
                                precompile_shapes: bool = True):
    """Suite rollout in two tiers (mpc_tpu/sim/scenarios.py:169-276).

    Each step, (1) the cheap pass: one step of every lane through
    ``controller_cheap`` (the same OCP with a low iteration cap); (2) the
    straggler pass: the lanes whose cheap solve failed, gathered with
    their roads (and obstacles) from the step's starting states and
    carries into a batch padded to
    ``straggler_pad * 2^j`` lanes by repeating them (``np.resize``), are
    solved again through ``controller`` (the full budget) and scattered
    back. Duplicate lanes carry identical results, so the scatter of the
    whole padded index writes agreeing values. Both controllers must share
    one Problem structure. ``precompile_shapes`` is accepted so that
    callers of both packages match, and ignored: it exists in the reference
    to compile its XLA programs ahead.

    Returns ``(state, conv)``: ``state = {"ys", "carries", "stats"}`` with
    the final plant states and carries, and ``conv`` the (B, n_sim) numpy
    convergence after both tiers. ``stats`` has, per step, the host-clock
    seconds of each tier (``cheap_s``, ``straggler_s``; each ends in a
    sync) and ``n_stragglers``.
    """
    b = scenarios.y0.shape[0]
    dev = scenarios.y0.device
    carries = controller.init_carry(b, device=dev)
    ys = scenarios.y0

    def tier_step(ctrl, y, carry, idx=None):
        out = ctrl.step(carry, dict(_suite_param(ctrl, params, scenarios,
                                                 idx), y0=y))
        return f_d(y, out.u0, params), out.carry, out.result.converged

    convs = []
    stats = {"cheap_s": [], "straggler_s": [], "n_stragglers": []}
    for _ in range(n_sim):
        prev_carries = carries
        t0 = time.perf_counter()
        ys2, carries, conv = tier_step(controller_cheap, ys, carries)
        conv_np = conv.cpu().numpy().copy()
        stats["cheap_s"].append(time.perf_counter() - t0)
        bad = np.flatnonzero(~conv_np)
        stats["n_stragglers"].append(int(bad.size))
        t0 = time.perf_counter()
        if bad.size:
            k = straggler_pad
            while k < bad.size:
                k *= 2
            idx = torch.as_tensor(np.resize(bad, k), device=dev)
            ys_r, car_r, conv_r = tier_step(
                controller, ys[idx], _take(prev_carries, idx), idx)
            ys2 = ys2.index_put((idx,), ys_r)
            carries = _put(carries, idx, car_r)
            conv_np[bad] = conv_r.cpu().numpy()[: bad.size]
            _sync(ys2)
        stats["straggler_s"].append(time.perf_counter() - t0)
        ys = ys2
        convs.append(conv_np)
    return ({"ys": ys, "carries": carries, "stats": stats},
            np.stack(convs, axis=1))


@torch.no_grad()
def run_scenario_suite_resumable(controller: MpcController, f_d: Callable,
                                 scenarios: ScenarioBatch, params,
                                 n_sim: int, segment: int = 50,
                                 checkpoint_path: Optional[str] = None):
    """Suite rollout in segments of ``segment`` steps with a checkpoint
    after each (mpc_tpu/sim/scenarios.py:279-331): the plant states and the
    carries, ``{"ys", "carries"}``, and the step index, written atomically
    (``utils.checkpoint``); a run that finds a checkpoint resumes from it.
    As in the reference a segment always runs whole, so the last one may
    end past ``n_sim``. The checkpoint's keys are the JAX package's, so a
    checkpoint written by either package resumes in the other. Returns
    ``(state, conv)``, ``conv`` (B, steps run) in numpy, or None when the
    checkpoint was already at ``n_sim``."""
    from mpc_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                save_checkpoint)

    b = scenarios.y0.shape[0]
    dev = scenarios.y0.device
    state = {"ys": scenarios.y0,
             "carries": controller.init_carry(b, device=dev)}
    step = 0
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        state, step = load_checkpoint(checkpoint_path, state)
    convs = []
    static = _suite_param(controller, params, scenarios)
    while step < n_sim:
        ys, carries = state["ys"], state["carries"]
        conv = []
        for _ in range(segment):
            out = controller.step(carries, dict(static, y0=ys))
            ys = f_d(ys, out.u0, params)
            carries = out.carry
            conv.append(out.result.converged)
        state = {"ys": ys, "carries": carries}
        convs.append(torch.stack(conv, dim=1).cpu().numpy())
        step += segment
        if checkpoint_path is not None:
            save_checkpoint(checkpoint_path, state, step=step)
    return state, np.concatenate(convs, axis=1) if convs else None


def suite_summary(out: ClosedLoopOut, scenarios: ScenarioBatch) -> dict:
    """Aggregate suite metrics on the host (mpc_tpu/sim/scenarios.py:339-354)."""
    ys = out.ys.cpu().numpy()               # (B, n_sim, 6)
    conv = out.converged.cpu().numpy()      # (B, n_sim)
    iters = out.inner_iters.cpu().numpy()
    return {
        "scenarios": ys.shape[0],
        "steps": ys.shape[1],
        "total_solves": int(conv.size),
        "converged_fraction": float(conv.mean()),
        "mean_inner_iters": float(iters.mean()),
        "mean_final_speed": float(np.abs(ys[:, -1, 3]).mean()),
        "nan_scenarios": int(np.isnan(ys[:, -1]).any(axis=1).sum()),
    }
