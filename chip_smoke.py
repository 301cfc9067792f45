"""Smoke test of the PyTorch/CUDA port (mpc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --timing

It drives the port's thirteen paths. Four go each through its own fan kernel
of csrc/fused_psi.cu (K1 and K2 instances of one phased kernel, K3 the same
phases as three kernels through a device scratch): the headline
(Pacejka, N=12; K1), config 1 (the kinematic bicycle, N=20; K2), ss_n40
(bounded state constraints through the ALM general path, N=40; K3) and
config 5 (the randomized scenario suite, one road per lane; K1 at a road
stride, "K1 roads"). ilqr_n40 (config 2: the same constrained OCP through
AL-iLQR) runs no kernel of its own, etc (config 3: event-triggered MPC over
the headline's controller) runs K1, and config 4 (the two-car game, each
car on its lane's road) runs K1 roads. Three run the plain OCP, whose fan
is autograd over B*K lanes and launches no kernel: ms_n40_m8 (multiple
shooting), config5_obs (config 5 with the obstacle field) and chain (the
hanging chain). Three run the sharded package (mpc_tpu_torch/parallel/):
mesh_dp (the scenario-sharded solver; K1), mesh_lqt (the horizon-sharded
LQT) and mesh_ilqr (the batched AL-iLQR over it). Phases, each of which
fails the run with a nonzero exit:

1. device: a CUDA device must be present; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles the fan kernels (csrc/fused_psi.cu) and PANOC's
   direction kernel (csrc/panoc_direction.cu) from this checkout and prints
   nvcc's registers, stack frame and spills of each instance;
3. kernel checks, for each kernel of the table ``KERNELS`` against its
   plain PyTorch version on the card (``mpc_tpu_torch.kernels.check``; psi
   rtol 2e-5 / atol 1e-6, grad rtol 2e-4 / atol 2e-5 per entry, for K3 plus
   1e-6 of each lane's largest gradient entry, the f32 rounding at the
   lane's scale that check.py documents). First on drawn inputs inside the
   solver's box: K1 at E in {1, 37, 5120}, N=12, straight and circle roads,
   default and non-default vehicle parameters; K2 at E in {1, 37, 5120},
   N=20, both roads; K3 at E in {1, 37, 1280}, N=40, on the lane-change
   road, with multipliers in [0, 2] and penalties log-uniform over
   [1e-1, 1e3] and [1e3, 1e9]; K1 roads on roads of random_scenarios (a
   mix of straight, arc and lane-change roads, one per scenario) from the
   scenarios' initial states, K lanes per road (the road stride, the lanes
   over the roads): E=1 and 37 at K=1, E=35 and 10240 at K=5, E=38 and
   10240 at K=2. Then on fan inputs captured from each path's first
   closed-loop steps, at the shapes the path gives its kernel: candidate
   fans (5 x batch lanes), whose L-BFGS candidates are not projected onto
   the box, and init pairs (2 x batch). K1: every call of 3 steps of the
   headline at batch 1024 (E=5120, 2048) and of 3 steps of config 5's
   batch-1 loop (E=5, 2). K2: every call of 2 steps at batch 1024 (E=5120,
   2048). K3: 2 steps at batch 256 (E=1280, 512); its plain version is slow
   at N=40, so at most 40 calls per shape are checked, evenly spaced, which
   takes in the first call of the first outer iteration of the first step
   and the last call of the last outer iteration of each step. K1 roads: 2
   steps of config 5 at batch 2048, both tiers (cheap tier E=10240, 4096;
   straggler tier 5 and 2 x 64 x 2^j), and 2 steps of config 4's loop at
   256 pairs (E=2560, 1024), at most 12 calls per shape of each, spaced
   so. A lane beyond the bar is excused only where the
   plain version in float32 misses its own float64 value by the bar too;
   such lanes are counted, and must be under 1% of a check's lanes;
4. timing: each kernel and its plain version on the first captured fan of
   each shape, in turns (plain, kernel, plain, kernel). The kernel's time is
   CUDA events around the replay of one CUDA graph of 200 launches, over
   the count (see ``launch_ms`` in mpc_tpu_torch/utils/roofline.py); the
   plain version's the median of 50 (K1), 10 (K2) or 5 (K3) calls, each
   between its own events. Beside them: the kernel's single-lane latency
   (E=1 on drawn inputs, at N and at N/2) and its serial chain, N times the
   slope of the single-lane time over N (see ``serial_chain``); and its
   bound, the larger of the bytes it must move over 3.35 TB/s and the
   operations it must do over 67 TFLOP/s (see ``fan_bound`` in
   utils/roofline.py; beside it the former count, which charged the
   per-stage constants to every evaluation). Then P1, PANOC's direction
   kernel (no TPU kernel: the JAX package's two-loop is jnp), at the
   benchmark cells' shapes (16,384 lanes, n = 24, L-BFGS memory 12;
   32,768, 40, 20) on drawn rings of every state with a NaN-gradient lane,
   held against its plain version by ``compare_direction`` (kernels/
   check.py: the same float64 rule), timed with its plain version as in
   phase 4, and its byte bound (``direction_bound``). K3 is also checked
   as in phase 3, then timed alone, on drawn inputs at the constrained
   benchmark cell's fan sizes (E = 8,192, 20,480 and 40,960 at N=40 on the
   lane-change road, penalties over [1e-1, 1e3]);
5. the LQT solves (mpc_tpu_torch/solver/lqr.py), sequential and parallel
   scan, at config 2's backward shapes (N=40, n=6, m=2; B=256 and B=1) on
   drawn well-posed problems with the cross term, each held against the
   float64 solution of the problem's KKT system to 2e-4 and the two
   against each other to 5e-4, and their times (CUDA events around one
   call, median of 20); then one masked AL-iLQR inner iteration at the
   ilqr_n40 shape under ``torch.cuda.set_sync_debug_mode("error")``, which
   raises on any host sync;
6. the paths, each through ``mpc_tpu_torch.bench`` with every launch count
   set to 0 just before it and read just after (``road_launches`` counts
   K1's launches on per-lane roads apart): the headline at batch 1024
   (5 warm-up, 20 timed steps, then the batch-1 loop over 50 steps), config
   1 at batch 1024 (4 warm-up, 10 timed steps), ss_n40 at batch 256 (2
   warm-up, 2 timed steps), ilqr_n40 at batch 256 (2 warm-up, 4 timed
   steps, then the batch-1 loop over 2 + 6 steps), etc at batch 1024 (4
   warm-up, 12 timed steps), config 5 at batch 2048 (an untimed 2-step
   pass, 10 timed steps in two tiers, then the batch-1 loop on scenario 0's
   road over 3 + 10 steps), config 4 at 256 pairs (a warm loop and one
   timed loop of 10 steps, then the payoff line); ss_n40, ilqr_n40 and the
   batch-1 loop of config 5 and config 4's timed loops are cut from their
   cells' depth for the script's time (``SMOKE_DEPTH``; widths are never
   cut). A path's kernel must have
   launched at least once per PANOC iteration run (the slowest lane's,
   summed over the controller's steps; both tiers for config 5); ilqr_n40
   must launch none. P1 must have launched exactly once per PANOC trip,
   summed over the path's solves (``SolveStats.trips``), and at least once
   per PANOC iteration run, on every path but ilqr_n40, which runs no
   PANOC; its calls numbered ``P1_CALLS`` in the path are held against its
   plain version as in phase 4, on their lanes with finite inputs. Every
   state must be
   finite, the mean converged fraction >= 0.99 (headline, config 1, etc,
   config 5) or >= 0.98 (ss_n40, ilqr_n40, whose converged lanes must also
   meet the constraints to delta = 1e-3), etc's mean trigger fraction in
   (0, 1], and some pair of config 4 must change lane;
7. the unfused paths, through ``mpc_tpu_torch.bench`` as in phase 6, each
   of which must launch no fan kernel: ms_n40_m8 at batch 256 (converged
   >= 0.85, its converged lanes within delta = 1e-3 of the constraints,
   the defects included), config5_obs at batch 2048 (converged >= 0.99 after
   both tiers, no NaN scenario; the least distance from a car to an
   obstacle beside the same steps without the term) and chain at batch 1
   (the least floor margin over steps and balls >= -1e-4, the ALM delta),
   each at a cut depth (``SMOKE_DEPTH``; a lane of ms_n40_m8 may end
   non-finite, see ``MAY_DIVERGE``); then the plain fan replayed from its
   CUDA graph against the eager call on ms_n40_m8's fan, equal bit for
   bit, and their times; then the windowed search
   (``window=32``) on the headline's lanes, 2 steps at batch 1024, its
   first inputs within 2e-3 of the dense fused controller's and its
   converged flags equal; then AL-iLQR with the obstacle field on the
   scenario of tests/test_obstacle_avoidance.py (N=12, 4 steps at batch
   1), every step converged, its first step within 2e-3 of the same
   controller on the CPU;
8. the sharded paths ("parallel", ``parallel_phase``): (a) a world of one
   rank on NCCL in this process at full width: mesh_dp's solve equal to
   the unsharded solve bit for bit, K1 on mesh_dp's fans against its plain
   version and timed, mesh_dp, mesh_lqt (against the float64 KKT solution
   to 2e-4) and mesh_ilqr (converged >= 0.98, no fan kernel) through the
   bench with the counts reset (mesh_dp's K1 launches at least its PANOC
   iterations), 3 steps of the sharded closed loop; (b) 2 ranks on the one
   card, worker processes with gloo collectives on CUDA tensors (NCCL
   cannot put two ranks on one GPU): the solver on (2, 1) and (1, 2)
   meshes at batch 64, the LQT on (1, 2) at N=512 and a mesh_ilqr step on
   (1, 2), each against (a) within the CPU tests' bands (the inner
   iterations' band at N=40); (c) with more than one card, (b) on NCCL,
   else a line saying it was not run.
9. the entry points ("entry points", ``entry_points_phase``): the demos
   of mpc_tpu_torch/examples/ through their ``main(argv)`` on the card,
   vehicle_mpc over its 400 steps at batch 1, with --circle and with
   --batch 1024 over 10; hanging_chain; --circle and the chain at a cut
   depth (``SMOKE_DEPTH``); lane_change_game, its decisions against the
   same demo on the CPU; scenario_suite at batch 2048 over 4 steps in
   segments of 2 with a checkpoint, then again from it; ``entry()`` and
   one call of its step; ``dryrun_multichip(1)`` (and over every card
   where there are several); each with the launch counts set to 0 just
   before it and read just after. K1 must launch in vehicle_mpc, entry()
   and the dry run, K1 roads in scenario_suite, no fan kernel in the chain
   and game demos; states finite; the converged fraction >= 0.99 in
   vehicle_mpc and --batch 1024, >= 0.98 in scenario_suite, at most 2
   failed steps with --circle (``ENTRY_LIMITS``: the JAX package's own
   runs set the last two); the chain's floor violation with MPC <= 1e-4;
   the resumed suite's states equal to those of the run that wrote the
   checkpoint;
10. the measurements ("measurements", ``measurements_phase``): one AL-iLQR
   inner iteration at ilqr_n40's shape composed from the solver's exposed
   phases, equal bit for bit to one ``iterate`` from the same state; the
   scripts mpc_tpu_torch/examples/profile_config2_phases.py and exp_mfu.py
   at their full width (batch 256, N=40; the candidate fan at E=5120), one
   timed call a phase (``MEASURE_REPS``), every number finite and every
   share of a bound at most 100%; exp_shift_warm.py on both roads at batch
   64 over 10 of its 20 steps (``SMOKE_DEPTH``), the counts set to 0 just
   before it: K1 launched in each run, states finite, each verbatim run
   converged >= 0.99; its K1 calls, recorded in that counted run, held
   against the plain fan as in phase 3 (at most 20 calls of each road and
   shape, E=320 and 128), and K1 timed at those shapes.

It prints the kernel table as one JSON line before the last, and as the last
line {"ok": true, "device": {...}}. It imports nothing of JAX.

With --timing it runs phases 1, 2 and 4 only, times each kernel alone (no
plain version; P1 with its plain version, which takes milliseconds; a
checkout without P1 leaves its row out) and prints {"timing": [...]} as
its last line, not the ok
line: copied over a checkout of another commit, it times that commit's
kernels the same way, so that two commits can be compared in one session
on one card (run them in turns: the first, the second, the second, the
first).
"""

import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import NamedTuple, Optional

HERE = os.path.dirname(os.path.abspath(__file__))

PSI_TOL = dict(rtol=2e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
SUBSTEPS, TS, S = 4, 0.05, 100
EXCUSED_MAX_SHARE = 0.01
K3_MAX_CALLS = 40           # captured K3 calls checked per shape
# a path's P1 calls captured and checked, by their number in the path:
# empty and partly filled rings first, full and wrapped ones later
P1_CALLS = (0, 1, 2, 4, 8, 16, 32, 64, 128, 256)
ROADS_MAX_CALLS = 12        # captured K1 roads calls checked per shape
# The depth of the paths driven at less than their cells': the fields of
# the cell replaced. ss_n40's steps take 14-22 s each on the H100 and
# ilqr_n40's 5-7 s (4 s at batch 1); with configs 5 and 4 the script would
# take about 780 s of its 1200 s, so those two are cut further, config 4
# runs one timed loop, and config 5's batch-1 loop runs 3 + 10 steps
# ms_n40_m8, config5_obs and chain, whose plain fans launch some 10^4 kernels
# per PANOC iteration (replayed from CUDA graphs), take 17-34 s a step on
# the H100 and are cut to a few steps
SMOKE_DEPTH = {"ss_n40": dict(n_warmup=2, n_steps=2),
               "ilqr_n40": dict(n_warmup=2, n_steps=4, batch1_steps=(2, 6)),
               "config5": dict(batch1_steps=(3, 10)),
               "config4": dict(n_loops=1),
               "ms_n40_m8": dict(n_warmup=1, n_steps=1),
               "config5_obs": dict(n_warm_steps=0, n_sim=2),
               "chain": dict(n_steps=3),
               # phase 9's demos (their flag --n-sim): on the H100 the
               # chain's first 10 steps after its disturbance took 88 s
               # (some 530 PANOC iterations a step; the source runs 180),
               # vehicle_mpc --circle's first 100 took 42.5 s
               "hanging_chain": dict(n_sim=2),
               "vehicle_mpc --circle": dict(n_sim=50),
               # phase 10: its 20 steps on both roads took 66 s on the
               # H100 (the circle's 27-28 s a start), its first 10 33 s
               "exp_shift_warm": dict(n_sim=10)}
# A lane of these paths may run to a non-finite state. Once the augmented
# Lagrangian is stiff enough that PANOC's step size falls to gamma_min, the
# reference accepts any step (mpc_tpu/solver/panoc.py:294), and a segment
# start state, which no box holds, can then run to inf: on the H100 one
# lane of ms_n40_m8's 256 does so in its first step and 10 by its ninth,
# and the JAX package's own controller does so on the CPU (lane 12 of the
# cell's first 16 in its second step; tests/test_torch_ms_controller.py run
# as a script). Such a lane counts as unconverged, and the path's converged
# fraction must meet its limit.
MAY_DIVERGE = ("ms_n40_m8",)
WINDOW_U0_BAND = 2e-3       # first inputs, windowed against dense
MIN_FLOOR_MARGIN = -1e-4    # the chain's ALM delta


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(tag, psi, grad, u, y0, cltab, pvec, args, model="pacejka",
          al=None):
    """Hold kernel outputs against the plain version; fail on a lane the
    plain version meets the bar on and the kernel does not. ``args`` are the
    fan's ``(n_horiz, substeps, h, v_ref, weights)``."""
    from mpc_tpu_torch.kernels.check import compare_fan
    r = compare_fan(psi, grad, u, y0, cltab, pvec, *args, PSI_TOL, GRAD_TOL,
                    model=model, al=al)
    why = (f", where the plain f32 version misses float64 by >= "
           f"{r['excused_plain_miss_min']:.3g}x the bar" if r["excused"] else "")
    print(f"kernel check {tag}: {r['lanes']} lanes, {r['beyond_bar']} beyond "
          f"the bar ({r['excused']} ill-conditioned{why}; {r['failed']} "
          f"failed); max err within the bar "
          f"{r['max_abs_err_within_bar']:.3e} abs, "
          f"{r['max_rel_err_within_bar']:.3e} of the lane's scale; over all "
          f"lanes psi "
          f"{r['max_abs_err_psi']:.3e} grad {r['max_abs_err_grad']:.3e}")
    if r["failed"] or r["excused"] > EXCUSED_MAX_SHARE * r["lanes"]:
        fail(f"{tag}: the kernel disagrees with its plain version: {r}")
    return r


def drawn_inputs(E, n_horiz, sd, road, seed):
    """``(u, y0, centerline)``: inputs inside the solver's box, driving
    forward: drive d in [0, 1], steering in [-0.32, 0.32] (max_steer); the
    paths' own inputs, which leave the box, are checked after these.
    ``road`` names one road for every lane, or is ``("scenarios", K)``:
    E / K roads of ``random_scenarios``, lane e on road e // K and starting
    from its scenario's initial state."""
    import numpy as np
    import torch
    from mpc_tpu_torch.bench import lane_change_road
    from mpc_tpu_torch.ops.road import circle_centerline, straight_centerline
    rng = np.random.default_rng(seed)
    u = np.empty((E, 2 * n_horiz), np.float32)
    u[:, 0::2] = rng.uniform(0.0, 1.0, (E, n_horiz))
    u[:, 1::2] = rng.uniform(-0.32, 0.32, (E, n_horiz))
    y0 = np.zeros((E, sd), np.float32)
    y0[:, 0] = rng.uniform(-0.1, 0.5, E)
    y0[:, 1] = rng.uniform(-0.1, 0.1, E)
    y0[:, 2] = rng.uniform(-0.3, 0.3, E)
    y0[:, 3] = rng.uniform(0.2, 1.0, E)
    u = torch.as_tensor(u, device="cuda")
    if isinstance(road, tuple):
        from mpc_tpu_torch.sim.scenarios import random_scenarios
        K = road[1]
        sc = random_scenarios(E // K, S, generator=torch.Generator(
            ).manual_seed(seed), device="cuda")
        return (u, sc.y0.repeat_interleave(K, dim=0).contiguous(),
                sc.centerline)
    # the straight and circle roads pass through the origin heading along +x
    # (the circle of radius 5 about (0, 5) at its lowest point), the
    # lane-change road starts there too
    cl = {"straight": straight_centerline, "circle": circle_centerline,
          "lane change": lambda n, device: lane_change_road(device)}[road](
              S, device="cuda")
    return u, torch.as_tensor(y0, device="cuda"), cl


def drawn_al(E, n_horiz, log_sigma, seed):
    """Multipliers in [0, 2] and penalties log-uniform over 10**log_sigma
    for the bounded state constraints x^2 - offsets <= 0."""
    import numpy as np
    import torch
    from mpc_tpu_torch.control.mpc import STATE_CONSTRAINT_OFFSETS
    rng = np.random.default_rng(seed)
    m = 6 * n_horiz
    lam = rng.uniform(0.0, 2.0, (E, m)).astype(np.float32)
    sigma = (10.0 ** rng.uniform(*log_sigma, (E, m))).astype(np.float32)
    return (torch.as_tensor(lam, device="cuda"),
            torch.as_tensor(sigma, device="cuda"),
            torch.tensor(STATE_CONSTRAINT_OFFSETS, device="cuda"),
            torch.full((m,), -float("inf"), device="cuda"),
            torch.zeros((m,), device="cuda"))


class Capture(NamedTuple):
    """Fan calls captured from the first closed-loop steps of a path."""
    cell: str            # a cell of mpc_tpu_torch.bench
    steps: int           # its closed-loop steps run
    shapes: tuple        # the fan sizes it must give: candidate fan, init pair
    exact: bool = True   # it gives no other sizes
    batch1: bool = False  # the cell's batch-1 loop, not its batched run


@contextlib.contextmanager
def recording(name, stamp=lambda: 0, counted=False):
    """``fp.<name>`` replaced by a wrapper that records every call as
    ``(stamp(), args)``, each ``args`` cloned; yields the list. The
    wrapper counts its launches on whatever fp.<name> names: the
    recording's launches land on the recorder and are dropped, or, with
    ``counted``, added to the wrapper's counts when the recording ends (a
    path's counted run recorded)."""
    import torch
    from mpc_tpu_torch.ops import fused_psi as fp
    wrapper = getattr(fp, name)
    calls = []

    def recorder(*args):
        calls.append((stamp(), tuple(a.clone() if torch.is_tensor(a) else a
                                     for a in args)))
        return wrapper(*args)

    recorder.launches = recorder.road_launches = 0
    setattr(fp, name, recorder)
    try:
        yield calls
    finally:
        setattr(fp, name, wrapper)
        if counted:
            wrapper.launches += recorder.launches
            if hasattr(wrapper, "road_launches"):
                wrapper.road_launches += recorder.road_launches


@contextlib.contextmanager
def recording_direction():
    """``panoc.direction`` replaced by a recorder that keeps the calls
    numbered in ``P1_CALLS`` as ``(args, out)``, each tensor cloned, and
    ``panoc.SolveStats``, which every PANOC solve builds once, by one that
    sums the solves' trips. Yields ``(calls, counts)``; ``counts`` holds P1's
    ``launches`` and the ``trips`` once the block ends. The wrapper counts
    its launches on whatever ``panoc.direction`` names, so they land on the
    recorder and are added to the wrapper's count at the end."""
    import torch
    from mpc_tpu_torch.solver import panoc
    wrapper, stats_cls = panoc.direction, panoc.SolveStats
    calls, counts, seen = [], {"launches": 0, "trips": 0}, [0]

    def clone(a):
        if torch.is_tensor(a):
            return a.clone()
        if isinstance(a, tuple) and hasattr(a, "_fields"):
            return type(a)(*map(clone, a))
        return a

    def recorder(*args):
        out = wrapper(*args)
        if seen[0] in P1_CALLS:
            calls.append((clone(args), clone(out)))
        seen[0] += 1
        return out

    def stats(trips, *rest, **kw):
        counts["trips"] += trips
        return stats_cls(trips, *rest, **kw)

    recorder.launches = 0
    panoc.direction, panoc.SolveStats = recorder, stats
    try:
        yield calls, counts
    finally:
        panoc.direction, panoc.SolveStats = wrapper, stats_cls
        counts["launches"] = recorder.launches
        wrapper.launches += recorder.launches


def check_direction_calls(tag, calls):
    """Hold each captured P1 call ``(args, out)`` against the plain version
    by ``compare_direction``, as phase 4 holds the drawn inputs, on the
    call's lanes whose inputs are all finite: a lane the closed loop ran to
    inf (``MAY_DIVERGE``) may turn inf into NaN in one summation order and
    not in the other (the NaN rule is held on the drawn inputs). Returns
    the totals."""
    import torch
    from mpc_tpu_torch.kernels.check import compare_direction
    tot = {"calls": len(calls), "lanes": 0, "excused": 0, "nonfinite": 0,
           "shapes": set()}
    for k, (args, out) in enumerate(calls):
        u, g, gamma, C, lb, tr_mult, taus = args
        fin = (torch.isfinite(u).all(1) & torch.isfinite(g).all(1)
               & torch.isfinite(gamma) & torch.isfinite(lb.rho).all(1)
               & torch.isfinite(lb.S).flatten(1).all(1)
               & torch.isfinite(lb.Y).flatten(1).all(1))
        idx = fin.nonzero().squeeze(1)
        tot["nonfinite"] += int(u.shape[0] - idx.numel())
        if not idx.numel():
            continue
        sub = lambda t: t[idx]                             # noqa: E731
        r = compare_direction(type(out)(*map(sub, out)), sub(u), sub(g),
                              sub(gamma), C, type(lb)(*map(sub, lb)),
                              tr_mult, taus)
        if r["failed"] or r["nan_mismatch"] or not r["elementwise_equal"] \
                or r["excused"] > EXCUSED_MAX_SHARE * r["lanes"]:
            fail(f"{tag}: P1's call {P1_CALLS[k]} (B={u.shape[0]}, "
                 f"n={u.shape[1]}, M={lb.S.shape[1]}): {r}")
        tot["lanes"] += r["lanes"]
        tot["excused"] += r["excused"]
        tot["shapes"].add((u.shape[1], lb.S.shape[1]))
    tot["shapes"] = sorted(tot["shapes"])
    return tot


def capture_fan_inputs(name, source):
    """The inputs of every call of the fan wrapper ``fp.<name>`` in the
    first ``source.steps`` closed-loop steps of ``source``, as the path gives
    them: ``[(step, args), ...]`` in call order, each ``args`` cloned. For
    the scenario suite the steps are its two-tier steps, for the two-car
    game the steps of its loop; ``step`` numbers the controller steps (a
    suite step's cheap and straggler passes are two)."""
    import torch
    from mpc_tpu_torch import bench
    cell = getattr(bench, source.cell)
    # a recorded controller's steps number the calls of the suite and the
    # game; the closed loop counts its own (and an earlier commit's bench,
    # timed by this script, has no StepRecord)
    step, records = [0], []
    with recording(name, lambda: step[0] + sum(len(r.iters)
                                               for r in records)) as calls:
        with torch.no_grad():
            if isinstance(cell, getattr(bench, "SuiteCell", ())):
                from mpc_tpu_torch.sim.scenarios import \
                    run_scenario_suite_two_tier
                records.append(bench.StepRecord())
                sc, params, f_d, full, cheap = bench.suite_setup(
                    cell, records[0])
                if source.batch1:
                    step1, ys, carry = bench.suite_batch1(sc, params, f_d,
                                                          full)
                    for _ in range(source.steps):
                        ys, carry = step1(ys, carry)
                else:
                    run_scenario_suite_two_tier(full, cheap, f_d, sc, params,
                                                source.steps,
                                                cell.straggler_pad)
            elif isinstance(cell, getattr(bench, "TwoCarCell", ())):
                records.append(bench.StepRecord())
                game, y0a, y0b = bench.two_car_setup(
                    dataclasses.replace(cell, n_sim=source.steps), records[0])
                game(y0a, y0b, 1, 1)
            else:
                loop = bench.ClosedLoop(cell)
                ys, carry = loop.start(cell.batch)
                for step[0] in range(source.steps):
                    ys, carry, _ = loop.step(ys, carry)
        torch.cuda.synchronize()
    return calls


def spread(calls, cap):
    """At most ``cap`` of ``calls``, evenly spaced, always with the first
    and the last call of each step (the first and last outer iterations)."""
    import numpy as np
    if len(calls) <= cap:
        return calls
    keep = set(np.linspace(0, len(calls) - 1, cap - 4).round().astype(int))
    for s in {st for st, _ in calls}:
        idx = [i for i, (st, _) in enumerate(calls) if st == s]
        keep.update((idx[0], idx[-1]))
    return [calls[i] for i in sorted(keep)]


def check_captured(kernel, calls, split):
    """Run the kernel ``kernel`` on each captured call and hold all of one
    shape together against the plain version. ``split(args) -> (u, y0,
    cltab, pvec, al, fan_args)`` names a call's operands. The calls of one
    shape share one road, or, on per-lane roads, are joined with their
    roads (each call's lanes are whole scenarios of the same K)."""
    import torch
    reports = []
    by_E = {}
    for _, args in calls:
        by_E.setdefault(args[0].shape[0], []).append(args)
    for E, group in sorted(by_E.items(), reverse=True):
        u0, y00, cl0, pv0, al0, fa0 = split(group[0])
        per_lane = cl0.dim() == 3
        us, y0s, psis, grads, als, cls = [], [], [], [], [], []
        for args in group:
            u, y0, cltab, pvec, al, fan_args = split(args)
            if fan_args != fa0 or not torch.equal(pvec, pv0) \
                    or cltab.shape != cl0.shape \
                    or (not per_lane and not torch.equal(cltab, cl0)):
                fail("the captured fan calls differ in road or parameters")
            cls.append(cltab)
            psi, grad = kernel(*args)
            torch.cuda.synchronize()
            us.append(u)
            y0s.append(y0)
            psis.append(psi)
            grads.append(grad)
            als.append(al)
        al = None
        if al0 is not None:
            al = (torch.cat([a[0] for a in als]),
                  torch.cat([a[1] for a in als]), *al0[2:])
        reports.append((E, len(group), torch.cat(psis), torch.cat(grads),
                        torch.cat(us), torch.cat(y0s),
                        torch.cat(cls) if per_lane else cl0, pv0, fa0, al))
    return reports


def median_ms(fn, n=50, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def time_pair(tag, kernel, plain, n_plain, info):
    """Kernel and plain version in turns (plain, kernel, plain, kernel);
    returns the smaller time of each: the kernel's per launch over a CUDA
    graph of 200 launches, the plain version's median of ``n_plain``. With
    ``plain`` None, the kernel alone twice, and None for the plain time."""
    ks, ps = [], []
    for _ in range(2):
        if plain is not None:
            ps.append(median_ms(plain, n=n_plain, warmup=1))
        ks.append(launch_ms(kernel))
    line = (f"timing {tag}: kernel {ks[0]:.4f} / {ks[1]:.4f} ms (a CUDA "
            f"graph of 200 launches)")
    if ps:
        line += (f", plain {ps[0]:.4f} / {ps[1]:.4f} ms (median of "
                 f"{n_plain})")
    print(f"{line}; CUDA events; {info['nvidia_smi']}")
    return min(ks), min(ps) if ps else None


def serial_chain(k, wrapper, fp, info):
    """The kernel's single-lane latency at its path's N, and its serial
    chain: at E=1 the grid is one block, whose per-stage parallel work fits
    its threads in one round for any N here, so the time grows with N only
    by the serial chain; N times the slope of the single-lane time between
    N/2 and N is that chain's time at N (the rollout and the adjoint
    recursion)."""
    from mpc_tpu_torch.models.params import VehicleParams
    road = k.drawn[0][1]
    times = {}
    for n in (k.n_horiz // 2, k.n_horiz):
        u, y0, cl = drawn_inputs(1, n, k.sd, road, seed=k.seed)
        cltab, pvec = fp.fan_params(cl, VehicleParams())
        al = drawn_al(1, n, (-1, 3), seed=k.seed + 100) if k.al else None
        args = (u, y0, cltab, pvec, *(al or ()), n, SUBSTEPS, TS / SUBSTEPS,
                1.0, fp.DEFAULT_VEHICLE_WEIGHTS)
        times[n] = launch_ms(lambda: wrapper(*args))
    (n1, t1), (n2, t2) = sorted(times.items())
    chain = n2 * (t2 - t1) / (n2 - n1)
    print(f"single lane {k.label}: {t1:.4f} ms at N={n1}, {t2:.4f} ms at "
          f"N={n2} (a CUDA graph of 200 launches); serial chain at N={n2} "
          f"{chain:.4f} ms; {info['nvidia_smi']}")
    return t2, chain


def drive(cell, wrapper, fp, min_conv, roads=False):
    """Drive one path through ``mpc_tpu_torch.bench`` with every launch
    count set to 0 just before it; fail unless its kernel ran on it (and,
    with ``roads``, on per-lane roads), or, for a path without a kernel
    (``wrapper`` None), unless none ran. ``min_conv`` None: the path has no
    convergence limit. Returns the counts, keyed by wrapper, and K1's
    launches on per-lane roads as ``road_launches``."""
    from mpc_tpu_torch.bench import run
    if cell.name in SMOKE_DEPTH:
        cell = dataclasses.replace(cell, **SMOKE_DEPTH[cell.name])
    wrappers = _reset_counts(fp)
    with recording_direction() as (p1_calls, p1_counts):
        r = run(cell)
    p1, trips = p1_counts["launches"], p1_counts["trips"]
    launches = {w.__name__: w.launches for w in wrappers}
    launches["road_launches"] = fp.fan_value_and_grad.road_launches
    r["fan_kernel_launches"] = launches
    r["direction_launches"] = p1
    r["panoc_trips"] = trips
    print(json.dumps({"bench": dict(r, cell=cell.name)}))
    ms = lambda key: f"{r[key] * 1e3:.2f} ms"        # noqa: E731
    parts = [f"{r['solves_per_s']:.1f} solves/s"]
    if "p50_step_latency_s" in r:
        parts.append(f"step p50 {ms('p50_step_latency_s')} p99 "
                     f"{ms('p99_step_latency_s')}")
    if "mean_converged_fraction" in r:
        parts.append(f"converged {r['mean_converged_fraction']:.4f}")
    if "inner_iters_mean" in r:
        parts.append(f"inner iters mean {r['inner_iters_mean']:.2f} max "
                     f"{r['inner_iters_max']}")
    if "n_stragglers_per_step" in r:
        parts.append(f"wall {r['wall_s']:.3f} s, stragglers per step "
                     f"{r['n_stragglers_per_step']}, cheap s "
                     f"{[round(t, 3) for t in r['cheap_s_per_step']]}, "
                     f"straggler s "
                     f"{[round(t, 3) for t in r['straggler_s_per_step']]}")
    if "pair_steps_per_s" in r:
        parts.append(f"{r['pair_steps_per_s']:.1f} pair-steps/s, wall per "
                     f"loop {r['wall_s_per_loop']:.3f} s, mean lane changes "
                     f"of A {r['mean_lane_changes_a']:.4f}, pairs with a "
                     f"lane change {r['pairs_with_lane_change']:.4f}, "
                     f"payoffs {r['decisions_per_s']:.1f} decisions/s at "
                     f"batch {r['payoff_batch']}")
    parts.append(f"inner iterations run {r['inner_iterations_run']}, "
                 f"launches {launches}, P1 {p1} for {trips} PANOC trips")
    if "single_solve_p50_s" in r:
        parts.append(f"batch-1 p50 {ms('single_solve_p50_s')} p99 "
                     f"{ms('single_solve_p99_s')}")
    if "outer_iters_mean" in r:
        parts.append(f"outer iters mean {r['outer_iters_mean']:.3f} max "
                     f"{r['outer_iters_max']}, max violation on converged "
                     f"lanes {r['max_violation_converged']:.3e}")
    if "mean_trigger_fraction" in r:
        parts.append(f"mean trigger fraction "
                     f"{r['mean_trigger_fraction']:.4f}")
    if r.get("nonfinite_lanes"):
        parts.append(f"{r['nonfinite_lanes']} lanes non-finite")
    if "min_obstacle_distance" in r:
        parts.append(f"least car-obstacle distance "
                     f"{r['min_obstacle_distance']:.4f} (without the term "
                     f"{r['min_obstacle_distance_without_term']:.4f}), NaN "
                     f"scenarios {r['nan_scenarios']}")
    if "min_floor_margin" in r:
        parts.append(f"failures {r['failures']}, least floor margin "
                     f"{r['min_floor_margin']:.3e}, free end's final "
                     f"distance to x_end {r['free_end_final_distance']:.4f}")
    print(f"path {cell.name}: " + ", ".join(parts))
    if wrapper is None:
        # config5_obs's comparison run without the term is config5's path
        # and launches K1 on per-lane roads; the cell's own run may not
        own = dict(launches)
        for key in ("fan_value_and_grad", "road_launches"):
            own[key] -= r.get("fan_launches_without_term", 0)
        if any(own.values()):
            fail(f"{cell.name}: a path without a fan kernel launched one: "
                 f"{own}")
    else:
        own = launches[wrapper.__name__]
        if own < max(1, r["inner_iterations_run"]):
            fail(f"{cell.name}: the path launched its fan kernel {own} "
                 f"times for {r['inner_iterations_run']} PANOC iterations")
        if roads and not launches["road_launches"]:
            fail(f"{cell.name}: the path never launched K1 on per-lane "
                 f"roads")
    if cell.name == "ilqr_n40":
        if p1 or trips:
            fail(f"ilqr_n40: PANOC ran {trips} trips and its direction "
                 f"kernel launched {p1} times on an AL-iLQR path")
    elif p1 != trips or p1 < max(1, r["inner_iterations_run"]):
        fail(f"{cell.name}: PANOC's direction kernel launched {p1} times "
             f"for {trips} PANOC trips and {r['inner_iterations_run']} "
             f"iterations")
    else:
        c = check_direction_calls(cell.name, p1_calls)
        print(f"path {cell.name}: P1 held against its plain version on "
              f"{c['calls']} calls, {c['lanes']} lanes (n, M) {c['shapes']}, "
              f"{c['excused']} excused, {c['nonfinite']} non-finite lanes "
              f"left out")
    if not r["states_finite"] and cell.name not in MAY_DIVERGE:
        fail(f"{cell.name}: non-finite plant state in the closed loop")
    if min_conv is not None \
            and not r["mean_converged_fraction"] >= min_conv:
        fail(f"{cell.name}: mean converged fraction "
             f"{r['mean_converged_fraction']} < {min_conv}")
    if "max_violation_converged" in r \
            and r["max_violation_converged"] > cell.alm_cfg.delta:
        fail(f"{cell.name}: a converged lane violates the constraints by "
             f"{r['max_violation_converged']} > delta")
    if "mean_trigger_fraction" in r \
            and not 0.0 < r["mean_trigger_fraction"] <= 1.0:
        fail(f"{cell.name}: mean trigger fraction "
             f"{r['mean_trigger_fraction']} outside (0, 1]")
    if "pairs_with_lane_change" in r \
            and not r["pairs_with_lane_change"] > 0.0:
        fail(f"{cell.name}: no pair changed lane (a frozen fixed point)")
    if r.get("nan_scenarios", 0):
        fail(f"{cell.name}: {r['nan_scenarios']} scenarios ended NaN")
    if "min_floor_margin" in r \
            and not r["min_floor_margin"] >= MIN_FLOOR_MARGIN:
        fail(f"{cell.name}: a ball went through the floor by "
             f"{r['min_floor_margin']:.3e} < {MIN_FLOOR_MARGIN}")
    return launches


def _reset_counts(fp):
    wrappers = (fp.fan_value_and_grad, fp.kin_fan_value_and_grad,
                fp.al_fan_value_and_grad)
    for w in wrappers:
        w.launches = 0
    fp.fan_value_and_grad.road_launches = 0
    return wrappers


def _no_fan_launched(tag, fp, wrappers):
    counts = {w.__name__: w.launches for w in wrappers}
    counts["road_launches"] = fp.fan_value_and_grad.road_launches
    if any(counts.values()):
        fail(f"{tag}: a path without a fan kernel launched one: {counts}")


def window_phase(bench, fp, info):
    """The windowed search (the plain OCP) on the headline's lanes against
    the dense fused controller (K1): 2 closed-loop steps of each from the
    same cold start at batch 1024; the windowed path must launch no fan
    kernel, its first inputs must lie within ``WINDOW_U0_BAND`` of the
    dense path's and its converged flags equal them."""
    import torch
    dense = bench.ClosedLoop(bench.HEADLINE)
    win = bench.ClosedLoop(dataclasses.replace(
        bench.HEADLINE, name="headline_window", window=32))
    runs = {}
    for tag, loop in (("window", win), ("dense", dense)):
        wrappers = _reset_counts(fp)
        ys, carry = loop.start(loop.cell.batch)
        outs = []
        t0 = time.perf_counter()
        with torch.no_grad():
            for _ in range(2):
                ys, carry, out = loop.step(ys, carry)
                outs.append(out)
        torch.cuda.synchronize()
        runs[tag] = (outs, time.perf_counter() - t0)
        if tag == "window":
            _no_fan_launched("headline window=32", fp, wrappers)
    gaps = []
    for k, (ow, od) in enumerate(zip(runs["window"][0], runs["dense"][0])):
        gap = float((ow.u0 - od.u0).abs().max())
        gaps.append(gap)
        if not gap <= WINDOW_U0_BAND:
            fail(f"window=32 step {k}: first inputs {gap:.3e} from the "
                 f"dense controller's > {WINDOW_U0_BAND}")
        if not bool((ow.result.converged == od.result.converged).all()):
            fail(f"window=32 step {k}: converged flags differ from the "
                 f"dense controller's")
    print(f"window check: headline lanes, batch 1024, window=32 against "
          f"dense: first inputs apart {[f'{g:.2e}' for g in gaps]}, flags "
          f"equal, slowest lane {[int(o.result.inner_iterations.max()) for o in runs['window'][0]]} "
          f"iterations; 2 steps in {runs['window'][1]:.2f} s (dense "
          f"{runs['dense'][1]:.2f} s); {info['nvidia_smi']}")


def fan_graph_phase(bench, info):
    """The plain OCP's candidate fan replayed from its CUDA graph
    (``solver/panoc.py:_FanGraph``) against the same call run eagerly, on
    ms_n40_m8's fan: 256 lanes x 5 candidates about the cold start, the AL
    objective at multipliers 0 and penalties 10. The outputs must be equal
    bit for bit, on the captured inputs and on new ones; prints both times
    (host clock to a sync, median of 5)."""
    import torch
    from mpc_tpu_torch.solver.panoc import candidate_fan
    from mpc_tpu_torch.solver.problem import project, value_and_grad
    loop = bench.ClosedLoop(bench.MS_N40_M8)
    ys, carry = loop.start(loop.cell.batch)
    prob = loop.ctrl.problem
    param = {"y0": ys, "p": loop.params, "centerline": loop.centerline}
    z = loop.ctrl.warm_prep(carry.U, param, torch.ones_like(carry.gamma,
                                                            dtype=torch.bool))
    gen = torch.Generator("cuda").manual_seed(0)
    cands = z[:, None] + 0.01 * torch.randn((z.shape[0], 5, z.shape[1]),
                                            device="cuda", generator=gen)
    args = (param, torch.zeros_like(carry.lam),
            torch.full_like(carry.lam, 10.0))

    def psi_vg(u, a):
        pa, lam, sigma = a

        def psi(u_, pa):
            f, g = prob.cost_constraints(u_, pa)
            zeta = g + lam / sigma
            r = zeta - project(zeta, prob.D)
            return f + 0.5 * (sigma * r ** 2).sum(dim=1)

        return value_and_grad(psi, u, pa)

    graphs = {}
    for c in (cands, cands * 1.001):
        eager = candidate_fan(psi_vg, c, args)
        graphed = candidate_fan(psi_vg, c, args, graphs)
        for e, g in zip(eager, graphed):
            if not torch.equal(e, g):
                fail(f"the graphed fan differs from the eager one by "
                     f"{float((e - g).abs().max()):.3e}")

    def seconds(fn, n=5):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return sorted(times)[n // 2]

    t_e = seconds(lambda: candidate_fan(psi_vg, cands, args))
    t_g = seconds(lambda: candidate_fan(psi_vg, cands, args, graphs))
    print(f"fan graph check: ms_n40_m8's fan (256 x 5 lanes, N=40, M=8), "
          f"graphed equal to eager bit for bit on {len(graphs)} graph; "
          f"eager {t_e * 1e3:.1f} ms, graphed {t_g * 1e3:.1f} ms a call "
          f"(host clock to a sync, median of 5); {info['nvidia_smi']}")


def ilqr_obstacle_phase(fp, info):
    """AL-iLQR with the obstacle field (its full second-order path) on the
    scenario of tests/test_obstacle_avoidance.py: one obstacle 5 cm off a
    straight road, the car at 0.5 m/s, N=12, 4 steps at batch 1. Every
    step must converge with finite states and launch no fan kernel; the
    first step's input must lie within ``WINDOW_U0_BAND`` of the same
    controller's on the CPU."""
    import torch
    from mpc_tpu_torch.control.mpc import build_vehicle_ilqr_controller
    from mpc_tpu_torch.models.bicycle import pacejka_dynamics
    from mpc_tpu_torch.models.integrators import discretize
    from mpc_tpu_torch.models.params import VehicleParams
    from mpc_tpu_torch.ops.road import straight_centerline
    kw = dict(n_horiz=12, obstacle_weight=2.0,
              obstacle_field_kwargs={"a_f": 1.0, "sigma_x": 0.2})
    f_d, params = discretize(pacejka_dynamics), VehicleParams()
    firsts = {}
    for dev in ("cpu", "cuda"):
        ctrl = build_vehicle_ilqr_controller(device=dev, **kw)
        static = {"p": params,
                  "centerline": straight_centerline(100, device=dev),
                  "obstacles": torch.tensor([[1.0, 0.05, 0.0, 0.0]],
                                            device=dev)}
        ys = torch.tensor([[0.0, 0.0, 0.0, 0.5, 0.0, 0.0]], device=dev)
        carry = ctrl.init_carry(1)
        wrappers = _reset_counts(fp)
        iters = []
        t0 = time.perf_counter()
        with torch.no_grad():
            for k in range(1 if dev == "cpu" else 4):
                out = ctrl.step(carry, dict(static, y0=ys))
                ys, carry = f_d(ys, out.u0, params), out.carry
                firsts.setdefault(dev, out.u0.cpu())
                iters.append(int(out.result.inner_iterations))
                if not bool(out.result.converged.all()):
                    fail(f"iLQR obstacle check ({dev}): step {k} did not "
                         f"converge")
        if dev == "cuda":
            torch.cuda.synchronize()
            _no_fan_launched("iLQR obstacle check", fp, wrappers)
            if not bool(torch.isfinite(ys).all()):
                fail("iLQR obstacle check: non-finite state")
            wall = time.perf_counter() - t0
    gap = float((firsts["cuda"] - firsts["cpu"]).abs().max())
    if not gap <= WINDOW_U0_BAND:
        fail(f"iLQR obstacle check: the card's first input is {gap:.3e} "
             f"from the CPU's")
    print(f"iLQR obstacle check: N=12, 4 steps at batch 1 converged, inner "
          f"iterations {iters}, in {wall:.2f} s; first input on the card "
          f"{firsts['cuda'].tolist()} ({gap:.2e} from the CPU's); "
          f"{info['nvidia_smi']}")


# ---- the sharded paths (mpc_tpu_torch/parallel/) ----------------------------

PAR_U_BAND = 5e-3       # inputs between meshes (tests/test_torch_sharding.py)
PAR_LQT_TOL = 2e-3      # us, xs, Ko, ko between meshes
# inner iterations per outer iteration, at N=40: the float32 rounding of
# the tol_dcost exit moves the JAX package's own counts by 3 when its inputs
# move by an ulp (ROADMAP Queue 3; tests/test_torch_ilqr_depth.py holds 3;
# the N=8 CPU tests hold 2)
PAR_INNER_BAND = 3
PAR_SOLVER = dict(batch=64, max_iter=100)   # the 2-rank solver runs
PAR_TIMEOUT = 400       # seconds for the 2-rank launch, every rank killed


def parallel_phase(bench, fp, info, k1):
    """Phase 8, the sharded paths (``mpc_tpu_torch/parallel/``).

    (a) A world of one rank on NCCL in this process, at full width: the
    world-1 ``mesh_dp`` solve against the unsharded ``build_vehicle_ocp`` +
    ``make_alm_solver`` on the same inputs, bit for bit (the same kernels;
    the gather is a copy); K1 on mesh_dp's fans (E = 1280, 512) against its
    plain version and timed; ``mesh_dp``, ``mesh_lqt`` (against the float64
    KKT solution) and ``mesh_ilqr`` through the bench, each with the launch
    counts reset just before it (mesh_dp must launch K1 once per PANOC
    iteration at least, mesh_ilqr no fan kernel); 3 steps of
    ``make_sharded_closed_loop``; and the references of (b).

    (b) Two ranks on the one card, processes of
    ``mpc_tpu_torch.parallel._dist_worker`` with gloo collectives on CUDA
    tensors (NCCL cannot put two ranks on one GPU): the solver on (2, 1)
    and (1, 2) meshes (``PAR_SOLVER``), the LQT on a (1, 2) horizon mesh at
    N = 512 and one mesh_ilqr step on (1, 2), each held against (a) within
    the CPU tests' bands.

    (c) With more than one card, (b) on NCCL, one rank per card.

    ``k1`` is K1's row of measurements, which gets mesh_dp's."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from mpc_tpu_torch.control.mpc import build_vehicle_ocp
    from mpc_tpu_torch.models.params import VehicleParams
    from mpc_tpu_torch.parallel._dist_worker import LQT_ARGS, launch
    from mpc_tpu_torch.parallel.distributed import initialize_world
    from mpc_tpu_torch.parallel.lqr_sharded import make_lqt_horizon_sharded
    from mpc_tpu_torch.parallel.mesh import make_horizon_mesh, make_mesh
    from mpc_tpu_torch.parallel.sharding import (make_sharded_closed_loop,
                                                 make_sharded_vehicle_solver)
    from mpc_tpu_torch.solver.alm import make_alm_solver
    t_phase = time.perf_counter()
    p = VehicleParams()

    # ---- (a) ----
    initialize_world()
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        fail(f"parallel (a): a world of {dist.get_world_size()} on "
             f"{dist.get_backend()}, not one rank on NCCL")
    mesh = make_mesh(1, 1)
    cell = bench.MESH_DP
    y0s, cl, U0s, lam0s = bench.mesh_dp_inputs(cell.batch, cell.n_horiz,
                                               "cuda")
    solve = make_sharded_vehicle_solver(mesh, n_horiz=cell.n_horiz,
                                        alm_cfg=bench.MESH_DP_ALM,
                                        panoc_cfg=bench.MESH_DP_PANOC)
    plain = make_alm_solver(build_vehicle_ocp(cell.n_horiz, device="cuda"),
                            bench.MESH_DP_ALM, bench.MESH_DP_PANOC)
    with torch.no_grad(), recording("fan_value_and_grad") as calls:
        got = solve(y0s, cl, p, U0s, lam0s)
    want = plain({"y0": y0s, "p": p, "centerline": cl}, U0s, lam0s)
    for name, g, w in zip(("u", "lam", "converged", "inner_iterations"),
                          got, (want.u, want.lam, want.converged,
                                want.inner_iterations)):
        if not torch.equal(g, w):
            fail(f"parallel (a): mesh_dp's world-1 {name} differs from the "
                 f"unsharded solve's")
    print(f"parallel (a): mesh_dp world of 1 on NCCL, batch {cell.batch}: "
          f"u, lam, converged, inner iterations equal to the unsharded "
          f"solve's bit for bit; converged "
          f"{float(got[2].float().mean()):.4f}")

    # K1 on mesh_dp's own fans, and its time there
    by_E = {}
    for c in calls:
        by_E.setdefault(c[1][0].shape[0], []).append(c)
    shapes = (5 * cell.batch, 2 * cell.batch)
    if sorted(by_E) != sorted(shapes):
        fail(f"mesh_dp gave K1 the shapes {sorted(by_E)}, not {shapes}")
    K1 = KERNELS[0]
    reports = [check(f"K1 mesh_dp E={E} ({n} calls)", psi, grad, u, y0, ct,
                     pv, fa, model="pacejka")
               for E, n, psi, grad, u, y0, ct, pv, fa, _ in check_captured(
                   fp.fan_value_and_grad, calls, lambda a: split(K1, a))]
    ms_by_E = {}
    for E in shapes:
        args = by_E[E][0][1]
        ms_by_E[E] = launch_ms(lambda: fp.fan_value_and_grad(*args))
    k1["max_abs_err"] = max(k1["max_abs_err"],
                            *(r["max_abs_err_within_bar"] for r in reports))
    k1["mesh_dp_lanes_checked"] = sum(r["lanes"] for r in reports)
    k1["mesh_dp_ms_by_E"] = ms_by_E
    print(f"parallel (a): K1 on mesh_dp's {len(calls)} fan calls, "
          f"{k1['mesh_dp_lanes_checked']} lanes checked; K1 "
          + ", ".join(f"{ms:.4f} ms at E={E}" for E, ms in ms_by_E.items())
          + f" (a CUDA graph of 200 launches); {info['nvidia_smi']}")

    # the three cells through the bench, counts reset just before each
    runs = {}
    for c, kw in ((bench.MESH_DP, {}), (bench.MESH_LQT, {"oracle": kkt_oracle}),
                  (bench.MESH_ILQR, {})):
        wrappers = _reset_counts(fp)
        with torch.no_grad():
            r = bench.MESH_RUNNERS[c.name](c, **kw)
        r["fan_kernel_launches"] = {w.__name__: w.launches for w in wrappers}
        runs[c.name] = r
        print(json.dumps({"bench": dict(r, cell=c.name)}))
        if not r["states_finite"]:
            fail(f"{c.name}: non-finite values")
    r = runs["mesh_dp"]
    if r["k1_launches"] != r["fan_kernel_launches"]["fan_value_and_grad"] \
            or r["k1_launches"] < r["inner_iterations_run"] + r["calls"]:
        fail(f"mesh_dp launched K1 {r['k1_launches']} times for "
             f"{r['inner_iterations_run']} PANOC iterations in "
             f"{r['calls']} solves")
    if not r["converged_fraction"] >= 0.95:
        fail(f"mesh_dp: converged fraction {r['converged_fraction']}")
    r = runs["mesh_lqt"]
    if not r["max_abs_err_vs_float64"] <= LQT_TOL:
        fail(f"mesh_lqt: {r['max_abs_err_vs_float64']:.3e} from the float64 "
             f"KKT solution > {LQT_TOL}")
    r = runs["mesh_ilqr"]
    if any(r["fan_kernel_launches"].values()):
        fail(f"mesh_ilqr launched a fan kernel: {r['fan_kernel_launches']}")
    if not r["converged_fraction"] >= 0.98:
        fail(f"mesh_ilqr: converged fraction {r['converged_fraction']} < "
             f"0.98 (ilqr_n40's limit)")
    print(f"parallel (a): mesh_dp {runs['mesh_dp']['solves_per_s']:.1f} "
          f"solves/s (p50 {runs['mesh_dp']['p50_s'] * 1e3:.2f} ms, converged"
          f" {runs['mesh_dp']['converged_fraction']:.4f}, K1 launches "
          f"{runs['mesh_dp']['k1_launches']}); mesh_lqt p50 "
          f"{runs['mesh_lqt']['p50_s'] * 1e3:.3f} ms, "
          f"{runs['mesh_lqt']['max_abs_err_vs_float64']:.2e} from float64, "
          f"{runs['mesh_lqt']['max_abs_err_vs_parallel']:.2e} from "
          f"lqt_solve_parallel; mesh_ilqr step p50 "
          f"{runs['mesh_ilqr']['p50_step_s']:.3f} s, converged "
          f"{runs['mesh_ilqr']['converged_fraction']:.4f}, first step against"
          f" ilqr_n40's controller: {runs['mesh_ilqr']['first_step_flags_differ']}"
          f" flags, {runs['mesh_ilqr']['first_step_outer_differ']} outer "
          f"counts differ, inner gaps "
          f"{runs['mesh_ilqr']['first_step_inner_gaps']} lanes at 0, 1, ...; "
          f"{info['nvidia_smi']}")
    k1["launches_mesh_dp"] = runs["mesh_dp"]["k1_launches"]

    n_sim = 3
    ys, traj, conv = make_sharded_closed_loop(
        mesh, n_sim, alm_cfg=bench.MESH_DP_ALM,
        panoc_cfg=bench.MESH_DP_PANOC)(y0s, cl, p)
    if traj.shape != (n_sim, cell.batch, 6) \
            or not bool(torch.isfinite(traj).all()) \
            or not torch.equal(ys, traj[-1]):
        fail("parallel (a): the sharded closed loop's states")
    print(f"parallel (a): make_sharded_closed_loop, {n_sim} steps at batch "
          f"{cell.batch}: finite, converged {float(conv.float().mean()):.4f}")

    # the references of (b)
    nb = PAR_SOLVER["batch"]
    panoc_b = dataclasses.replace(bench.MESH_DP_PANOC,
                                  max_iter=PAR_SOLVER["max_iter"])
    ref_solver = make_sharded_vehicle_solver(
        mesh, n_horiz=cell.n_horiz, alm_cfg=bench.MESH_DP_ALM,
        panoc_cfg=panoc_b)(y0s[:nb], cl, p, U0s[:nb], lam0s[:nb])
    prob = bench.mesh_lqt_problem(bench.MESH_LQT.batch, bench.MESH_LQT.n_horiz)
    ref_lqt = make_lqt_horizon_sharded(make_horizon_mesh(1, 1))(
        *(torch.as_tensor(a, device="cuda") for a in prob))
    ctrl = bench.mesh_ilqr_controller(make_horizon_mesh(1, 1), "cuda")
    y_il = torch.as_tensor(bench.ss_n40_states(bench.MESH_ILQR.batch),
                           device="cuda")
    with torch.no_grad():
        ref_ilqr = ctrl.step(ctrl.init_carry(y_il.shape[0]), {
            "y0": y_il, "p": p,
            "centerline": bench.lane_change_road("cuda")}).result
    torch.cuda.synchronize()
    dist.destroy_process_group()
    print(f"parallel (a) done in {time.perf_counter() - t_phase:.1f} s")

    # ---- (b), (c) ----
    il = bench.ILQR_N40
    spec = {
        "solver": {"cases": {
            f"solver_{a}x{b}": dict(
                mesh=[a, b], n_horiz=cell.n_horiz,
                alm=dataclasses.asdict(bench.MESH_DP_ALM),
                panoc={k: v for k, v in dataclasses.asdict(panoc_b).items()
                       if k != "taus"})
            for a, b in ((2, 1), (1, 2))}},
        "lqt": {"cases": {"lqt_1x2": {"mesh": [1, 2], "timed": 10}}},
        "ilqr": {"cases": {"ilqr_1x2": dict(
            mesh=[1, 2], n_horiz=il.n_horiz,
            alm=dataclasses.asdict(il.alm_cfg),
            ilqr=dataclasses.asdict(il.solver_cfg), n_steps=1)}}}
    arrays = {}
    for case in spec["solver"]["cases"]:
        arrays.update({f"{case}/y0s": y0s[:nb].cpu().numpy(),
                       f"{case}/cl": cl.cpu().numpy(),
                       f"{case}/U0s": U0s[:nb].cpu().numpy(),
                       f"{case}/lam0s": lam0s[:nb].cpu().numpy()})
    arrays.update({f"lqt_1x2/{k}": a for k, a in zip(LQT_ARGS, prob)})
    arrays.update({"ilqr_1x2/cl": bench.lane_change_road().numpy(),
                   "ilqr_1x2/y0s": y_il.cpu().numpy()})

    def two_ranks(tag, backend):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as work:
            out = launch("solver,lqt,ilqr", 2, work, spec=spec,
                         arrays=arrays, device="cuda", backend=backend,
                         timeout=PAR_TIMEOUT)
        wall = time.perf_counter() - t0
        a = lambda t: t.cpu().numpy()              # noqa: E731
        lines = []
        for case in spec["solver"]["cases"]:
            conv = out[f"{case}/converged"]
            gap = float(np.abs(out[f"{case}/u"] - a(ref_solver[0])).max())
            if not np.array_equal(conv, a(ref_solver[2])) \
                    or not gap <= PAR_U_BAND:
                fail(f"parallel {tag}: {case}: flags equal "
                     f"{np.array_equal(conv, a(ref_solver[2]))}, inputs "
                     f"{gap:.3e} from (a)'s (band {PAR_U_BAND})")
            lines.append(f"{case} converged {conv.mean():.4f}, inputs "
                         f"{gap:.2e} from (a), {float(out[f'{case}/wall_s']):.2f}"
                         f" s, K1 launches {int(out[f'{case}/k1_launches'])}, "
                         f"fan {'graphed' if out[f'{case}/fan_graph'] else 'eager' if case.endswith('1x2') else 'K1'}")
        gaps = {k: float(np.abs(out[f"lqt_1x2/{k}"]
                                - a(getattr(ref_lqt, k))).max())
                for k in ("us", "xs", "Ko", "ko")}
        if not max(gaps.values()) <= PAR_LQT_TOL:
            fail(f"parallel {tag}: LQT on (1, 2) against (a): {gaps}")
        lines.append(f"LQT (1, 2) N={bench.MESH_LQT.n_horiz}: "
                     f"{max(gaps.values()):.2e} from (a), p50 "
                     f"{float(out['lqt_1x2/p50_s']) * 1e3:.3f} ms of 10")
        conv, outer, inner = (out[f"ilqr_1x2/{k}"][0]
                              for k in ("converged", "outer", "inner"))
        gap = np.abs(inner.astype(int)
                     - a(ref_ilqr.inner_iterations).astype(int))
        over = int((gap > PAR_INNER_BAND
                    * a(ref_ilqr.outer_iterations)).sum())
        flags = int((conv != a(ref_ilqr.converged)).sum())
        outers = int((outer != a(ref_ilqr.outer_iterations)).sum())
        lines.append(f"mesh_ilqr step (1, 2): converged {conv.mean():.4f}, "
                     f"{flags} flags and {outers} outer counts differ from "
                     f"(a)'s, inner gaps {np.bincount(gap).tolist()} lanes "
                     f"at 0, 1, ..., {float(out['ilqr_1x2/wall_s'][0]):.2f} s")
        print(f"parallel {tag}: 2 ranks on {backend}, one launch in "
              f"{wall:.1f} s: " + "; ".join(lines)
              + f"; {info['nvidia_smi']}")
        if flags or outers or over:
            fail(f"parallel {tag}: mesh_ilqr step on (1, 2) against (a): "
                 f"{flags} flags, {outers} outer counts differ, {over} inner "
                 f"counts beyond {PAR_INNER_BAND} per outer iteration")

    print("parallel (b): gloo takes CUDA tensors and stages each collective "
          "through host memory itself; NCCL cannot put two ranks on one GPU, "
          "so the 2-rank runs share the one card over gloo (not NVLink); the "
          "(1, 2) solver's fan communicates, so it runs eager (decided "
          "when the solver is built: make_panoc_solver(group=))")
    two_ranks("(b)", "gloo")
    if torch.cuda.device_count() > 1:
        two_ranks("(c)", "nccl")
    else:
        print(f"parallel (c): not run: {torch.cuda.device_count()} CUDA "
              f"device (NCCL needs a card per rank)")
    print(f"parallel phase done in {time.perf_counter() - t_phase:.1f} s")
    return runs


# ---- the entry points (mpc_tpu_torch/examples/, mpc_tpu_torch/entry.py) ----

# Each demo run's limit: the least converged fraction, or the most failed
# steps. The suite demo solves in one tier at max_iter 60, which leaves
# some lanes of its cold first step unconverged in the JAX package too:
# over its first 4 steps on the first 256 of these scenarios,
# examples/scenario_suite.py reads 0.9873 on the CPU (the port's demo
# 0.9844 there, 0.9865 at 2048 on the H100). On the circle the JAX
# package's own closed loop fails 2 of its first 100 steps, and 0-2 from
# the initial state moved by one ulp (15 draws; tests/
# test_torch_example_vehicle.py run as a script); of its first 50 none
# (examples/vehicle_mpc.py --circle --n-sim 50 on the CPU), the port's
# one on the H100.
ENTRY_LIMITS = {"vehicle_mpc": dict(min_conv=0.99),
                "vehicle_mpc --circle": dict(max_failures=2),
                "vehicle_mpc --batch 1024": dict(min_conv=0.99),
                "scenario_suite": dict(min_conv=0.98)}
ENTRY_MAX_FLOOR_VIOLATION = 1e-4    # the chain demo with MPC: its ALM delta


def entry_points_phase(fp):
    """Phase 9, the port's own entry points, each driven as a user runs it
    (the demos' ``main(argv)``, ``entry()``, ``dryrun_multichip``) on the
    card with every launch count set to 0 just before it and read just
    after. K1 must have launched in vehicle_mpc, entry() and
    dryrun_multichip(1), K1 roads in scenario_suite, no fan kernel in the
    chain and game demos. Every state must be finite, each run within its
    ``ENTRY_LIMITS``, the chain's floor violation with MPC <= 1e-4, the
    game's decisions those of the same demo on the CPU, and the resumed
    suite's states those of the run that wrote the checkpoint. Returns the
    launches of each run."""
    import tempfile

    import numpy as np
    import torch
    from mpc_tpu_torch.entry import dryrun_multichip, entry
    from mpc_tpu_torch.examples import (hanging_chain, lane_change_game,
                                        scenario_suite, vehicle_mpc)
    t_phase = time.perf_counter()
    runs = {}

    def run(tag, fn, kernel=None):
        """Drive ``fn`` with the counts reset; ``kernel`` is the count that
        must move ("K1" or "K1 roads"; None: no fan kernel may launch)."""
        wrappers = _reset_counts(fp)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        road = fp.fan_value_and_grad.road_launches
        counts = {"K1": fp.fan_value_and_grad.launches - road,
                  "K1 roads": road, "K2": wrappers[1].launches,
                  "K3": wrappers[2].launches}
        runs[tag] = counts
        print(f"entry points {tag}: {wall:.2f} s, launches {counts}")
        if kernel is None and any(counts.values()):
            fail(f"entry points {tag}: a path without a fan kernel "
                 f"launched one: {counts}")
        if kernel is not None and not counts[kernel]:
            fail(f"entry points {tag}: {kernel} never launched")
        return out

    def demo(tag, module, argv, kernel=None):
        out = run(tag, lambda: module.main(argv), kernel)
        for key in ("final_states", "ys"):
            if key in out and not np.isfinite(out[key]).all():
                fail(f"entry points {tag}: non-finite state")
        limit = ENTRY_LIMITS.get(tag, {})
        conv = out.get("converged_fraction")   # None: nothing left to run
        if conv is not None and not conv >= limit.get("min_conv", 0.0):
            fail(f"entry points {tag}: converged fraction {conv} < "
                 f"{limit['min_conv']}")
        if "max_failures" in limit \
                and out["failures"] > limit["max_failures"]:
            fail(f"entry points {tag}: {out['failures']} failed steps > "
                 f"{limit['max_failures']}")
        return out

    demo("vehicle_mpc", vehicle_mpc, [], "K1")
    demo("vehicle_mpc --circle", vehicle_mpc,
         ["--circle", "--n-sim",
          str(SMOKE_DEPTH["vehicle_mpc --circle"]["n_sim"])], "K1")
    demo("vehicle_mpc --batch 1024", vehicle_mpc,
         ["--batch", "1024", "--n-sim", "10"], "K1")

    n_sim = SMOKE_DEPTH["hanging_chain"]["n_sim"]
    chain = demo("hanging_chain", hanging_chain, ["--n-sim", str(n_sim)])
    viol = chain["max_floor_violation_mpc_unrounded"]
    if not viol <= ENTRY_MAX_FLOOR_VIOLATION:
        fail(f"entry points hanging_chain: a ball {viol:.3e} below the "
             f"floor with MPC")

    game = demo("lane_change_game", lane_change_game, [])
    plain = lane_change_game.main(["--device", "cpu"])
    for name in ("test_1", "test_2", "test_3"):
        if game[name] != plain[name]:
            fail(f"entry points lane_change_game {name}: {game[name]} on "
                 f"the card, {plain[name]} on the CPU")

    with tempfile.TemporaryDirectory() as work:
        argv = ["--batch", "2048", "--n-sim", "4", "--segment", "2",
                "--checkpoint", os.path.join(work, "suite.npz")]
        suite = demo("scenario_suite", scenario_suite, argv, "K1 roads")
        resumed = demo("scenario_suite resumed", scenario_suite, argv)
    if suite["nan_scenarios"]:
        fail(f"entry points scenario_suite: {suite['nan_scenarios']} "
             f"scenarios ended NaN")
    if not np.array_equal(resumed["final_states"], suite["final_states"]):
        fail("entry points scenario_suite: the resumed run's states differ "
             "from those of the run that wrote the checkpoint")

    fn, args = entry()
    u0, U = run("entry()", lambda: fn(*args), "K1")
    if tuple(u0.shape) != (1, 2) or tuple(U.shape) != (1, 24) \
            or not bool(torch.isfinite(U).all()):
        fail(f"entry points entry(): u0 {tuple(u0.shape)}, U "
             f"{tuple(U.shape)}, finite {bool(torch.isfinite(U).all())}")
    print(f"entry points entry(): u0 {u0.tolist()}")

    shapes = run("dryrun_multichip(1)", lambda: dryrun_multichip(1), "K1")
    print(f"entry points dryrun_multichip(1): {shapes}")
    n = torch.cuda.device_count()
    if n > 1:
        shapes = run(f"dryrun_multichip({n})", lambda: dryrun_multichip(n),
                     "K1")
        print(f"entry points dryrun_multichip({n}): {shapes}")
    else:
        print("entry points dryrun_multichip: one card, so no multi-rank "
              "run (NCCL needs a card per rank)")
    print(f"entry points phase done in {time.perf_counter() - t_phase:.1f} "
          f"s")
    return runs


# ---- the AL-iLQR measurements and the warm-start experiment --------------

# timed calls of each phase (the scripts' 10): at 3 the phase took 96 s
# on the H100, the two scripts' phases 60 s of it
MEASURE_REPS = 1
SHIFT_WARM_BATCH = 64      # exp_shift_warm's full batch
SHIFT_WARM_MIN_CONV = 0.99  # each verbatim run of exp_shift_warm
SHIFT_WARM_MAX_CALLS = 20   # its recorded K1 calls checked per road, shape


def measurements_phase(fp, k1, info):
    """Phase 10: the measurement scripts of mpc_tpu_torch/examples/ on the
    card. First the AL-iLQR inner iteration at ilqr_n40's shape (batch 256,
    N=40) composed from its exposed phases (``IlqrPhases``: derivatives,
    the LQT solve, the forward fan, the step size's pick) against one
    ``iterate`` from the same state: every field bit for bit. Then
    profile_config2_phases and exp_mfu at their full width, ``MEASURE_REPS``
    timed calls a phase: every time finite, every share of a bound at most
    100%; then exp_shift_warm on both roads at batch 64 over the first
    10 of its 20 steps (``SMOKE_DEPTH``), with the launch counts set to 0
    just before it: K1 launched in every run, every state finite, each
    verbatim run converged >= 0.99. Its K1 calls are recorded (counted
    still) and at most ``SHIFT_WARM_MAX_CALLS`` of each road and shape
    (E = 5 and 2 x the batch) held against the plain fan, and K1 timed at
    those shapes; ``k1``, K1's row of measurements, gets both. Returns the
    K1 launches of each exp_shift_warm run."""
    import math

    import torch
    from mpc_tpu_torch.examples import exp_mfu, exp_shift_warm
    from mpc_tpu_torch.examples import profile_config2_phases as pcp
    t_phase = time.perf_counter()

    batch = 256
    with torch.no_grad():
        s = pcp.setup(pcp.draw_inputs(batch), "cuda")
        st, ph = s.state, s.phases
        if not bool(s.cond(st).all()):
            fail("measurements: the prepared state's loop condition does not "
                 "hold on every lane")
        want = s.iterate(st)
        Ks, kos, gnorm = ph.lqt_solve(ph.derivatives(st.xs, st.us), st.reg)
        got = ph.accept(st, gnorm, *ph.forward(st.xs, st.us, Ks, kos))
        torch.cuda.synchronize()
    def bits(t):
        return t.view(torch.int32) if t.is_floating_point() else t

    for field in ("us", "xs", "cost", "reg", "iters", "converged",
                  "grad_norm"):
        a, b = getattr(got, field), getattr(want, field)
        if not torch.equal(bits(a), bits(b)):
            fail(f"measurements: the composed phases' {field} differs from "
                 f"one iterate's (max gap "
                 f"{float((a.double() - b.double()).abs().max()):.3e})")
    print(f"measurements: the exposed phases composed equal one iterate bit "
          f"for bit at batch {batch}, N={pcp.N}")

    def finite(tag, values):
        bad = [v for v in values if v is not None
               and not math.isfinite(v)]
        if bad:
            fail(f"measurements {tag}: non-finite numbers {bad}")

    row = pcp.main(["--reps", str(MEASURE_REPS)])
    finite("profile_config2_phases",
           [v for k, v in row.items() if k.endswith(("_ms", "_kernels"))])
    if not all(row[f"{p}_kernels"] for p in pcp.PHASES):
        fail(f"measurements profile_config2_phases: a phase launched no "
             f"kernel: {row}")
    mfu = exp_mfu.main(["--reps", str(MEASURE_REPS)])
    for r in mfu["rows"]:
        shares = [r.get("pct_of_bound"), r.get("device_pct_of_bound")]
        if None in shares:
            fail(f"measurements exp_mfu {r['kernel']}: no share of the "
                 f"bound on the card")
        finite(r["kernel"], [r["wall_ms"], r["device_ms"], r["bound_ms"],
                             *shares])
        for key in ("pct_of_bound", "device_pct_of_bound"):
            if r[key] > 100.0:
                fail(f"measurements exp_mfu {r['kernel']}: {key} "
                     f"{r[key]:.3f}% > 100%, a fault of the count")

    _reset_counts(fp)
    with recording("fan_value_and_grad", counted=True) as calls:
        rows = exp_shift_warm.main(
            ["--batch", str(SHIFT_WARM_BATCH),
             "--n-sim", str(SMOKE_DEPTH["exp_shift_warm"]["n_sim"])])
    launches = {}
    for name, r in rows.items():
        launches[name] = r["k1_launches"]
        if not r["states_finite"]:
            fail(f"measurements exp_shift_warm {name}: non-finite state")
        if not r["k1_launches"]:
            fail(f"measurements exp_shift_warm {name}: K1 never launched")
        if name.endswith("_verbatim") \
                and not r["mean_converged_fraction"] >= SHIFT_WARM_MIN_CONV:
            fail(f"measurements exp_shift_warm {name}: converged "
                 f"{r['mean_converged_fraction']} < {SHIFT_WARM_MIN_CONV}")
    if sum(launches.values()) != fp.fan_value_and_grad.launches \
            or len(calls) != fp.fan_value_and_grad.launches:
        fail(f"measurements exp_shift_warm: {launches} K1 launches in the "
             f"runs, {fp.fan_value_and_grad.launches} counted, "
             f"{len(calls)} recorded")
    shift_warm_k1(fp, calls, k1, info)
    print(f"measurements phase done in {time.perf_counter() - t_phase:.1f} "
          f"s")
    return launches


def shift_warm_k1(fp, calls, k1, info):
    """K1 on exp_shift_warm's recorded fans: each road's calls (one road
    a run) at each shape, at most ``SHIFT_WARM_MAX_CALLS`` of them, against
    the plain fan, and K1's time at each shape."""
    import torch
    from mpc_tpu_torch.examples.exp_shift_warm import ROADS
    roads = []              # [(cltab, its calls)], in the runs' order
    for c in calls:
        for cltab, group in roads:
            if torch.equal(cltab, c[1][2]):
                group.append(c)
                break
        else:
            roads.append((c[1][2], [c]))
    if len(roads) != len(ROADS):
        fail(f"exp_shift_warm gave K1 {len(roads)} roads, not {len(ROADS)}")
    shapes = (5 * SHIFT_WARM_BATCH, 2 * SHIFT_WARM_BATCH)
    K1 = KERNELS[0]
    reports, ms_by_E = [], {}
    for road, (_, group) in zip(ROADS, roads):
        by_E = {}
        for c in group:
            by_E.setdefault(c[1][0].shape[0], []).append(c)
        if sorted(by_E) != sorted(shapes):
            fail(f"exp_shift_warm {road} gave K1 the shapes {sorted(by_E)}, "
                 f"not {shapes}")
        kept = [c for v in by_E.values()
                for c in spread(v, SHIFT_WARM_MAX_CALLS)]
        reports += [check(f"K1 exp_shift_warm {road} E={E} ({n} calls)",
                          psi, grad, u, y0, ct, pv, fa, model="pacejka")
                    for E, n, psi, grad, u, y0, ct, pv, fa, _ in
                    check_captured(fp.fan_value_and_grad, kept,
                                   lambda a: split(K1, a))]
        for E in shapes:
            if E not in ms_by_E:
                args = by_E[E][0][1]
                ms_by_E[E] = launch_ms(lambda: fp.fan_value_and_grad(*args))
    k1["max_abs_err"] = max(k1["max_abs_err"],
                            *(r["max_abs_err_within_bar"] for r in reports))
    k1["exp_shift_warm_lanes_checked"] = sum(r["lanes"] for r in reports)
    k1["exp_shift_warm_ms_by_E"] = ms_by_E
    print(f"measurements: K1 on exp_shift_warm's {len(calls)} fan calls, "
          f"{k1['exp_shift_warm_lanes_checked']} lanes checked; K1 "
          + ", ".join(f"{ms:.4f} ms at E={E}" for E, ms in ms_by_E.items())
          + f" (a CUDA graph of 200 launches); {info['nvidia_smi']}")


# ---- the LQT solves (mpc_tpu_torch/solver/lqr.py) --------------------------

LQT_TOL = 2e-4          # us, xs against the float64 KKT solution
LQT_PAIR_TOL = 5e-4     # parallel against sequential


def random_lqt(rng, N, n, m):
    """A drawn well-posed LQT problem with the cross term, float64 (the
    generator of tests/test_lqr.py:17-37)."""
    import numpy as np

    def psd(k, scale=1.0):
        M = rng.normal(size=(k, k))
        return scale * (M @ M.T / k + np.eye(k))

    A = np.stack([np.eye(n) + 0.1 * rng.normal(size=(n, n))
                  for _ in range(N)])
    B = 0.5 * rng.normal(size=(N, n, m))
    c = 0.1 * rng.normal(size=(N, n))
    Q = np.stack([psd(n, 0.5) for _ in range(N)])
    q = 0.1 * rng.normal(size=(N, n))
    R = np.stack([psd(m, 1.0) for _ in range(N)])
    r = 0.1 * rng.normal(size=(N, m))
    P = 0.1 * rng.normal(size=(N, m, n))
    QN = psd(n, 1.0)
    qN = 0.1 * rng.normal(size=(n,))
    x0 = rng.normal(size=(n,))
    return x0, A, B, c, Q, q, R, r, QN, qN, P


def kkt_oracle(x0, A, B, c, Q, q, R, r, QN, qN, P):
    """(xs, us) of the LQT problem by a dense float64 solve of its KKT
    system in z = [x_1..x_N, u_0..u_{N-1}] (a copy of tests/test_lqr.py:
    40-90)."""
    import numpy as np
    N, n = A.shape[0], A.shape[1]
    m = B.shape[2]
    nz = N * n + N * m

    def xi(k):
        return slice((k - 1) * n, k * n)

    def ui(k):
        return slice(N * n + k * m, N * n + (k + 1) * m)

    H = np.zeros((nz, nz))
    h = np.zeros(nz)
    for k in range(N):
        H[ui(k), ui(k)] += R[k]
        h[ui(k)] += r[k]
        if k == 0:
            h[ui(0)] += P[0] @ x0
        else:
            H[xi(k), xi(k)] += Q[k]
            h[xi(k)] += q[k]
            H[ui(k), xi(k)] += P[k]
            H[xi(k), ui(k)] += P[k].T
    H[xi(N), xi(N)] += QN
    h[xi(N)] += qN
    E = np.zeros((N * n, nz))
    d = np.zeros(N * n)
    for k in range(N):
        rows = slice(k * n, (k + 1) * n)
        E[rows, xi(k + 1)] = np.eye(n)
        E[rows, ui(k)] = -B[k]
        d[rows] = c[k]
        if k == 0:
            d[rows] += A[0] @ x0
        else:
            E[rows, xi(k)] = -A[k]
    KKT = np.block([[H, E.T], [E, np.zeros((N * n, N * n))]])
    sol = np.linalg.solve(KKT, np.concatenate([-h, d]))
    return (np.concatenate([x0[None], sol[: N * n].reshape(N, n)]),
            sol[N * n: nz].reshape(N, m))


def lqt_phase(info):
    """Both LQT solves on the card at config 2's backward shapes (N=40,
    n=6, m=2; B=256 and 1) against the float64 KKT solution and each other,
    and their times, CUDA events around each call (median of 20): the
    sequential Riccati against the parallel scan."""
    import numpy as np
    import torch
    from mpc_tpu_torch.solver.lqr import (lqt_solve_parallel,
                                          lqt_solve_sequential)
    out = {}
    for B in (256, 1):
        rng = np.random.default_rng(B)
        probs = [random_lqt(rng, 40, 6, 2) for _ in range(B)]
        oracle = [kkt_oracle(*p) for p in probs]
        xs_o = np.stack([o[0] for o in oracle])
        us_o = np.stack([o[1] for o in oracle])
        args = [torch.as_tensor(np.stack([p[i] for p in probs]),
                                dtype=torch.float32, device="cuda")
                for i in range(11)]
        sols, times = {}, {}
        for name, fn in (("sequential", lqt_solve_sequential),
                         ("parallel", lqt_solve_parallel)):
            sol = fn(*args[:10], P=args[10])
            torch.cuda.synchronize()
            err = max(float(np.abs(sol.us.cpu().numpy() - us_o).max()),
                      float(np.abs(sol.xs.cpu().numpy() - xs_o).max()))
            if not err <= LQT_TOL:
                fail(f"LQT {name} B={B}: max error {err:.3e} against the "
                     f"float64 KKT solution > {LQT_TOL}")
            sols[name] = sol
            times[name] = median_ms(lambda: fn(*args[:10], P=args[10]),
                                    n=20)
            out[(B, name)] = dict(ms=times[name], max_abs_err=err)
        gap = max(float((sols["parallel"].us
                         - sols["sequential"].us).abs().max()),
                  float((sols["parallel"].xs
                         - sols["sequential"].xs).abs().max()))
        if not gap <= LQT_PAIR_TOL:
            fail(f"LQT B={B}: parallel and sequential differ by {gap:.3e}")
        print(f"LQT B={B} N=40 n=6 m=2: sequential {times['sequential']:.3f}"
              f" ms (max err {out[(B, 'sequential')]['max_abs_err']:.2e}), "
              f"parallel {times['parallel']:.3f} ms (max err "
              f"{out[(B, 'parallel')]['max_abs_err']:.2e}), apart "
              f"{gap:.2e}; CUDA events around one call, median of 20; "
              f"{info['nvidia_smi']}")
    return out


def no_sync_phase(bench):
    """One masked AL-iLQR inner iteration at the ilqr_n40 shape under
    ``torch.cuda.set_sync_debug_mode("error")``: any host sync raises."""
    import torch
    loop = bench.ClosedLoop(bench.ILQR_N40)
    ys, carry = loop.start(loop.cell.batch)
    param = {"y0": ys, "p": loop.params, "centerline": loop.centerline}
    sigma = torch.full_like(carry.lam, loop.cell.alm_cfg.sigma_0)
    st, iterate, cond, result = loop.ctrl.solve.prepare_inner(
        param, carry.U, carry.lam, sigma)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = iterate(st)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    res = result(st)
    if not bool(torch.isfinite(res.cost).all()) \
            or int(res.iterations.min()) != 1:
        fail("no-sync check: the iteration did not run on every lane")
    print(f"no-sync check: one AL-iLQR inner iteration at batch "
          f"{loop.cell.batch}, N={loop.cell.n_horiz} ran with "
          f"set_sync_debug_mode('error') in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")


class Kernel(NamedTuple):
    """One fan kernel, its path and its checks."""
    label: str           # K1, K2, K3
    name: str            # the row's name in the kernel table
    variant: str
    wrapper: str         # its wrapper in mpc_tpu_torch.ops.fused_psi
    model: str
    al: bool             # the augmented-Lagrangian operands follow pvec
    cell: str            # its path: a cell of mpc_tpu_torch.bench
    n_horiz: int
    sd: int              # state dimension
    drawn: tuple         # ((E, road, VehicleParams kwargs, log_sigma), ...)
    seed: int            # of the drawn inputs; the AL operands use seed + 100
    captures: tuple      # Capture, ...: the first is timed at its shapes
    cap: Optional[int]   # captured calls checked per shape (None: all)
    n_plain: int         # timed runs of the plain version
    min_conv: float      # the path's least mean converged fraction
    count: str = "launches"   # the wrapper's count of this kernel's launches
    paths: tuple = ()    # the paths (bench cells) that launch it
    timed_E: tuple = ()  # further sizes on drawn inputs: checked, then
                         # timed (the kernel alone)


KERNELS = (
    # config 5's batch-1 loop runs K1 on scenario 0's road
    Kernel("K1", "fused_psi_fan", "K1, model=pacejka", "fan_value_and_grad",
           "pacejka", False, "HEADLINE", 12, 6,
           tuple((E, road, {}, None) for E in (1, 37, 5120)
                 for road in ("straight", "circle"))
           + ((37, "circle", dict(mass=0.25, cm1=0.4), None),),
           0, (Capture("HEADLINE", 3, (5120, 2048)),
               Capture("CONFIG5", 3, (5, 2), batch1=True)), None, 50, 0.99,
           paths=("headline", "config5 batch-1 loop", "etc", "mesh_dp",
                  "exp_shift_warm")),
    Kernel("K2", "fused_psi_fan_kin", "K2, model=simplified",
           "kin_fan_value_and_grad", "simplified", False, "CONFIG1", 20, 4,
           tuple((E, road, {}, None) for E in (1, 37, 5120)
                 for road in ("straight", "circle")),
           100, (Capture("CONFIG1", 2, (5120, 2048)),), None, 10, 0.99),
    Kernel("K3", "fused_psi_fan_al", "K3, al_ls", "al_fan_value_and_grad",
           "pacejka", True, "SS_N40", 40, 6,
           tuple((E, "lane change", {}, ls) for E in (1, 37, 1280)
                 for ls in ((-1, 3), (3, 9))),
           200, (Capture("SS_N40", 2, (1280, 512)),), K3_MAX_CALLS, 5, 0.98,
           timed_E=(8192, 20480, 40960)),
    # lanes per road K = 1 (a road for every lane, the most roads a block
    # stages), 5 (a candidate fan) and 2 (an init pair); config 5's
    # straggler tier gives further sizes, 5 and 2 x 64 x 2^j
    Kernel("K1 roads", "fused_psi_fan_roads",
           "K1 on per-lane roads (road stride K)", "fan_value_and_grad",
           "pacejka", False, "CONFIG5", 12, 6,
           tuple((E, ("scenarios", K), {}, None)
                 for E, K in ((1, 1), (37, 1), (35, 5), (10240, 5), (38, 2),
                              (10240, 2))),
           300, (Capture("CONFIG5", 2, (10240, 4096), exact=False),
                 Capture("CONFIG4", 2, (2560, 1024))),
           ROADS_MAX_CALLS, 5, 0.99, count="road_launches"),
)


#: P1's shapes (lanes, n, L-BFGS memory): the straight and circle cells'
#: and the kinematic cell's
DIRECTION_SHAPES = ((16384, 24, 12), (32768, 40, 20))
DIRECTION_TAUS = (1.0, 0.25, 1.0 / 16.0, 1.0 / 64.0)


def direction_phase(info, timing=False):
    """P1, PANOC's direction kernel, at ``DIRECTION_SHAPES`` on drawn rings
    (every ring state, a NaN-gradient lane): held against its plain version
    (not with ``timing``), timed with it by ``time_pair``, and its bound.
    Returns its row of the kernel table."""
    import torch
    from mpc_tpu_torch.kernels.check import (compare_direction,
                                             drawn_direction_inputs)
    from mpc_tpu_torch.solver import panoc
    from mpc_tpu_torch.utils.roofline import direction_bound
    taus, tr_mult = DIRECTION_TAUS, 1e5
    row = {"name": "panoc_direction", "label": "P1", "route": "cuda",
           "source": "mpc_tpu_torch/csrc/panoc_direction.cu",
           "replaces": "no TPU kernel: the JAX package's two-loop is jnp "
                       "(mpc_tpu/solver/panoc.py:241-281)",
           "library_ms": None, "ms_by_E": {}, "plain_ms_by_E": {},
           "bound_ms_by_E": {}, "bound_by": None, "lanes_checked": 0,
           "lanes_excused": 0}
    for B, n, M in DIRECTION_SHAPES:
        args = drawn_direction_inputs(B, n, M, seed=B + n, device="cuda",
                                      nan_lanes=(5,))
        out = panoc.direction(*args, tr_mult, taus)
        torch.cuda.synchronize()
        if not timing:
            r = compare_direction(out, *args, tr_mult, taus)
            print(f"kernel check P1 E={B} n={n} M={M}: {r}")
            if r["failed"] or r["nan_mismatch"] \
                    or not r["elementwise_equal"] \
                    or r["excused"] > EXCUSED_MAX_SHARE * B:
                fail(f"P1 at E={B}: {r}")
            row["lanes_checked"] += r["lanes"]
            row["lanes_excused"] += r["excused"]
        ms, plain_ms = time_pair(
            f"P1 E={B} n={n} M={M}",
            lambda: panoc.direction(*args, tr_mult, taus),
            lambda: panoc.direction_reference(*args, tr_mult, taus), 10, info)
        u, g, gamma, C, lb = args
        bound_ms, bound_by, nbytes, ops = direction_bound(
            B, n, M, len(taus), [u, g, gamma, C.lower, C.upper, *lb],
            list(out))
        print(f"bound P1 E={B}: {nbytes} bytes, {ops} operations -> "
              f"{bound_ms:.5f} ms ({bound_by}); kernel at "
              f"{bound_ms / ms:.2%} of it; plain version {plain_ms:.4f} ms")
        row["ms_by_E"][B] = ms
        row["plain_ms_by_E"][B] = plain_ms
        row["bound_ms_by_E"][B] = bound_ms
        row["bound_by"] = bound_by
    return row


def split(k, args):
    """A wrapper call's operands: ``(u, y0, cltab, pvec, al, fan_args)``."""
    u, y0, cltab, pvec = args[:4]
    if k.al:
        return u, y0, cltab, pvec, tuple(args[4:9]), tuple(args[9:])
    return u, y0, cltab, pvec, None, tuple(args[4:9])


def kernel_phase(k, fp, bench, info, timing=False):
    """Phases 3 and 4 for one kernel: its drawn and captured checks, then
    the timing of kernel and plain version at the fan shapes of its first
    capture (with ``timing``, no checks, that capture alone and the kernel
    alone). Returns a dict: the checks' ``lanes``, ``excused``,
    ``max_abs_err``, ``max_rel_err`` and ``lane_term_needed``; ``ms``,
    ``plain_ms``, ``bound_ms`` and ``bound_by`` at the candidate-fan shape;
    ``ms_by_E``; ``single_lane_ms`` and ``serial_chain_ms``."""
    import torch
    from mpc_tpu_torch.models.params import VehicleParams
    wrapper = getattr(fp, k.wrapper)
    fan_args = (k.n_horiz, SUBSTEPS, TS / SUBSTEPS, 1.0,
                fp.DEFAULT_VEHICLE_WEIGHTS)
    reports = []
    for i, (E, road, p_kw, log_sigma) in enumerate(() if timing
                                                   else k.drawn):
        u, y0, cl = drawn_inputs(E, k.n_horiz, k.sd, road, seed=k.seed + i)
        cltab, pvec = fp.fan_params(cl, VehicleParams(**p_kw))
        al = drawn_al(E, k.n_horiz, log_sigma, seed=k.seed + 100 + i) \
            if k.al else None
        psi, grad = wrapper(u, y0, cltab, pvec, *(al or ()), *fan_args)
        torch.cuda.synchronize()
        tag = f"{k.label} E={E} " \
            + (f"{cltab.shape[0]} scenario roads, K={E // cltab.shape[0]}"
               if cltab.dim() == 3 else road) \
            + (" p*" if p_kw else "") \
            + (f" sigma in 1e{log_sigma}" if k.al else "")
        reports.append(check(tag, psi, grad, u, y0, cltab, pvec, fan_args,
                             model=k.model, al=al))
    # the further sizes, on drawn inputs on the first drawn road: checked
    # here with the drawn ones, timed below
    sized = []
    for i, E in enumerate(k.timed_E):
        u, y0, cl = drawn_inputs(E, k.n_horiz, k.sd, k.drawn[0][1],
                                 seed=k.seed + 50 + i)
        cltab, pvec = fp.fan_params(cl, VehicleParams())
        al = drawn_al(E, k.n_horiz, (-1, 3), seed=k.seed + 150 + i) \
            if k.al else None
        sized.append((E, (u, y0, cltab, pvec, *(al or ()), *fan_args)))
        if timing:
            continue
        psi, grad = wrapper(*sized[-1][1])
        torch.cuda.synchronize()
        reports.append(check(f"{k.label} E={E} drawn {k.drawn[0][1]}"
                             + (" sigma in 1e(-1, 3)" if k.al else ""),
                             psi, grad, u, y0, cltab, pvec, fan_args,
                             model=k.model, al=al))

    timed = None
    for source in k.captures[:1] if timing else k.captures:
        cell = getattr(bench, source.cell)
        t0 = time.perf_counter()
        captured = capture_fan_inputs(k.wrapper, source)
        by_E = {}
        for c in captured:
            by_E.setdefault(c[1][0].shape[0], []).append(c)
        where = f"{cell.name}{' batch-1 loop' if source.batch1 else ''}"
        print(f"{k.label}: captured {len(captured)} fan calls of "
              f"{source.steps} closed-loop steps of {where} in "
              f"{time.perf_counter() - t0:.1f} s ("
              + ", ".join(f"{len(v)} at E={E}"
                          for E, v in sorted(by_E.items()))
              + (f"); checking at most {k.cap} per shape" if k.cap else ")"))
        if not set(source.shapes) <= set(by_E) \
                or (source.exact and sorted(by_E) != sorted(source.shapes)):
            fail(f"{where} gave its fan shapes {sorted(by_E)}, not "
                 f"{sorted(source.shapes)}")
        timed = timed or (source, by_E)
        if timing:
            continue
        calls = [c for v in by_E.values()
                 for c in (spread(v, k.cap) if k.cap else v)]
        for E, n, psi, grad, u, y0, cltab, pvec, fa, al in \
                check_captured(wrapper, calls, lambda args: split(k, args)):
            reports.append(check(f"{k.label} {where} E={E} ({n} calls)",
                                 psi, grad, u, y0, cltab, pvec, fa,
                                 model=k.model, al=al))
    out = {}
    if not timing:
        out = dict(
            lanes=sum(r["lanes"] for r in reports),
            excused=sum(r["excused"] for r in reports),
            max_abs_err=max(r["max_abs_err_within_bar"] for r in reports),
            max_rel_err=max(r["max_rel_err_within_bar"] for r in reports),
            lane_term_needed=max(r["lane_term_needed"] for r in reports))
        print(f"kernel check {k.label}: {out['lanes']} lanes, "
              f"{out['excused']} ill-conditioned lanes excused, max err over "
              f"the rest {out['max_abs_err']:.3e} abs, "
              f"{out['max_rel_err']:.3e} of the lane's scale, lane term "
              f"needed {out['lane_term_needed']:.3e}")

    source, by_E = timed
    out["ms_by_E"] = {}
    for E in source.shapes:
        args = by_E[E][0][1]
        u, y0, cltab, pvec, al, fa = split(k, args)
        ms, plain_ms = time_pair(
            f"{k.label} E={E}", lambda: wrapper(*args),
            None if timing else
            lambda: fp.fan_value_and_grad_reference(
                u, y0, cltab, pvec, *fa, model=k.model, al=al),
            k.n_plain, info)
        psi, grad = wrapper(*args)
        # the operands include every road's table, each read once
        bound_ms, bound_by, nbytes, ops, former_ms = fan_bound(
            k.model, k.al, E, k.n_horiz, SUBSTEPS, cltab.shape[-2],
            [u, y0, cltab, pvec, *(al or ())], [psi, grad])
        print(f"bound {k.label} E={E}: {nbytes} bytes, {ops} operations -> "
              f"{bound_ms:.5f} ms ({bound_by}); kernel at "
              f"{bound_ms / ms:.2%} of it; former count {former_ms:.5f} ms")
        out["ms_by_E"][E] = ms
        if E == source.shapes[0]:
            out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by)
    for E, args in sized:
        ms, _ = time_pair(f"{k.label} E={E} drawn", lambda: wrapper(*args),
                          None, 0, info)
        psi, grad = wrapper(*args)
        bound_ms = fan_bound(k.model, k.al, E, k.n_horiz, SUBSTEPS,
                             args[2].shape[-2], list(args[:-len(fan_args)]),
                             [psi, grad])[0]
        print(f"bound {k.label} E={E} drawn: {bound_ms:.5f} ms; kernel at "
              f"{bound_ms / ms:.2%} of it")
        out["ms_by_E"][E] = ms
    out["single_lane_ms"], out["serial_chain_ms"] = serial_chain(
        k, wrapper, fp, info)
    return out


def main():
    if not os.path.isdir(os.path.join(HERE, "mpc_tpu_torch")):
        fail("mpc_tpu_torch/ is not beside chip_smoke.py: run it from a "
             "checkout of the repository")
    timing = sys.argv[1:] == ["--timing"]
    if sys.argv[1:] and not timing:
        fail(f"unknown arguments {sys.argv[1:]}: the one option is --timing")
    sys.path.insert(0, HERE)
    import torch
    # the kernels' timing and bounds, for every phase that times a kernel
    global fan_bound, launch_ms
    from mpc_tpu_torch.utils.roofline import fan_bound, launch_ms

    # ---- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    from mpc_tpu_torch import bench
    info = bench.gpu_info()
    kind = torch.cuda.get_device_name(0)
    print(info["nvidia_smi"])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t_start = time.perf_counter()

    # ---- 2. build ---------------------------------------------------------
    # the fan kernels (nvcc) and config 5's scenario generator (g++), each
    # from its source in this checkout, built at the same time
    import threading
    from mpc_tpu_torch.kernels import build as kbuild
    t0 = time.perf_counter()
    native = {}

    def build_native():
        try:
            from mpc_tpu_torch.io import native_scenarios
            native_scenarios.load()
        except Exception as e:      # reported after the kernels' build
            native["error"] = e

    # an earlier commit timed by this script has no generator to build
    has_native = os.path.exists(os.path.join(HERE, "mpc_tpu_torch", "io",
                                             "native_scenarios.py"))
    thread = threading.Thread(target=build_native)
    if has_native:
        thread.start()
    b = kbuild.build("fused_psi")
    kbuild.load_fused_psi()
    # an earlier commit timed by this script has no direction kernel
    has_p1 = hasattr(kbuild, "load_panoc_direction")
    b_p1 = kbuild.build("panoc_direction") if has_p1 else None
    if has_p1:
        kbuild.load_panoc_direction()
    if has_native:
        thread.join()
        if "error" in native:
            fail(f"the native scenario generator did not build: "
                 f"{native['error']}")
    print(f"build: fused_psi {'compiled' if b['built'] else 'cached'} in "
          f"{time.perf_counter() - t0:.2f} s -> "
          f"{os.path.relpath(b['path'], HERE)}")
    if has_p1:
        print(f"build: panoc_direction "
              f"{'compiled' if b_p1['built'] else 'cached'} in "
              f"{b_p1['seconds']:.2f} s -> "
              f"{os.path.relpath(b_p1['path'], HERE)}")
    for line in (b["log"] + (b_p1["log"] if has_p1 else "")).splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "error")):
            print(f"  nvcc: {line.strip()}")

    # ---- 3, 4. kernel checks and timing -----------------------------------
    from mpc_tpu_torch.ops import fused_psi as fp
    if timing:
        # a kernel whose path this checkout's bench lacks (an earlier
        # commit's, timed by this script) is left out
        kernels = [k for k in KERNELS if hasattr(bench, k.cell)]
        for k in KERNELS:
            if k not in kernels:
                print(f"timing {k.label}: skipped, no path {k.cell} in this "
                      f"checkout")
        measured = [kernel_phase(k, fp, bench, info, timing)
                    for k in kernels]
        p1 = [direction_phase(info, timing)] if has_p1 else []
        print(f"kernel phases done in {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"timing": [
            {"name": k.name, "ms_by_E": m["ms_by_E"],
             "single_lane_ms": m["single_lane_ms"],
             "serial_chain_ms": m["serial_chain_ms"]}
            for k, m in zip(kernels, measured)] + p1}))
        return
    measured = [kernel_phase(k, fp, bench, info) for k in KERNELS]
    p1 = direction_phase(info)
    print(f"kernel phases done in {time.perf_counter() - t_start:.1f} s")

    # ---- 5. the LQT solves and the no-sync check --------------------------
    lqt_phase(info)
    no_sync_phase(bench)

    # ---- 6. the paths -----------------------------------------------------
    def own(k, counts):
        """Kernel ``k``'s own launches among ``counts``: K1's on one road
        are the wrapper's launches less those on per-lane roads."""
        if k.count == "road_launches":
            return counts["road_launches"]
        return counts[k.wrapper] - (counts["road_launches"]
                                    if k.wrapper == "fan_value_and_grad"
                                    else 0)

    runs = {k.cell: drive(getattr(bench, k.cell), getattr(fp, k.wrapper),
                          fp, k.min_conv, roads=k.count == "road_launches")
            for k in KERNELS}
    runs["ILQR_N40"] = drive(bench.ILQR_N40, None, fp, 0.98)
    runs["ETC"] = drive(bench.ETC, fp.fan_value_and_grad, fp, 0.99)
    runs["CONFIG4"] = drive(bench.CONFIG4, fp.fan_value_and_grad, fp, None,
                            roads=True)
    print(f"kernel paths done in {time.perf_counter() - t_start:.1f} s")

    # ---- 7. the unfused paths ---------------------------------------------
    drive(bench.MS_N40_M8, None, fp, 0.85)
    drive(bench.CONFIG5_OBS, None, fp, 0.99)
    drive(bench.CHAIN, None, fp, None)
    fan_graph_phase(bench, info)
    window_phase(bench, fp, info)
    ilqr_obstacle_phase(fp, info)

    # ---- 8. the sharded paths ---------------------------------------------
    parallel_phase(bench, fp, info, measured[0])

    # ---- 9. the entry points ----------------------------------------------
    entry_runs = entry_points_phase(fp)

    # ---- 10. the measurements -------------------------------------------
    shift_warm = measurements_phase(fp, measured[0], info)
    print(f"all phases done in {time.perf_counter() - t_start:.1f} s")

    rows = []
    for k, m in zip(KERNELS, measured):
        # no single PyTorch call computes the fan (rollout, argmin, stage
        # cost and adjoint), so there is no library time
        rows.append({
            "name": k.name, "variant": k.variant, "route": "cuda",
            "source": "mpc_tpu_torch/csrc/fused_psi.cu",
            "replaces": "mpc_tpu/ops/fused_psi.py:321",
            "launches": own(k, runs[k.cell]),
            **{f"launches_{c.lower()}": own(k, runs[c])
               for c in ("ETC", "ILQR_N40", "CONFIG5", "CONFIG4")
               if c != k.cell},
            "max_abs_err": m["max_abs_err"],
            "max_rel_err": m["max_rel_err"],
            "lane_term_needed": m["lane_term_needed"],
            "lanes_checked": m["lanes"], "lanes_excused": m["excused"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None, "single_lane_ms": m["single_lane_ms"],
            "serial_chain_ms": m["serial_chain_ms"], "paths": list(k.paths),
            **{key: m[key] for key in ("launches_mesh_dp", "mesh_dp_ms_by_E",
                                       "mesh_dp_lanes_checked",
                                       "exp_shift_warm_ms_by_E",
                                       "exp_shift_warm_lanes_checked")
               if key in m},
            "launches_entry_points": {tag: c[k.label] for tag, c in
                                      entry_runs.items() if c[k.label]},
            **({"launches_exp_shift_warm": shift_warm}
               if k.label == "K1" else {})})
    print(json.dumps({"kernels": rows + [p1]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
