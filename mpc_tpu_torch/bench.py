"""Benchmark of the port's paths: batched warm-started MPC solves on one
NVIDIA GPU, one closed loop per cell.

- ``headline`` (the default): the counterpart of the repository's root
  ``bench.py`` (the JAX package on a TPU), with the same shape: the Pacejka
  vehicle OCP, N=12, 24 decision variables, 100-point straight centerline,
  ``AlmConfig(eps=1e-4)``, ``PanocConfig(lbfgs_memory=12, max_iter=300)``,
  batch 1024, 5 warm-up and 20 timed closed-loop steps with the plant
  stepped by the same ``f_d``, then a batch-1 closed loop for the
  single-solve latency. Its fan is kernel K1.
- ``config1``: the kinematic bicycle on the straight road, N=20,
  ``AlmConfig(eps=1e-4)``, ``PanocConfig(lbfgs_memory=20, max_iter=200)``,
  batch 1024, 4 warm-up and 10 timed steps, initial states
  ``[0, U(-0.05, 0.05), 0, U(0.2, 1.0)]`` (examples/bench_suite.py:116-128).
  Its fan is kernel K2.
- ``ss_n40``: the Pacejka OCP with bounded state constraints, single
  shooting at N=40 through the ALM general path, on the lane-change Bezier
  road, ``AlmConfig(eps=1e-3, delta=1e-3, max_iter=8, eps_0=1e-2,
  sigma_0=1e3)``, ``PanocConfig(lbfgs_memory=40, max_iter=150)``, batch 256,
  3 warm-up and 6 timed steps (examples/exp_ms.py:97-119). Its fan is
  kernel K3.
- ``ilqr_n40``: config 2 (examples/bench_suite.py:145-169), the same OCP
  and road solved by AL-iLQR with the sequential Riccati backward pass,
  ``AlmConfig(delta=1e-3, max_iter=8, sigma_0=1e3, penalty_factor=5.0)``,
  ``IlqrConfig(max_iter=30)``, batch 256 on the ss_n40 initial states, 4
  warm-up and 6 timed steps, then a batch-1 loop of 3 warm-up and 10 timed
  steps (the source runs 5 + 40). No kernel: batched torch ops throughout.
- ``etc``: config 3 (examples/bench_suite.py:172-215), event-triggered MPC
  (threshold 1e-2, eps 1e-4) over the headline's controller on the straight
  road, batch 1024, y0 = [0, U(-0.1, 0.1), 0, U(0.3, 1.0), 0, 0], 4 warm-up
  and 12 timed steps. Its fan is kernel K1; it also reports the mean
  fraction of lanes that trigger a solve.
- ``config5``: the randomized scenario suite (examples/bench_suite.py:
  307-364): 2048 scenarios of the native generator (seed 0, 100-point
  roads), one road per lane, N=12, ``AlmConfig(eps=1e-4)``, rolled out 10
  steps in two tiers (``sim/scenarios.py:run_scenario_suite_two_tier``): a
  cheap pass ``PanocConfig(lbfgs_memory=12, max_iter=40)`` over every lane,
  then the lanes it left unconverged again at ``max_iter=150``, padded to
  64 x 2^j lanes; one untimed 2-step pass first. Then a batch-1 loop on
  scenario 0's road (5 warm-up, 40 timed steps). Its fan is K1 on per-lane
  roads ("K1 roads"; the batch-1 loop's is K1 on one road).
- ``config4``: the two-car game (examples/bench_suite.py:218-304): 256
  overtake pairs (``np.random.default_rng(7)``), both cars in lane 1, 10
  steps of iterated best response and one MPC solve per car, each car on
  its lane's road, N=12, ``AlmConfig(eps=1e-4)``,
  ``PanocConfig(lbfgs_memory=12, max_iter=150)``; one warm loop, then the
  median of 3 timed loops; then the lane payoffs alone at batch 4096 with 4
  cars (``default_rng(1)``), the median of 20 timed calls. Its fan is K1 on
  per-lane roads.

- ``ms_n40_m8``: multiple shooting (examples/exp_ms.py:136-142, ``bench()``
  at :39-80): ss_n40's OCP, road and initial states split into 8 segments
  of 5 stages glued by defect equalities, ``AlmConfig(eps=1e-3,
  delta=1e-3, max_iter=8, eps_0=1e-2, sigma_0=1e3, penalty_factor=5.0)``
  (defects at sigma_0 = 10), ``PanocConfig(lbfgs_memory=40,
  max_iter=150)``, batch 256, 3 warm-up and 6 timed steps. No kernel: the
  plain OCP's fan is autograd over B*K lanes.
- ``config5_obs``: config 5 with the obstacle field of the JAX package's
  suite test (tests/test_obstacle_avoidance.py:36, :88-92:
  ``obstacle_weight=1.0``, ``a_f=1.0``, ``sigma_x=0.2``), each lane with its
  scenario's 2 obstacles; no batch-1 loop. No kernel (the plain OCP). It
  reports the least distance from any car to any obstacle over the timed
  rollout beside the same number from the same steps without the term.
- ``chain``: the hanging chain (examples/hanging_chain.py:32-60, the
  reference's alpaqa demo): 6 balls in 2-D, disturbed 3 steps at
  u = [-0.5, 0.5], N=12, the chain controller's ``AlmConfig``,
  ``PanocConfig(lbfgs_memory=12, max_iter=250)``, batch 1, a closed loop
  of ``CHAIN_STEPS`` steps (the source runs 180). No kernel.

The sharded cells (``parallel/``) run over the ranks of the world they
are started in: under ``torchrun``, one rank per card on NCCL; started
alone, a world of one rank on this process's card, whose collectives are
copies. Rank 0 prints.

- ``mesh_dp``: the scenario-sharded vehicle solver
  (examples/exp_mesh_scaling.py:46-75): ``make_mesh(world, 1)``, the
  headline's OCP at N=12 on the 100-point straight road,
  ``AlmConfig(eps=1e-4)``, ``PanocConfig(lbfgs_memory=12, max_iter=60)``,
  batch 256, cold U0 = [1, 0] and zero multipliers, y0[:, 1] ~ U(-0.1, 0.1),
  y0[:, 3] ~ U(0.3, 1.0) from ``default_rng(0)``; one warm-up call, then
  the median of 5 timed calls; solves/s = batch / p50. Its fan is K1.
- ``mesh_lqt``: the horizon-sharded LQT (examples/exp_mesh_lqt.py:40-75):
  ``make_horizon_mesh(1, world)``, N=512, batch 4, n=6, m=2, from
  ``default_rng(0)``; one warm-up, then the median of 10; its error against
  ``lqt_solve_parallel`` (and, from chip_smoke.py, the float64 KKT
  solution). No kernel.
- ``mesh_ilqr``: one AL-iLQR MPC step per lane through
  ``build_vehicle_ilqr_controller(mesh=make_horizon_mesh(1, world))``
  (``__graft_entry__.py:107-131``) at ilqr_n40's width (its OCP, road,
  configurations and 256 initial states): 1 warm-up and 3 timed
  closed-loop steps; its first step against ilqr_n40's own controller on
  the same lanes. No kernel.

``solves/s`` is all the timed solves over all the timed wall time; the root
``bench.py`` divides the batch by the p50 step.

    python -m mpc_tpu_torch.bench [headline|config1|ss_n40|ilqr_n40|etc|config5|config4|ms_n40_m8|config5_obs|chain|mesh_dp|mesh_lqt|mesh_ilqr]
    torchrun --nproc_per_node=<gpus> -m mpc_tpu_torch.bench mesh_dp

Prints, for the closed-loop cells, the lane that spent the most inner
iterations in each timed step and that count (``{"slowest_lane_per_step":
[[lane, iterations], ...]}``), then a detail JSON line (with the card's
name and power limit) and, last, the result JSON line. Without a CUDA
device it exits with an error: a measurement is never taken on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from mpc_tpu_torch.config import AlmConfig, IlqrConfig, PanocConfig
from mpc_tpu_torch.control.event_triggered import EventTriggeredController
from mpc_tpu_torch.control.chain_mpc import (build_chain_controller,
                                             floor_coefficients, g_constr)
from mpc_tpu_torch.control.mpc import (build_vehicle_controller,
                                       build_vehicle_ilqr_controller,
                                       build_vehicle_ms_controller)
from mpc_tpu_torch.decision.game_theory import Cars, Ego, lane_payoffs
from mpc_tpu_torch.models.bicycle import pacejka_dynamics, simplified_dynamics
from mpc_tpu_torch.models.chain import ChainSpec, chain_dynamics
from mpc_tpu_torch.models.integrators import discretize
from mpc_tpu_torch.models.params import ChainParams, VehicleParams
from mpc_tpu_torch.ops import fused_psi as fp
from mpc_tpu_torch.ops.bezier import (bezier_centerline,
                                      lane_change_control_points)
from mpc_tpu_torch.ops.road import straight_centerline
from mpc_tpu_torch.parallel.distributed import initialize_world
from mpc_tpu_torch.parallel.lqr_sharded import make_lqt_horizon_sharded
from mpc_tpu_torch.parallel.mesh import make_horizon_mesh, make_mesh
from mpc_tpu_torch.parallel.sharding import make_sharded_vehicle_solver
from mpc_tpu_torch.sim.scenarios import run_scenario_suite_two_tier
from mpc_tpu_torch.solver.lqr import lqt_solve_parallel
from mpc_tpu_torch.sim.two_car import make_two_car_game
from mpc_tpu_torch.utils.perfdb import gpu_info

REALTIME_BUDGET_S = 0.05   # Ts, the control interval
BATCH, N_HORIZ, CENTERLINE_POINTS = 1024, 12, 100
N_WARMUP, N_STEPS, N_LATENCY, SEED = 5, 20, 50, 0


def initial_states(batch: int, seed: int = SEED) -> np.ndarray:
    """Initial plant states, drawn as the root bench.py draws them."""
    rng = np.random.default_rng(seed)
    y0s = np.zeros((batch, 6), np.float32)
    y0s[:, 0] = rng.uniform(-0.1, 0.5, batch)
    y0s[:, 1] = rng.uniform(-0.1, 0.1, batch)
    y0s[:, 2] = rng.uniform(-0.2, 0.2, batch)
    y0s[:, 3] = rng.uniform(0.3, 1.0, batch)
    return y0s


def config1_states(batch: int, seed: int = SEED) -> np.ndarray:
    """[0, U(-0.05, 0.05), 0, U(0.2, 1.0)], drawn lane by lane as
    examples/bench_suite.py:123-125 draws them."""
    rng = np.random.default_rng(seed)
    return np.stack([np.array([0, rng.uniform(-0.05, 0.05), 0,
                               rng.uniform(0.2, 1.0)], np.float32)
                     for _ in range(batch)])


def lane_change_road(device=None) -> torch.Tensor:
    """The 100-point lane-change Bezier road of examples/exp_ms.py:97-98."""
    pts = lane_change_control_points(5.0, device=device).control_points
    return bezier_centerline(pts * 0.01, size=100)


def ss_n40_states(batch: int, seed: int = SEED) -> np.ndarray:
    """At the road's start, heading along it: [cl0_x, cl0_y + U(-0.02,
    0.02), heading of cl1 - cl0, U(0.2, 0.8), 0, 0]
    (examples/exp_ms.py:99-106)."""
    cl = lane_change_road().numpy()
    d0 = cl[1] - cl[0]
    rng = np.random.default_rng(seed)
    y0s = np.zeros((batch, 6), np.float32)
    y0s[:, 0] = cl[0, 0]
    y0s[:, 1] = cl[0, 1] + rng.uniform(-0.02, 0.02, batch)
    y0s[:, 2] = np.arctan2(np.float32(d0[1]), np.float32(d0[0]))
    y0s[:, 3] = rng.uniform(0.2, 0.8, batch)
    return y0s


def etc_states(batch: int, seed: int = SEED) -> np.ndarray:
    """[0, U(-0.1, 0.1), 0, U(0.3, 1.0), 0, 0], drawn as
    examples/bench_suite.py:182-186 draws them."""
    rng = np.random.default_rng(seed)
    y0s = np.zeros((batch, 6), np.float32)
    y0s[:, 1] = rng.uniform(-0.1, 0.1, batch)
    y0s[:, 3] = rng.uniform(0.3, 1.0, batch)
    return y0s


@dataclasses.dataclass(frozen=True)
class Cell:
    """One benchmark configuration: controller, plant, road, lanes, steps.

    ``solver_cfg`` is the inner solver's configuration, and its type names
    the solver family: ``PanocConfig`` (ALM+PANOC) or ``IlqrConfig``
    (AL-iLQR). ``batch1_steps`` is the (warm-up, timed) steps of a batch-1
    loop after the batched one; ``trigger_threshold`` wraps the controller
    in event-triggered MPC; ``n_segments`` makes it the multiple-shooting
    controller; ``window`` searches the road in a window (the plain OCP)."""
    name: str
    model: str
    n_horiz: int
    alm_cfg: AlmConfig
    solver_cfg: PanocConfig | IlqrConfig
    road: Callable[..., torch.Tensor]
    states: Callable[[int], np.ndarray]
    batch: int
    n_warmup: int
    n_steps: int
    bound_state_constraints: bool = False
    batch1_steps: Optional[tuple] = None
    trigger_threshold: Optional[float] = None
    n_segments: Optional[int] = None
    window: Optional[int] = None


def _straight(device):
    return straight_centerline(CENTERLINE_POINTS, device=device)


HEADLINE = Cell(
    "headline", "pacejka", N_HORIZ, AlmConfig(eps=1e-4),
    PanocConfig(lbfgs_memory=N_HORIZ, max_iter=300), _straight,
    initial_states, BATCH, N_WARMUP, N_STEPS,
    batch1_steps=(N_WARMUP, N_LATENCY))
CONFIG1 = Cell(
    "config1", "simplified", 20, AlmConfig(eps=1e-4),
    PanocConfig(lbfgs_memory=20, max_iter=200), _straight,
    config1_states, 1024, 4, 10)
SS_N40 = Cell(
    "ss_n40", "pacejka", 40,
    AlmConfig(eps=1e-3, delta=1e-3, max_iter=8, eps_0=1e-2, sigma_0=1e3),
    PanocConfig(lbfgs_memory=40, max_iter=150), lane_change_road,
    ss_n40_states, 256, 3, 6, bound_state_constraints=True)
ILQR_N40 = Cell(
    "ilqr_n40", "pacejka", 40,
    AlmConfig(delta=1e-3, max_iter=8, sigma_0=1e3, penalty_factor=5.0),
    IlqrConfig(max_iter=30), lane_change_road, ss_n40_states, 256, 4, 6,
    bound_state_constraints=True, batch1_steps=(3, 10))
ETC = Cell(
    "etc", "pacejka", N_HORIZ, AlmConfig(eps=1e-4),
    PanocConfig(lbfgs_memory=N_HORIZ, max_iter=300), _straight, etc_states,
    1024, 4, 12, trigger_threshold=1e-2)
MS_N40_M8 = Cell(
    "ms_n40_m8", "pacejka", 40,
    AlmConfig(eps=1e-3, delta=1e-3, max_iter=8, eps_0=1e-2, sigma_0=1e3,
              penalty_factor=5.0),
    PanocConfig(lbfgs_memory=40, max_iter=150), lane_change_road,
    ss_n40_states, 256, 3, 6, bound_state_constraints=True, n_segments=8)


@dataclasses.dataclass(frozen=True)
class SuiteCell:
    """The randomized scenario suite in two tiers: scenarios of the native
    generator, one road per lane; with ``obstacle_weight`` > 0 the cost has
    the obstacle field (``obstacle_field_kwargs``) and each lane its
    scenario's obstacles. ``batch1_steps`` None: no batch-1 loop."""
    name: str
    n_horiz: int
    alm_cfg: AlmConfig
    full_cfg: PanocConfig
    cheap_cfg: PanocConfig
    batch: int
    size: int
    seed: int
    n_sim: int
    n_warm_steps: int
    straggler_pad: int
    batch1_steps: Optional[tuple]
    obstacle_weight: float = 0.0
    obstacle_field_kwargs: Optional[dict] = None


@dataclasses.dataclass(frozen=True)
class TwoCarCell:
    """The two-car game over scenario pairs, and its payoff line."""
    name: str
    n_horiz: int
    alm_cfg: AlmConfig
    solver_cfg: PanocConfig
    pairs: int
    n_sim: int
    n_loops: int
    payoff_batch: int
    payoff_cars: int
    payoff_calls: int


CONFIG5 = SuiteCell(
    "config5", N_HORIZ, AlmConfig(eps=1e-4),
    PanocConfig(lbfgs_memory=N_HORIZ, max_iter=150),
    PanocConfig(lbfgs_memory=N_HORIZ, max_iter=40), batch=2048,
    size=CENTERLINE_POINTS, seed=0, n_sim=10, n_warm_steps=2,
    straggler_pad=64, batch1_steps=(5, 40))
CONFIG4 = TwoCarCell(
    "config4", N_HORIZ, AlmConfig(eps=1e-4),
    PanocConfig(lbfgs_memory=N_HORIZ, max_iter=150), pairs=256, n_sim=10,
    n_loops=3, payoff_batch=4096, payoff_cars=4, payoff_calls=20)
CONFIG5_OBS = dataclasses.replace(
    CONFIG5, name="config5_obs", batch1_steps=None, obstacle_weight=1.0,
    obstacle_field_kwargs={"a_f": 1.0, "sigma_x": 0.2})


@dataclasses.dataclass(frozen=True)
class ChainCell:
    """The hanging chain's closed loop at batch ``batch``, after
    ``n_dist`` disturbance steps at ``u_dist``; ``alm_cfg`` None is the
    chain controller's default."""
    name: str
    n_balls: int
    dim: int
    n_horiz: int
    alm_cfg: Optional[AlmConfig]
    solver_cfg: PanocConfig
    u_dist: tuple
    n_dist: int
    batch: int
    n_steps: int


#: the chain cell's closed-loop steps, cut from the source's 180: see
#: PERF.md section 4
CHAIN_STEPS = 60
CHAIN = ChainCell("chain", 6, 2, N_HORIZ, None,
                  PanocConfig(lbfgs_memory=N_HORIZ, max_iter=250),
                  (-0.5, 0.5), 3, 1, CHAIN_STEPS)


@dataclasses.dataclass(frozen=True)
class MeshCell:
    """A cell of the sharded paths (``parallel/``), run over the ranks of
    the world it is started in: ``mesh_dp`` the scenario-sharded vehicle
    solver, ``mesh_lqt`` the horizon-sharded LQT, ``mesh_ilqr`` the
    horizon-sharded AL-iLQR controller. ``n_warmup`` untimed and
    ``n_steps`` timed calls (or closed-loop steps)."""
    name: str
    batch: int
    n_horiz: int
    n_warmup: int
    n_steps: int


MESH_DP = MeshCell("mesh_dp", 256, N_HORIZ, 1, 5)
MESH_LQT = MeshCell("mesh_lqt", 4, 512, 1, 10)
MESH_ILQR = MeshCell("mesh_ilqr", 256, 40, 1, 3)
#: mesh_dp's solver settings (examples/exp_mesh_scaling.py:46-50)
MESH_DP_ALM = AlmConfig(eps=1e-4)
MESH_DP_PANOC = PanocConfig(lbfgs_memory=N_HORIZ, max_iter=60)
CELLS = {c.name: c for c in (HEADLINE, CONFIG1, SS_N40, ILQR_N40, ETC,
                             CONFIG5, CONFIG4, MS_N40_M8, CONFIG5_OBS,
                             CHAIN, MESH_DP, MESH_LQT, MESH_ILQR)}


class ClosedLoop:
    """A cell's controller, plant and road on the card (or on ``device``
    where a caller names one); ``step(ys, carry) -> (ys, carry, out)`` is
    one closed-loop step, with ``out`` the controller's step output
    (``out.result`` the solve's)."""

    def __init__(self, cell: Cell = HEADLINE, device=None):
        dev = self.device = _cuda() if device is None \
            else torch.device(device)
        self.cell = cell
        self.params = VehicleParams()
        self.f_d = discretize(pacejka_dynamics if cell.model == "pacejka"
                              else simplified_dynamics)
        kw = dict(n_horiz=cell.n_horiz, alm_cfg=cell.alm_cfg,
                  model=cell.model,
                  bound_state_constraints=cell.bound_state_constraints,
                  device=dev)
        if isinstance(cell.solver_cfg, IlqrConfig):
            self.ctrl = build_vehicle_ilqr_controller(
                ilqr_cfg=cell.solver_cfg, **kw)
        elif cell.n_segments is not None:
            self.ctrl, _ = build_vehicle_ms_controller(
                n_segments=cell.n_segments, panoc_cfg=cell.solver_cfg, **kw)
        else:
            self.ctrl = build_vehicle_controller(panoc_cfg=cell.solver_cfg,
                                                 window=cell.window, **kw)
        if cell.trigger_threshold is not None:
            self.ctrl = EventTriggeredController(
                base=self.ctrl, f_d=self.f_d,
                threshold=cell.trigger_threshold, eps=cell.alm_cfg.eps)
        self.centerline = cell.road(device=dev)

    def start(self, batch: int):
        """Cold carry for ``batch`` lanes and their plant states: the first
        ``batch`` rows of the cell's initial states."""
        ys = torch.as_tensor(self.cell.states(self.cell.batch)[:batch],
                             device=self.device)
        return ys, self.ctrl.init_carry(batch, device=self.device)

    def step(self, ys, carry):
        out = self.ctrl.step(carry, {"y0": ys, "p": self.params,
                                     "centerline": self.centerline})
        return self.f_d(ys, out.u0, self.params), out.carry, out


class StepRecord:
    """Per controller step, in call order: the slowest lane's PANOC
    iterations (``iters``) and the converged fraction (``converged``),
    tensors on the card (no sync); the controller's tag (``tiers``) and the
    K1 kernel's launches in the step (``fan_launches``)."""

    def __init__(self):
        self.iters, self.converged = [], []
        self.tiers, self.fan_launches = [], []

    def clear(self):
        for items in (self.iters, self.converged, self.tiers,
                      self.fan_launches):
            items.clear()

    def launches_by_tier(self, start: int = 0) -> dict:
        """Per two-tier step from the ``start``-th record: the fan launches
        of its cheap pass and of its straggler pass (0 where no lane
        straggled), ``{"cheap": [...], "straggler": [...]}``."""
        out = {"cheap": [], "straggler": []}
        for tier, n in zip(self.tiers[start:], self.fan_launches[start:]):
            if tier == "cheap":
                out["cheap"].append(n)
                out["straggler"].append(0)
            else:
                out["straggler"][-1] += n
        return out


class _Recorded:
    """A controller whose every step is added to a ``StepRecord`` under the
    tag ``tier``."""

    def __init__(self, ctrl, record: StepRecord, tier: str = ""):
        self.ctrl, self.record, self.device = ctrl, record, ctrl.device
        self.problem = ctrl.problem
        self.tier = tier
        self.states = []        # the cheap tier's y0: every lane, each step

    def init_carry(self, *args, **kwargs):
        return self.ctrl.init_carry(*args, **kwargs)

    def step(self, carry, param):
        n0 = fp.fan_value_and_grad.launches
        if self.tier == "cheap":
            self.states.append(param["y0"])
        out = self.ctrl.step(carry, param)
        self.record.iters.append(out.result.inner_iterations.max())
        self.record.converged.append(out.result.converged.float().mean())
        self.record.tiers.append(self.tier)
        self.record.fan_launches.append(fp.fan_value_and_grad.launches - n0)
        return out


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("mpc_tpu_torch.bench: no CUDA device; the "
                           "benchmark runs only on a GPU")
    return torch.device("cuda")


def _batch1_latency(step, ys, carry, n_warm, n_timed) -> dict:
    """A batch-1 closed loop: ``n_warm`` steps, then the host-clock time of
    each of ``n_timed`` steps, each ended by a sync."""
    for _ in range(n_warm):
        ys, carry = step(ys, carry)
    torch.cuda.synchronize()
    lat = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        ys, carry = step(ys, carry)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    lat = np.asarray(lat)
    return {"single_solve_p50_s": float(np.percentile(lat, 50)),
            "single_solve_p99_s": float(np.percentile(lat, 99)),
            "single_solve_steps": n_timed,
            "realtime_budget_s": REALTIME_BUDGET_S,
            "single_solve_finite": bool(torch.isfinite(ys).all())}


def suite_setup(cell: SuiteCell, record: StepRecord):
    """Config 5's scenarios, plant and recorded controllers on the card:
    ``(scenarios, params, f_d, full, cheap)``."""
    from mpc_tpu_torch.io.native_scenarios import generate_scenarios
    dev = _cuda()
    sc = generate_scenarios(cell.seed, cell.batch, cell.size, device=dev)
    params = VehicleParams()
    f_d = discretize(pacejka_dynamics)
    full, cheap = (_Recorded(build_vehicle_controller(
        n_horiz=cell.n_horiz, alm_cfg=cell.alm_cfg, panoc_cfg=cfg,
        obstacle_weight=cell.obstacle_weight,
        obstacle_field_kwargs=cell.obstacle_field_kwargs,
        device=dev), record, tier) for cfg, tier in (
            (cell.full_cfg, "straggler"), (cell.cheap_cfg, "cheap")))
    return sc, params, f_d, full, cheap


def min_obstacle_distance(states, obstacles) -> float:
    """The least distance from any car to any of its scenario's obstacles
    over ``states``, a list of (B, 6) plant states, ``obstacles`` (B, K,
    4)."""
    pos = torch.stack(states)[..., None, :2]          # (T, B, 1, 2)
    d = torch.linalg.vector_norm(pos - obstacles[None, ..., :2], dim=-1)
    return float(d.min())


def suite_batch1(sc, params, f_d, full):
    """Config 5's batch-1 loop: scenario 0 alone on its road, an (S, 2)
    centerline (K1's shared-road launch), with the full-budget controller
    from a cold carry. ``(step, ys, carry)``, ``step(ys, carry) -> (ys,
    carry)``."""
    cl0 = sc.centerline[0]

    def step(ys, carry):
        out = full.step(carry, {"y0": ys, "p": params, "centerline": cl0})
        return f_d(ys, out.u0, params), out.carry

    return step, sc.y0[:1], full.init_carry(1)


@torch.no_grad()
def run_suite(cell: SuiteCell = CONFIG5) -> dict:
    """Config 5: the two-tier suite (an untimed pass of ``n_warm_steps``,
    then the timed ``n_sim`` steps), then the batch-1 loop on scenario 0's
    road with the full-budget controller."""
    record = StepRecord()
    sc, params, f_d, full, cheap = suite_setup(cell, record)

    def suite(n_sim):
        return run_scenario_suite_two_tier(full, cheap, f_d, sc, params,
                                           n_sim, cell.straggler_pad)

    if cell.n_warm_steps:
        suite(cell.n_warm_steps)
    torch.cuda.synchronize()
    k0 = len(record.iters)
    cheap.states.clear()
    t0 = time.perf_counter()
    state, conv = suite(cell.n_sim)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    states = cheap.states + [state["ys"]]
    st = state["stats"]
    tiers = record.launches_by_tier(k0)
    r = {
        "batch": cell.batch, "n_horiz": cell.n_horiz, "n_steps": cell.n_sim,
        "cheap_max_iter": cell.cheap_cfg.max_iter,
        "full_max_iter": cell.full_cfg.max_iter,
        "wall_s": wall, "solves_per_s": cell.batch * cell.n_sim / wall,
        "mean_converged_fraction": float(conv.mean()),
        "converged_per_step": conv.mean(axis=0).tolist(),
        "cheap_s_per_step": st["cheap_s"],
        "straggler_s_per_step": st["straggler_s"],
        "n_stragglers_per_step": st["n_stragglers"],
        "fan_launches_cheap_per_step": tiers["cheap"],
        "fan_launches_straggler_per_step": tiers["straggler"],
    }
    finite = bool(torch.isfinite(state["ys"]).all())
    r["nan_scenarios"] = int((~torch.isfinite(state["ys"])).any(dim=1).sum())
    if cell.obstacle_weight > 0.0:
        # the same scenarios and steps through the cell without the term
        plain = dataclasses.replace(cell, obstacle_weight=0.0,
                                    obstacle_field_kwargs=None)
        prec = StepRecord()
        _, _, _, pfull, pcheap = suite_setup(plain, prec)
        pstate, _ = run_scenario_suite_two_tier(
            pfull, pcheap, f_d, sc, params, cell.n_sim, cell.straggler_pad)
        # that run's K1 launches (on per-lane roads), not the cell's own
        r["fan_launches_without_term"] = sum(prec.fan_launches)
        r["min_obstacle_distance"] = min_obstacle_distance(states,
                                                           sc.obstacles)
        r["min_obstacle_distance_without_term"] = min_obstacle_distance(
            pcheap.states + [pstate["ys"]], sc.obstacles)
    if cell.batch1_steps is not None:
        n_warm, n_timed = cell.batch1_steps
        k = len(record.iters)
        r.update(_batch1_latency(*suite_batch1(sc, params, f_d, full),
                                 n_warm, n_timed))
        r["single_solve_iters_mean"] = float(
            torch.stack(record.iters[k + n_warm:]).float().mean())
        finite = finite and r.pop("single_solve_finite")
    r["states_finite"] = finite
    r["inner_iterations_run"] = int(torch.stack(record.iters).sum())
    return r


def overtake_pairs(pairs: int):
    """Config 4's pairs, drawn as examples/bench_suite.py:236-244 draws
    them: A fast in lane 1, B slow and close ahead of it."""
    rng = np.random.default_rng(7)
    y0a = np.zeros((pairs, 6), np.float32)
    y0a[:, 1] = rng.uniform(-0.02, 0.02, pairs)
    y0a[:, 3] = rng.uniform(0.7, 1.0, pairs)
    y0b = np.zeros((pairs, 6), np.float32)
    y0b[:, 0] = rng.uniform(0.08, 0.25, pairs)
    y0b[:, 1] = rng.uniform(-0.02, 0.02, pairs)
    y0b[:, 3] = rng.uniform(0.08, 0.2, pairs)
    return y0a, y0b


def payoff_inputs(batch: int, cars: int, device=None):
    """The payoff line's egos and cars, drawn as
    examples/bench_suite.py:283-292 draws them."""
    rng = np.random.default_rng(1)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    egos = Ego(x=t(rng.uniform(-10, 10, batch)),
               v=t(rng.uniform(5, 20, batch)),
               lane=torch.ones((batch,), dtype=torch.int32, device=device))
    others = Cars(x=t(rng.uniform(-50, 80, (batch, cars))),
                  v=t(rng.uniform(0, 20, (batch, cars))),
                  lane=t(rng.integers(1, 3, (batch, cars)), torch.int32),
                  mask=torch.ones((batch, cars), dtype=torch.bool,
                                  device=device))
    return egos, others


def two_car_setup(cell: TwoCarCell, record: StepRecord):
    """Config 4's game and pairs on the card: ``(run, y0a, y0b)``."""
    dev = _cuda()
    params = VehicleParams()
    ctrl = _Recorded(build_vehicle_controller(
        n_horiz=cell.n_horiz, alm_cfg=cell.alm_cfg,
        panoc_cfg=cell.solver_cfg, device=dev), record)
    game = make_two_car_game(ctrl, discretize(pacejka_dynamics), params,
                             n_sim=cell.n_sim)
    y0a, y0b = (torch.as_tensor(a, device=dev)
                for a in overtake_pairs(cell.pairs))
    return game, y0a, y0b


@torch.no_grad()
def run_two_car(cell: TwoCarCell = CONFIG4) -> dict:
    """Config 4: one warm loop, the median of ``n_loops`` timed loops, then
    the payoff line."""
    record = StepRecord()
    game, y0a, y0b = two_car_setup(cell, record)
    out = game(y0a, y0b, 1, 1)
    torch.cuda.synchronize()
    walls = []
    for _ in range(cell.n_loops):
        t0 = time.perf_counter()
        out = game(y0a, y0b, 1, 1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    # lane changes, the step-1 decision from lane 1 included
    # (examples/bench_suite.py:262-266)
    lanes_a = out.lanes_a.cpu().numpy()
    full = np.concatenate([np.ones((cell.pairs, 1), lanes_a.dtype), lanes_a],
                          axis=1)
    changes = np.abs(np.diff(full, axis=1)) > 0
    B, n = cell.pairs, cell.n_sim
    r = {
        "batch_pairs": B, "n_horiz": cell.n_horiz, "n_steps": n,
        "pair_steps_per_s": B * n / wall,
        "solves_per_s": 2 * B * n / wall,
        "wall_s_per_loop": wall, "wall_s_loops": walls,
        # every solve of every loop (the loops repeat the same work)
        "mean_converged_fraction": float(torch.stack(
            record.converged).mean()),
        "mean_lane_changes_a": float(changes.mean()),
        "pairs_with_lane_change": float(changes.any(axis=1).mean()),
        "states_finite": bool(torch.isfinite(out.ys_a).all()
                              and torch.isfinite(out.ys_b).all()),
        "inner_iterations_run": int(torch.stack(record.iters).sum()),
    }
    egos, others = payoff_inputs(cell.payoff_batch, cell.payoff_cars,
                                 y0a.device)
    lane_payoffs(egos, others)
    torch.cuda.synchronize()
    lat = []
    for _ in range(cell.payoff_calls):
        t0 = time.perf_counter()
        lane_payoffs(egos, others)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    p50 = float(np.percentile(lat, 50))
    r.update({"payoff_batch": cell.payoff_batch, "payoff_p50_s": p50,
              "decisions_per_s": cell.payoff_batch / p50})
    return r


def chain_setup(cell: ChainCell, record: StepRecord):
    """The chain's controller (recorded), plant, floor and disturbed start
    on the card: ``(ctrl, f_d, static_param, spec, ys)``."""
    dev = _cuda()
    spec = ChainSpec(cell.n_balls, cell.dim)
    params = ChainParams()
    f_d = discretize(chain_dynamics(spec))
    ctrl = _Recorded(build_chain_controller(
        spec, cell.n_horiz, alm_cfg=cell.alm_cfg, panoc_cfg=cell.solver_cfg,
        device=dev), record)
    ys = spec.initial_state(cell.batch, device=dev)
    u = torch.tensor(cell.u_dist, device=dev).expand(cell.batch, -1)
    for _ in range(cell.n_dist):
        ys = f_d(ys, u, params)
    coeff, _ = floor_coefficients(device=dev)
    return ctrl, f_d, {"p": params, "constr": coeff}, spec, ys


@torch.no_grad()
def run_chain(cell: ChainCell = CHAIN) -> dict:
    """The hanging chain: a closed loop of ``n_steps`` steps from the
    disturbed chain, each step timed on the host clock to a sync."""
    record = StepRecord()
    ctrl, f_d, static, spec, ys = chain_setup(cell, record)
    carry = ctrl.init_carry(cell.batch)
    torch.cuda.synchronize()
    times, states = [], []
    for _ in range(cell.n_steps):
        t0 = time.perf_counter()
        out = ctrl.step(carry, dict(static, y0=ys))
        ys, carry = f_d(ys, out.u0, static["p"]), out.carry
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        states.append(ys)
    ys_all = torch.stack(states)                  # (T, B, state_dim)
    n, d = spec.n_balls, spec.dim
    balls = ys_all[..., : n * d].reshape(*ys_all.shape[:2], n, d)
    _, lb = floor_coefficients()
    margin = balls[..., d - 1] - g_constr(static["constr"],
                                          balls[..., 0]) - lb
    times = np.asarray(times)
    return {
        "batch": cell.batch, "n_horiz": cell.n_horiz,
        "n_steps": cell.n_steps,
        "solves_per_s": cell.batch * cell.n_steps / float(times.sum()),
        "p50_step_latency_s": float(np.percentile(times, 50)),
        "p99_step_latency_s": float(np.percentile(times, 99)),
        "mean_converged_fraction": float(torch.stack(
            record.converged).mean()),
        "failures": int(carry.failures.sum()),
        "inner_iterations_total": int(carry.tot_it.sum()),
        "min_floor_margin": float(margin.min()),
        "free_end_final_distance": float(torch.linalg.vector_norm(
            ys[:, 2 * n * d:] - spec.x_end(ys.device), dim=1).max()),
        "states_finite": bool(torch.isfinite(ys_all).all()),
        "inner_iterations_run": int(torch.stack(record.iters).sum()),
    }


def mesh_dp_inputs(batch: int, n_horiz: int = N_HORIZ, device=None):
    """mesh_dp's lanes (examples/exp_mesh_scaling.py:52-60): ``(y0s, cl,
    U0s, lam0s)``, y0[:, 1] ~ U(-0.1, 0.1) and y0[:, 3] ~ U(0.3, 1.0) from
    ``default_rng(0)``, the 100-point straight road, cold ``U0 = [1, 0] *
    N`` and zero multipliers."""
    rng = np.random.default_rng(SEED)
    y0s = np.zeros((batch, 6), np.float32)
    y0s[:, 1] = rng.uniform(-0.1, 0.1, batch)
    y0s[:, 3] = rng.uniform(0.3, 1.0, batch)
    U0s = torch.tensor([1.0, 0.0], device=device).repeat(n_horiz) \
        .expand(batch, -1).clone()
    return (torch.as_tensor(y0s, device=device), _straight(device), U0s,
            torch.zeros((batch, 6 * n_horiz), device=device))


def mesh_lqt_problem(batch: int, N: int, n: int = 6, m: int = 2,
                     seed: int = SEED) -> tuple:
    """mesh_lqt's problem (examples/exp_mesh_lqt.py:40-56's generator, from
    ``default_rng(seed)``), float32 numpy ``(x0, A, B, c, Q, q, R, r, QN,
    qN)`` with the terminal terms repeated per lane, as the port's LQT
    takes them."""
    rng = np.random.default_rng(seed)

    def psd(head, d, scale):
        M = rng.normal(0, scale, (*head, d, d)).astype(np.float32)
        return M @ np.swapaxes(M, -1, -2) + 0.5 * np.eye(d, dtype=np.float32)

    A = (np.eye(n, dtype=np.float32)
         + 0.1 * rng.normal(0, 1, (batch, N, n, n)).astype(np.float32) / n)
    B = rng.normal(0, 0.4, (batch, N, n, m)).astype(np.float32)
    c = rng.normal(0, 0.05, (batch, N, n)).astype(np.float32)
    Q = psd((batch, N), n, 0.3)
    q = rng.normal(0, 0.2, (batch, N, n)).astype(np.float32)
    R = psd((batch, N), m, 0.3) + np.eye(m, dtype=np.float32)
    r = rng.normal(0, 0.2, (batch, N, m)).astype(np.float32)
    QN = psd((), n, 0.3)
    qN = rng.normal(0, 0.2, n).astype(np.float32)
    x0 = rng.normal(0, 0.3, (batch, n)).astype(np.float32)
    return (x0, A, B, c, Q, q, R, r,
            np.broadcast_to(QN, (batch, n, n)).copy(),
            np.broadcast_to(qN, (batch, n)).copy())


def _timed(fn, n_warmup: int, n_timed: int,
           timed_call=contextlib.nullcontext):
    """``(last output, host-clock seconds of each timed call)``, each call
    ended by a sync and run inside ``timed_call()``."""
    for _ in range(n_warmup):
        out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n_timed):
        with timed_call():
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    return out, times


def _world() -> dict:
    import torch.distributed as dist
    initialize_world()
    return {"world": dist.get_world_size(),
            "backend": dist.get_backend()}


def run_mesh_dp(cell: MeshCell = MESH_DP,
                timed_call=contextlib.nullcontext) -> dict:
    """The scenario-sharded solve (examples/exp_mesh_scaling.py:46-75):
    ``make_mesh(world, 1)``, one warm-up call, then the median of the timed
    calls, each run inside ``timed_call()``; solves/s is the batch over that
    median. The fan is K1."""
    w = _world()
    dev = _cuda()
    mesh = make_mesh(w["world"], 1)
    solve = make_sharded_vehicle_solver(
        mesh, n_horiz=cell.n_horiz, alm_cfg=MESH_DP_ALM,
        panoc_cfg=MESH_DP_PANOC, device=dev)
    args = mesh_dp_inputs(cell.batch, cell.n_horiz, dev)
    iters_run = []

    def call():
        out = solve(args[0], args[1], VehicleParams(), args[2], args[3])
        iters_run.append(out[3].max())
        return out

    fp.fan_value_and_grad.launches = 0
    (u, lam, conv, iters), times = _timed(call, cell.n_warmup, cell.n_steps,
                                          timed_call)
    p50 = float(np.median(times))
    return {**w, "mesh": [w["world"], 1], "batch": cell.batch,
            "n_horiz": cell.n_horiz, "solves_per_s": cell.batch / p50,
            "p50_s": p50, "times_s": times,
            "converged_fraction": float(conv.float().mean()),
            "inner_iters_mean": float(iters.float().mean()),
            "inner_iters_max": int(iters.max()),
            "k1_launches": fp.fan_value_and_grad.launches,
            "inner_iterations_run": int(torch.stack(iters_run).sum()),
            "calls": cell.n_warmup + cell.n_steps,
            "states_finite": bool(torch.isfinite(u).all())}


def run_mesh_lqt(cell: MeshCell = MESH_LQT,
                 oracle: Optional[Callable] = None,
                 timed_call=contextlib.nullcontext) -> dict:
    """The horizon-sharded LQT (examples/exp_mesh_lqt.py:58-75):
    ``make_horizon_mesh(1, world)``, one warm-up call, then the median of
    the timed calls (each inside ``timed_call()``); its error against
    ``lqt_solve_parallel`` on the same problem and, given ``oracle(x0, A, B, c, Q, q, R, r, QN, qN, P) ->
    (xs, us)`` (a float64 solution of one lane), against it."""
    w = _world()
    mesh = make_horizon_mesh(1, w["world"])
    solve = make_lqt_horizon_sharded(mesh)
    prob = mesh_lqt_problem(cell.batch, cell.n_horiz)
    args = [torch.as_tensor(a, device=_cuda()) for a in prob]
    sol, times = _timed(lambda: solve(*args), cell.n_warmup, cell.n_steps,
                        timed_call)
    ref = lqt_solve_parallel(*args)
    r = {**w, "mesh": [1, w["world"]], "batch": cell.batch,
         "n_horiz": cell.n_horiz, "p50_s": float(np.median(times)),
         "times_s": times,
         "max_abs_err_vs_parallel": max(
             float((sol.us - ref.us).abs().max()),
             float((sol.xs - ref.xs).abs().max())),
         "states_finite": bool(torch.isfinite(sol.xs).all())}
    if oracle is not None:
        err = 0.0
        n, m = prob[2].shape[2:]
        P = np.zeros((cell.n_horiz, m, n))             # no cross term
        for i in range(cell.batch):
            xs, us = oracle(*(a[i].astype(np.float64) for a in prob), P)
            err = max(err,
                      float(np.abs(sol.us[i].cpu().numpy() - us).max()),
                      float(np.abs(sol.xs[i].cpu().numpy() - xs).max()))
        r["max_abs_err_vs_float64"] = err
    return r


def mesh_ilqr_controller(mesh, device=None):
    """``build_vehicle_ilqr_controller`` on ilqr_n40's OCP and settings,
    over ``mesh`` (None: ilqr_n40's own controller)."""
    return build_vehicle_ilqr_controller(
        n_horiz=ILQR_N40.n_horiz, bound_state_constraints=True,
        alm_cfg=ILQR_N40.alm_cfg, ilqr_cfg=ILQR_N40.solver_cfg, mesh=mesh,
        device=device)


def run_mesh_ilqr(cell: MeshCell = MESH_ILQR,
                  timed_call=contextlib.nullcontext) -> dict:
    """The horizon-sharded AL-iLQR step (``__graft_entry__.py:107-131``'s
    ``dryrun_multichip`` step) at ilqr_n40's width: ilqr_n40's OCP, road,
    configurations and first ``batch`` initial states through
    ``build_vehicle_ilqr_controller(mesh=make_horizon_mesh(1, world))``, a
    closed loop of ``n_warmup`` untimed and ``n_steps`` timed steps, each
    timed one inside ``timed_call()``. Its first step is held against
    ilqr_n40's own (unsharded, sequential Riccati) controller on the same
    lanes."""
    w = _world()
    loop = ClosedLoop(ILQR_N40)
    ys, carry = loop.start(cell.batch)
    _, _, ref = loop.step(ys, carry)          # ilqr_n40's own first step
    loop.ctrl = mesh_ilqr_controller(make_horizon_mesh(1, w["world"]),
                                     loop.device)
    outs, times = [], []
    for k in range(cell.n_warmup + cell.n_steps):
        is_timed = k >= cell.n_warmup
        with timed_call() if is_timed else contextlib.nullcontext():
            t0 = time.perf_counter()
            ys, carry, out = loop.step(ys, carry)
            torch.cuda.synchronize()
            if is_timed:
                times.append(time.perf_counter() - t0)
        outs.append(out.result)
    first = outs[0]
    timed = outs[cell.n_warmup:]
    inner = torch.stack([o.inner_iterations for o in timed]).float()
    outer = torch.stack([o.outer_iterations for o in timed]).float()
    gap = (first.inner_iterations - ref.result.inner_iterations).abs()
    return {**w, "mesh": [1, w["world"]], "batch": cell.batch,
            "n_horiz": cell.n_horiz, "p50_step_s": float(np.median(times)),
            "times_s": times,
            "converged_fraction": float(torch.stack(
                [o.converged.float().mean() for o in timed]).mean()),
            "inner_iters_mean": float(inner.mean()),
            "inner_iters_max": int(inner.max()),
            "outer_iters_mean": float(outer.mean()),
            "outer_iters_max": int(outer.max()),
            "first_step_converged": float(first.converged.float().mean()),
            "first_step_flags_differ": int(
                (first.converged != ref.result.converged).sum()),
            "first_step_outer_differ": int(
                (first.outer_iterations != ref.result.outer_iterations)
                .sum()),
            "first_step_inner_gap_max": int(gap.max()),
            # lanes whose inner count differs by 0, 1, 2, ...
            "first_step_inner_gaps": torch.bincount(gap).tolist(),
            "states_finite": bool(torch.isfinite(ys).all())}


#: the sharded cells' runners, by name
MESH_RUNNERS = {"mesh_dp": run_mesh_dp, "mesh_lqt": run_mesh_lqt,
                "mesh_ilqr": run_mesh_ilqr}


@torch.no_grad()
def run(cell: Cell = HEADLINE, device=None) -> dict:
    """Run the cell's closed loop at its batch (and its batch-1 loop, where
    it has one) on the card; return the measurements. ``device`` names
    another device for a closed-loop cell (``Cell``) without a batch-1
    loop, so that a caller can run it on the CPU at a small size."""
    if isinstance(cell, SuiteCell):
        return run_suite(cell)
    if isinstance(cell, TwoCarCell):
        return run_two_car(cell)
    if isinstance(cell, ChainCell):
        return run_chain(cell)
    if isinstance(cell, MeshCell):
        return MESH_RUNNERS[cell.name](cell)
    loop = ClosedLoop(cell, device)
    if loop.device.type == "cuda":
        sync = torch.cuda.synchronize
    elif cell.batch1_steps is None:
        def sync():
            pass
    else:
        raise ValueError("a batch-1 loop is timed on the card only")
    iters_run = []          # per step: the slowest lane's inner iterations

    def step(ys, carry):
        ys, carry, out = loop.step(ys, carry)
        iters_run.append(out.result.inner_iterations.max())
        return ys, carry, out

    ys, carry = loop.start(cell.batch)
    for _ in range(cell.n_warmup):
        ys, carry, _ = step(ys, carry)
    sync()
    times, conv, iters, outer, viol, trig = [], [], [], [], [], []
    for _ in range(cell.n_steps):
        t0 = time.perf_counter()
        ys, carry, out = step(ys, carry)
        sync()
        times.append(time.perf_counter() - t0)
        res = out.result
        conv.append(res.converged.float().mean())
        iters.append(res.inner_iterations)
        outer.append(res.outer_iterations)
        viol.append(torch.where(res.converged, res.constraint_violation,
                                torch.zeros_like(res.constraint_violation)))
        if cell.trigger_threshold is not None:
            trig.append(out.triggered.float().mean())
    times = np.asarray(times)
    iters = torch.stack(iters)
    # [lane, its inner iterations] of the lane that spent the most in each
    # timed step (the first such lane where several tie)
    slowest = torch.stack([iters.argmax(dim=1), iters.amax(dim=1)], dim=1)
    iters = iters.float()
    r = {
        "batch": cell.batch, "n_horiz": cell.n_horiz, "n_steps": cell.n_steps,
        # all the timed work over all the timed wall time
        "solves_per_s": cell.batch * cell.n_steps / float(times.sum()),
        "p50_step_latency_s": float(np.percentile(times, 50)),
        "p99_step_latency_s": float(np.percentile(times, 99)),
        "mean_converged_fraction": float(torch.stack(conv).mean()),
        "inner_iters_mean": float(iters.mean()),
        "inner_iters_max": int(iters.max()),
        "slowest_lane_per_step": slowest.tolist(),
    }
    finite = bool(torch.isfinite(ys).all())
    r["nonfinite_lanes"] = int((~torch.isfinite(ys)).any(dim=1).sum())
    if cell.bound_state_constraints:
        r["outer_iters_mean"] = float(torch.stack(outer).float().mean())
        r["outer_iters_max"] = int(torch.stack(outer).max())
        r["max_violation_converged"] = float(torch.stack(viol).max())
    if trig:
        r["mean_trigger_fraction"] = float(torch.stack(trig).mean())
    if cell.batch1_steps is not None:
        r.update(_batch1_latency(lambda y, c: step(y, c)[:2],
                                 *loop.start(1), *cell.batch1_steps))
        finite = finite and r.pop("single_solve_finite")
    r["states_finite"] = finite
    r["inner_iterations_run"] = int(torch.stack(iters_run).sum())
    return r


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    name = argv[0] if argv else "headline"
    if name not in CELLS or len(argv) > 1:
        raise SystemExit(f"usage: python -m mpc_tpu_torch.bench "
                         f"[{'|'.join(CELLS)}]")
    r = run(CELLS[name])
    if isinstance(CELLS[name], MeshCell):
        import torch.distributed as dist
        rank = dist.get_rank()
        dist.destroy_process_group()
        if rank:
            return
    if "slowest_lane_per_step" in r:
        print(json.dumps({"slowest_lane_per_step":
                          r.pop("slowest_lane_per_step")}))
    info = gpu_info()
    r["device"] = torch.cuda.get_device_name(0)
    r["power_limit"] = info["power_limit"]
    print(json.dumps({"detail": r}))
    metric, key, unit = {
        "headline": ("mpc_solves_per_s", "solves_per_s", "solves/s"),
        "mesh_lqt": ("lqt_p50_s_mesh_lqt", "p50_s", "s"),
        "mesh_ilqr": ("step_p50_s_mesh_ilqr", "p50_step_s", "s"),
    }.get(name, (f"mpc_solves_per_s_{name}", "solves_per_s", "solves/s"))
    print(json.dumps({"metric": metric, "value": r[key], "unit": unit,
                      "device": r["device"],
                      "power_limit": info["power_limit"]}))


if __name__ == "__main__":
    main()
