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

``solves/s`` is all the timed solves over all the timed wall time; the root
``bench.py`` divides the batch by the p50 step.

    python -m mpc_tpu_torch.bench [headline|config1|ss_n40|ilqr_n40|etc]

Prints a detail JSON line (with the card's name and power limit) and, last,
the result JSON line. Without a CUDA device it exits with an error: a
measurement is never taken on the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from mpc_tpu_torch.config import AlmConfig, IlqrConfig, PanocConfig
from mpc_tpu_torch.control.event_triggered import EventTriggeredController
from mpc_tpu_torch.control.mpc import (build_vehicle_controller,
                                       build_vehicle_ilqr_controller)
from mpc_tpu_torch.models.bicycle import pacejka_dynamics, simplified_dynamics
from mpc_tpu_torch.models.integrators import discretize
from mpc_tpu_torch.models.params import VehicleParams
from mpc_tpu_torch.ops.bezier import (bezier_centerline,
                                      lane_change_control_points)
from mpc_tpu_torch.ops.road import straight_centerline

REALTIME_BUDGET_S = 0.05   # Ts, the control interval
BATCH, N_HORIZ, CENTERLINE_POINTS = 1024, 12, 100
N_WARMUP, N_STEPS, N_LATENCY, SEED = 5, 20, 50, 0


def gpu_info() -> dict:
    """Name and power limit of the first card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    first = out.splitlines()[0]
    name, power = (s.strip() for s in first.rsplit(",", 1))
    return {"nvidia_smi": first, "name": name, "power_limit": power}


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
    in event-triggered MPC."""
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
CELLS = {c.name: c for c in (HEADLINE, CONFIG1, SS_N40, ILQR_N40, ETC)}


class ClosedLoop:
    """A cell's controller, plant and road on the card;
    ``step(ys, carry) -> (ys, carry, out)`` is one closed-loop step, with
    ``out`` the controller's step output (``out.result`` the solve's)."""

    def __init__(self, cell: Cell = HEADLINE):
        if not torch.cuda.is_available():
            raise RuntimeError("mpc_tpu_torch.bench: no CUDA device; the "
                               "benchmark runs only on a GPU")
        dev = self.device = torch.device("cuda")
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
        else:
            self.ctrl = build_vehicle_controller(panoc_cfg=cell.solver_cfg,
                                                 **kw)
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


@torch.no_grad()
def run(cell: Cell = HEADLINE) -> dict:
    """Run the cell's closed loop at its batch (and its batch-1 loop, where
    it has one) on the card; return the measurements."""
    loop = ClosedLoop(cell)
    sync = torch.cuda.synchronize
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
    iters = torch.stack(iters).float()
    r = {
        "batch": cell.batch, "n_horiz": cell.n_horiz, "n_steps": cell.n_steps,
        # all the timed work over all the timed wall time
        "solves_per_s": cell.batch * cell.n_steps / float(times.sum()),
        "p50_step_latency_s": float(np.percentile(times, 50)),
        "p99_step_latency_s": float(np.percentile(times, 99)),
        "mean_converged_fraction": float(torch.stack(conv).mean()),
        "inner_iters_mean": float(iters.mean()),
        "inner_iters_max": int(iters.max()),
    }
    finite = bool(torch.isfinite(ys).all())
    if cell.bound_state_constraints:
        r["outer_iters_mean"] = float(torch.stack(outer).float().mean())
        r["outer_iters_max"] = int(torch.stack(outer).max())
        r["max_violation_converged"] = float(torch.stack(viol).max())
    if trig:
        r["mean_trigger_fraction"] = float(torch.stack(trig).mean())
    if cell.batch1_steps is not None:
        n_warm, n_timed = cell.batch1_steps
        y1, c1 = loop.start(1)
        for _ in range(n_warm):
            y1, c1, _ = step(y1, c1)
        sync()
        lat = []
        for _ in range(n_timed):
            t0 = time.perf_counter()
            y1, c1, _ = step(y1, c1)
            sync()
            lat.append(time.perf_counter() - t0)
        lat = np.asarray(lat)
        r.update({
            "single_solve_p50_s": float(np.percentile(lat, 50)),
            "single_solve_p99_s": float(np.percentile(lat, 99)),
            "single_solve_steps": n_timed,
            "realtime_budget_s": REALTIME_BUDGET_S,
        })
        finite = finite and bool(torch.isfinite(y1).all())
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
    info = gpu_info()
    r["device"] = torch.cuda.get_device_name(0)
    r["power_limit"] = info["power_limit"]
    print(json.dumps({"detail": r}))
    metric = "mpc_solves_per_s" if name == "headline" \
        else f"mpc_solves_per_s_{name}"
    print(json.dumps({"metric": metric, "value": r["solves_per_s"],
                      "unit": "solves/s", "device": r["device"],
                      "power_limit": info["power_limit"]}))


if __name__ == "__main__":
    main()
