"""Benchmark of the port's main path: batched warm-started MPC solves on one
NVIDIA GPU.

The counterpart of the repository's root ``bench.py`` (the JAX package on a
TPU), with the same shape: the Pacejka vehicle OCP, N=12, 24 decision
variables, 100-point straight centerline, ``AlmConfig(eps=1e-4)``,
``PanocConfig(lbfgs_memory=12, max_iter=300)``, batch 1024, 5 warm-up and 20
timed closed-loop steps with the plant stepped by the same ``f_d``, then a
batch-1 closed loop for the single-solve latency. The candidate fan goes
through the CUDA kernel. ``solves/s`` is all the timed solves over all the
timed wall time; the root ``bench.py`` divides the batch by the p50 step.

    python -m mpc_tpu_torch.bench

Prints a detail JSON line (with the card's name and power limit) and, last,
the result JSON line. Without a CUDA device it exits with an error: a
measurement is never taken on the CPU.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from mpc_tpu_torch.config import AlmConfig, PanocConfig
from mpc_tpu_torch.control.mpc import build_vehicle_controller
from mpc_tpu_torch.models.bicycle import pacejka_dynamics
from mpc_tpu_torch.models.integrators import discretize
from mpc_tpu_torch.models.params import VehicleParams
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


class ClosedLoop:
    """The benchmark's controller, plant and road on the card;
    ``step(ys, carry) -> (ys, carry, result)`` is one closed-loop step."""

    def __init__(self):
        if not torch.cuda.is_available():
            raise RuntimeError("mpc_tpu_torch.bench: no CUDA device; the "
                               "benchmark runs only on a GPU")
        dev = self.device = torch.device("cuda")
        self.ctrl = build_vehicle_controller(
            n_horiz=N_HORIZ, alm_cfg=AlmConfig(eps=1e-4),
            panoc_cfg=PanocConfig(lbfgs_memory=N_HORIZ, max_iter=300),
            device=dev)
        self.params = VehicleParams()
        self.f_d = discretize(pacejka_dynamics)
        self.centerline = straight_centerline(CENTERLINE_POINTS, device=dev)

    def start(self, batch: int):
        """Cold carry for ``batch`` lanes and their plant states: the first
        ``batch`` rows of the batch-1024 initial states."""
        ys = torch.as_tensor(initial_states(BATCH)[:batch],
                             device=self.device)
        return ys, self.ctrl.init_carry(batch, self.device)

    def step(self, ys, carry):
        out = self.ctrl.step(carry, {"y0": ys, "p": self.params,
                                     "centerline": self.centerline})
        return self.f_d(ys, out.u0, self.params), out.carry, out.result


@torch.no_grad()
def run() -> dict:
    """Run the closed loop at batch 1024 and the batch-1 latency loop on the
    card; return the measurements."""
    loop = ClosedLoop()
    sync = torch.cuda.synchronize
    iters_run = []          # per step: the slowest lane's PANOC iterations

    def step(ys, carry):
        ys, carry, res = loop.step(ys, carry)
        iters_run.append(res.inner_iterations.max())
        return ys, carry, res

    ys, carry = loop.start(BATCH)
    for _ in range(N_WARMUP):
        ys, carry, _ = step(ys, carry)
    sync()
    times, conv, iters = [], [], []
    for _ in range(N_STEPS):
        t0 = time.perf_counter()
        ys, carry, res = step(ys, carry)
        sync()
        times.append(time.perf_counter() - t0)
        conv.append(res.converged.float().mean())
        iters.append(res.inner_iterations)
    times = np.asarray(times)
    iters = torch.stack(iters).float()

    y1, c1 = loop.start(1)
    for _ in range(N_WARMUP):
        y1, c1, _ = step(y1, c1)
    sync()
    lat = []
    for _ in range(N_LATENCY):
        t0 = time.perf_counter()
        y1, c1, _ = step(y1, c1)
        sync()
        lat.append(time.perf_counter() - t0)
    lat = np.asarray(lat)

    return {
        "batch": BATCH, "n_horiz": N_HORIZ, "n_steps": N_STEPS,
        # all the timed work over all the timed wall time
        "solves_per_s": BATCH * N_STEPS / float(times.sum()),
        "p50_step_latency_s": float(np.percentile(times, 50)),
        "p99_step_latency_s": float(np.percentile(times, 99)),
        "mean_converged_fraction": float(torch.stack(conv).mean()),
        "inner_iters_mean": float(iters.mean()),
        "inner_iters_max": int(iters.max()),
        "single_solve_p50_s": float(np.percentile(lat, 50)),
        "single_solve_p99_s": float(np.percentile(lat, 99)),
        "realtime_budget_s": REALTIME_BUDGET_S,
        "states_finite": bool(torch.isfinite(ys).all()
                              and torch.isfinite(y1).all()),
        "panoc_iterations_run": int(torch.stack(iters_run).sum()),
    }


def main():
    r = run()
    info = gpu_info()
    r["device"] = torch.cuda.get_device_name(0)
    r["power_limit"] = info["power_limit"]
    print(json.dumps({"detail": r}))
    print(json.dumps({"metric": "mpc_solves_per_s", "value": r["solves_per_s"],
                      "unit": "solves/s", "device": r["device"],
                      "power_limit": info["power_limit"]}))


if __name__ == "__main__":
    main()
