"""Warm-started vehicle MPC, batch-native (port of mpc_tpu/control/mpc.py).

The reference controller is functional and per-lane (``vmap``-ed by its
callers); here ``MpcController`` is an ``nn.Module`` whose ``step`` takes a
carry with a leading lane axis B. The carry holds the warm start (U, lam),
the ALM penalties sigma and the PANOC step size gamma; ``sigma = 0`` and
``gamma = 0`` are the cold sentinels.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch import nn

from mpc_tpu_torch.config import AlmConfig, IlqrConfig, PanocConfig
from mpc_tpu_torch.models.bicycle import (pacejka_dynamics,
                                           simplified_dynamics)
from mpc_tpu_torch.models.integrators import discretize
from mpc_tpu_torch.models.params import VehicleParams
from mpc_tpu_torch.ops.costs import (DEFAULT_VEHICLE_WEIGHTS,
                                     vehicle_stage_cost,
                                     vehicle_stage_residuals)
from mpc_tpu_torch.ops.fused_psi import (fan_params, make_vehicle_al_multi,
                                         make_vehicle_cost_multi)
from mpc_tpu_torch.solver.alm import AlmResult, make_alm_solver
from mpc_tpu_torch.solver.ilqr import make_al_ilqr_solver
from mpc_tpu_torch.solver.problem import Box, Problem, build_ocp_problem

# Quadratic state-constraint offsets: y_i^2 - b_i per stage
STATE_CONSTRAINT_OFFSETS = (20.0, 1.0, 1.0, 2.0, 1.0, 0.1)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Without a card a default call raises instead of running on the
    CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("mpc_tpu_torch: no CUDA device; the controller "
                           "runs on the card by default. Pass device=\"cpu\" "
                           "to run it on the CPU through the plain versions "
                           "of its kernels")
    return torch.device("cuda")


class MpcCarry(NamedTuple):
    """Warm-start carry across MPC steps, one row per lane."""
    U: torch.Tensor          # (B, n_horiz * input_dim) flat input sequence
    lam: torch.Tensor        # (B, m) Lagrange multipliers
    sigma: torch.Tensor      # (B, m) ALM penalties (0 -> cold)
    gamma: torch.Tensor      # (B,) PANOC step size (<= 0 -> re-estimate)
    tot_it: torch.Tensor     # (B,) int32 accumulated inner iterations
    failures: torch.Tensor   # (B,) int32 accumulated non-converged solves


class MpcStepOut(NamedTuple):
    carry: MpcCarry
    u0: torch.Tensor         # (B, input_dim) first optimal input
    result: AlmResult


class MpcController(nn.Module):
    """A built MPC controller: ``step(carry, param)`` over a lane batch.

    ``param`` is the per-step parameter dict, on the controller's
    ``device``: ``y0`` (B, state_dim), ``p`` (VehicleParams, shared) and
    ``centerline``, either (S, 2), one road shared by every lane, or
    (B, S, 2), one road per lane (the roads of a scenario suite, or each
    car's lane in the two-car game).
    """

    def __init__(self, problem: Problem, solve: Callable, n_horiz: int,
                 input_dim: int, warm_start_input: tuple,
                 device: torch.device):
        super().__init__()
        self.problem = problem
        self.solve = solve
        self.n_horiz = n_horiz
        self.input_dim = input_dim
        self.warm_start_input = tuple(warm_start_input)
        self.device = torch.device(device)

    def init_carry(self, batch: int, device=None,
                   dtype=torch.float32) -> MpcCarry:
        """Cold carry for ``batch`` lanes, on the controller's device unless
        ``device`` names another."""
        device = self.device if device is None else device
        U0 = torch.tensor(self.warm_start_input, dtype=dtype,
                          device=device).repeat(self.n_horiz)
        m = self.problem.m
        return MpcCarry(
            U=U0.expand(batch, -1).clone(),
            lam=torch.zeros((batch, m), dtype=dtype, device=device),
            sigma=torch.zeros((batch, m), dtype=dtype, device=device),
            gamma=torch.zeros((batch,), dtype=dtype, device=device),
            tot_it=torch.zeros((batch,), dtype=torch.int32, device=device),
            failures=torch.zeros((batch,), dtype=torch.int32, device=device),
        )

    def step(self, carry: MpcCarry, param: Any) -> MpcStepOut:
        """One warm-started MPC solve per lane (mpc_tpu/control/mpc.py:101-129)."""
        res = self.solve(param, carry.U, carry.lam, sigma0=carry.sigma,
                         gamma0=carry.gamma)
        # A non-converged lane goes back to the cold sentinels, so the next
        # solve re-estimates its step size instead of compounding a failure.
        ok = res.converged
        new_carry = MpcCarry(
            U=res.u,
            lam=res.lam,
            sigma=torch.where(ok[:, None], res.sigma,
                              torch.zeros_like(res.sigma)),
            gamma=torch.where(ok, res.gamma, torch.zeros_like(res.gamma)),
            tot_it=carry.tot_it + res.inner_iterations,
            failures=carry.failures + (~ok).to(torch.int32),
        )
        return MpcStepOut(new_carry, res.u[:, : self.input_dim], res)

    def forward(self, carry: MpcCarry, param: Any) -> MpcStepOut:
        return self.step(carry, param)


def build_vehicle_ocp(n_horiz: int = 12, v_ref: float = 1.0,
                      ts: float = 0.05,
                      params: Optional[VehicleParams] = None,
                      weights=DEFAULT_VEHICLE_WEIGHTS,
                      bound_state_constraints: bool = False,
                      window: Optional[int] = None,
                      model: str = "pacejka",
                      obstacle_weight: float = 0.0,
                      device=None) -> Problem:
    """Vehicle OCP on the dense full-centerline path, fused
    (mpc_tpu/control/mpc.py:141-274 with ``fused`` set).

    ``model="pacejka"``: the 6-state single-track model, whose candidate fan
    is ``ops.fused_psi.fan_value_and_grad`` (K1); its quadratic state
    constraints ``x^2 - STATE_CONSTRAINT_OFFSETS`` are built per stage and
    left unbounded, unless ``bound_state_constraints`` bounds them above by
    0, and then the ALM general path evaluates its fan through
    ``al_fan_value_and_grad`` (K3). ``model="simplified"``: the 4-state
    kinematic bicycle with input boxes only (no state constraints), whose
    fan is ``kin_fan_value_and_grad`` (K2). Each fan runs its CUDA kernel on
    a CUDA device and its plain version on the CPU. ``device=None`` is the
    card (:func:`resolve_device`: without one it raises; pass
    ``device="cpu"`` for the CPU). The windowed search and the obstacle
    field are not ported yet and raise.
    """
    if window is not None:
        raise NotImplementedError("mpc_tpu_torch: only the dense "
                                  "full-centerline error path is ported")
    if obstacle_weight > 0.0:
        raise NotImplementedError("mpc_tpu_torch: the obstacle field "
                                  "(ops/potential_field.py) is not ported yet")
    if model == "pacejka":
        state_dim, dynamics = 6, pacejka_dynamics
    elif model == "simplified":
        state_dim, dynamics = 4, simplified_dynamics
    else:
        raise ValueError(f"unknown model {model!r}")
    device = resolve_device(device)
    multi = make_vehicle_cost_multi(n_horiz, ts=ts, v_ref=v_ref,
                                    weights=weights, model=model)
    if params is None:
        params = VehicleParams()
    f_d = discretize(dynamics, ts=ts)

    def stage_cost(x, u, param):
        return vehicle_stage_cost(x, u, param["centerline"], v_ref, weights)

    lim = torch.tensor([float(params.max_drive), float(params.max_steer)],
                       dtype=torch.float32, device=device).repeat(n_horiz)

    stage_constraints, n_stage, D = None, 0, None
    if state_dim == 6:
        offs = torch.tensor(STATE_CONSTRAINT_OFFSETS, dtype=torch.float32,
                            device=device)

        def stage_constraints(x, u, param):
            return x ** 2 - offs

        n_stage = 6
        if bound_state_constraints:
            m = n_stage * n_horiz
            D = Box(torch.full((m,), -float("inf"), device=device),
                    torch.zeros((m,), device=device))

    problem = build_ocp_problem(
        f_d, stage_cost, n_horiz, state_dim=state_dim, input_dim=2,
        C=Box(lower=-lim, upper=lim), stage_constraints=stage_constraints,
        n_stage_constraints=n_stage, D=D)

    def param_prep(param):
        cltab, pvec = fan_params(param["centerline"], param["p"])
        return dict(param, cltab=cltab, pvec=pvec)

    def cost_multi(cands, param):
        return multi(cands, param["y0"], param["cltab"], param["pvec"])

    al_multi = None
    if D is not None:
        al = make_vehicle_al_multi(n_horiz, STATE_CONSTRAINT_OFFSETS,
                                   D.lower, D.upper, ts=ts, v_ref=v_ref,
                                   weights=weights, device=device)

        def al_multi(cands, param, lam, sigma):
            return al(cands, param["y0"], param["cltab"], param["pvec"],
                      lam, sigma)

    return dataclasses.replace(problem, cost_multi=cost_multi,
                               al_multi=al_multi, param_prep=param_prep)


def build_vehicle_controller(n_horiz: int = 12, v_ref: float = 1.0,
                             ts: float = 0.05,
                             params: Optional[VehicleParams] = None,
                             alm_cfg: Optional[AlmConfig] = None,
                             panoc_cfg: Optional[PanocConfig] = None,
                             bound_state_constraints: bool = False,
                             model: str = "pacejka",
                             weights=DEFAULT_VEHICLE_WEIGHTS,
                             device=None) -> MpcController:
    """Vehicle MPC controller with the reference's solver configuration
    (mpc_tpu/control/mpc.py:277-311): warm start ``U = [1, 0] * N``, L-BFGS
    memory N, the tolerance from ``AlmConfig``. ``device=None`` is the card
    (see :func:`build_vehicle_ocp`)."""
    device = resolve_device(device)
    problem = build_vehicle_ocp(n_horiz, v_ref, ts, params, weights=weights,
                                bound_state_constraints=bound_state_constraints,
                                model=model, device=device)
    if alm_cfg is None:
        alm_cfg = AlmConfig()
    if panoc_cfg is None:
        panoc_cfg = PanocConfig(lbfgs_memory=n_horiz)
    solve = make_alm_solver(problem, alm_cfg, panoc_cfg)
    return MpcController(problem=problem, solve=solve, n_horiz=n_horiz,
                         input_dim=2, warm_start_input=(1.0, 0.0),
                         device=device)


def build_vehicle_ilqr_controller(n_horiz: int = 40, v_ref: float = 1.0,
                                  ts: float = 0.05,
                                  params: Optional[VehicleParams] = None,
                                  bound_state_constraints: bool = False,
                                  weights=DEFAULT_VEHICLE_WEIGHTS,
                                  model: str = "pacejka",
                                  alm_cfg: Optional[AlmConfig] = None,
                                  ilqr_cfg: Optional[IlqrConfig] = None,
                                  obstacle_weight: float = 0.0,
                                  mesh=None, device=None) -> MpcController:
    """Vehicle MPC controller backed by AL-iLQR (solver/ilqr.py;
    mpc_tpu/control/mpc.py:314-428): the same OCP as
    :func:`build_vehicle_ocp`, solved with Gauss-Newton curvature from the
    stage cost's residual form. With ``bound_state_constraints`` (Pacejka)
    the quadratic state constraints ``x^2 - STATE_CONSTRAINT_OFFSETS <= 0``
    go through the AL outer loop. It runs no fan kernel: the AL-iLQR path
    is batched torch ops throughout. ``device=None`` is the card
    (:func:`resolve_device`). The obstacle field and the horizon-sharded
    ``mesh=`` path are not ported yet and raise.
    """
    if obstacle_weight > 0.0:
        raise NotImplementedError("mpc_tpu_torch: the obstacle field "
                                  "(ops/potential_field.py) is not ported yet")
    if mesh is not None:
        raise NotImplementedError("mpc_tpu_torch: the horizon-sharded "
                                  "AL-iLQR (parallel/ilqr_sharded.py) is not "
                                  "ported yet")
    if model == "pacejka":
        state_dim, dynamics = 6, pacejka_dynamics
    elif model == "simplified":
        state_dim, dynamics = 4, simplified_dynamics
    else:
        raise ValueError(f"unknown model {model!r}")
    device = resolve_device(device)
    if params is None:
        params = VehicleParams()
    f_d = discretize(dynamics, ts=ts)

    def stage_cost(x, u, param):
        return vehicle_stage_cost(x, u, param["centerline"], v_ref, weights)

    def stage_residuals(x, u, param):
        return vehicle_stage_residuals(x, u, param["centerline"], v_ref,
                                       weights)

    lim = torch.tensor([float(params.max_drive), float(params.max_steer)],
                       dtype=torch.float32, device=device).repeat(n_horiz)
    C = Box(lower=-lim, upper=lim)

    stage_constraints, n_stage = None, 0
    if bound_state_constraints and state_dim == 6:
        offs = torch.tensor(STATE_CONSTRAINT_OFFSETS, dtype=torch.float32,
                            device=device)

        def stage_constraints(x, u, param):
            return x ** 2 - offs

        n_stage = 6
    m = n_stage * n_horiz
    D = Box(torch.full((m,), -float("inf"), device=device),
            torch.zeros((m,), device=device))

    problem = build_ocp_problem(
        f_d, stage_cost, n_horiz, state_dim=state_dim, input_dim=2, C=C,
        stage_constraints=stage_constraints, n_stage_constraints=n_stage,
        D=D)
    solve = make_al_ilqr_solver(
        f_d, stage_cost, n_horiz, state_dim, 2, u_box=C,
        stage_constraints=stage_constraints, n_stage_constraints=n_stage,
        D=D, alm_cfg=alm_cfg or AlmConfig(),
        ilqr_cfg=ilqr_cfg or IlqrConfig(), stage_residuals=stage_residuals)
    return MpcController(problem=problem, solve=solve, n_horiz=n_horiz,
                         input_dim=2, warm_start_input=(1.0, 0.0),
                         device=device)
