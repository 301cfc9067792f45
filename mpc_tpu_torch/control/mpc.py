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

from mpc_tpu_torch.config import AlmConfig, PanocConfig
from mpc_tpu_torch.models.bicycle import pacejka_dynamics
from mpc_tpu_torch.models.integrators import discretize
from mpc_tpu_torch.models.params import VehicleParams
from mpc_tpu_torch.ops.costs import DEFAULT_VEHICLE_WEIGHTS, vehicle_stage_cost
from mpc_tpu_torch.ops.fused_psi import fan_params, make_vehicle_cost_multi
from mpc_tpu_torch.solver.alm import AlmResult, make_alm_solver
from mpc_tpu_torch.solver.problem import Box, Problem, build_ocp_problem

# Quadratic state-constraint offsets: y_i^2 - b_i per stage
STATE_CONSTRAINT_OFFSETS = (20.0, 1.0, 1.0, 2.0, 1.0, 0.1)


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

    ``param`` is the per-step parameter dict: ``y0`` (B, state_dim), ``p``
    (VehicleParams, shared) and ``centerline`` (S, 2, shared).
    """

    def __init__(self, problem: Problem, solve: Callable, n_horiz: int,
                 input_dim: int, warm_start_input: tuple):
        super().__init__()
        self.problem = problem
        self.solve = solve
        self.n_horiz = n_horiz
        self.input_dim = input_dim
        self.warm_start_input = tuple(warm_start_input)

    def init_carry(self, batch: int, device=None,
                   dtype=torch.float32) -> MpcCarry:
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
    (mpc_tpu/control/mpc.py:141-274 with ``fused=True``).

    The PANOC candidate fan goes through ``ops.fused_psi.fan_value_and_grad``:
    the CUDA kernel on a CUDA device, its plain version on the CPU. The
    kinematic model (its fan is kernel K2), the windowed search, the obstacle
    field and bounded state constraints are not ported yet and raise.
    """
    if window is not None:
        raise NotImplementedError("mpc_tpu_torch: only the dense "
                                  "full-centerline error path is ported")
    if obstacle_weight > 0.0:
        raise NotImplementedError("mpc_tpu_torch: the obstacle field "
                                  "(ops/potential_field.py) is not ported yet")
    if bound_state_constraints:
        raise NotImplementedError("mpc_tpu_torch: bounded state constraints "
                                  "need the ALM general path, not ported yet")
    multi = make_vehicle_cost_multi(n_horiz, ts=ts, v_ref=v_ref,
                                    weights=weights, model=model)
    if params is None:
        params = VehicleParams()
    f_d = discretize(pacejka_dynamics, ts=ts)

    def stage_cost(x, u, param):
        return vehicle_stage_cost(x, u, param["centerline"], v_ref, weights)

    lim = torch.tensor([float(params.max_drive), float(params.max_steer)],
                       dtype=torch.float32, device=device).repeat(n_horiz)
    offs = torch.tensor(STATE_CONSTRAINT_OFFSETS, dtype=torch.float32,
                        device=device)

    def stage_constraints(x, u, param):
        return x ** 2 - offs

    problem = build_ocp_problem(
        f_d, stage_cost, n_horiz, state_dim=6, input_dim=2,
        C=Box(lower=-lim, upper=lim), stage_constraints=stage_constraints,
        n_stage_constraints=6)

    def param_prep(param):
        cltab, pvec = fan_params(param["centerline"], param["p"])
        return dict(param, cltab=cltab, pvec=pvec)

    def cost_multi(cands, param):
        return multi(cands, param["y0"], param["cltab"], param["pvec"])

    return dataclasses.replace(problem, cost_multi=cost_multi,
                               param_prep=param_prep)


def build_vehicle_controller(n_horiz: int = 12, v_ref: float = 1.0,
                             ts: float = 0.05,
                             params: Optional[VehicleParams] = None,
                             alm_cfg: Optional[AlmConfig] = None,
                             panoc_cfg: Optional[PanocConfig] = None,
                             model: str = "pacejka",
                             weights=DEFAULT_VEHICLE_WEIGHTS,
                             device=None) -> MpcController:
    """Vehicle MPC controller with the reference's solver configuration
    (mpc_tpu/control/mpc.py:277-311): warm start ``U = [1, 0] * N``, L-BFGS
    memory N, the tolerance from ``AlmConfig``."""
    problem = build_vehicle_ocp(n_horiz, v_ref, ts, params, weights=weights,
                                model=model, device=device)
    if alm_cfg is None:
        alm_cfg = AlmConfig()
    if panoc_cfg is None:
        panoc_cfg = PanocConfig(lbfgs_memory=n_horiz)
    solve = make_alm_solver(problem, alm_cfg, panoc_cfg)
    return MpcController(problem=problem, solve=solve, n_horiz=n_horiz,
                         input_dim=2, warm_start_input=(1.0, 0.0))
