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
from mpc_tpu_torch.ops.potential_field import obstacle_stage_cost
from mpc_tpu_torch.ops.road import (compute_errors_ocp_windowed,
                                    find_nearest_point)
from mpc_tpu_torch.solver.alm import AlmResult, make_alm_solver
from mpc_tpu_torch.solver.ilqr import make_al_ilqr_solver
from mpc_tpu_torch.solver.multiple_shooting import (build_ms_ocp_problem,
                                                    ms_warm_start)
from mpc_tpu_torch.solver.problem import Box, Problem, build_ocp_problem
from mpc_tpu_torch.utils.timing import span

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

    A decision vector longer than the input sequence (multiple shooting:
    ``z = [U; X_1..X_{M-1}]``) has ``n_extra`` tail entries, zero in the
    cold carry, and ``warm_prep(z (B, n), param, cold (B,)) -> z`` prepares
    it before each solve; a lane is cold when every one of its carried
    penalties is <= 0, the cold-start sentinel
    (mpc_tpu/control/mpc.py:79-91, :109-112).
    """

    def __init__(self, problem: Problem, solve: Callable, n_horiz: int,
                 input_dim: int, warm_start_input: tuple,
                 device: torch.device, n_extra: int = 0,
                 warm_prep: Optional[Callable] = None):
        super().__init__()
        self.problem = problem
        self.solve = solve
        self.n_horiz = n_horiz
        self.input_dim = input_dim
        self.warm_start_input = tuple(warm_start_input)
        self.device = torch.device(device)
        self.n_extra = n_extra
        self.warm_prep = warm_prep

    def init_carry(self, batch: int, device=None,
                   dtype=torch.float32) -> MpcCarry:
        """Cold carry for ``batch`` lanes, on the controller's device unless
        ``device`` names another."""
        device = self.device if device is None else device
        U0 = torch.tensor(self.warm_start_input, dtype=dtype,
                          device=device).repeat(self.n_horiz)
        U0 = torch.cat([U0, torch.zeros((self.n_extra,), dtype=dtype,
                                        device=device)])
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
        with span("mpc.step"):
            return self._step(carry, param)

    def _step(self, carry: MpcCarry, param: Any) -> MpcStepOut:
        U0 = carry.U
        if self.warm_prep is not None:
            U0 = self.warm_prep(U0, param, (carry.sigma <= 0).all(dim=1))
        res = self.solve(param, U0, carry.lam, sigma0=carry.sigma,
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


def input_to_matrix(u_flat: torch.Tensor, input_dim: int = 2) -> torch.Tensor:
    """Flat input sequences (B, N * input_dim), stage-major ``[d0, delta0,
    d1, delta1, ...]``, as (B, input_dim, N) matrices
    (mpc_tpu/control/mpc.py:132-138)."""
    return u_flat.reshape(u_flat.shape[0], -1, input_dim).transpose(1, 2)


def _vehicle_model(model: str):
    """``(state_dim, continuous dynamics)`` of a vehicle model's name."""
    if model == "pacejka":
        return 6, pacejka_dynamics
    if model == "simplified":
        return 4, simplified_dynamics
    raise ValueError(f"unknown model {model!r}")


def _input_box(params: VehicleParams, n_horiz: int, device) -> Box:
    lim = torch.tensor([float(params.max_drive), float(params.max_steer)],
                       dtype=torch.float32, device=device).repeat(n_horiz)
    return Box(lower=-lim, upper=lim)


def _state_constraints(device) -> Callable:
    """The quadratic state constraints ``x^2 - STATE_CONSTRAINT_OFFSETS``
    of one stage, (B, 6)."""
    offs = torch.tensor(STATE_CONSTRAINT_OFFSETS, dtype=torch.float32,
                        device=device)

    def stage_constraints(x, u, param):
        return x ** 2 - offs

    return stage_constraints


def _nonpositive(m: int, device) -> Box:
    """The box (-inf, 0] of ``m`` constraints."""
    return Box(torch.full((m,), -float("inf"), device=device),
               torch.zeros((m,), device=device))


def _with_obstacles(stage_cost: Callable, obstacle_weight: float,
                    obstacle_field_kwargs: Optional[dict]) -> Callable:
    """``stage_cost`` plus the obstacle field at each stage's state
    (mpc_tpu/control/mpc.py:209-216): the parameters then carry
    ``obstacles``, (K, 4) shared or (B, K, 4) one set per lane."""
    kw = obstacle_field_kwargs or {}

    def cost(x, u, param):
        return stage_cost(x, u, param) + obstacle_stage_cost(
            x, param["obstacles"], weight=obstacle_weight, **kw)

    return cost


def build_vehicle_ocp(n_horiz: int = 12, v_ref: float = 1.0,
                      ts: float = 0.05,
                      params: Optional[VehicleParams] = None,
                      weights=DEFAULT_VEHICLE_WEIGHTS,
                      bound_state_constraints: bool = False,
                      window: Optional[int] = None,
                      errors_fn: Optional[Callable] = None,
                      model: str = "pacejka",
                      obstacle_weight: float = 0.0,
                      obstacle_field_kwargs: Optional[dict] = None,
                      centerline_size: int = 100,
                      device=None) -> Problem:
    """Vehicle OCP (mpc_tpu/control/mpc.py:141-274).

    ``model="pacejka"``: the 6-state single-track model, with quadratic
    state constraints ``x^2 - STATE_CONSTRAINT_OFFSETS`` per stage, left
    unbounded unless ``bound_state_constraints`` bounds them above by 0
    (then the ALM general path solves it). ``model="simplified"``: the
    4-state kinematic bicycle with input boxes only.

    On the dense full-centerline path the OCP is fused, as the JAX package's
    with ``fused`` set: its candidate fan is ``ops.fused_psi``'s kernel, K1
    (Pacejka), K2 (kinematic) or, with bounded constraints, K3, run as CUDA
    on a CUDA device and as its plain version on the CPU. Three options
    choose the plain OCP instead, whose fan is the stage cost and its
    autograd over B*K lanes (``solver/panoc.py``), because the JAX package's
    fused backend refuses them (mpc_tpu/control/mpc.py:246-252):
    ``window``, the nearest point searched in ``window`` centerline points
    around each lane's nearest point to its initial state (anchored once
    per solve in ``param_prep``; it must cover the horizon's travel);
    ``errors_fn(pos, heading, centerline) -> RoadErrors``, the road errors
    (ignored when ``window`` is set, as in the JAX package);
    ``obstacle_weight > 0``, the obstacle field (``ops/potential_field.py``,
    ``obstacle_field_kwargs`` its settings) added to every stage cost, the
    parameters then carrying ``obstacles``. ``centerline_size`` is taken for
    the JAX package's signature, which does not read it either: the road's
    size is its centerline's. ``device=None`` is the card
    (:func:`resolve_device`: without one it raises; pass ``device="cpu"``
    for the CPU).
    """
    state_dim, dynamics = _vehicle_model(model)
    device = resolve_device(device)
    if params is None:
        params = VehicleParams()
    f_d = discretize(dynamics, ts=ts)
    fused = window is None and errors_fn is None and obstacle_weight <= 0.0

    param_prep = None
    if window is not None:
        def param_prep(param):
            idx, _ = find_nearest_point(param["y0"][:, :2],
                                        param["centerline"])
            return dict(param, window_center=idx)

        def stage_cost(x, u, param):
            def werr(pos, heading, cl):
                return compute_errors_ocp_windowed(
                    pos, heading, cl, param["window_center"], window)
            return vehicle_stage_cost(x, u, param["centerline"], v_ref,
                                      weights, errors_fn=werr)
    elif errors_fn is not None:
        def stage_cost(x, u, param):
            return vehicle_stage_cost(x, u, param["centerline"], v_ref,
                                      weights, errors_fn=errors_fn)
    else:
        def stage_cost(x, u, param):
            return vehicle_stage_cost(x, u, param["centerline"], v_ref,
                                      weights)
    if obstacle_weight > 0.0:
        stage_cost = _with_obstacles(stage_cost, obstacle_weight,
                                     obstacle_field_kwargs)

    stage_constraints, n_stage, D = None, 0, None
    if state_dim == 6:
        stage_constraints, n_stage = _state_constraints(device), 6
        if bound_state_constraints:
            D = _nonpositive(n_stage * n_horiz, device)

    problem = build_ocp_problem(
        f_d, stage_cost, n_horiz, state_dim=state_dim, input_dim=2,
        C=_input_box(params, n_horiz, device),
        stage_constraints=stage_constraints, n_stage_constraints=n_stage,
        D=D)
    if not fused:
        return dataclasses.replace(problem, param_prep=param_prep,
                                   uses_obstacles=obstacle_weight > 0.0)

    multi = make_vehicle_cost_multi(n_horiz, ts=ts, v_ref=v_ref,
                                    weights=weights, model=model)

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
                             window: Optional[int] = None,
                             model: str = "pacejka",
                             weights=DEFAULT_VEHICLE_WEIGHTS,
                             obstacle_weight: float = 0.0,
                             obstacle_field_kwargs: Optional[dict] = None,
                             centerline_size: int = 100,
                             device=None) -> MpcController:
    """Vehicle MPC controller with the reference's solver configuration
    (mpc_tpu/control/mpc.py:277-311): warm start ``U = [1, 0] * N``, L-BFGS
    memory N, the tolerance from ``AlmConfig``. The options and
    ``device=None``, the card, are :func:`build_vehicle_ocp`'s."""
    device = resolve_device(device)
    problem = build_vehicle_ocp(
        n_horiz, v_ref, ts, params, weights=weights,
        bound_state_constraints=bound_state_constraints, window=window,
        model=model, obstacle_weight=obstacle_weight,
        obstacle_field_kwargs=obstacle_field_kwargs,
        centerline_size=centerline_size, device=device)
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
                                  obstacle_field_kwargs: Optional[dict] = None,
                                  mesh=None, device=None) -> MpcController:
    """Vehicle MPC controller backed by AL-iLQR (solver/ilqr.py;
    mpc_tpu/control/mpc.py:314-428): the same OCP as
    :func:`build_vehicle_ocp`, solved with Gauss-Newton curvature from the
    stage cost's residual form. With ``bound_state_constraints`` (Pacejka)
    the quadratic state constraints ``x^2 - STATE_CONSTRAINT_OFFSETS <= 0``
    go through the AL outer loop. ``obstacle_weight > 0`` adds the obstacle
    field to the stage cost; it is not a sum of squares, so the backward
    pass then takes the full second-order path (mpc_tpu/control/mpc.py:
    370-377), and the obstacles, like the road, are shared by the lanes
    ((K, 4)). It runs no fan kernel: the AL-iLQR path is batched torch ops
    throughout. ``device=None`` is the card (:func:`resolve_device`).

    ``mesh``: a (scenario, horizon) mesh
    (``parallel/mesh.py:make_horizon_mesh``). With one, the controller is
    the batch-native ``BatchedMpcController`` of
    ``parallel/ilqr_sharded.py`` (mpc_tpu/control/mpc.py:410-420): the
    lanes over the scenario axis, every Riccati backward pass over the
    horizon axis; its carry and parameters hold the global batch on every
    rank.
    """
    state_dim, dynamics = _vehicle_model(model)
    device = resolve_device(device)
    if params is None:
        params = VehicleParams()
    f_d = discretize(dynamics, ts=ts)

    def stage_cost(x, u, param):
        return vehicle_stage_cost(x, u, param["centerline"], v_ref, weights)

    def stage_residuals(x, u, param):
        return vehicle_stage_residuals(x, u, param["centerline"], v_ref,
                                       weights)

    if obstacle_weight > 0.0:
        stage_cost = _with_obstacles(stage_cost, obstacle_weight,
                                     obstacle_field_kwargs)
        stage_residuals = None

    C = _input_box(params, n_horiz, device)
    stage_constraints, n_stage = None, 0
    if bound_state_constraints and state_dim == 6:
        stage_constraints, n_stage = _state_constraints(device), 6
    D = _nonpositive(n_stage * n_horiz, device)

    problem = build_ocp_problem(
        f_d, stage_cost, n_horiz, state_dim=state_dim, input_dim=2, C=C,
        stage_constraints=stage_constraints, n_stage_constraints=n_stage,
        D=D)
    problem = dataclasses.replace(problem,
                                  uses_obstacles=obstacle_weight > 0.0)
    kw = dict(stage_constraints=stage_constraints,
              n_stage_constraints=n_stage, D=D,
              alm_cfg=alm_cfg or AlmConfig(),
              ilqr_cfg=ilqr_cfg or IlqrConfig(),
              stage_residuals=stage_residuals)
    if mesh is not None:
        from mpc_tpu_torch.parallel.ilqr_sharded import (
            BatchedMpcController, make_al_ilqr_solver_batched)
        solve = make_al_ilqr_solver_batched(f_d, stage_cost, n_horiz,
                                            state_dim, 2, u_box=C, mesh=mesh,
                                            **kw)
        return BatchedMpcController(problem=problem, solve=solve,
                                    n_horiz=n_horiz, input_dim=2,
                                    warm_start_input=(1.0, 0.0),
                                    device=device)
    solve = make_al_ilqr_solver(f_d, stage_cost, n_horiz, state_dim, 2,
                                u_box=C, **kw)
    return MpcController(problem=problem, solve=solve, n_horiz=n_horiz,
                         input_dim=2, warm_start_input=(1.0, 0.0),
                         device=device)


def build_vehicle_ms_controller(n_horiz: int = 40, n_segments: int = 8,
                                v_ref: float = 1.0, ts: float = 0.05,
                                params: Optional[VehicleParams] = None,
                                alm_cfg: Optional[AlmConfig] = None,
                                panoc_cfg: Optional[PanocConfig] = None,
                                bound_state_constraints: bool = False,
                                weights=DEFAULT_VEHICLE_WEIGHTS,
                                model: str = "pacejka",
                                state_bound=None,
                                sigma_0_defect: float = 10.0,
                                device=None):
    """Vehicle MPC controller on the multiple-shooting OCP
    (mpc_tpu/control/mpc.py:431-529), ``(MpcController, MsLayout)``.

    The horizon is split into ``n_segments`` segments rolled out side by
    side (``solver/multiple_shooting.py``), glued by defect equalities that
    the ALM general path handles. Cold lanes seed the segment-start states
    by rolling their input sequence out (``ms_warm_start``, the
    controller's ``warm_prep``), so their first solve starts with zero
    defects; warm lanes carry the whole decision vector. The initial
    penalties are per constraint: ``alm_cfg.sigma_0`` on the stage
    inequalities (``bound_state_constraints``), ``sigma_0_defect`` on the
    defects. Defaults: ``AlmConfig(eps=1e-4, delta=1e-4, sigma_0=1e3,
    penalty_factor=5.0)``, L-BFGS memory ``2 * n_segments + 8``. There is
    no fused fan for this OCP in either package. ``device=None`` is the
    card (:func:`resolve_device`).
    """
    state_dim, dynamics = _vehicle_model(model)
    device = resolve_device(device)
    if params is None:
        params = VehicleParams()
    f_d = discretize(dynamics, ts=ts)

    def stage_cost(x, u, param):
        return vehicle_stage_cost(x, u, param["centerline"], v_ref, weights)

    stage_constraints, n_stage, D_stage = None, 0, None
    if bound_state_constraints and state_dim == 6:
        stage_constraints, n_stage = _state_constraints(device), 6
        D_stage = _nonpositive(n_stage * n_horiz, device)

    problem, lo = build_ms_ocp_problem(
        f_d, stage_cost, n_horiz, n_segments, state_dim, 2,
        _input_box(params, n_horiz, device),
        stage_constraints=stage_constraints, n_stage_constraints=n_stage,
        D_stage=D_stage, state_bound=state_bound)

    if alm_cfg is None:
        alm_cfg = AlmConfig(eps=1e-4, delta=1e-4, sigma_0=1e3,
                            penalty_factor=5.0)
    if panoc_cfg is None:
        panoc_cfg = PanocConfig(lbfgs_memory=2 * n_segments + 8)
    m_stage = n_stage * n_horiz
    sigma_0 = (float(alm_cfg.sigma_0),) * m_stage \
        + (float(sigma_0_defect),) * (problem.m - m_stage)
    solve = make_alm_solver(problem,
                            dataclasses.replace(alm_cfg, sigma_0=sigma_0),
                            panoc_cfg)

    def warm_prep(z, param, cold):
        z_cold = ms_warm_start(f_d, lo, param["y0"], z[:, : lo.n_inputs],
                               param["p"])
        return torch.where(cold[:, None], z_cold, z)

    ctrl = MpcController(problem=problem, solve=solve, n_horiz=n_horiz,
                         input_dim=2, warm_start_input=(1.0, 0.0),
                         device=device, n_extra=lo.n_states,
                         warm_prep=warm_prep)
    return ctrl, lo
