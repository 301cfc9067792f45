"""Batched AL-iLQR whose Riccati backward pass runs horizon-sharded, and
the batch-native MPC controller over it (port of
mpc_tpu/parallel/ilqr_sharded.py).

The JAX package writes a natively batched AL-iLQR beside its per-lane one
so that a mesh can reach the backward pass. The port's
``solver/ilqr.py`` is batch-native already, so this module only wires it
to a (scenario, horizon) mesh:

- the lanes go over the scenario axis: each rank solves its scenario slice,
  and the result is gathered over the scenario group at the end of the
  solve (the JAX contract: global arrays in and out);
- the LQT of every inner iteration is ``parallel/lqr_sharded.py``'s
  blocked scan over the horizon group, passed through the ``lqt`` hook of
  ``make_ilqr_solver`` / ``make_al_ilqr_solver``; the ranks of a horizon
  group hold the same lanes and get the same solution, so their loops run
  in lockstep, and each loop's all-lanes-done test is reduced over the
  group all the same (the ``group`` hook).

Kept from the JAX module as it behaves: with a mesh the backward pass is
the associative scan whatever ``IlqrConfig.parallel_backward`` says
(mpc_tpu/parallel/ilqr_sharded.py:53-62), and the batched family keeps no
traces (``trace`` is None). The rest is ``solver/ilqr.py``'s semantics,
which the JAX batched module mirrors too: on the path without general
constraints ``outer_iterations = (iterations > 0)``; a warm lane's
penalties are ``min(max(sigma_in, 1e-12), sigma_0)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from mpc_tpu_torch.config import AlmConfig, IlqrConfig
from mpc_tpu_torch.control.mpc import MpcController, MpcStepOut
from mpc_tpu_torch.parallel.lqr_sharded import make_lqt_horizon_sharded
from mpc_tpu_torch.parallel.mesh import HORIZON_AXIS, scenario_slice
from mpc_tpu_torch.parallel.sharding import gather_scenarios
from mpc_tpu_torch.solver.ilqr import make_al_ilqr_solver, make_ilqr_solver
from mpc_tpu_torch.solver.problem import LANE_NDIM, Box

#: the batched controller's step output: ``MpcStepOut``'s fields
BatchedMpcStepOut = MpcStepOut


def _rows(t, rows: slice, batch: int):
    """Rows ``rows`` of a per-lane tensor (leading axis ``batch``); anything
    else (a scalar tolerance, None) as it is."""
    if torch.is_tensor(t) and t.dim() and t.shape[0] == batch:
        return t[rows]
    return t


def _param_rows(param: dict, rows: slice) -> dict:
    """The per-lane entries of a parameter dict (``LANE_NDIM``) cut to
    ``rows``; shared entries as they are."""
    return {k: v[rows] if torch.is_tensor(v) and v.dim() == LANE_NDIM.get(k)
            else v for k, v in param.items()}


def _gathered(mesh, res):
    """Every tensor field of a result NamedTuple gathered over the scenario
    group."""
    return type(res)(*(gather_scenarios(mesh, t) if torch.is_tensor(t)
                       else t for t in res))


def _hooks(mesh) -> dict:
    return dict(lqt=make_lqt_horizon_sharded(mesh, scenario_axis=None),
                group=mesh.get_group(HORIZON_AXIS))


def make_ilqr_solver_batched(f_d: Callable, stage_cost: Callable,
                             n_horiz: int, state_dim: int, input_dim: int,
                             u_box: Optional[Box] = None,
                             cfg: IlqrConfig = IlqrConfig(),
                             stage_residuals: Optional[Callable] = None,
                             *, mesh) -> Callable:
    """``solve(us0 (B, N*m), param, al_args=None, skip=None) ->
    IlqrResult`` (``trace`` None): ``solver/ilqr.py:make_ilqr_solver``
    with the lanes over the scenario axis of the (scenario, horizon)
    ``mesh`` and the backward pass over its horizon axis."""
    inner = make_ilqr_solver(f_d, stage_cost, n_horiz, state_dim, input_dim,
                             u_box=u_box,
                             cfg=dataclasses.replace(cfg, trace=False),
                             stage_residuals=stage_residuals, **_hooks(mesh))

    def solve(us0, param, al_args=None, skip=None):
        B = us0.shape[0]
        rows = scenario_slice(mesh, B)
        if al_args is not None:
            al_args = (_rows(al_args[0], rows, B), _rows(al_args[1], rows, B),
                       *al_args[2:])
        return _gathered(mesh, inner(us0[rows], _param_rows(param, rows),
                                     al_args, _rows(skip, rows, B)))

    return solve


def make_al_ilqr_solver_batched(f_d: Callable, stage_cost: Callable,
                                n_horiz: int, state_dim: int, input_dim: int,
                                u_box: Box,
                                stage_constraints: Optional[Callable] = None,
                                n_stage_constraints: int = 0,
                                D: Optional[Box] = None,
                                alm_cfg: Optional[AlmConfig] = None,
                                ilqr_cfg: IlqrConfig = IlqrConfig(),
                                stage_residuals: Optional[Callable] = None,
                                *, mesh) -> Callable:
    """``solve(param, u0 (B, N*m), lam0 (B, M), tol=None, sigma0=None,
    gamma0=None) -> AlmResult``: ``solver/ilqr.py:make_al_ilqr_solver``
    with the lanes over the mesh's scenario axis and every inner backward
    pass over its horizon axis."""
    inner = make_al_ilqr_solver(
        f_d, stage_cost, n_horiz, state_dim, input_dim, u_box,
        stage_constraints=stage_constraints,
        n_stage_constraints=n_stage_constraints, D=D,
        alm_cfg=alm_cfg or AlmConfig(),
        ilqr_cfg=dataclasses.replace(ilqr_cfg, trace=False),
        stage_residuals=stage_residuals, **_hooks(mesh))

    def solve(param, u0, lam0, tol=None, sigma0=None, gamma0=None):
        B = u0.shape[0]
        rows = scenario_slice(mesh, B)
        return _gathered(mesh, inner(
            _param_rows(param, rows), u0[rows], lam0[rows],
            tol=_rows(tol, rows, B), sigma0=_rows(sigma0, rows, B),
            gamma0=_rows(gamma0, rows, B)))

    return solve


class BatchedMpcController(MpcController):
    """The batch-native MPC controller over the mesh-sharded AL-iLQR
    (mpc_tpu/parallel/ilqr_sharded.py:456-491), what
    ``build_vehicle_ilqr_controller(mesh=)`` returns. Its carry and
    parameters hold the global batch (B divisible by the mesh's scenario
    axis) on every rank.

    Its ``step`` is ``MpcController.step``, which does what the JAX
    batched controller's does: ``U`` is carried as solved, with no cold
    reset, and a lane that did not converge has its sigma and gamma set to
    the cold sentinel 0."""
