"""The system under test for a state-constrained vehicle MPC configuration:
the PyTorch and CUDA port ``mpc_tpu_torch``, built through its own entry
point ``build_vehicle_controller(..., bound_state_constraints=True)`` with
the configuration's settings, and its plant
``discretize(pacejka_dynamics)``. Its solver is the ALM general path: an
outer loop of multiplier and penalty updates over PANOC, whose fan is
kernel K3 (the Pacejka fan plus the AL terms) on a card.

Each step's result keeps what the check judges: the plan, its AL objective,
the final multipliers (``lam``), the outer and inner iterations, and each
lane's last inner solve (``inner_gamma``, ``inner_lam``, ``inner_sigma``:
its step size and the multipliers and penalties it minimised under). A
program whose ``AlmResult`` lacks those fields cannot be judged, and
``build`` raises.

Beside it, built the same way:
- ``control``: the program's controller and loop with the plain reference
  (``benchmark/reference/constrained.py``), computed in TF32, as the OCP's
  cost and constraints (the AL objective's gradient by autograd over the
  candidates, the program's plain-fan path, with no road tables derived)
  and as the plant;
- ``broken``: the program with one fault planted (``FAULTS``), for the
  tests and for the readings that set the limits.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.programs import vehicle_mpc
# the harness sets the configuration's float32 precision through this module
from benchmark.programs.vehicle_mpc import SUBSTEPS, set_precision  # noqa: F401
from mpc_tpu_torch.config import AlmConfig, PanocConfig
from mpc_tpu_torch.control.mpc import (STATE_CONSTRAINT_OFFSETS, MpcCarry,
                                       MpcController,
                                       build_vehicle_controller)
from mpc_tpu_torch.models.bicycle import pacejka_dynamics
from mpc_tpu_torch.models.integrators import discretize
from mpc_tpu_torch.models.params import VehicleParams
from mpc_tpu_torch.solver.alm import AlmResult, make_alm_solver

#: the result fields the check reads of each lane's last inner solve
INNER_FIELDS = ("inner_gamma", "inner_lam", "inner_sigma")


class Program(vehicle_mpc.Program):
    """``vehicle_mpc.Program`` whose window keeps the multipliers and the
    last inner solve's fields."""

    def step(self, carry, y, inputs: dict):
        out = self.ctrl.step(carry, {"y0": y, "p": self.params,
                                     "centerline": inputs["centerline"]})
        # the window keeps every step's result: not the updated penalties,
        # which the carry passes on and nothing judges
        return out._replace(result=out.result._replace(sigma=None))


def _require_inner_fields():
    missing = [f for f in INNER_FIELDS if f not in AlmResult._fields]
    if missing:
        raise RuntimeError(
            "the program's AlmResult lacks " + ", ".join(missing)
            + ": the last inner solve's step size, multipliers and penalties"
            " that the constrained check judges by")


def _configs(cfg: dict):
    panoc = cfg["panoc"]
    return (AlmConfig(**cfg["alm"]),
            PanocConfig(lbfgs_memory=panoc["lbfgs_memory"],
                        max_iter=panoc["max_iter"],
                        crit_floor_mult=panoc["crit_floor_mult"]))


def _check_cfg(cfg: dict):
    if cfg["substeps"] != SUBSTEPS:
        raise ValueError(f"the program integrates with {SUBSTEPS} RK4 "
                         "substeps")
    if cfg["model"] != "pacejka":
        raise ValueError("the program bounds state constraints of the "
                         "Pacejka model only")
    c = cfg["constraints"]
    if tuple(c["offsets"]) != STATE_CONSTRAINT_OFFSETS \
            or c["lower"] is not None or c["upper"] != 0.0:
        raise ValueError("the program's state constraints are x^2 - "
                         f"{STATE_CONSTRAINT_OFFSETS} in (-inf, 0]")


def build(cfg: dict, traffic: dict, device,
          bound_state_constraints: bool = True) -> Program:
    """The program as the configuration states it."""
    _require_inner_fields()
    _check_cfg(cfg)
    alm, panoc = _configs(cfg)
    ctrl = build_vehicle_controller(
        n_horiz=cfg["n_horiz"], v_ref=cfg["v_ref"], ts=cfg["ts"],
        params=VehicleParams(**cfg["params"]), alm_cfg=alm, panoc_cfg=panoc,
        bound_state_constraints=bound_state_constraints, model=cfg["model"],
        weights=tuple(cfg["weights"]), device=device)
    f_d = discretize(pacejka_dynamics, ts=cfg["ts"], substeps=cfg["substeps"])
    return Program(ctrl, VehicleParams(**cfg["params"]), f_d)


def _with_problem(ctrl, cfg: dict, **changes) -> MpcController:
    """``ctrl`` with its OCP's fields replaced and its solver built again
    over them."""
    problem = dataclasses.replace(ctrl.problem, **changes)
    return MpcController(problem=problem,
                         solve=make_alm_solver(problem, *_configs(cfg)),
                         n_horiz=cfg["n_horiz"], input_dim=2,
                         warm_start_input=tuple(cfg["warm_start_input"]),
                         device=ctrl.device)


def control(cfg: dict, traffic: dict, device) -> Program:
    """The control: the reference in TF32 as the OCP's cost and
    constraints (one function of both, the AL objective's gradient by
    autograd over the candidates on the program's plain-fan path, with no
    road tables derived) and as the plant."""
    from benchmark.reference import constrained as cref
    from benchmark.reference import vehicle as ref

    def cost(u, param):
        f, _ = ref.cost(cfg, u, param["y0"], param["centerline"].double(),
                        ref.TF32)
        return f

    def cons(u, param):
        return cref.constraints(cfg, u, param["y0"], ref.TF32)

    def cost_constraints(u, param):
        return cost(u, param), cons(u, param)

    prog = build(cfg, traffic, device)
    prog.ctrl = _with_problem(prog.ctrl, cfg, cost=cost, constraints=cons,
                              cost_constraints=cost_constraints,
                              cost_multi=None, al_multi=None,
                              param_prep=None)
    prog.f_d = lambda y, u, params: ref.plant(cfg, y, u, ref.TF32)
    return prog


def _lam_zero(prog: Program, cfg: dict) -> Program:
    """Each pass's inner solve handed zero multipliers: the fan drops the
    multipliers' shift while the outer loop updates and reports them."""
    al = prog.ctrl.problem.al_multi

    def zeroed(cands, param, lam, sigma):
        return al(cands, param, torch.zeros_like(lam), sigma)

    prog.ctrl = _with_problem(prog.ctrl, cfg, al_multi=zeroed)
    return prog


def _grad_half(prog: Program, cfg: dict) -> Program:
    """The fan's gradient halved, its value kept."""
    al = prog.ctrl.problem.al_multi

    def half(cands, param, lam, sigma):
        psi, grad = al(cands, param, lam, sigma)
        return psi, 0.5 * grad

    prog.ctrl = _with_problem(prog.ctrl, cfg, al_multi=half)
    return prog


class _Stale:
    """The program's controller, where a warm lane (every carried penalty
    above 0: every lane after its first converged step) skips its solve:
    its carried plan comes back unchanged, flagged converged, with its true
    AL objective under its carried multipliers and penalties and the step
    size of the solve it skipped."""

    def __init__(self, ctrl):
        self.ctrl = ctrl
        self.problem, self.device = ctrl.problem, ctrl.device

    def init_carry(self, *args, **kwargs):
        return self.ctrl.init_carry(*args, **kwargs)

    def step(self, carry, param):
        out = self.ctrl.step(carry, param)
        warm = (carry.sigma > 0).all(dim=1)
        prep = self.problem.param_prep(param)
        psi_c, _ = self.problem.al_multi(carry.U[:, None, :], prep,
                                         carry.lam, carry.sigma)
        res = out.result
        w1 = warm[:, None]
        res = res._replace(
            u=torch.where(w1, carry.U, res.u),
            psi=torch.where(warm, psi_c[:, 0], res.psi),
            converged=res.converged | warm,
            lam=torch.where(w1, carry.lam, res.lam),
            inner_lam=torch.where(w1, carry.lam, res.inner_lam),
            inner_sigma=torch.where(w1, carry.sigma, res.inner_sigma),
            inner_iterations=torch.where(
                warm, torch.zeros_like(res.inner_iterations),
                res.inner_iterations))
        new = MpcCarry(*(torch.where(w1 if t.dim() == 2 else warm, c, t)
                         for c, t in zip(carry, out.carry)))
        return out._replace(carry=new, u0=res.u[:, :2], result=res)


#: the faults that ``broken`` plants: the AL terms dropped (the OCP's D
#: left unbounded, the fast path); each pass's inner solve handed zero
#: multipliers; a warm lane's solve skipped and its carried plan returned
#: flagged converged; the fan's gradient halved
FAULTS = ("unconstrained", "lam_zero", "stale", "grad_half")


def broken(cfg: dict, traffic: dict, device, fault: str) -> Program:
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if fault == "unconstrained":
        return build(cfg, traffic, device, bound_state_constraints=False)
    prog = build(cfg, traffic, device)
    if fault == "lam_zero":
        return _lam_zero(prog, cfg)
    if fault == "grad_half":
        return _grad_half(prog, cfg)
    prog.ctrl = _Stale(prog.ctrl)
    return prog
