"""The system under test for a vehicle MPC configuration: the PyTorch and
CUDA port ``mpc_tpu_torch``, built through its own entry point
``build_vehicle_controller`` with the configuration's settings, and its
plant ``discretize(pacejka_dynamics | simplified_dynamics)``. The
program's fan is kernel K1 (Pacejka) or K2 (kinematic) on a card.

Beside it, built the same way:
- ``control``: the program's controller and loop with the plain reference
  (``benchmark/reference/vehicle.py``), computed in TF32, in the place of
  the fan (the OCP's cost and gradient) and of the plant;
- ``broken``: the program with one fault planted in its step (``FAULTS``),
  for the tests and for the readings that set the limits.
"""

from __future__ import annotations

import dataclasses

import torch

from mpc_tpu_torch.config import AlmConfig, PanocConfig
from mpc_tpu_torch.control.mpc import (MpcCarry, MpcController,
                                       build_vehicle_controller)
from mpc_tpu_torch.models.bicycle import pacejka_dynamics, simplified_dynamics
from mpc_tpu_torch.models.integrators import discretize
from mpc_tpu_torch.models.params import VehicleParams
from mpc_tpu_torch.solver.alm import make_alm_solver

DYNAMICS = {"pacejka": pacejka_dynamics, "simplified": simplified_dynamics}

#: the program integrates each control interval with 4 RK4 substeps
SUBSTEPS = 4


@dataclasses.dataclass
class Program:
    """A controller ``ctrl`` and its plant ``f_d(y, u, params)``, in the
    closed loop's terms (``benchmark/loops/closed_loop.py``)."""
    ctrl: object
    params: VehicleParams
    f_d: object

    def init_carry(self, batch: int):
        return self.ctrl.init_carry(batch)

    def step(self, carry, y, inputs: dict):
        out = self.ctrl.step(carry, {"y0": y, "p": self.params,
                                     "centerline": inputs["centerline"]})
        # the window keeps every step's result: not its (B, m) multipliers
        # and penalties, which the carry passes on and nothing judges
        return out._replace(result=out.result._replace(lam=None, sigma=None))

    def plant(self, y, u0):
        return self.f_d(y, u0, self.params)


def _configs(cfg: dict):
    panoc = cfg["panoc"]
    return (AlmConfig(eps=cfg["alm"]["eps"]),
            PanocConfig(lbfgs_memory=panoc["lbfgs_memory"],
                        max_iter=panoc["max_iter"],
                        crit_floor_mult=panoc["crit_floor_mult"]))


def build(cfg: dict, traffic: dict, device) -> Program:
    """The program as the configuration states it."""
    if cfg["substeps"] != SUBSTEPS:
        raise ValueError(f"the program integrates with {SUBSTEPS} RK4 "
                         "substeps")
    alm, panoc = _configs(cfg)
    ctrl = build_vehicle_controller(
        n_horiz=cfg["n_horiz"], v_ref=cfg["v_ref"], ts=cfg["ts"],
        params=VehicleParams(**cfg["params"]), alm_cfg=alm, panoc_cfg=panoc,
        model=cfg["model"], weights=tuple(cfg["weights"]), device=device)
    f_d = discretize(DYNAMICS[cfg["model"]], ts=cfg["ts"],
                     substeps=cfg["substeps"])
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
    """The control: the reference in TF32 as the OCP's cost (its gradient
    by autograd over the candidates, the program's plain-fan path, with no
    road tables derived) and as the plant."""
    from benchmark.reference import vehicle as ref

    def cost(u, param):
        psi, _ = ref.cost(cfg, u, param["y0"], param["centerline"].double(),
                          ref.TF32)
        return psi

    prog = build(cfg, traffic, device)
    prog.ctrl = _with_problem(prog.ctrl, cfg, cost=cost, cost_multi=None,
                              param_prep=None)
    prog.f_d = lambda y, u, params: ref.plant(cfg, y, u, ref.TF32)
    return prog


class _Broken:
    """The program's controller with one fault planted in its step."""

    def __init__(self, ctrl, fault: str):
        self.ctrl, self.fault = ctrl, fault
        self.problem, self.device = ctrl.problem, ctrl.device

    def init_carry(self, *args, **kwargs):
        return self.ctrl.init_carry(*args, **kwargs)

    def step(self, carry, param):
        if self.fault == "half":
            return self._half(carry, param)
        out = self.ctrl.step(carry, param)
        res = out.result
        if self.fault == "unchanged":
            none = torch.zeros_like(res.converged)
            res = res._replace(u=carry.U, converged=none,
                               inner_iterations=torch.zeros_like(
                                   res.inner_iterations))
            return out._replace(carry=carry, u0=carry.U[:, :2], result=res)
        if self.fault == "stale":
            return self._stale(carry, param, out)
        if self.fault == "psi":
            return out._replace(result=res._replace(psi=res.psi * 1.01))
        if self.fault == "u0":
            return out._replace(u0=out.u0 + 1e-2)
        raise ValueError(f"unknown fault {self.fault!r}")

    def _stale(self, carry, param, out):
        """A lane with a carried step size (every lane after an episode's
        first step) skips its solve: its carried plan comes back unchanged,
        flagged converged, with its true cost and the carried step size."""
        warm = carry.gamma > 0
        prep = self.problem.param_prep(param)
        psi_c, _ = self.problem.cost_multi(carry.U[:, None, :], prep)
        res = out.result
        w1 = warm[:, None]
        res = res._replace(
            u=torch.where(w1, carry.U, res.u),
            psi=torch.where(warm, psi_c[:, 0], res.psi),
            converged=res.converged | warm,
            gamma=torch.where(warm, carry.gamma, res.gamma),
            inner_iterations=torch.where(
                warm, torch.zeros_like(res.inner_iterations),
                res.inner_iterations))
        new = MpcCarry(*(torch.where(w1 if t.dim() == 2 else warm, c, t)
                         for c, t in zip(carry, out.carry)))
        return out._replace(carry=new, u0=res.u[:, :2], result=res)

    def _half(self, carry, param):
        """Only the first half of the lanes is solved; the rest take their
        results."""
        B = param["y0"].shape[0]
        h = max(B // 2, 1)
        rows = torch.arange(B, device=param["y0"].device) % h
        sub = dict(param, y0=param["y0"][:h])
        if param["centerline"].dim() == 3:
            sub["centerline"] = param["centerline"][:h]
        out = self.ctrl.step(MpcCarry(*(t[:h] for t in carry)), sub)

        def tile(nt):
            return type(nt)(*(t[rows] if torch.is_tensor(t) and t.dim()
                              and t.shape[0] == h else t for t in nt))

        return out._replace(carry=tile(out.carry), u0=out.u0[rows],
                            result=tile(out.result))


def _grad_half(prog: Program, cfg: dict) -> Program:
    """The fan's gradient halved, its value kept."""
    multi = prog.ctrl.problem.cost_multi

    def half(cands, param):
        psi, grad = multi(cands, param)
        return psi, 0.5 * grad

    prog.ctrl = _with_problem(prog.ctrl, cfg, cost_multi=half)
    return prog


#: the faults that ``broken`` plants: a step that returns its state
#: unchanged (flagged unconverged), or skips its solve and returns the
#: carried plan flagged converged (``stale``); half the batch solved and
#: copied over the rest; the fan's gradient halved; an answer altered where
#: it is produced (the cost, the first input)
FAULTS = ("unchanged", "stale", "half", "grad_half", "psi", "u0")


def broken(cfg: dict, traffic: dict, device, fault: str) -> Program:
    prog = build(cfg, traffic, device)
    if fault == "grad_half":
        return _grad_half(prog, cfg)
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    prog.ctrl = _Broken(prog.ctrl, fault)
    return prog


def set_precision(cfg: dict):
    """Float32 as the configuration states it: TF32 on or off everywhere."""
    tf32 = bool(cfg.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
