"""The benchmark's constrained configuration (``constrained_n40``) on the
CPU at a tiny size: the float64 reference against the port's plain K3
twin, the ALM result's last-inner-solve fields, its pass counter and
``alm.update`` span, the Bezier road kind, the check on a short closed loop
of the program, of each planted fault and of the control, and the AL
fan's frozen operation count. No JAX; N <= 6, batch <= 4."""

import collections
import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.core import al_roofline, check, roofline, spec, window
from benchmark.generators import fleet
from benchmark.reference import constrained as cref
from benchmark.reference import vehicle as ref
from mpc_tpu_torch.bench import lane_change_road
from mpc_tpu_torch.config import AlmConfig, PanocConfig
from mpc_tpu_torch.control.mpc import (STATE_CONSTRAINT_OFFSETS,
                                       build_vehicle_ocp)
from mpc_tpu_torch.models.params import VehicleParams
from mpc_tpu_torch.ops.fused_psi import (fan_params,
                                         fan_value_and_grad_reference,
                                         make_vehicle_al_multi)
from mpc_tpu_torch.solver import alm as talm
from mpc_tpu_torch.solver.problem import Box, Problem
from mpc_tpu_torch.utils import timing

torch.set_num_threads(1)

CELL = "constrained_n40.lanechange_b4096"
SEED = 2 ** 31 + 4242


def _cell(n_horiz=2, batch=4, steps=2):
    """The cell cut to ``n_horiz`` stages (L-BFGS memory as many),
    ``batch`` lanes and ``steps`` steps an episode."""
    c = spec.cell(CELL)
    c.cfg["n_horiz"] = n_horiz
    c.cfg["panoc"]["lbfgs_memory"] = n_horiz
    c.traffic.update(batch=batch, episode_steps=steps, warmup_steps=1,
                     min_steps=0)
    c.traffic["trace_slice"] = {"start": 0, "steps": 1}
    return c


# ---- the reference against the port's plain K3 twin -----------------------

def _draw(cfg, road, B, seed, log_sigma):
    g = torch.Generator().manual_seed(seed)
    y = torch.zeros(B, 6, dtype=torch.float64)
    y[:, :2] = road[0].double() + 0.05 * torch.randn(B, 2, generator=g,
                                                    dtype=torch.float64)
    y[:, 2] = 0.3 * torch.randn(B, generator=g, dtype=torch.float64)
    y[:, 3] = 0.5 + 0.3 * torch.rand(B, generator=g, dtype=torch.float64)
    y[:, 5] = 0.5 * torch.randn(B, generator=g, dtype=torch.float64)
    u = torch.rand(B, 2 * cfg["n_horiz"], generator=g, dtype=torch.float64)
    u[:, 0::2] = 2 * u[:, 0::2] - 1
    u[:, 1::2] = 0.3 * (2 * u[:, 1::2] - 1)
    m = 6 * cfg["n_horiz"]
    lam = 2.0 * torch.rand(B, m, generator=g, dtype=torch.float64)
    sigma = 10.0 ** (log_sigma[0] + (log_sigma[1] - log_sigma[0])
                     * torch.rand(B, m, generator=g, dtype=torch.float64))
    return y, u, lam, sigma


@pytest.mark.parametrize("seed,log_sigma", [(0, (-1.0, 3.0)),
                                            (1, (2.0, 4.0)),
                                            (2, (0.0, 1.0))])
def test_reference_matches_the_programs_plain_k3(seed, log_sigma):
    c = _cell(n_horiz=5)
    cfg = c.cfg
    road = torch.as_tensor(fleet.road(c.traffic))
    y, u, lam, sigma = _draw(cfg, road, 5, seed, log_sigma)
    p = VehicleParams(**cfg["params"])
    cltab, pvec = fan_params(road, p)
    args = (cfg["n_horiz"], cfg["substeps"], cfg["ts"] / cfg["substeps"],
            cfg["v_ref"], cfg["weights"])
    f, _ = ref.cost(cfg, u, y, road.double())
    psi, grad, amb = cref.al_objective_and_grad(cfg, u, y, road, lam, sigma)
    assert (~amb).sum() >= 3
    keep = ~amb

    # f: the port's plain fan in float64, its parameters and road table
    # held in float32 (about 3e-8 of each, well inside 1e-7)
    p_f, _ = fan_value_and_grad_reference(u, y, cltab.double(),
                                          pvec.double(), *args)
    torch.testing.assert_close(f[keep], p_f[keep], rtol=1e-7, atol=0)

    # g: the port's own constraints in float64 at the plan, on the same
    # RK4 (float32 parameters again)
    ocp = build_vehicle_ocp(cfg["n_horiz"], cfg["v_ref"], cfg["ts"], p,
                            bound_state_constraints=True, device="cpu")
    param = ocp.param_prep({"y0": y, "p": p, "centerline": road})
    g64 = cref.constraints(cfg, u, y)
    torch.testing.assert_close(g64, ocp.constraints(u, param).double(),
                               rtol=1e-6, atol=1e-6)

    # the AL objective and its gradient: the K3 twin evaluates in float32
    # (its constants and penalties rounded to float32, a sum of 6N + N
    # terms), so psi agrees to float32 rounding of a sum (2e-6 of it) and
    # the gradient to 1e-4 of the lane's largest entry (the AL terms scale
    # the rollout's rounding by sigma up to 1e4)
    al = make_vehicle_al_multi(cfg["n_horiz"], STATE_CONSTRAINT_OFFSETS,
                               *cref.bounds(cfg, 6 * cfg["n_horiz"], "cpu",
                                            torch.float32),
                               ts=cfg["ts"], v_ref=cfg["v_ref"],
                               weights=cfg["weights"])
    k_psi, k_grad = al(u.float()[:, None, :], y.float(), cltab, pvec,
                       lam.float(), sigma.float())
    torch.testing.assert_close(k_psi[keep, 0].double(), psi[keep],
                               rtol=2e-6, atol=0)
    scale = grad.abs().amax(dim=1, keepdim=True)
    err = (k_grad[:, 0].double() - grad).abs() / scale
    assert float(err[keep].max()) < 1e-4, float(err[keep].max())


# ---- the ALM result's fields, counter and span ---------------------------

def _recording(monkeypatch):
    """Every inner solve's ``(args, result)``, in call order."""
    calls = []
    build = talm.make_panoc_solver

    def recording(*a, **k):
        solve = build(*a, **k)

        def wrapped(u0, tol, args, gamma_init=None):
            res = solve(u0, tol, args, gamma_init=gamma_init)
            calls.append((args, res))
            return res
        wrapped.fan_graph = solve.fan_graph
        return wrapped

    monkeypatch.setattr(talm, "make_panoc_solver", recording)
    return calls


def _general_solve(max_iter=12):
    prob = Problem(
        cost=lambda u, t: ((u - t) ** 2).sum(dim=1),
        constraints=lambda u, _: u[:, :1] + u[:, 1:], C=Box.unbounded(2),
        D=Box(torch.tensor([-1.0]), torch.tensor([1.0])), n=2, m=1)
    solve = talm.make_alm_solver(
        prob, AlmConfig(eps=1e-4, delta=1e-4, sigma_0=100.0,
                        max_iter=max_iter, eps_0=1e-2),
        PanocConfig(lbfgs_memory=5, max_iter=200))
    targets = torch.tensor([[2.0, 2.0], [0.2, 0.3], [3.0, -1.0]])
    # the second lane warm: it starts at the final tolerance and needs
    # fewer passes than the cold ones' eps_0 -> eps homotopy
    return solve(targets, torch.zeros((3, 2)), torch.zeros((3, 1)),
                 sigma0=torch.tensor([[0.0], [100.0], [0.0]]))


def test_inner_fields_are_each_lanes_last_pass(monkeypatch):
    calls = _recording(monkeypatch)
    res = _general_solve()
    outer = res.outer_iterations.tolist()
    assert len(set(outer)) > 1
    for lane, k in enumerate(outer):
        (_, lam, sigma), inner = calls[k - 1]
        assert res.inner_gamma[lane] == inner.gamma[lane] > 0
        assert torch.equal(res.inner_lam[lane], lam[lane])
        assert torch.equal(res.inner_sigma[lane], sigma[lane])
    # the carry as before: gamma reset to 0, lam the update from the last
    # inner solve's multipliers and penalties at the plan
    assert torch.equal(res.gamma, torch.zeros(3))
    g = res.u[:, :1] + res.u[:, 1:]
    zeta = g + res.inner_lam / res.inner_sigma
    lam_plus = res.inner_sigma * (zeta - zeta.clamp(-1.0, 1.0))
    torch.testing.assert_close(res.lam, lam_plus)


def test_outer_passes_count_the_slowest_lanes_iterations(monkeypatch):
    calls = _recording(monkeypatch)
    res = _general_solve()
    assert res.stats.outer_passes == int(res.outer_iterations.max()) \
        == len(calls)


def test_fast_path_fills_the_inner_fields_from_its_one_solve():
    prob = Problem(cost=lambda u, t: ((u - t) ** 2).sum(dim=1),
                   constraints=None, C=Box.unbounded(2),
                   D=Box.unbounded(1), n=2, m=1)
    solve = talm.make_alm_solver(prob, AlmConfig(eps=1e-5),
                                 PanocConfig(lbfgs_memory=5, max_iter=100))
    lam0, sigma0 = torch.zeros((2, 1)), torch.ones((2, 1))
    res = solve(torch.tensor([[1.0, 2.0], [0.0, -1.0]]), torch.zeros((2, 2)),
                lam0, sigma0=sigma0)
    assert res.inner_gamma is res.gamma
    assert res.inner_lam is lam0 and res.inner_sigma is sigma0
    assert res.stats.outer_passes == 1


def test_alm_update_is_recorded_inside_alm_outer():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = _general_solve(max_iter=3)
    _, spans, _ = timing.profiler_events(prof)
    by = collections.defaultdict(list)
    for s in spans:
        by[s[2]].append(s)
    passes = res.stats.outer_passes
    assert len(by["alm.outer"]) == len(by["alm.update"]) == passes > 1
    for upd in by["alm.update"]:
        assert any(o[0] <= upd[0] and upd[1] <= o[1] for o in by["alm.outer"])
    # after each pass's PANOC solve, none of whose spans it holds
    for name in ("panoc.init", "panoc.final", "panoc.fan"):
        for s in by[name]:
            assert not any(u[0] <= s[0] and s[1] <= u[1]
                           for u in by["alm.update"]), name


# ---- the road, the check and the metrics ---------------------------------

def test_bezier_road_kind_is_the_programs_lane_change_road():
    c = spec.cell(CELL)
    got = fleet.road(c.traffic)
    want = lane_change_road().numpy()
    assert got.shape == want.shape == (100, 2) and got.dtype == np.float32
    # the program sums the Bernstein terms in float32, the road kind in
    # float64 before one rounding: a few float32 ulps of the road's extent
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=4 * np.finfo(np.float32).eps * scale)


@pytest.fixture(scope="module")
def program_run():
    c = _cell()
    prog = c.program().build(c.cfg, c.traffic, "cpu")
    c.program().set_precision(c.cfg)
    win = window.run(prog, c, SEED, 0.0, "cpu", episodes=1)
    return c, win


def test_the_programs_closed_loop_is_correct(program_run):
    c, win = program_run
    judged = check.judge(c, win.steps, SEED, "cpu")
    correct, numbers = check.verdict(judged["numbers"], c.limits)
    assert correct, numbers
    assert judged["detail"]["judged"] >= 4
    assert judged["detail"]["active_share"] > 0.0
    for s in win.steps:
        assert s.result.stats.outer_passes == \
            int(s.result.outer_iterations.max())


def test_the_alm_metrics_read_the_programs_counters(program_run):
    c, win = program_run
    steps = win.steps
    r = SimpleNamespace(steps=steps, batch=[4, 4], traffic=c.traffic,
                        cfg=c.cfg)
    passes = [s.result.stats.outer_passes for s in steps]
    got = spec.metric_reader("alm_passes_per_step").read(r)
    assert got == np.mean(passes)
    occ = spec.metric_reader("alm_lane_occupancy").read(r)
    outer = sum(int(s.result.outer_iterations.sum()) for s in steps)
    assert occ == pytest.approx(100.0 * outer / (4 * sum(passes)))
    assert 0.0 < occ <= 100.0
    # K3's share: the slice's evaluations at the frozen count over the
    # fan's device time
    r.trace = SimpleNamespace(fan_s=1e-3)
    s0 = steps[0]
    evals = 2 * int(s0.result.outer_iterations.sum()) \
        + 5 * int(s0.iters.sum())
    ops = evals * al_roofline.eval_ops(c.cfg, 100)
    nbytes = evals * al_roofline.eval_bytes(c.cfg)
    assert spec.metric_reader("al_fan_roofline").read(r) == pytest.approx(
        100.0 * roofline.bound_s(ops, nbytes) / 1e-3)
    # a program without the counter: nothing, and no error
    bare = SimpleNamespace(steps=[SimpleNamespace(result=SimpleNamespace(
        stats=SimpleNamespace(trips=4)))], batch=[4])
    assert spec.metric_reader("alm_passes_per_step").read(bare) is None
    assert spec.metric_reader("alm_lane_occupancy").read(bare) is None


#: the number that each fault and the control has to fail, where one alone
#: can see it at this size
CAUGHT_BY = {"unconstrained": "violation_ratio", "lam_zero": "crit_ratio",
             "stale": "crit_ratio", "grad_half": "crit_ratio",
             "control": "plant_gap"}


@pytest.mark.parametrize("fault", ["unconstrained", "lam_zero", "stale",
                                   "grad_half", "control"])
def test_a_broken_step_or_the_control_is_not_correct(fault):
    c = _cell()
    if fault == "control":
        # the control's TF32 reference fans are slow on the CPU: one pass of
        # 10 iterations, whose plan the plant's TF32 step is judged under
        cfg = copy.deepcopy(c.cfg)
        cfg["alm"]["max_iter"], cfg["panoc"]["max_iter"] = 1, 10
        c.traffic["episode_steps"] = 1
        prog = c.program().control(cfg, c.traffic, "cpu")
    else:
        assert fault in c.program().FAULTS
        prog = c.program().broken(c.cfg, c.traffic, "cpu", fault)
    # the window alone, without the set-up's warm-up episode
    win = window.run(prog, c, SEED, 0.0, "cpu", episodes=1)
    judged = check.judge(c, win.steps, SEED, "cpu")
    correct, numbers = check.verdict(judged["numbers"], c.limits)
    assert not correct, numbers
    over = [k for k, v in numbers.items() if not v["value"] <= v["limit"]]
    assert CAUGHT_BY[fault] in over, numbers


def test_the_program_refuses_a_result_without_the_inner_fields(monkeypatch):
    c = _cell()
    program = c.program()
    bare = collections.namedtuple("AlmResult", ["u", "lam", "psi"])
    monkeypatch.setattr(program, "AlmResult", bare)
    with pytest.raises(RuntimeError, match="inner_gamma"):
        program.build(c.cfg, c.traffic, "cpu")


def test_al_roofline_counts_a_hand_worked_stage():
    cfg = {"model": "pacejka", "substeps": 4, "n_horiz": 1,
           "constraints": {"offsets": list(STATE_CONSTRAINT_OFFSETS)}}
    # K1's stage: 2 per stage, 4 substeps of 4 ODE evaluations (53 each)
    # and 6 components' RK4 update (13 each), the cost (45); forward and
    # gradient, and the argmin over 99 road candidates (6 each)
    k1 = 2 * (2 + 4 * (4 * 53 + 13 * 6) + 45) + 6 * 99
    assert roofline.eval_ops(cfg, 100) == k1 == 3008
    # six constraints, 11 operations each, forward and gradient
    assert al_roofline.eval_ops(cfg, 100) == k1 + 2 * 6 * 11
    # bytes: the plan (2) and gradient (2), the state (6) and psi, and the
    # 6 multipliers and 6 penalties, float32
    assert al_roofline.eval_bytes(cfg) == 4 * (2 + 6 + 1 + 2 + 12)
    # a lane's outer iteration is one PANOC solve: 2 evaluations, then 5 an
    # inner iteration
    assert roofline.evaluations(lane_iterations=10, lane_solves=3) == 56
