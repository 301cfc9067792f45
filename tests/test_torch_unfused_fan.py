"""The port's unfused PANOC candidate fan and the ALM general path's
one-rollout objective (mpc_tpu_torch/solver/{panoc,problem,alm}.py).

- ``candidate_fan``: the K candidates of B lanes in one call over B*K
  lanes, the per-lane parameters repeated K times (``fold_lanes``), the
  port of ``jax.vmap(psi_vg)`` (mpc_tpu/solver/panoc.py:178-179). It must
  equal the per-candidate loop it replaced: the ops are elementwise per
  lane, so folding the candidates into the lane axis changes no rounding
  of the arithmetic. On the CPU, though, PyTorch's vectorised
  transcendental functions round an element by its position in
  the tensor (vector body or scalar tail), so the fold may move psi by a
  few ulp (within 2e-6 relative) and the gradient within 1e-5 of the
  lane's largest entry. Held on the plain vehicle OCP with each option that
  chooses it (``errors_fn``, ``window``, the obstacle field), with roads
  and obstacle sets shared and one per lane, where the number of lanes
  equals the road's points (a shape alone cannot tell a shared (S, 2)
  road from per-lane (B, 2) rows), and on the general path's
  ``(param, lam, sigma)``.
- ``cost_constraints``: cost and constraints from one rollout. The values
  equal the two rollouts' bit for bit; the AL objective's gradient sums the
  cost's and the constraints' adjoints at each state instead of at the
  inputs, which reorders float32 additions: within 1e-5 of the lane's
  largest entry.
"""

import numpy as np
import pytest
import torch

from mpc_tpu_torch.control.mpc import build_vehicle_ocp
from mpc_tpu_torch.models.params import VehicleParams
from mpc_tpu_torch.ops.road import compute_errors_ocp, straight_centerline
from mpc_tpu_torch.solver.multiple_shooting import build_ms_ocp_problem
from mpc_tpu_torch.solver.panoc import candidate_fan
from mpc_tpu_torch.solver.problem import (Box, fold_lanes, project,
                                          value_and_grad)

torch.set_num_threads(1)

N_HORIZ, S, K = 4, 20, 5


def _cands(seed, B):
    rng = np.random.default_rng(seed)
    u = np.empty((B, K, 2 * N_HORIZ), np.float32)
    u[..., 0::2] = rng.uniform(-0.2, 1.0, (B, K, N_HORIZ))
    u[..., 1::2] = rng.uniform(-0.4, 0.4, (B, K, N_HORIZ))
    return torch.as_tensor(u)


def _param(seed, B, per_lane_road, obstacles=None):
    rng = np.random.default_rng(seed + 1)
    y0 = np.zeros((B, 6), np.float32)
    y0[:, 0] = rng.uniform(0.0, 0.6, B)
    y0[:, 1] = rng.uniform(-0.1, 0.1, B)
    y0[:, 3] = rng.uniform(0.3, 1.0, B)
    cl = straight_centerline(S)
    if per_lane_road:
        # each lane's road turned by its own angle about the origin
        a = torch.as_tensor(rng.uniform(-0.3, 0.3, B).astype(np.float32))
        rot = torch.stack([torch.stack([a.cos(), -a.sin()], 1),
                           torch.stack([a.sin(), a.cos()], 1)], 1)
        cl = torch.einsum("bij,sj->bsi", rot, cl)
    param = {"y0": torch.as_tensor(y0), "p": VehicleParams(),
             "centerline": cl}
    if obstacles == "shared":
        param["obstacles"] = torch.tensor([[0.5, 0.03, 0.0, 0.0],
                                           [1.2, -0.05, 0.0, 0.2]])
    elif obstacles == "per_lane":
        o = rng.uniform(0.2, 1.5, (B, 3, 4)).astype(np.float32)
        o[..., 1] -= 0.85
        param["obstacles"] = torch.as_tensor(o)
    return param


def _loop(psi_vg, cands, args):
    outs = [psi_vg(cands[:, k], args) for k in range(cands.shape[1])]
    return (torch.stack([o[0] for o in outs], 1),
            torch.stack([o[1] for o in outs], 1))


def _assert_fan_close(psi, grad, psi_l, grad_l):
    torch.testing.assert_close(psi, psi_l, rtol=2e-6, atol=0)
    scale = grad_l.abs().amax(dim=2, keepdim=True)
    assert bool(((grad - grad_l).abs() <= 1e-5 * scale).all()), \
        float(((grad - grad_l).abs() / scale).max())


OPTIONS = {
    "errors_fn": dict(errors_fn=compute_errors_ocp),
    "window": dict(window=8),
    "obstacles": dict(obstacle_weight=1.0,
                      obstacle_field_kwargs=dict(a_f=1.0, sigma_x=0.2)),
}


@pytest.mark.parametrize("option,per_lane_road,obstacles", [
    ("errors_fn", False, None), ("errors_fn", True, None),
    ("window", True, None), ("obstacles", False, "shared"),
    ("obstacles", True, "per_lane")])
def test_fold_equals_the_per_candidate_loop(option, per_lane_road,
                                            obstacles):
    B = S                     # as many lanes as road points
    prob = build_vehicle_ocp(N_HORIZ, device="cpu", **OPTIONS[option])
    assert prob.cost_multi is None and prob.al_multi is None
    assert prob.uses_obstacles == (option == "obstacles")
    param = _param(0, B, per_lane_road, obstacles)
    if prob.param_prep is not None:
        param = prob.param_prep(param)

    def psi_vg(u, p):
        return value_and_grad(prob.cost, u, p)

    cands = _cands(0, B)
    psi, grad = candidate_fan(psi_vg, cands, param)
    psi_l, grad_l = _loop(psi_vg, cands, param)
    assert psi.shape == (B, K) and grad.shape == (B, K, 2 * N_HORIZ)
    _assert_fan_close(psi, grad, psi_l, grad_l)
    assert bool(torch.isfinite(grad).all())


def _al_psi(fg, D):
    def psi_vg(u, args):
        param, lam, sigma = args

        def psi(u_, param):
            f, g = fg(u_, param)
            zeta = g + lam / sigma
            r = zeta - project(zeta, D)
            return f + 0.5 * (sigma * r ** 2).sum(dim=1)

        return value_and_grad(psi, u, param)
    return psi_vg


def _al_args(seed, B, m, param):
    rng = np.random.default_rng(seed + 2)
    lam = torch.as_tensor(rng.uniform(0, 2, (B, m)).astype(np.float32))
    sigma = torch.as_tensor((10.0 ** rng.uniform(1, 4, (B, m))).astype(
        np.float32))
    return param, lam, sigma


def test_fold_of_the_general_path_arguments_equals_the_loop():
    B = 6
    prob = build_vehicle_ocp(N_HORIZ, bound_state_constraints=True,
                             window=8, device="cpu")
    param = prob.param_prep(_param(1, B, True))
    args = _al_args(1, B, prob.m, param)
    psi_vg = _al_psi(prob.cost_constraints, prob.D)
    cands = _cands(1, B)
    psi, grad = candidate_fan(psi_vg, cands, args)
    psi_l, grad_l = _loop(psi_vg, cands, args)
    _assert_fan_close(psi, grad, psi_l, grad_l)


def test_fold_lanes_repeats_only_the_per_lane_entries():
    B, k = 3, 2
    param = {"y0": torch.arange(B * 6.).reshape(B, 6),
             "centerline": torch.zeros((B, 2)),           # shared, S == B
             "obstacles": torch.arange(B * 4.).reshape(B, 1, 4).expand(
                 B, 1, 4),                                  # per lane
             "window_center": torch.arange(B), "p": VehicleParams(),
             "constr": torch.ones(3)}
    lam = torch.arange(B * 2.).reshape(B, 2)
    out, lam_f = fold_lanes((param, lam), k)
    assert out["centerline"] is param["centerline"]
    assert out["constr"] is param["constr"] and out["p"] is param["p"]
    torch.testing.assert_close(out["y0"][1::2], param["y0"])
    torch.testing.assert_close(out["obstacles"][::2], param["obstacles"])
    assert out["window_center"].tolist() == [0, 0, 1, 1, 2, 2]
    assert lam_f.shape == (B * k, 2)
    per_lane = fold_lanes({"centerline": torch.zeros((B, 5, 2))}, k)
    assert per_lane["centerline"].shape == (B * k, 5, 2)


def _assert_one_rollout_matches_two(prob, param, args_seed, u):
    f1, g1 = prob.cost_constraints(u, param)
    torch.testing.assert_close(f1, prob.cost(u, param), rtol=0, atol=0)
    torch.testing.assert_close(g1, prob.constraints(u, param), rtol=0,
                               atol=0)
    args = _al_args(args_seed, u.shape[0], prob.m, param)
    psi1, grad1 = _al_psi(prob.cost_constraints, prob.D)(u, args)
    psi2, grad2 = _al_psi(lambda v, p: (prob.cost(v, p),
                                        prob.constraints(v, p)),
                          prob.D)(u, args)
    torch.testing.assert_close(psi1, psi2, rtol=0, atol=0)
    scale = grad2.abs().amax(dim=1, keepdim=True)
    assert bool(((grad1 - grad2).abs() <= 1e-5 * scale).all())


def test_one_rollout_al_objective_matches_two_rollouts():
    B = 8
    prob = build_vehicle_ocp(N_HORIZ, bound_state_constraints=True,
                             obstacle_weight=1.0, device="cpu")
    param = _param(2, B, False, "shared")
    _assert_one_rollout_matches_two(prob, param, 2,
                                    _cands(2, B)[:, 0].contiguous())


def test_one_rollout_multiple_shooting_objective_matches_two_rollouts():
    from mpc_tpu_torch.models.bicycle import pacejka_dynamics
    from mpc_tpu_torch.models.integrators import discretize
    from mpc_tpu_torch.ops.costs import vehicle_stage_cost
    B, N, M = 5, 8, 4
    lim = torch.tensor([1.0, 0.32]).repeat(N)
    offs = torch.tensor([20.0, 1.0, 1.0, 2.0, 1.0, 0.1])
    prob, lo = build_ms_ocp_problem(
        discretize(pacejka_dynamics),
        lambda x, u, p: vehicle_stage_cost(x, u, p["centerline"], 1.0),
        N, M, 6, 2, Box(-lim, lim),
        stage_constraints=lambda x, u, p: x ** 2 - offs,
        n_stage_constraints=6,
        D_stage=Box(torch.full((6 * N,), -float("inf")),
                    torch.zeros(6 * N)))
    param = _param(3, B, True)
    rng = np.random.default_rng(3)
    z = torch.as_tensor(np.concatenate(
        [rng.uniform(-0.3, 0.9, (B, lo.n_inputs)),
         rng.uniform(-0.2, 0.8, (B, lo.n_states))], 1).astype(np.float32))
    _assert_one_rollout_matches_two(prob, param, 3, z)


def test_graph_key_separates_shapes_and_shared_parameters():
    # on the card the fan is replayed from a CUDA graph keyed by its
    # inputs' structure: the tensors become static buffers, every other
    # leaf (the vehicle parameters) is part of the key
    from mpc_tpu_torch.solver.panoc import _flatten, _unflatten
    param = _param(4, 3, True, "per_lane")
    lam = torch.zeros((3, 2))
    leaves, spec = _flatten((param, lam, lam + 1))
    assert len(leaves) == 5 and hash(spec) is not None
    back = _unflatten(spec, iter(leaves))
    assert back[0]["p"] is param["p"] and back[1] is lam
    assert all(back[0][k] is param[k] for k in ("y0", "centerline",
                                                 "obstacles"))
    other = dict(param, p=VehicleParams(mass=0.2))
    assert _flatten((other, lam, lam + 1))[1] != spec
