"""Parity of the port's multiple-shooting OCP (mpc_tpu_torch/solver/
multiple_shooting.py) with the JAX package's: the layout and its packing,
the boxes C and D (the defect equalities D = [0, 0] after the stage
inequalities, -inf/+inf entries included), the cost, constraints and their
gradients on drawn decision vectors, and ``ms_warm_start``.

Tolerance: layouts, boxes and packing exact; values within 1e-5 relative
(1e-6 absolute), gradients within 1e-4 of the lane's largest entry (float32
rounding of two frameworks' transcendental functions and sums); the
defects of a warm start 0 to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.costs import vehicle_stage_cost
from mpc_tpu.ops.road import straight_centerline
from mpc_tpu.solver import multiple_shooting as jms
from mpc_tpu.solver.problem import Box
from mpc_tpu_torch.models import bicycle as tbicycle
from mpc_tpu_torch.models import integrators as tintegrators
from mpc_tpu_torch.models.params import VehicleParams as TVehicleParams
from mpc_tpu_torch.ops import costs as tcosts
from mpc_tpu_torch.solver import multiple_shooting as tms
from mpc_tpu_torch.solver import problem as tproblem

torch.set_num_threads(1)

PARAMS = VehicleParams()
OFFS = (20.0, 1.0, 1.0, 2.0, 1.0, 0.1)
CL = np.array(straight_centerline(100))
N, M = 8, 4


def _problems(constrained, state_bound=None):
    lim = np.tile(np.array([1.0, 0.32], np.float32), N)
    kw_j, kw_t = {}, {}
    if constrained:
        offs_j, offs_t = jnp.asarray(OFFS), torch.tensor(OFFS)
        m = 6 * N
        kw_j = dict(stage_constraints=lambda x, u, p: x ** 2 - offs_j,
                    n_stage_constraints=6,
                    D_stage=Box(jnp.full((m,), -jnp.inf), jnp.zeros(m)))
        kw_t = dict(stage_constraints=lambda x, u, p: x ** 2 - offs_t,
                    n_stage_constraints=6,
                    D_stage=tproblem.Box(torch.full((m,), -float("inf")),
                                         torch.zeros(m)))
    jp, jlo = jms.build_ms_ocp_problem(
        discretize(pacejka_dynamics),
        lambda x, u, p: vehicle_stage_cost(x, u, p["centerline"], 1.0),
        N, M, 6, 2, Box(jnp.asarray(-lim), jnp.asarray(lim)),
        state_bound=state_bound, **kw_j)
    tp, tlo = tms.build_ms_ocp_problem(
        tintegrators.discretize(tbicycle.pacejka_dynamics),
        lambda x, u, p: tcosts.vehicle_stage_cost(x, u, p["centerline"],
                                                  1.0),
        N, M, 6, 2, tproblem.Box(torch.as_tensor(-lim), torch.as_tensor(lim)),
        state_bound=state_bound, **kw_t)
    return jp, jlo, tp, tlo


def _z(seed, B, lo):
    rng = np.random.default_rng(seed)
    us = np.empty((B, N, 2), np.float32)
    us[..., 0] = rng.uniform(-0.2, 1.0, (B, N))
    us[..., 1] = rng.uniform(-0.3, 0.3, (B, N))
    xs = np.zeros((B, M - 1, 6), np.float32)
    xs[..., 0] = rng.uniform(0.0, 1.0, (B, M - 1))
    xs[..., 1] = rng.uniform(-0.1, 0.1, (B, M - 1))
    xs[..., 2] = rng.uniform(-0.2, 0.2, (B, M - 1))
    xs[..., 3] = rng.uniform(0.2, 1.0, (B, M - 1))
    return np.concatenate([us.reshape(B, -1), xs.reshape(B, -1)], 1)


def _y0(seed, B):
    rng = np.random.default_rng(seed + 7)
    y0 = np.zeros((B, 6), np.float32)
    y0[:, 1] = rng.uniform(-0.05, 0.05, B)
    y0[:, 3] = rng.uniform(0.3, 1.0, B)
    return y0


def test_layout_and_packing_match_jax():
    jp, jlo, tp, tlo = _problems(False)
    assert tuple(tlo) == tuple(jlo)
    assert (tlo.n_inputs, tlo.n_states, tlo.n) == \
        (jlo.n_inputs, jlo.n_states, jlo.n)
    assert (tp.n, tp.m) == (jp.n, jp.m)
    z = _z(0, 3, tlo)
    us, xs = tms.unpack_decision(torch.as_tensor(z), tlo)
    jus, jxs = jax.vmap(lambda v: jms.unpack_decision(v, jlo))(
        jnp.asarray(z))
    np.testing.assert_array_equal(us.numpy(), np.asarray(jus))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    np.testing.assert_array_equal(tms.pack_decision(us, xs).numpy(), z)


@pytest.mark.parametrize("constrained,state_bound", [
    (False, None), (True, None), (True, (5.0, 5.0, 4.0, 3.0, 2.0, 6.0))])
def test_boxes_match_jax(constrained, state_bound):
    jp, _, tp, _ = _problems(constrained, state_bound)
    for got, want in ((tp.C, jp.C), (tp.D, jp.D)):
        np.testing.assert_array_equal(got.lower.numpy(),
                                      np.asarray(want.lower))
        np.testing.assert_array_equal(got.upper.numpy(),
                                      np.asarray(want.upper))
    # the defects are equalities: D = [0, 0] after the stage inequalities
    assert float(tp.D.lower[-6 * (M - 1):].abs().max()) == 0.0
    assert float(tp.D.upper[-6 * (M - 1):].abs().max()) == 0.0


def test_bad_shapes_raise():
    with pytest.raises(ValueError, match="divisible"):
        tms.build_ms_ocp_problem(None, None, 10, 4, 6, 2,
                                 tproblem.Box.unbounded(20))
    with pytest.raises(ValueError, match="state_bound"):
        tms.build_ms_ocp_problem(None, None, 8, 4, 6, 2,
                                 tproblem.Box.unbounded(16),
                                 state_bound=(1.0, 2.0))


@pytest.mark.parametrize("constrained", [False, True])
def test_cost_constraints_and_gradients_match_jax(constrained):
    B = 5
    jp, jlo, tp, tlo = _problems(constrained)
    z, y0 = _z(1, B, tlo), _y0(1, B)

    def jparam(y):
        return {"y0": y, "p": PARAMS, "centerline": jnp.asarray(CL)}

    jc, jgc = jax.vmap(lambda v, y: jax.value_and_grad(jp.cost)(
        v, jparam(y)))(jnp.asarray(z), jnp.asarray(y0))
    jg = jax.vmap(lambda v, y: jp.constraints(v, jparam(y)))(
        jnp.asarray(z), jnp.asarray(y0))
    param = {"y0": torch.as_tensor(y0), "p": TVehicleParams(),
             "centerline": torch.as_tensor(CL)}
    c, gc = tproblem.value_and_grad(tp.cost, torch.as_tensor(z), param)
    g = tp.constraints(torch.as_tensor(z), param)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
    jgc = np.asarray(jgc)
    scale = np.abs(jgc).max(axis=1, keepdims=True)
    assert np.all(np.abs(gc.numpy() - jgc) <= 1e-4 * scale)


def test_warm_start_matches_jax_and_has_zero_defects():
    B = 4
    jp, jlo, tp, tlo = _problems(True)
    y0 = _y0(2, B)
    us = _z(2, B, tlo)[:, : tlo.n_inputs]
    f_d = tintegrators.discretize(tbicycle.pacejka_dynamics)
    z = tms.ms_warm_start(f_d, tlo, torch.as_tensor(y0), torch.as_tensor(us),
                          TVehicleParams())
    jz = jax.vmap(lambda y, u: jms.ms_warm_start(
        discretize(pacejka_dynamics), jlo, y, u, PARAMS))(
            jnp.asarray(y0), jnp.asarray(us))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(z[:, : tlo.n_inputs].numpy(), us)
    g = tp.constraints(z, {"y0": torch.as_tensor(y0), "p": TVehicleParams(),
                           "centerline": torch.as_tensor(CL)})
    assert float(g[:, -tlo.n_states:].abs().max()) <= 1e-6
