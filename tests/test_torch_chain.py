"""Parity of the port's hanging chain (mpc_tpu_torch/models/chain.py,
control/chain_mpc.py, ``ops.costs.chain_stage_cost``) with the JAX
package's: the spring dynamics (also against an independent float64
transcription of the reference's formulas, tests/test_chain.py:20-36), the
stage cost, the floor constraints with their one-sided box D = [lb, +inf),
and a short closed loop of the chain controller (N=4, the depth of
tests/test_ocp_parity.py:208), the port stepped from JAX's state and carry.

Tolerance: values within 1e-5 relative (1e-5 absolute for the dynamics,
whose forces cancel); in the loop, converged flags and outer counts equal,
first inputs within 2e-3 and the JAX cost of the port's inputs within 1e-3
relative of JAX's own (ROADMAP, "How to judge a fault").
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.config import PanocConfig
from mpc_tpu.control import chain_mpc as jchain_mpc
from mpc_tpu.models import chain as jchain
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import ChainParams
from mpc_tpu.ops.costs import chain_stage_cost
from mpc_tpu_torch import config as tconfig
from mpc_tpu_torch.control import chain_mpc as tchain_mpc
from mpc_tpu_torch.convert import carry_from_numpy, chain_params_from_numpy
from mpc_tpu_torch.models import chain as tchain
from mpc_tpu_torch.models import integrators as tintegrators
from mpc_tpu_torch.ops import costs as tcosts

torch.set_num_threads(1)

SPEC_J, SPEC_T = jchain.ChainSpec(6, 2), tchain.ChainSpec(6, 2)
PARAMS = ChainParams()
TPARAMS = chain_params_from_numpy(
    {f: np.asarray(getattr(PARAMS, f)) for f in ("m", "D", "L")})


def _states(seed, B):
    """The initial chain, disturbed per lane."""
    rng = np.random.default_rng(seed)
    y = np.tile(np.asarray(SPEC_J.initial_state()), (B, 1))
    y[:, :12] += rng.uniform(-0.05, 0.05, (B, 12)).astype(np.float32)
    y[:, 12:24] = rng.uniform(-0.5, 0.5, (B, 12))
    return y.astype(np.float32)


def _numpy_dynamics(y, u, p):
    """The reference's spring ODE in float64, ball by ball."""
    n, d = 6, 2
    g = np.array([0.0, -9.81])
    y1 = y[: n * d].reshape(n, d)
    y2 = y[n * d: 2 * n * d]
    y3 = y[2 * n * d:]
    f2 = []
    for i in range(n):
        xi = y1[i]
        xip1 = y1[i + 1] if i < n - 1 else y3
        xim1 = y1[i - 1] if i > 0 else np.zeros(d)
        up = p.D * (1 - p.L / np.linalg.norm(xip1 - xi)) * (xip1 - xi)
        dn = p.D * (1 - p.L / np.linalg.norm(xi - xim1)) * (xi - xim1)
        f2.append((up - dn) / p.m + g)
    return np.concatenate([y2, np.concatenate(f2), u])


def test_params_and_spec_match_jax():
    assert (TPARAMS.m, TPARAMS.D, TPARAMS.L) == pytest.approx(
        (PARAMS.m, PARAMS.D, PARAMS.L))
    np.testing.assert_array_equal(TPARAMS.to_vector().numpy(),
                                  np.asarray(PARAMS.to_vector()))
    assert SPEC_T.state_dim == SPEC_J.state_dim == 26
    np.testing.assert_array_equal(SPEC_T.initial_state(2).numpy(),
                                  np.tile(np.asarray(SPEC_J.initial_state()),
                                          (2, 1)))
    np.testing.assert_array_equal(SPEC_T.x_end().numpy(),
                                  np.asarray(SPEC_J.x_end()))
    for got, want in zip(tchain.chain_state_to_pos(SPEC_T,
                                                   SPEC_T.initial_state(1)),
                         jchain.chain_state_to_pos(SPEC_J,
                                                   SPEC_J.initial_state())):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def test_dynamics_match_jax_and_the_reference_formulas():
    B = 5
    y = _states(0, B)
    u = np.random.default_rng(1).uniform(-1, 1, (B, 2)).astype(np.float32)
    got = tchain.chain_dynamics(SPEC_T)(torch.as_tensor(y),
                                        torch.as_tensor(u), TPARAMS).numpy()
    want = jax.vmap(lambda a, b: jchain.chain_dynamics(SPEC_J)(
        a, b, PARAMS))(jnp.asarray(y), jnp.asarray(u))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    for b in range(B):
        np.testing.assert_allclose(
            got[b], _numpy_dynamics(y[b].astype(np.float64), u[b], PARAMS),
            rtol=1e-4, atol=1e-4)


def test_discrete_rollout_matches_jax():
    f_t = tintegrators.discretize(tchain.chain_dynamics(SPEC_T))
    f_j = discretize(jchain.chain_dynamics(SPEC_J))
    y = torch.as_tensor(_states(2, 3))
    yj = jnp.asarray(y.numpy())
    for _ in range(3):
        y = f_t(y, torch.tensor([[-0.5, 0.5]] * 3), TPARAMS)
        yj = jax.vmap(lambda a: f_j(a, jnp.array([-0.5, 0.5]), PARAMS))(yj)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)


def test_floor_and_stage_cost_match_jax():
    coeff, lb = tchain_mpc.floor_coefficients()
    jcoeff, jlb = jchain_mpc.floor_coefficients()
    np.testing.assert_array_equal(coeff.numpy(), np.asarray(jcoeff))
    assert lb == jlb
    xs = torch.linspace(-0.3, 1.3, 17)
    np.testing.assert_allclose(
        tchain_mpc.g_constr(coeff, xs).numpy(),
        np.asarray(jchain_mpc.g_constr(jcoeff, jnp.asarray(xs.numpy()))),
        rtol=1e-5, atol=1e-6)
    y = _states(3, 4)
    u = np.random.default_rng(3).uniform(-1, 1, (4, 2)).astype(np.float32)
    got = tcosts.chain_stage_cost(torch.as_tensor(y), torch.as_tensor(u), 6,
                                  2, SPEC_T.x_end())
    want = jax.vmap(lambda a, b: chain_stage_cost(a, b, 6, 2,
                                                  SPEC_J.x_end()))(
        jnp.asarray(y), jnp.asarray(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_ocp_constraints_and_one_sided_box_match_jax():
    N, B = 4, 3
    tp = tchain_mpc.build_chain_ocp(SPEC_T, N, device="cpu")
    jp = jchain_mpc.build_chain_ocp(SPEC_J, N)
    assert (tp.n, tp.m) == (jp.n, jp.m) == (8, 28)
    for got, want in ((tp.C, jp.C), (tp.D, jp.D)):
        np.testing.assert_array_equal(got.lower.numpy(),
                                      np.asarray(want.lower))
        np.testing.assert_array_equal(got.upper.numpy(),
                                      np.asarray(want.upper))
    assert bool(torch.isinf(tp.D.upper).all()) \
        and bool(torch.isfinite(tp.D.lower).all())
    coeff, _ = tchain_mpc.floor_coefficients()
    y0 = _states(4, B)
    u = np.random.default_rng(4).uniform(-1, 1, (B, 2 * N)).astype(
        np.float32)
    param = {"y0": torch.as_tensor(y0), "p": TPARAMS, "constr": coeff}
    jparam = lambda y: {"y0": y, "p": PARAMS,       # noqa: E731
                        "constr": jchain_mpc.floor_coefficients()[0]}
    f, g = tp.cost_constraints(torch.as_tensor(u), param)
    jf = jax.vmap(lambda a, y: jp.cost(a, jparam(y)))(jnp.asarray(u),
                                                      jnp.asarray(y0))
    jg = jax.vmap(lambda a, y: jp.constraints(a, jparam(y)))(
        jnp.asarray(u), jnp.asarray(y0))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)


@functools.lru_cache(maxsize=None)
def _controllers(N):
    jctrl = jchain_mpc.build_chain_controller(
        SPEC_J, N, panoc_cfg=PanocConfig(lbfgs_memory=N, max_iter=250))
    f_d = discretize(jchain.chain_dynamics(SPEC_J))
    static = {"p": PARAMS, "constr": jchain_mpc.floor_coefficients()[0]}

    @jax.jit
    def jstep(ys, carries):
        def one(y, carry):
            out = jctrl.step(carry, dict(static, y0=y))
            return f_d(y, out.u0, PARAMS), out.carry, out.u0, out.result
        return jax.vmap(one)(ys, carries)

    tctrl = tchain_mpc.build_chain_controller(
        SPEC_T, N, panoc_cfg=tconfig.PanocConfig(lbfgs_memory=N,
                                                 max_iter=250),
        device="cpu")
    return jctrl, jstep, tctrl


def test_closed_loop_matches_jax():
    N = 4
    jctrl, jstep, tctrl = _controllers(N)
    static = {"p": PARAMS, "constr": jchain_mpc.floor_coefficients()[0]}
    jcost = jax.jit(jax.vmap(lambda U, y: jctrl.problem.cost(
        U, dict(static, y0=y))))
    coeff, _ = tchain_mpc.floor_coefficients()
    # the reference's disturbance: 3 steps at u = [-0.5, 0.5]
    f_d = discretize(jchain.chain_dynamics(SPEC_J))
    y = SPEC_J.initial_state()
    for _ in range(3):
        y = f_d(y, jnp.array([-0.5, 0.5]), PARAMS)
    ys = jnp.stack([y, jnp.asarray(_states(5, 1)[0])])
    carries = jax.vmap(lambda _: jctrl.init_carry())(jnp.arange(2))
    for k in range(3):
        t_carry = carry_from_numpy(
            {f: np.asarray(v) for f, v in carries._asdict().items()})
        with torch.no_grad():
            out = tctrl.step(t_carry, {"y0": torch.as_tensor(np.array(ys)),
                                       "p": TPARAMS, "constr": coeff})
        y_prev = ys
        ys, carries, u0, res = jstep(ys, carries)
        r, msg = out.result, f"step {k}"
        np.testing.assert_array_equal(r.converged.numpy(),
                                      np.asarray(res.converged), err_msg=msg)
        np.testing.assert_array_equal(r.outer_iterations.numpy(),
                                      np.asarray(res.outer_iterations),
                                      err_msg=msg)
        np.testing.assert_allclose(out.u0.numpy(), np.asarray(u0), rtol=0,
                                   atol=2e-3, err_msg=msg)
        np.testing.assert_allclose(
            np.asarray(jcost(jnp.asarray(out.carry.U.numpy()), y_prev)),
            np.asarray(jcost(carries.U, y_prev)), rtol=1e-3, err_msg=msg)
    assert bool(res.converged.all())


@pytest.mark.parametrize("path", ["chain", "ms", "window"])
def test_new_entry_points_default_to_the_card(path):
    from mpc_tpu_torch.control import mpc as tmpc
    build = {"chain": lambda: tchain_mpc.build_chain_controller(SPEC_T, 4),
             "ms": lambda: tmpc.build_vehicle_ms_controller(8, 4)[0],
             "window": lambda: tmpc.build_vehicle_controller(6, window=8)}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build[path]()
    else:
        assert build[path]().device.type == "cuda"
