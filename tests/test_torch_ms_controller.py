"""Parity of the port's multiple-shooting MPC controller
(``build_vehicle_ms_controller``, mpc_tpu_torch/control/mpc.py) with the JAX
package's at N=8, M=4 on a straight road: its carry (the ``n_extra`` tail of
segment start states), its per-lane cold start (``warm_prep``: a lane whose
carried penalties are all <= 0 rolls its inputs out to seed the start
states), its per-constraint initial penalties, and three closed-loop steps
from one cold carry, the port stepped from JAX's state and carry each step.

Each step holds: converged flags and outer iteration counts equal; the
first inputs within 2e-3; the JAX cost of the port's returned decision
vector within 1e-3 relative of JAX's own, its defects within delta
(ROADMAP, "How to judge a fault": the solves stop at a float32 criterion,
so their inner iteration counts move with rounding).

The lanes are on the line. A lane off it (y0 = [0, 0.05, 0, 0.5, 0, 0] or
[0, -0.02, 0.05, 0.8, 0, 0]) makes the f32 augmented Lagrangian stiff:
its inner solves end on the plateau exit in most outer iterations in both
packages, the two frameworks' inner iterates, equal to 4-6 digits for
about 28 iterations from the same start, drift apart by rounding, and
whether the lane converges within ALM max_iter = 10 is decided by that
drift (JAX converges the second in 6 outer iterations, the port runs out at
10 with a violation of 1.19e-4 against delta = 1e-4).

Run as a script, it runs both packages' controllers of the cell ms_n40_m8
(N=40, M=8, its configs) on two sets of 16 of the cell's lanes for two
steps each from a cold carry and prints the converged fractions and the
lanes whose state is no longer finite; then the first set's cold step
again from initial states moved by one ulp (two draws), which shows how
far rounding alone moves each package's converged lanes:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_ms_controller.py
"""

import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.control import mpc as jmpc
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.road import straight_centerline
from mpc_tpu_torch import config as tconfig
from mpc_tpu_torch.control import mpc as tmpc
from mpc_tpu_torch.convert import carry_from_numpy
from mpc_tpu_torch.models.params import VehicleParams as TVehicleParams

torch.set_num_threads(1)

N, M = 8, 4
PARAMS = VehicleParams()
CL = np.array(straight_centerline(100))
ALM = dict(eps=1e-4, delta=1e-4, max_iter=10, eps_0=1e-2, sigma_0=1e3,
           penalty_factor=5.0)
PANOC = dict(lbfgs_memory=16, max_iter=250)
# lanes whose inner solves all converge (JAX: no inner failure in three
# steps); see the module's docstring for lanes off the line
Y0 = np.array([[0.0, 0.0, 0.0, 0.5, 0.0, 0.0],
               [0.0, 0.0, 0.0, 1.0, 0.0, 0.0]], np.float32)


@functools.lru_cache(maxsize=None)
def _controllers():
    jctrl, jlo = jmpc.build_vehicle_ms_controller(
        n_horiz=N, n_segments=M, alm_cfg=AlmConfig(**ALM),
        panoc_cfg=PanocConfig(**PANOC))
    f_d = discretize(pacejka_dynamics)
    static = {"p": PARAMS, "centerline": jnp.asarray(CL)}

    @jax.jit
    def jstep(ys, carries):
        def one(y, carry):
            out = jctrl.step(carry, dict(static, y0=y))
            return f_d(y, out.u0, PARAMS), out.carry, out.u0, out.result
        return jax.vmap(one)(ys, carries)

    tctrl, tlo = tmpc.build_vehicle_ms_controller(
        n_horiz=N, n_segments=M, alm_cfg=tconfig.AlmConfig(**ALM),
        panoc_cfg=tconfig.PanocConfig(**PANOC), device="cpu")
    return jctrl, jlo, jstep, tctrl, tlo


def _tparam(ys):
    return {"y0": torch.as_tensor(np.array(ys)), "p": TVehicleParams(),
            "centerline": torch.as_tensor(CL)}


def test_carry_layout_matches_jax():
    jctrl, jlo, _, tctrl, tlo = _controllers()
    assert tuple(tlo) == tuple(jlo) and tctrl.n_extra == tlo.n_states
    carry = tctrl.init_carry(3)
    jcarry = jctrl.init_carry()
    assert carry.U.shape == (3, tctrl.problem.n) == (3,) + jcarry.U.shape
    np.testing.assert_array_equal(carry.U[0].numpy(), np.asarray(jcarry.U))
    assert carry.lam.shape == (3, tctrl.problem.m)
    assert float(carry.sigma.abs().max()) == 0.0


def test_warm_prep_seeds_only_the_cold_lanes():
    _, _, _, tctrl, tlo = _controllers()
    z = torch.as_tensor(np.random.default_rng(0).uniform(
        0.0, 0.5, (2, tlo.n)).astype(np.float32))
    cold = torch.tensor([True, False])
    out = tctrl.warm_prep(z, _tparam(Y0), cold)
    # the inputs stay, the cold lane's start states become its rollout's
    torch.testing.assert_close(out[:, : tlo.n_inputs], z[:, : tlo.n_inputs])
    torch.testing.assert_close(out[1], z[1])
    g = tctrl.problem.constraints(out, _tparam(Y0))
    assert float(g[0, -tlo.n_states:].abs().max()) <= 1e-6
    assert float(g[1, -tlo.n_states:].abs().max()) > 1e-2


def test_per_constraint_initial_penalties():
    # no stage inequalities here: every constraint is a defect, whose
    # initial penalty is sigma_0_defect = 10, not alm_cfg.sigma_0
    _, _, _, tctrl, tlo = _controllers()
    carry = tctrl.init_carry(2)
    res = tctrl.solve(_tparam(Y0), carry.U, carry.lam, sigma0=carry.sigma)
    assert tctrl.problem.m == tlo.n_states
    assert float(res.sigma.min()) >= 10.0
    assert float(res.sigma.min()) < ALM["sigma_0"]


def test_closed_loop_matches_jax():
    jctrl, _, jstep, tctrl, tlo = _controllers()
    jcost = jax.jit(jax.vmap(lambda z, y: jctrl.problem.cost(z, {
        "y0": y, "p": PARAMS, "centerline": jnp.asarray(CL)})))
    ys = jnp.asarray(Y0)
    carries = jax.vmap(lambda _: jctrl.init_carry())(jnp.arange(len(Y0)))
    for k in range(3):
        t_carry = carry_from_numpy(
            {f: np.asarray(v) for f, v in carries._asdict().items()})
        with torch.no_grad():
            out = tctrl.step(t_carry, _tparam(ys))
        y_prev = ys
        ys, carries, u0, res = jstep(ys, carries)
        r = out.result
        msg = f"step {k}"
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
        assert float(r.constraint_violation.max()) <= ALM["delta"], msg


def main():
    from mpc_tpu_torch.bench import MS_N40_M8 as cell
    from mpc_tpu_torch.bench import lane_change_road, ss_n40_states
    from mpc_tpu_torch.models import bicycle as tbicycle
    from mpc_tpu_torch.models import integrators as tintegrators
    cl = lane_change_road()
    jcl = jnp.asarray(cl.numpy())
    a = cell.alm_cfg
    alm = dict(eps=a.eps, delta=a.delta, max_iter=a.max_iter, eps_0=a.eps_0,
               sigma_0=a.sigma_0, penalty_factor=a.penalty_factor)
    panoc = dict(lbfgs_memory=cell.solver_cfg.lbfgs_memory,
                 max_iter=cell.solver_cfg.max_iter)
    jctrl, _ = jmpc.build_vehicle_ms_controller(
        n_horiz=cell.n_horiz, n_segments=cell.n_segments,
        bound_state_constraints=True, alm_cfg=AlmConfig(**alm),
        panoc_cfg=PanocConfig(**panoc))
    tctrl, _ = tmpc.build_vehicle_ms_controller(
        n_horiz=cell.n_horiz, n_segments=cell.n_segments,
        bound_state_constraints=True, alm_cfg=tconfig.AlmConfig(**alm),
        panoc_cfg=tconfig.PanocConfig(**panoc), device="cpu")
    f_d = discretize(pacejka_dynamics)
    tf_d = tintegrators.discretize(tbicycle.pacejka_dynamics)

    @jax.jit
    def jstep(ys, carries):
        def one(y, carry):
            out = jctrl.step(carry, {"y0": y, "p": PARAMS, "centerline": jcl})
            return f_d(y, out.u0, PARAMS), out.carry, out.result.converged
        return jax.vmap(one)(ys, carries)

    for start, nudge in ((0, 0), (48, 0), (0, 1), (0, 2)):
        y0 = ss_n40_states(cell.batch)[start:start + 16]
        if nudge:
            rng = np.random.default_rng(nudge)
            d = rng.integers(-1, 2, size=y0.shape)
            to = np.where(d > 0, np.inf, -np.inf).astype(np.float32)
            y0 = np.where(d == 0, y0, np.nextafter(y0, to)).astype(
                np.float32)
        ys = jnp.asarray(y0)
        carries = jax.vmap(lambda _: jctrl.init_carry())(jnp.arange(16))
        ty, tc = torch.as_tensor(y0), tctrl.init_carry(16)
        for k in range(1 if nudge else 2):
            ys, carries, jconv = jstep(ys, carries)
            with torch.no_grad():
                out = tctrl.step(tc, {"y0": ty, "p": TVehicleParams(),
                                      "centerline": cl})
            ty, tc = tf_d(ty, out.u0, TVehicleParams()), out.carry
            print(json.dumps({
                "lanes": f"{start}-{start + 15}", "step": k,
                "one_ulp_draw": nudge,
                "jax_converged": float(np.asarray(jconv).mean()),
                "port_converged": float(out.result.converged.float().mean()),
                "jax_converged_lanes": np.flatnonzero(
                    np.asarray(jconv)).tolist(),
                "port_converged_lanes": torch.nonzero(
                    out.result.converged).flatten().tolist(),
                "jax_nonfinite": np.flatnonzero(~np.isfinite(
                    np.asarray(ys)).all(axis=1)).tolist(),
                "port_nonfinite": torch.nonzero(~torch.isfinite(ty).all(
                    dim=1)).flatten().tolist()}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
