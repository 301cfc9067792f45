"""Event-triggered MPC over the AL-iLQR family, port against the JAX
package (tests/test_event_triggered.py:104-146 with N=4): the lane-skip
sentinel ``tol > 1e30`` must reach the AL-iLQR outer loop, so an
untriggered lane spends zero solver iterations and keeps its plan, its
multipliers and (as the JAX package's ETC drops them) no penalties.

Step by step, each step fed the JAX carry: triggered flags, k, tot_solves
and the per-step iteration counts of untriggered lanes (zero) equal; an
untriggered lane's plan kept bit for bit. After the first step the plan is
within 5e-4 of the JAX one (the band of tests/test_torch_ilqr.py) and the
inner iterations within 2 per outer iteration (tests/test_torch_mpc_ilqr.py).
The first step is a cold solve from [1, 0] on every stage, and every ETC
solve starts its penalties cold (the JAX package drops them from the
carry): there lane 2 takes 5 outer iterations of up to 25 inner ones, and
rounding decides how many (97 here against 129 for the JAX package, both
converged, plans 7e-2 apart). A file of its own: it compiles a JAX AL-iLQR
controller.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mpc_tpu.config import AlmConfig
from mpc_tpu.control.event_triggered import EventTriggeredController
from mpc_tpu.control.mpc import build_vehicle_ilqr_controller
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.road import straight_centerline
from mpc_tpu.solver.ilqr import IlqrConfig
from mpc_tpu_torch import config as tconfig
from mpc_tpu_torch.control import event_triggered as tetc
from mpc_tpu_torch.control import mpc as tmpc
from mpc_tpu_torch.convert import centerline_from_numpy, etc_carry_from_numpy
from mpc_tpu_torch.models.bicycle import pacejka_dynamics as t_pacejka
from mpc_tpu_torch.models.integrators import discretize as t_discretize
from mpc_tpu_torch.models.params import VehicleParams as TVehicleParams

torch.set_num_threads(1)

N_HORIZ, STEPS = 4, 9
ALM = dict(delta=1e-3, max_iter=8, sigma_0=1e3, penalty_factor=5.0)
ILQR = dict(max_iter=25)
PARAMS, TPARAMS = VehicleParams(), TVehicleParams()
CL = straight_centerline(100)
Y0 = np.array([[0.0, 0.0, 0.0, 0.5, 0.0, 0.0],
               [0.0, 0.03, 0.05, 0.6, 0.0, 0.0],
               [0.0, -0.04, -0.05, 0.7, 0.0, 0.0]], np.float32)


@functools.lru_cache(maxsize=None)
def _jax_etc():
    base = build_vehicle_ilqr_controller(
        n_horiz=N_HORIZ, bound_state_constraints=True,
        alm_cfg=AlmConfig(**ALM), ilqr_cfg=IlqrConfig(**ILQR))
    f_d = discretize(pacejka_dynamics)
    etc = EventTriggeredController(base=base, f_d=f_d, threshold=1e-2,
                                   eps=1e-4)

    @jax.jit
    def jstep(ys, carries):
        def one(y, c):
            out = etc.step(c, {"y0": y, "p": PARAMS, "centerline": CL})
            return f_d(y, out.u0, PARAMS), out.carry, out.triggered
        return jax.vmap(one)(ys, carries)

    return etc, jstep


def test_untriggered_ilqr_lanes_cost_zero_iterations_as_in_jax():
    etc, jstep = _jax_etc()
    base = tmpc.build_vehicle_ilqr_controller(
        n_horiz=N_HORIZ, bound_state_constraints=True,
        alm_cfg=tconfig.AlmConfig(**ALM), ilqr_cfg=tconfig.IlqrConfig(**ILQR),
        device="cpu")
    t_etc = tetc.EventTriggeredController(
        base=base, f_d=t_discretize(t_pacejka), threshold=1e-2, eps=1e-4)
    tcl = centerline_from_numpy(np.array(CL))
    noise = np.random.default_rng(2).normal(0, 6e-3, (STEPS, len(Y0), 6))
    noise[:, :2] = 0.0                     # lanes 0, 1: plant == model
    ys = jnp.asarray(Y0)
    carries = jax.vmap(lambda _: etc.init_carry())(jnp.arange(len(Y0)))
    trigs = []
    for k in range(STEPS):
        t_carry = etc_carry_from_numpy(
            {f: np.asarray(v) for f, v in carries._asdict().items()})
        out = t_etc.step(t_carry, {"y0": torch.as_tensor(np.array(ys)),
                                   "p": TPARAMS, "centerline": tcl})
        it_before = np.asarray(carries.tot_it)
        ys, carries, trig = jstep(ys, carries)
        msg = f"step {k}"
        trig = np.asarray(trig)
        np.testing.assert_array_equal(out.triggered.numpy(), trig,
                                      err_msg=msg)
        for f in ("k", "tot_solves"):
            np.testing.assert_array_equal(getattr(out.carry, f).numpy(),
                                          np.asarray(getattr(carries, f)),
                                          err_msg=f"{msg}: {f}")
        it_t = out.result.inner_iterations.numpy()
        it_j = np.asarray(carries.tot_it) - it_before
        np.testing.assert_array_equal(it_t[~trig], 0, err_msg=msg)
        np.testing.assert_array_equal(it_j[~trig], 0, err_msg=msg)
        assert np.all(it_t[trig] > 0), (msg, it_t)
        outer = out.result.outer_iterations.numpy()
        np.testing.assert_array_equal(outer[~trig], 0, err_msg=msg)
        np.testing.assert_array_equal(out.carry.U[~trig].numpy(),
                                      t_carry.U[~trig].numpy(), err_msg=msg)
        assert bool(out.result.converged.all()), msg
        if k > 0:
            assert np.all(np.abs(it_t - it_j) <= 2 * outer), \
                (msg, it_t, it_j)
            np.testing.assert_allclose(out.carry.U.numpy(),
                                       np.asarray(carries.U), rtol=0,
                                       atol=5e-4, err_msg=msg)
        trigs.append(trig)
        ys = ys + noise[k]
    trigs = np.stack(trigs)
    # the undisturbed lanes re-solve only when their plan expires
    np.testing.assert_array_equal(trigs[:, 0],
                                  np.arange(STEPS) % N_HORIZ == 0)
    assert trigs[:, 2].sum() > STEPS // N_HORIZ + 1
