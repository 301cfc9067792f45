"""Parity of the port's event-triggered MPC
(mpc_tpu_torch/control/event_triggered.py) with the JAX package's, over the
PANOC controller of config 3 (examples/bench_suite.py:172-215) at N=4:
step by step, each step fed the JAX carry (``convert.etc_carry_from_numpy``),
on lanes that trigger at different times (two are disturbed, two replay
their plan until it expires). Also: a zero threshold re-solves every step
and tracks as plain MPC does.

Tolerances: triggered flags, k and tot_solves equal (their inputs, the JAX
carry and plant state, are equal; the prediction errors agree to 1e-5
relative, far from the threshold); the stored plan and the applied input
within 2e-2 and 5e-3, the bands of tests/test_torch_mpc.py (PANOC's
iterates move with float32 rounding); the prediction, the plan rolled out
over 4 stages, within 1e-2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.control.event_triggered import EventTriggeredController
from mpc_tpu.control.mpc import build_vehicle_controller
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.road import straight_centerline
from mpc_tpu_torch import config as tconfig
from mpc_tpu_torch.control import event_triggered as tetc
from mpc_tpu_torch.control import mpc as tmpc
from mpc_tpu_torch.convert import centerline_from_numpy, etc_carry_from_numpy
from mpc_tpu_torch.models.bicycle import pacejka_dynamics as t_pacejka
from mpc_tpu_torch.models.integrators import discretize as t_discretize
from mpc_tpu_torch.models.params import VehicleParams as TVehicleParams
from mpc_tpu_torch.sim.closedloop import run_closed_loop

torch.set_num_threads(1)

B, N_HORIZ, THRESHOLD = 4, 4, 1e-2
ALM = dict(eps=1e-4)
PANOC = dict(lbfgs_memory=N_HORIZ, max_iter=300)
PARAMS, TPARAMS = VehicleParams(), TVehicleParams()
CL = straight_centerline(100)


def y0s():
    """[0, U(-0.1, 0.1), 0, U(0.3, 1.0), 0, 0], drawn as config 3 draws."""
    rng = np.random.default_rng(0)
    y = np.zeros((B, 6), np.float32)
    y[:, 1] = rng.uniform(-0.1, 0.1, B)
    y[:, 3] = rng.uniform(0.3, 1.0, B)
    return y


def t_etc(threshold):
    base = tmpc.build_vehicle_controller(
        n_horiz=N_HORIZ, alm_cfg=tconfig.AlmConfig(**ALM),
        panoc_cfg=tconfig.PanocConfig(**PANOC), device="cpu")
    return tetc.EventTriggeredController(
        base=base, f_d=t_discretize(t_pacejka), threshold=threshold,
        eps=1e-4)


@functools.lru_cache(maxsize=None)
def _jax_etc():
    base = build_vehicle_controller(n_horiz=N_HORIZ, alm_cfg=AlmConfig(**ALM),
                                    panoc_cfg=PanocConfig(**PANOC))
    f_d = discretize(pacejka_dynamics)
    etc = EventTriggeredController(base=base, f_d=f_d, threshold=THRESHOLD,
                                   eps=1e-4)

    @jax.jit
    def jstep(ys, carries):
        def one(y, c):
            out = etc.step(c, {"y0": y, "p": PARAMS, "centerline": CL})
            return (f_d(y, out.u0, PARAMS), out.carry, out.u0,
                    out.triggered, out.prediction_error)
        return jax.vmap(one)(ys, carries)

    return etc, jstep


def test_steps_match_jax():
    etc, jstep = _jax_etc()
    tetc_ = t_etc(THRESHOLD)
    tcl = centerline_from_numpy(np.array(CL))
    noise = np.random.default_rng(1).normal(0, 6e-3, (10, B, 6))
    noise[:, [0, 2]] = 0.0            # lanes 0 and 2: plant == model
    ys = jnp.asarray(y0s())
    carries = jax.vmap(lambda _: etc.init_carry())(jnp.arange(B))
    t0 = tetc_.init_carry(B)
    for f in ("U", "lam", "xs_pred", "k", "tot_solves", "tot_it"):
        np.testing.assert_array_equal(getattr(t0, f).numpy(),
                                      np.asarray(getattr(carries, f)))
    trig_seen = []
    for k in range(10):
        t_carry = etc_carry_from_numpy(
            {f: np.asarray(v) for f, v in carries._asdict().items()})
        out = tetc_.step(t_carry, {"y0": torch.as_tensor(np.array(ys)),
                                   "p": TPARAMS, "centerline": tcl})
        ys, carries, u0, trig, err = jstep(ys, carries)
        msg = f"step {k}"
        np.testing.assert_array_equal(out.triggered.numpy(),
                                      np.asarray(trig), err_msg=msg)
        for f in ("k", "tot_solves"):
            np.testing.assert_array_equal(getattr(out.carry, f).numpy(),
                                          np.asarray(getattr(carries, f)),
                                          err_msg=f"{msg}: {f}")
        fin = np.isfinite(np.asarray(err))
        np.testing.assert_array_equal(np.isfinite(out.prediction_error),
                                      fin, err_msg=msg)
        np.testing.assert_allclose(out.prediction_error.numpy()[fin],
                                   np.asarray(err)[fin], rtol=1e-5,
                                   atol=1e-7, err_msg=msg)
        np.testing.assert_allclose(out.carry.U.numpy(),
                                   np.asarray(carries.U), rtol=0, atol=2e-2,
                                   err_msg=msg)
        np.testing.assert_allclose(out.u0.numpy(), np.asarray(u0), rtol=0,
                                   atol=5e-3, err_msg=msg)
        np.testing.assert_allclose(out.carry.xs_pred.numpy(),
                                   np.asarray(carries.xs_pred), rtol=0,
                                   atol=1e-2, err_msg=msg)
        # an untriggered lane replays its plan: no solver iteration
        it = out.result.inner_iterations.numpy()
        assert np.all(it[~out.triggered.numpy()] == 0), (msg, it)
        assert bool(out.result.converged.all()), msg
        trig_seen.append(np.asarray(trig))
        ys = ys + noise[k]
    trig_seen = np.stack(trig_seen)
    # every lane solves on its first step; the undisturbed lanes again only
    # when their plan expires (every N steps); the disturbed ones more often
    assert trig_seen[0].all()
    np.testing.assert_array_equal(trig_seen[:, 0], np.arange(10) % 4 == 0)
    assert trig_seen[:, 1].sum() > 3 and trig_seen[:, 3].sum() > 3


def test_zero_threshold_is_plain_mpc():
    # threshold 0 re-solves every step, and the closed loop tracks as the
    # plain controller's does, to the bar of tests/test_event_triggered.py:
    # 2e-3 (the ETC solve re-estimates PANOC's step size, the controller
    # carries it)
    etc = t_etc(0.0)
    f_d = t_discretize(t_pacejka)
    tcl = centerline_from_numpy(np.array(CL))
    y = torch.as_tensor(y0s())
    carry = etc.init_carry(B)
    ys = []
    for _ in range(6):
        out = etc.step(carry, {"y0": y, "p": TPARAMS, "centerline": tcl})
        assert bool(out.triggered.all())
        y, carry = f_d(y, out.u0, TPARAMS), out.carry
        ys.append(y)
    assert carry.tot_solves.tolist() == [6] * B
    ref = run_closed_loop(etc.base, f_d, torch.as_tensor(y0s()),
                          {"p": TPARAMS, "centerline": tcl}, 6, TPARAMS)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), ref.ys.numpy(),
                               atol=2e-3)
