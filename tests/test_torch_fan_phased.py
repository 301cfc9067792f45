"""The phased algorithm of the fan kernels K1, K2 and K3
(``_fan_phased_transcription`` in mpc_tpu_torch/ops/fused_psi.py, line for
line what ``fused_psi_fan_phased`` in csrc/fused_psi.cu does, and K3's
three kernels there in turn) against
autograd of the port's plain version and against the JAX package's fused XLA
evaluator (``mpc_tpu.ops.fused_psi._eval_xla``); and the port's device
default: its entry points run on the card unless the caller names the CPU.

Tolerances. psi is formed in the plain version's operation order, so it
must equal the plain version's bit for bit. The gradient is reassociated by
the composition of the stage Jacobians, so it is held to the bars that
chip_smoke.py holds the kernel to (``mpc_tpu_torch.kernels.check``: psi
rtol 2e-5 / atol 1e-6, gradient rtol 2e-4 / atol 2e-5 per entry, for K3 plus
1e-6 of the lane's largest entry). Against the JAX package, which evaluates
atan2 through atan and a quadrant select and sums in its own order, psi and
the gradient are held to those same bars.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops import fused_psi as jfp
from mpc_tpu.ops.road import circle_centerline, straight_centerline
from mpc_tpu_torch.control import mpc as tmpc
from mpc_tpu_torch.kernels.check import AL_LANE_RTOL, compare_fan
from mpc_tpu_torch.models.params import VehicleParams as TVehicleParams
from mpc_tpu_torch.ops import fused_psi as tfp
from mpc_tpu_torch.ops.costs import DEFAULT_VEHICLE_WEIGHTS

torch.set_num_threads(1)

OFFSETS = (20.0, 1.0, 1.0, 2.0, 1.0, 0.1)
PSI_TOL = dict(rtol=2e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
N_HORIZ, SUBSTEPS, H, V_REF = 6, 4, 0.0125, 1.0

# (model, road, log10 of the penalty range or None for K1 and K2, out of
# the box)
CASES = {
    "K1-straight": ("pacejka", "straight", None, False),
    "K1-circle": ("pacejka", "circle", None, False),
    "K3-sigma-1e-1..1e3": ("pacejka", "circle", (-1, 3), False),
    "K3-sigma-1e3..1e9": ("pacejka", "straight", (3, 9), False),
    "K1-out-of-box": ("pacejka", "circle", None, True),
    "K3-out-of-box": ("pacejka", "straight", (-1, 3), True),
    "K2-straight": ("simplified", "straight", None, False),
    "K2-circle": ("simplified", "circle", None, False),
    "K2-out-of-box": ("simplified", "circle", None, True),
}
IN_BOX = [c for c, (_, _, _, oob) in CASES.items() if not oob]
SD = {"pacejka": 6, "simplified": 4}


def _case(name, E=12, seed=0):
    """Inputs of one fan call as numpy arrays: ``(cl, u, y0, al)``. In the
    box: d in [0, 1], |delta| <= 0.32, speed in [0.2, 1]. Out of it:
    |d| <= 1.5, |delta| <= 1.0 (K2: 1.4, where tan(delta) is large), speed
    in [0, 1] with every fourth lane starting at rest, as unprojected L-BFGS
    candidates can be; for K2 those lanes also have zero drive, so that
    their speed stays exactly 0, where d|v|/dv = sign(0) = 0."""
    model, road, log_sigma, oob = CASES[name]
    kin = model == "simplified"
    max_steer = (1.4 if kin else 1.0) if oob else 0.32
    rng = np.random.default_rng(seed)
    u = np.empty((E, 2 * N_HORIZ), np.float32)
    u[:, 0::2] = rng.uniform(-1.5 if oob else 0.0, 1.5 if oob else 1.0,
                             (E, N_HORIZ))
    u[:, 1::2] = rng.uniform(-max_steer, max_steer, (E, N_HORIZ))
    y0 = np.zeros((E, SD[model]), np.float32)
    y0[:, 0] = rng.uniform(-0.1, 0.5, E)
    y0[:, 1] = rng.uniform(-0.1, 0.1, E)
    y0[:, 2] = rng.uniform(-0.3, 0.3, E)
    y0[:, 3] = rng.uniform(0.0 if oob else 0.2, 1.0, E)
    if oob:
        y0[::4, 3] = 0.0
        if kin:
            u[::4, 0::2] = 0.0
    al = None
    if log_sigma is not None:
        m = 6 * N_HORIZ
        al = (rng.uniform(0.0, 2.0, (E, m)).astype(np.float32),
              (10.0 ** rng.uniform(*log_sigma, (E, m))).astype(np.float32),
              np.asarray(OFFSETS, np.float32),
              np.full(m, -np.inf, np.float32), np.zeros(m, np.float32))
    cl = straight_centerline(50) if road == "straight" \
        else circle_centerline(50)
    return np.array(cl), u, y0, al


def _torch_args(cl, u, y0, al):
    cltab, pvec = tfp.fan_params(torch.as_tensor(cl), TVehicleParams())
    al_t = None if al is None else tuple(torch.as_tensor(a) for a in al)
    return torch.as_tensor(u), torch.as_tensor(y0), cltab, pvec, al_t


@functools.lru_cache(maxsize=None)
def _jax_eval(model, with_al):
    deriv = jfp._simplified_deriv if model == "simplified" \
        else jfp._pacejka_deriv
    cfg = dict(n_horiz=N_HORIZ, deriv=deriv, state_dim=SD[model], h=H,
               substeps=SUBSTEPS, v_ref=V_REF,
               weights=tuple(DEFAULT_VEHICLE_WEIGHTS), unroll=1)

    def run(u, y0, cl, *al):
        return jfp._eval_xla(u, y0, jfp.make_cltab(cl), VehicleParams(), cfg,
                             al_ls=al if with_al else None)

    return jax.jit(run)


def _within(got, ref, tol, lane_rtol=0.0):
    scale = np.abs(ref).reshape(ref.shape[0], -1)
    bar = tol["atol"] + tol["rtol"] * scale \
        + lane_rtol * scale.max(axis=1, keepdims=True)
    return bool((np.abs(got - ref).reshape(ref.shape[0], -1) <= bar).all())


@pytest.mark.parametrize("case", list(CASES))
def test_phased_transcription_matches_autograd(case):
    # psi bit for bit; the gradient within check.py's bars, where no lane may
    # fail (a lane beyond the bar only where the plain f32 version also
    # misses float64, out of the box)
    model, oob = CASES[case][0], CASES[case][3]
    u, y0, cltab, pvec, al = _torch_args(*_case(case))
    args = (N_HORIZ, SUBSTEPS, H, V_REF, DEFAULT_VEHICLE_WEIGHTS)
    psi_r, grad_r = tfp.fan_value_and_grad_reference(u, y0, cltab, pvec,
                                                     *args, model=model,
                                                     al=al)
    psi, grad = tfp._fan_phased_transcription(u, y0, cltab, pvec, *args,
                                              model=model, al=al)
    np.testing.assert_array_equal(psi.numpy(), psi_r.numpy())
    r = compare_fan(psi, grad, u, y0, cltab, pvec, *args, PSI_TOL, GRAD_TOL,
                    model=model, al=al)
    assert r["failed"] == 0 and r["max_abs_err_psi"] == 0.0, r
    assert r["excused"] == 0 or oob, r
    if model == "simplified" and oob:
        # the lanes at rest with zero drive: steering still acts
        assert float(grad_r[::4].abs().max()) > 0.0
        assert float(grad[::4].abs().max()) > 0.0


@pytest.mark.parametrize("case", IN_BOX)
def test_phased_transcription_matches_jax_fused_xla(case):
    model = CASES[case][0]
    cl, u, y0, al = _case(case, seed=1)
    psi_j, grad_j = _jax_eval(model, al is not None)(
        jnp.asarray(u), jnp.asarray(y0), jnp.asarray(cl),
        *(jnp.asarray(a) for a in (al or ())))
    psi_j, grad_j = np.asarray(psi_j), np.asarray(grad_j)
    ut, y0t, cltab, pvec, al_t = _torch_args(cl, u, y0, al)
    psi, grad = tfp._fan_phased_transcription(
        ut, y0t, cltab, pvec, N_HORIZ, SUBSTEPS, H, V_REF,
        DEFAULT_VEHICLE_WEIGHTS, model=model, al=al_t)
    assert np.isfinite(grad_j).all()
    assert _within(psi.numpy()[:, None], psi_j[:, None], PSI_TOL)
    assert _within(grad.numpy(), grad_j, GRAD_TOL,
                   AL_LANE_RTOL if al is not None else 0.0)


def test_phased_transcription_refuses_an_unknown_model():
    u, y0, cltab, pvec, _ = _torch_args(*_case("K1-straight", E=2))
    with pytest.raises(ValueError, match="unknown model 'kinematic'"):
        tfp._fan_phased_transcription(u, y0, cltab, pvec, N_HORIZ, SUBSTEPS,
                                      H, V_REF, DEFAULT_VEHICLE_WEIGHTS,
                                      model="kinematic")


# ---------------------------------------------------------------------------
# The device default
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["build_vehicle_ocp",
                                   "build_vehicle_controller"])
def test_entry_points_default_to_the_card(entry):
    # Decided here, in the test body: without a card a default call raises
    # and names device="cpu"; with one it builds on the card.
    build = getattr(tmpc, entry)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build(n_horiz=4)
        return
    built = build(n_horiz=4)
    problem = built if entry == "build_vehicle_ocp" else built.problem
    assert problem.C.lower.device.type == "cuda"


def test_cpu_device_builds_and_carries_on_the_cpu():
    ctrl = tmpc.build_vehicle_controller(n_horiz=4, device="cpu")
    assert ctrl.device == torch.device("cpu")
    carry = ctrl.init_carry(3)
    assert all(t.device.type == "cpu" for t in carry)
    assert carry.U.shape == (3, 8)
    assert tmpc.resolve_device("cpu") == torch.device("cpu")
