"""The exposed phases of one AL-iLQR inner iteration
(``IlqrPhases``, ``iterate.phases`` of the port's ``solve.prepare_inner``,
mpc_tpu_torch/solver/ilqr.py) against the JAX package's phase profile,
examples/profile_config2_phases.py (``rollout``, ``derivatives``,
``backward_only`` sequential and parallel, ``forward_fan``, jitted and
vmapped over the lanes as that script runs them), at B = 4 and N = 6 on the
inputs of the port's counterpart script (``draw_inputs``: ``default_rng(0)``,
the lane-change road, multipliers 0, penalties 1e3, regularisation 1e-3).
The JAX script reads its module's ``N = 40`` inside ``backward`` and
``backward_only``, so the test sets that attribute to 6 for its calls.
Each phase takes the same numpy operands in both packages, so a gap is the
phase's own.

Tolerances, float32 against float32 with other operation orders:
- the rollout's states 1e-5 relative / 1e-6 absolute, the test of the
  models' rollouts (tests/test_torch_models.py); its cost 1e-5 relative;
- the derivatives: forward mode over replicated points against
  ``jax.jacfwd`` per point, each array within 1e-5 of its largest entry
  (the products J'J with penalties of 1e3 reach 1e5 in a few entries, and
  their rounding is relative to those);
- the Riccati gains within 1e-4 of each array's largest entry: the two
  packages' 2x2 solves round differently, and six stages of the recursion
  compound it;
- the fan's states and inputs as the rollout's, its costs 1e-5 relative.

Also on the CPU: the four phases composed (derivatives, the LQT solve, the
forward fan, the step size's pick) give exactly what one ``iterate`` gives
from the same state, every field bit for bit; and the LQT solve without
``parallel`` is the solver's own.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu_torch.examples import profile_config2_phases as tph

torch.set_num_threads(1)

B, N = 4, 6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATE_TOL = dict(rtol=1e-5, atol=1e-6)
COST_RTOL = 1e-5
DERIV_SCALE_TOL = 1e-5
GAIN_SCALE_TOL = 1e-4


def _jax_script(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "jax_profile_config2_phases",
        os.path.join(REPO, "examples", "profile_config2_phases.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "N", N)
    return mod


@pytest.fixture(scope="module")
def port():
    inputs = tph.draw_inputs(B, n_horiz=N)
    with torch.no_grad():
        return inputs, tph.setup(inputs, "cpu", n_horiz=N)


@pytest.fixture(scope="module")
def runs(port):
    """Each phase in both packages on the same operands: ``{phase: (port's
    outputs, JAX's outputs)}``, numpy."""
    mp = pytest.MonkeyPatch()
    try:
        jph = _jax_script(mp)
        inputs, s = port
        ph = s.phases
        y0, us, lam, sigma, reg = (jnp.asarray(a) for a in (
            inputs.y0, inputs.us, inputs.lam, inputs.sigma, inputs.reg))
        cl = jnp.asarray(inputs.road)
        t = {k: torch.as_tensor(v) for k, v in inputs._asdict().items()}
        out = {}
        with torch.no_grad():
            xs, cost = ph.rollout(t["us"])
        roll_j = jax.jit(jax.vmap(functools.partial(jph.rollout, unroll=8),
                                  in_axes=(0, 0, 0, 0, None)))
        out["rollout"] = ((xs[:, 1:].numpy(), cost.numpy()),
                          tuple(map(np.asarray,
                                    roll_j(y0, us, lam, sigma, cl))))

        with torch.no_grad():
            derivs = ph.derivatives(xs, t["us"])
        deriv_j = jax.jit(jax.vmap(jph.derivatives,
                                   in_axes=(0, 0, 0, 0, None)))
        out["derivatives"] = (
            tuple(d.numpy() for d in derivs),
            tuple(map(np.asarray, deriv_j(jnp.asarray(xs.numpy()), us, lam,
                                          sigma, cl))))

        dj = tuple(jnp.asarray(d.numpy()) for d in derivs)
        for name, par in (("backward_sequential", False),
                          ("backward_parallel", True)):
            with torch.no_grad():
                Ko, ko, _ = ph.lqt_solve(derivs, t["reg"], parallel=par)
            bwd_j = jax.jit(jax.vmap(
                functools.partial(jph.backward_only, parallel=par)))
            out[name] = ((Ko.numpy(), ko.numpy()),
                         tuple(map(np.asarray, bwd_j(*dj, reg))))

        Ko, ko = out["backward_parallel"][0]
        with torch.no_grad():
            fxs, fus, fcost = ph.forward(xs, t["us"], torch.as_tensor(Ko),
                                         torch.as_tensor(ko))
        fan_j = jax.jit(jax.vmap(functools.partial(jph.forward_fan,
                                                   unroll=8),
                                 in_axes=(0, 0, 0, 0, 0, 0, 0, None)))
        out["forward_fan6"] = (
            (fxs[:, :, 1:].numpy(), fus.numpy(), fcost.numpy()),
            tuple(map(np.asarray, fan_j(y0, jnp.asarray(xs.numpy()), us,
                                        jnp.asarray(Ko), jnp.asarray(ko),
                                        lam, sigma, cl))))
        return out
    finally:
        mp.undo()


def _scaled(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-30)
    gap = float(np.abs(got - want).max())
    assert gap <= tol * scale, (gap, scale)


def test_rollout_matches_jax(runs):
    (xs, cost), (xs_j, cost_j) = runs["rollout"]
    assert xs.shape == (B, N, 6)
    np.testing.assert_allclose(xs, xs_j, **STATE_TOL)
    np.testing.assert_allclose(cost, cost_j, rtol=COST_RTOL)


@pytest.mark.parametrize("k, name", list(enumerate(
    ("A", "B", "Q", "q", "R", "r", "P"))))
def test_derivatives_match_jax(runs, k, name):
    got, want = runs["derivatives"][0][k], runs["derivatives"][1][k]
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    _scaled(got, want, DERIV_SCALE_TOL)


@pytest.mark.parametrize("name", ["backward_sequential",
                                  "backward_parallel"])
def test_riccati_gains_match_jax(runs, name):
    (Ko, ko), (Ko_j, ko_j) = runs[name]
    assert Ko.shape == (B, N, 2, 6) and ko.shape == (B, N, 2)
    _scaled(Ko, Ko_j, GAIN_SCALE_TOL)
    _scaled(ko, ko_j, GAIN_SCALE_TOL)


def test_forward_fan_matches_jax(runs):
    (xs, us, cost), (xs_j, us_j, cost_j) = runs["forward_fan6"]
    assert xs.shape == (B, 6, N, 6) and cost.shape == (B, 6)
    np.testing.assert_allclose(xs, xs_j, **STATE_TOL)
    np.testing.assert_allclose(us, us_j, **STATE_TOL)
    np.testing.assert_allclose(cost, cost_j, rtol=COST_RTOL)


def _bits(t):
    return t.view(torch.int32) if t.is_floating_point() else t


def test_composed_phases_are_one_iterate(port):
    _, s = port
    st, ph = s.state, s.phases
    with torch.no_grad():
        assert bool(s.cond(st).all())
        want = s.iterate(st)
        Ks, kos, gnorm = ph.lqt_solve(ph.derivatives(st.xs, st.us), st.reg)
        got = ph.accept(st, gnorm, *ph.forward(st.xs, st.us, Ks, kos))
    for field in ("us", "xs", "cost", "reg", "iters", "converged",
                  "grad_norm"):
        assert torch.equal(_bits(getattr(got, field)),
                           _bits(getattr(want, field))), field


def test_lqt_solve_defaults_to_the_solvers_own(port):
    # ilqr_n40's configuration: the sequential Riccati
    _, s = port
    derivs = s.args["derivs"]
    with torch.no_grad():
        own = s.phases.lqt_solve(derivs, s.args["reg"])
        seq = s.phases.lqt_solve(derivs, s.args["reg"], parallel=False)
    for a, b in zip(own, seq):
        assert torch.equal(a, b)
