"""The port's hanging-chain demo (mpc_tpu_torch/examples/hanging_chain.py)
against the JAX package's examples/hanging_chain.py, both run as a user
runs them (``main()``, the JAX script loaded from its path, its stdout
captured), at ``--n-sim 1``: one port step of the chain's N=12 OCP takes
about 55 s on this CPU (some 575 PANOC iterations of the plain fan, each
about 9,000 eager ops), so the JAX script runs in a thread beside it.

Held equal: the JSON keys, the failures (0) and so the converged flags.
Within 1e-3: the uncontrolled run's floor violation and the free end's
height, which the saturated input fixes. The solution: the JAX cost of the
port's first-step inputs within 1e-3 relative of the JAX package's own
(tests/test_torch_chain.py's band), and no ball below the floor with MPC.

The first inputs and the inner iteration count are not held: this step is
decided by rounding in the JAX package itself. From the same disturbed
state moved by one ulp in one component (seven draws), JAX's first input
ranges over [-0.884, -0.101], its inner iterations over 316-660 and its
outer iterations over 3-5, with costs 392.951-395.121 against 392.955
unmoved; the port reads -0.441, 575 and 6, cost 393.091. Run as a script,
this file prints that spread and the port's step:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_example_chain.py
"""

import concurrent.futures
import importlib.util
import json
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mpc_tpu_torch.examples import hanging_chain

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_jax_example(name, argv, patch=None):
    """Run the JAX package's ``examples/<name>.py`` ``main()`` with
    ``argv``; returns its printed lines. ``patch(module)`` may wrap the
    module's names before the run."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lines = []
    mod.print = lambda *a, **k: lines.append(" ".join(map(str, a)))
    if patch is not None:
        patch(mod)
    with mock.patch.object(sys, "argv", [name, *argv]):
        mod.main()
    return lines


def _capture_run(captured):
    """Wrap the script's closed loop to keep its controller, arguments and
    output."""
    def patch(mod):
        build = mod.run_closed_loop_jit

        def run_closed_loop_jit(ctrl, f_d, n_sim):
            run = build(ctrl, f_d, n_sim=n_sim)

            def wrapped(*args):
                out = run(*args)
                captured.update(ctrl=ctrl, args=args, out=out)
                return out
            return wrapped
        mod.run_closed_loop_jit = run_closed_loop_jit
    return patch


def test_hanging_chain_matches_the_jax_script():
    captured = {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_lines = pool.submit(run_jax_example, "hanging_chain",
                                ["--n-sim", "1"], _capture_run(captured))
        got = hanging_chain.main(["--n-sim", "1", "--device", "cpu"])
        lines = jax_lines.result()
    jtot, jfail = map(int, lines[0].split())
    ref = json.loads(lines[1])
    assert set(ref) <= set(got)
    assert got["failures"] == jfail == 0
    assert got["converged_fraction"] == 1.0
    assert got["n_sim"] == ref["n_sim"] == 1
    np.testing.assert_allclose(got["max_floor_violation_uncontrolled"],
                               ref["max_floor_violation_uncontrolled"],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["free_end_final"][1],
                               ref["free_end_final"][1], rtol=0, atol=1e-3)
    assert got["max_floor_violation_mpc"] <= 0.0
    assert ref["max_floor_violation_mpc"] <= 0.0

    ctrl, (y, static, _), out = (captured[k] for k in ("ctrl", "args",
                                                        "out"))
    cost = jax.jit(lambda U: ctrl.problem.cost(U, dict(static, y0=y)))
    np.testing.assert_allclose(float(cost(jnp.asarray(got["U"]))),
                               float(cost(out.carry.U)), rtol=1e-3)
    assert jtot > 0 and got["tot_it"] > 0


def _jax_first_step():
    """The JAX package's chain controller of the script, its static
    parameters and the script's disturbed state."""
    from mpc_tpu.config import PanocConfig
    from mpc_tpu.control import chain_mpc
    from mpc_tpu.models.chain import ChainSpec, chain_dynamics
    from mpc_tpu.models.integrators import discretize
    from mpc_tpu.models.params import ChainParams

    spec, params = ChainSpec(6, 2), ChainParams()
    ctrl = chain_mpc.build_chain_controller(
        spec, n_horiz=12, panoc_cfg=PanocConfig(lbfgs_memory=12,
                                                max_iter=250))
    static = {"p": params, "constr": chain_mpc.floor_coefficients()[0]}
    f_d = discretize(chain_dynamics(spec))
    y = spec.initial_state()
    for _ in range(3):
        y = f_d(y, jnp.array([-0.5, 0.5]), params)
    return ctrl, static, np.asarray(y)


def jax_spread(draws: int = 7, seed: int = 1) -> dict:
    """The JAX package's first chain step from the script's disturbed state
    and from that state moved by one ulp in one component per draw: first
    inputs, inner and outer iterations, flags and costs."""
    ctrl, static, y = _jax_first_step()
    rng = np.random.default_rng(seed)
    ys = [y]
    for _ in range(draws):
        moved = y.copy()
        i = rng.integers(0, y.size)
        moved[i] = np.nextafter(moved[i], np.float32(
            np.inf if rng.random() < 0.5 else -np.inf))
        ys.append(moved)
    ys = jnp.asarray(np.stack(ys))
    carries = jax.vmap(lambda _: ctrl.init_carry())(jnp.arange(len(ys)))
    out = jax.jit(jax.vmap(lambda c, y0: ctrl.step(
        c, dict(static, y0=y0))))(carries, ys)
    cost = jax.jit(jax.vmap(lambda U, y0: ctrl.problem.cost(
        U, dict(static, y0=y0))))
    r = out.result
    return {"u0": np.asarray(out.u0)[:, 0].tolist(),
            "inner": np.asarray(r.inner_iterations).tolist(),
            "outer": np.asarray(r.outer_iterations).tolist(),
            "converged": np.asarray(r.converged).tolist(),
            "cost": np.asarray(cost(out.carry.U, ys)).tolist()}


def port_first_step() -> dict:
    """The port's first chain step from the same disturbed state: first
    input, inner and outer iterations, flag, and the JAX cost of its
    inputs beside JAX's own."""
    from mpc_tpu_torch import config as tconfig
    from mpc_tpu_torch.control import chain_mpc as tchain_mpc
    from mpc_tpu_torch.models.chain import ChainSpec as TChainSpec
    from mpc_tpu_torch.models.params import ChainParams as TChainParams

    ctrl, static, y = _jax_first_step()
    jout = jax.jit(lambda y0: ctrl.step(ctrl.init_carry(),
                                        dict(static, y0=y0)))(y)
    tctrl = tchain_mpc.build_chain_controller(
        TChainSpec(6, 2), n_horiz=12, panoc_cfg=tconfig.PanocConfig(
            lbfgs_memory=12, max_iter=250), device="cpu")
    coeff, _ = tchain_mpc.floor_coefficients()
    with torch.no_grad():
        out = tctrl.step(tctrl.init_carry(1), {
            "y0": torch.as_tensor(y.copy())[None], "p": TChainParams(),
            "constr": coeff})
    cost = jax.jit(lambda U: ctrl.problem.cost(U, dict(static, y0=y)))
    r = out.result
    return {"u0": float(out.u0[0, 0]),
            "inner": int(r.inner_iterations[0]),
            "outer": int(r.outer_iterations[0]),
            "converged": bool(r.converged[0]),
            "jax_cost_of_port_inputs": float(cost(jnp.asarray(
                out.carry.U[0].numpy()))),
            "jax_cost_of_jax_inputs": float(cost(jout.carry.U))}


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps({"jax_spread": jax_spread(),
                      "port": port_first_step()}))
