"""Parity of the port's MPC controller (mpc_tpu_torch/control/mpc.py) with
the JAX package, on the fused path (the candidate fan through
``fan_value_and_grad``, whose plain version runs on the CPU); and the check
that the port never imports jax. The closed loop is held against the JAX
package in tests/test_torch_closedloop.py.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.control.mpc import build_vehicle_controller
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.road import straight_centerline
from mpc_tpu_torch import config as tconfig
from mpc_tpu_torch.bench import initial_states
from mpc_tpu_torch.control import mpc as tmpc
from mpc_tpu_torch.convert import carry_from_numpy, centerline_from_numpy
from mpc_tpu_torch.models.params import VehicleParams as TVehicleParams

torch.set_num_threads(1)

PKG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "mpc_tpu_torch")
PARAMS, TPARAMS = VehicleParams(), TVehicleParams()


def _controllers(n_horiz, eps, max_iter):
    # The JAX side takes the plain per-lane path (the same mathematics as its
    # fused XLA path): on XLA:CPU it compiles in about half the time.
    jctrl = build_vehicle_controller(
        n_horiz=n_horiz, alm_cfg=AlmConfig(eps=eps),
        panoc_cfg=PanocConfig(lbfgs_memory=n_horiz, max_iter=max_iter))
    tctrl = tmpc.build_vehicle_controller(
        n_horiz=n_horiz, alm_cfg=tconfig.AlmConfig(eps=eps),
        panoc_cfg=tconfig.PanocConfig(lbfgs_memory=n_horiz,
                                      max_iter=max_iter), device="cpu")
    return jctrl, tctrl


def test_cold_and_warm_steps_match_jax():
    # One cold step and 5 warm steps at B=4, N=6. Before every step the JAX
    # carry is carried across with convert.carry_from_numpy, so each step
    # starts both solvers from the same warm start.
    B, n_horiz = 4, 6
    jctrl, tctrl = _controllers(n_horiz, eps=1e-4, max_iter=150)
    cl = straight_centerline(100)
    tcl = centerline_from_numpy(np.array(cl))
    f_d = discretize(pacejka_dynamics)

    @jax.jit
    def jstep(ys, carries):
        def one(y, carry):
            out = jctrl.step(carry, {"y0": y, "p": PARAMS, "centerline": cl})
            return (f_d(y, out.u0, PARAMS), out.carry, out.u0,
                    out.result.psi, out.result.converged)
        return jax.vmap(one)(ys, carries)

    ys = jnp.asarray(initial_states(B, 0))
    carries = jax.vmap(lambda _: jctrl.init_carry())(jnp.arange(B))
    t_carry = tctrl.init_carry(B)
    np.testing.assert_array_equal(
        t_carry.U.numpy(), np.asarray(carries.U))
    for k in range(6):
        t_carry = carry_from_numpy(
            {f: np.asarray(v) for f, v in carries._asdict().items()})
        out = tctrl.step(t_carry, {"y0": torch.as_tensor(np.array(ys)),
                                   "p": TPARAMS, "centerline": tcl})
        ys, carries, u0, psi, conv = jstep(ys, carries)
        np.testing.assert_array_equal(out.result.converged.numpy(),
                                      np.asarray(conv), err_msg=f"step {k}")
        assert bool(out.result.converged.all()), f"step {k}"
        np.testing.assert_allclose(out.result.psi.numpy(), np.asarray(psi),
                                   rtol=1e-3, atol=1e-5, err_msg=f"step {k}")
        np.testing.assert_allclose(out.u0.numpy(), np.asarray(u0), rtol=0,
                                   atol=5e-3, err_msg=f"step {k}")
        # the carry the port hands on has the JAX layout and semantics
        np.testing.assert_allclose(out.carry.U.numpy(),
                                   np.asarray(carries.U), rtol=0, atol=2e-2)
        assert out.carry.sigma.shape == carries.sigma.shape
        np.testing.assert_array_equal(out.carry.failures.numpy(),
                                      np.asarray(carries.failures))


def test_unported_options_raise():
    # the kinematic model and the bounded state constraints are ported
    # (tests/test_torch_mpc_config1.py, tests/test_torch_mpc_constrained.py),
    # and so are the windowed search and the obstacle field, which choose
    # the plain OCP (tests/test_torch_obstacle.py); the horizon-sharded
    # AL-iLQR, the option that raised last, is ported too: over a world of
    # one rank in this process it is the batch-native controller, and its
    # step is the unsharded controller's with the parallel-scan backward
    # pass (a scan over one rank folds in identity elements, which is
    # exact)
    import torch.distributed as dist
    from mpc_tpu_torch.config import AlmConfig, IlqrConfig
    from mpc_tpu_torch.parallel.distributed import initialize
    from mpc_tpu_torch.parallel.ilqr_sharded import BatchedMpcController
    from mpc_tpu_torch.parallel.mesh import make_horizon_mesh
    for kw in ({"window": 20}, {"obstacle_weight": 1.0}):
        prob = tmpc.build_vehicle_ocp(n_horiz=4, device="cpu", **kw)
        assert prob.cost_multi is None
    initialize("gloo", "cpu", store=dist.HashStore(), rank=0, world_size=1)
    try:
        kw = dict(n_horiz=4, bound_state_constraints=True,
                  alm_cfg=AlmConfig(delta=1e-3, max_iter=4, sigma_0=1e3),
                  ilqr_cfg=IlqrConfig(max_iter=10, parallel_backward=True),
                  device="cpu")
        ctrl = tmpc.build_vehicle_ilqr_controller(
            mesh=make_horizon_mesh(1, 1), **kw)
        assert isinstance(ctrl, BatchedMpcController)
        base = tmpc.build_vehicle_ilqr_controller(**kw)
        y0 = torch.tensor([[0.0, 0.05, 0.0, 0.5, 0.0, 0.0],
                           [0.0, -0.03, 0.1, 0.8, 0.0, 0.0]])
        param = {"y0": y0, "p": TVehicleParams(),
                 "centerline": centerline_from_numpy(
                     np.asarray(straight_centerline(100)))}
        got = ctrl.step(ctrl.init_carry(2, device="cpu"), param)
        want = base.step(base.init_carry(2, device="cpu"), param)
        for a, b in zip(got.result, want.result):
            if a is not None:
                assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


def _port_modules():
    for root, _, files in os.walk(PKG_DIR):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_port_sources_import_no_jax():
    offenders = []
    for path in _port_modules():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "mpc_tpu"):
                    offenders.append(f"{path}: {name}")
    assert not offenders, offenders


def test_port_import_leaves_jax_unloaded():
    mods = []
    for path in _port_modules():
        rel = os.path.relpath(path, os.path.dirname(PKG_DIR))[:-3]
        mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'mpc_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=os.path.dirname(PKG_DIR), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


def test_vehicle_ocp_always_evaluates_the_fan():
    # The controller's only path: the PANOC candidate fan through
    # fan_value_and_grad (the kernel on a CUDA device).
    import pytest
    problem = tmpc.build_vehicle_ocp(n_horiz=4, device="cpu")
    assert problem.cost_multi is not None and problem.param_prep is not None
    with pytest.raises(ValueError):
        tmpc.build_vehicle_ocp(n_horiz=4, model="unicycle", device="cpu")
