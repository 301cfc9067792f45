"""The port's sharded closed loop (mpc_tpu_torch/parallel/sharding.py:
make_sharded_closed_loop) on a 2-rank gloo world, on (2, 1) and (1, 2)
meshes, 3 steps of tests/test_torch_sharding.py's lanes, against the JAX
package's ``make_sharded_closed_loop`` on an (8, 1) virtual mesh and
against the port's single-device loop (the same solver, unsharded): equal
converged flags, states within 5e-3. The ranks run while the references
do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.config import AlmConfig as JAlmConfig
from mpc_tpu.config import PanocConfig as JPanocConfig
from mpc_tpu.models.params import VehicleParams as JVehicleParams
from mpc_tpu.parallel.mesh import make_mesh
from mpc_tpu.parallel.sharding import make_sharded_closed_loop
from mpc_tpu_torch.config import AlmConfig, PanocConfig
from mpc_tpu_torch.control.mpc import build_vehicle_ocp
from mpc_tpu_torch.models.bicycle import pacejka_dynamics
from mpc_tpu_torch.models.integrators import discretize
from mpc_tpu_torch.models.params import VehicleParams
from mpc_tpu_torch.solver.alm import make_alm_solver
from test_torch_sharding import (ALM, B, BAND, N, PANOC, PORT_MESHES,
                                 _inputs, by_case, launch_solver)

torch.set_num_threads(1)

N_SIM = 3


def _single_device_loop():
    y0s, cl, _, _ = _inputs()
    problem = build_vehicle_ocp(N, device="cpu")
    solve = make_alm_solver(problem, AlmConfig(**ALM), PanocConfig(**PANOC))
    f_d = discretize(pacejka_dynamics)
    p, cl = VehicleParams(), torch.as_tensor(cl)
    ys = torch.as_tensor(y0s)
    Us = torch.tensor([1.0, 0.0]).repeat(N).expand(B, -1).clone()
    lams = torch.zeros((B, problem.m))
    traj, conv = [], []
    for _ in range(N_SIM):
        res = solve({"y0": ys, "p": p, "centerline": cl}, Us, lams)
        ys = f_d(ys, res.u[:, :2], p)
        Us, lams = res.u, res.lam
        traj.append(ys)
        conv.append(res.converged)
    return torch.stack(traj).numpy(), torch.stack(conv).numpy()


def _jax_loop():
    y0s, cl, _, _ = _inputs()
    run = make_sharded_closed_loop(
        make_mesh(n_scenario=8, n_model=1), N_SIM, n_horiz=N,
        centerline_size=cl.shape[0], alm_cfg=JAlmConfig(**ALM),
        panoc_cfg=JPanocConfig(**PANOC))
    ys, traj, conv = run(jnp.asarray(y0s), jnp.asarray(cl),
                         JVehicleParams())
    return np.asarray(ys), np.asarray(traj), np.asarray(conv)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(port, single_device_ref, jax_ref)``."""
    fut = launch_solver(tmp_path_factory.mktemp("loop"), n_sim=N_SIM)
    ref = _single_device_loop()
    jref = _jax_loop()
    return by_case(fut.result()), ref, jref


@pytest.mark.parametrize("name", PORT_MESHES)
def test_sharded_closed_loop(runs, name):
    traj, conv = runs[1]
    got = runs[0][name]
    assert got["cl_traj"].shape == (N_SIM, B, 6)
    assert got["cl_ys"].shape == (B, 6)
    np.testing.assert_array_equal(got["cl_ys"], got["cl_traj"][-1])
    np.testing.assert_array_equal(got["cl_conv"], conv)
    np.testing.assert_allclose(got["cl_traj"], traj, atol=BAND, rtol=0)
    # every lane accelerates toward v_ref
    assert (got["cl_ys"][:, 3] > _inputs()[0][:, 3] - 1e-3).all()


@pytest.mark.parametrize("name", PORT_MESHES)
def test_sharded_closed_loop_matches_jax(runs, name):
    ys, traj, conv = runs[2]
    got = runs[0][name]
    assert traj.shape == got["cl_traj"].shape
    np.testing.assert_array_equal(got["cl_conv"], conv)
    np.testing.assert_allclose(got["cl_traj"], traj, atol=BAND, rtol=0)
    np.testing.assert_allclose(got["cl_ys"], ys, atol=BAND, rtol=0)
