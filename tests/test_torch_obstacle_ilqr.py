"""Parity of the port's AL-iLQR vehicle controller with the obstacle field
(``build_vehicle_ilqr_controller(obstacle_weight=...)``, mpc_tpu_torch/
control/mpc.py) with the JAX package's: the term is not a sum of squares,
so both take the full second-order backward pass
(mpc_tpu/control/mpc.py:370-377). Three steps from the scenario of
tests/test_obstacle_avoidance.py (one obstacle 5 cm off a straight road),
the port stepped from JAX's state and carry: converged flags and outer
counts equal, inner counts within 2 per outer iteration
(tests/test_torch_mpc_ilqr.py), first inputs within 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mpc_tpu.control import mpc as jmpc
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops import road as jroad
from mpc_tpu.solver.ilqr import IlqrConfig
from mpc_tpu_torch import config as tconfig
from mpc_tpu_torch.control import mpc as tmpc
from mpc_tpu_torch.convert import carry_from_numpy
from mpc_tpu_torch.models.params import VehicleParams as TVehicleParams

torch.set_num_threads(1)

PARAMS = VehicleParams()
FIELD = {"a_f": 1.0, "sigma_x": 0.2}
OBSTACLE = np.array([[1.0, 0.05, 0.0, 0.0]], np.float32)
CL = np.array(jroad.straight_centerline(100))
Y0 = np.array([[0.0, 0.0, 0.0, 0.5, 0.0, 0.0],
               [0.1, 0.04, 0.05, 0.7, 0.0, 0.0],
               [0.3, -0.03, -0.1, 0.9, 0.0, 0.0]], np.float32)


def test_ilqr_with_obstacle_term_matches_jax():
    N, B = 6, 3
    ilqr = dict(max_iter=20)
    jctrl = jmpc.build_vehicle_ilqr_controller(
        n_horiz=N, obstacle_weight=2.0, obstacle_field_kwargs=FIELD,
        ilqr_cfg=IlqrConfig(**ilqr))
    f_d = discretize(pacejka_dynamics)
    static = {"p": PARAMS, "centerline": jnp.asarray(CL),
              "obstacles": jnp.asarray(OBSTACLE)}

    @jax.jit
    def jstep(ys, carries):
        def one(y, carry):
            out = jctrl.step(carry, dict(static, y0=y))
            return f_d(y, out.u0, PARAMS), out.carry, out.u0, out.result
        return jax.vmap(one)(ys, carries)

    tctrl = tmpc.build_vehicle_ilqr_controller(
        n_horiz=N, obstacle_weight=2.0, obstacle_field_kwargs=FIELD,
        ilqr_cfg=tconfig.IlqrConfig(**ilqr), device="cpu")
    assert tctrl.problem.uses_obstacles
    tstatic = {"p": TVehicleParams(), "centerline": torch.as_tensor(CL),
               "obstacles": torch.as_tensor(OBSTACLE)}
    ys = jnp.asarray(Y0[:B])
    carries = jax.vmap(lambda _: jctrl.init_carry())(jnp.arange(B))
    for k in range(3):
        t_carry = carry_from_numpy(
            {f: np.asarray(v) for f, v in carries._asdict().items()})
        with torch.no_grad():
            out = tctrl.step(t_carry, dict(tstatic,
                                           y0=torch.as_tensor(np.array(ys))))
        ys, carries, u0, res = jstep(ys, carries)
        r = out.result
        np.testing.assert_array_equal(r.converged.numpy(),
                                      np.asarray(res.converged))
        np.testing.assert_array_equal(r.outer_iterations.numpy(),
                                      np.asarray(res.outer_iterations))
        gap = np.abs(r.inner_iterations.numpy()
                     - np.asarray(res.inner_iterations))
        assert np.all(gap <= 2 * np.asarray(res.outer_iterations)), (k, gap)
        np.testing.assert_allclose(out.u0.numpy(), np.asarray(u0), rtol=0,
                                   atol=2e-3, err_msg=f"step {k}")
