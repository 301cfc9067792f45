"""AL-iLQR inner iterations of the port against the JAX package at config
2's depth (ROADMAP Queue 3's first check): the ilqr_n40 controller (N=40,
bounded state constraints, ``AlmConfig(delta=1e-3, max_iter=8,
sigma_0=1e3, penalty_factor=5.0)``, ``IlqrConfig(max_iter=30)``) on the
first lanes of ilqr_n40's initial states and lane-change road, on the CPU,
the port stepped from JAX's state and carry each step.

The test runs the first ``STEPS`` steps and holds converged flags and
outer counts equal and the inner counts within 3 per outer iteration, with
means within 10%. The band is 3, not tests/test_torch_mpc_ilqr.py's 2 at
N=8: at N=40 the JAX package's own inner count moves by up to 3 when its
state or carry moves by one ulp (the exit ``rel < tol_dcost = 1e-7`` sits
below float32's resolution of the cost). Run as a script, it covers the
source's 5 + 40 steps and measures that spread:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_ilqr_depth.py
"""

import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mpc_tpu.config import AlmConfig
from mpc_tpu.control.mpc import build_vehicle_ilqr_controller
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.solver.ilqr import IlqrConfig
from mpc_tpu_torch import config as tconfig
from mpc_tpu_torch.bench import lane_change_road, ss_n40_states
from mpc_tpu_torch.control import mpc as tmpc
from mpc_tpu_torch.convert import carry_from_numpy
from mpc_tpu_torch.models.params import VehicleParams as TVehicleParams

torch.set_num_threads(1)

B, N, STEPS, SOURCE_STEPS = 4, 40, 8, 45
ALM = dict(delta=1e-3, max_iter=8, sigma_0=1e3, penalty_factor=5.0)
PARAMS = VehicleParams()
BAND = 3


@functools.lru_cache(maxsize=None)
def _setup():
    cl = lane_change_road()
    jcl = jnp.asarray(cl.numpy())
    jctrl = build_vehicle_ilqr_controller(
        n_horiz=N, bound_state_constraints=True, alm_cfg=AlmConfig(**ALM),
        ilqr_cfg=IlqrConfig(max_iter=30))
    f_d = discretize(pacejka_dynamics)

    @jax.jit
    def jstep(ys, carries):
        def one(y, carry):
            out = jctrl.step(carry, {"y0": y, "p": PARAMS, "centerline": jcl})
            return f_d(y, out.u0, PARAMS), out.carry, out.result
        return jax.vmap(one)(ys, carries)

    tctrl = tmpc.build_vehicle_ilqr_controller(
        n_horiz=N, bound_state_constraints=True,
        alm_cfg=tconfig.AlmConfig(**ALM),
        ilqr_cfg=tconfig.IlqrConfig(max_iter=30), device="cpu")
    return cl, jctrl, jstep, tctrl


def _compare(steps):
    """Per step: JAX's and the port's (fed) results, as numpy dicts; and
    the JAX states and carries each step started from."""
    cl, jctrl, jstep, tctrl = _setup()
    ys = jnp.asarray(ss_n40_states(256)[:B])
    carries = jax.vmap(lambda _: jctrl.init_carry())(jnp.arange(B))
    rows, starts = [], []
    for _ in range(steps):
        t_carry = carry_from_numpy(
            {f: np.asarray(v) for f, v in carries._asdict().items()})
        with torch.no_grad():
            out = tctrl.step(t_carry, {"y0": torch.as_tensor(np.array(ys)),
                                       "p": TVehicleParams(),
                                       "centerline": cl})
        starts.append((ys, carries))
        ys, carries, res = jstep(ys, carries)
        rows.append({f: (np.asarray(getattr(res, f)),
                         getattr(out.result, f).numpy())
                     for f in ("converged", "outer_iterations",
                               "inner_iterations")})
    return rows, starts


def test_inner_iterations_match_jax_at_the_source_depth():
    rows, _ = _compare(STEPS)
    for k, r in enumerate(rows):
        for f in ("converged", "outer_iterations"):
            np.testing.assert_array_equal(r[f][1], r[f][0],
                                          err_msg=f"step {k}: {f}")
        gap = np.abs(r["inner_iterations"][1] - r["inner_iterations"][0])
        assert np.all(gap <= BAND * r["outer_iterations"][0]), (k, gap)
    jm = np.mean([r["inner_iterations"][0] for r in rows])
    tm = np.mean([r["inner_iterations"][1] for r in rows])
    assert abs(tm - jm) <= 0.1 * jm, (tm, jm)


def _ulp_spread(ys, carries, trials=16, seed=0):
    """JAX's inner counts from ``ys``/``carries`` moved by one ulp
    (alternately the states and the carried inputs, each entry up, down
    or not at all): (min, max) per lane."""
    _, _, jstep, _ = _setup()
    rng = np.random.default_rng(seed)

    def nudge(a):
        d = rng.integers(-1, 2, size=a.shape)
        to = np.where(d > 0, np.inf, -np.inf).astype(np.float32)
        return np.where(d == 0, a, np.nextafter(a, to)).astype(np.float32)

    its = [np.asarray(jstep(ys, carries)[2].inner_iterations)]
    for t in range(trials):
        y, U = np.asarray(ys), np.asarray(carries.U)
        y, U = (nudge(y), U) if t % 2 == 0 else (y, nudge(U))
        its.append(np.asarray(jstep(jnp.asarray(y), carries._replace(
            U=jnp.asarray(U)))[2].inner_iterations))
    its = np.stack(its)
    return its.min(axis=0), its.max(axis=0)


def main():
    rows, starts = _compare(SOURCE_STEPS)
    ji = np.stack([r["inner_iterations"][0] for r in rows])
    ti = np.stack([r["inner_iterations"][1] for r in rows])
    jo = np.stack([r["outer_iterations"][0] for r in rows])
    gap = np.abs(ti - ji)
    over = [(int(k), int(b)) for k, b in zip(*np.nonzero(gap > 2 * jo))]
    spreads = {}
    for k, b in over:
        lo, hi = _ulp_spread(*starts[k])
        spreads[f"step {k} lane {b}"] = dict(
            jax=int(ji[k, b]), port=int(ti[k, b]),
            jax_one_ulp_min=int(lo[b]), jax_one_ulp_max=int(hi[b]))
    print(json.dumps({
        "steps": SOURCE_STEPS, "lanes": B,
        "jax_inner_mean": float(ji.mean()), "jax_inner_max": int(ji.max()),
        "port_inner_mean": float(ti.mean()), "port_inner_max": int(ti.max()),
        "flags_equal": all(np.array_equal(*r["converged"]) for r in rows),
        "outer_equal": all(np.array_equal(*r["outer_iterations"])
                           for r in rows),
        "gap_histogram": {int(g): int((gap == g).sum())
                          for g in np.unique(gap)},
        "beyond_2_per_outer": spreads}))


if __name__ == "__main__":
    sys.exit(main())
