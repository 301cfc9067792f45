"""The port's warm-start experiment (mpc_tpu_torch/examples/
exp_shift_warm.py) against the JAX package's, at batch 4 over 3 steps on
the straight road: the headline's controller warm-started verbatim and
with the plan shifted one stage (``warm_prep``). The port's script runs
each start through its ``run`` and ``controllers``, as its ``main`` does,
in a process of its own while the JAX package compiles; the JAX side is examples/exp_shift_warm.py's loop
(its initial states, its shift, its controller), both starts in one
compiled step.

Failures and the converged fraction must be equal. The mean total inner
iterations of a cold closed loop are set by rounding: over one-ulp moves
of the initial states (x, y and the speed, up and down) the JAX package's
own mean moves by up to some iterations (8.5 of 86.75 when this test was
written). Each package's count lies that far from a common centre, so the
port's must lie within twice the JAX package's largest move of the JAX
count, for both starts. That band cannot tell the two starts apart at
this size, so the shift itself is held exactly: the port's against the
JAX script's on a drawn plan, bit for bit, and each controller's hook.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.control.mpc import build_vehicle_controller
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.road import straight_centerline

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, N_SIM = 4, 3
#: the one-ulp moves of the JAX package's spread: (component, direction)
MOVES = tuple((c, d) for c in (0, 1, 3) for d in (np.inf, -np.inf))
PORT_TIMEOUT = 300


def jax_initial_states(cl) -> np.ndarray:
    """examples/exp_shift_warm.py:39-45."""
    rng = np.random.default_rng(0)
    y0s = np.zeros((BATCH, 6), np.float32)
    y0s[:, 0] = float(cl[0, 0])
    y0s[:, 1] = float(cl[0, 1]) + rng.uniform(-0.05, 0.05, BATCH)
    d0 = cl[1] - cl[0]
    y0s[:, 2] = float(jnp.arctan2(d0[1], d0[0]))
    y0s[:, 3] = rng.uniform(0.3, 1.0, BATCH)
    return y0s


def jax_shift(z, param, cold):
    """examples/exp_shift_warm.py:77-85."""
    del cold
    u = z.reshape(-1, 2)
    return jnp.concatenate([u[1:], u[-1:]], axis=0).reshape(-1)


def jax_runs():
    """The JAX loop of both starts in one compiled step: the verbatim start
    on the lanes and on their one-ulp moves (``MOVES``), the shifted start
    on the lanes, each lane choosing its start by a flag (the warm-start
    hook applies the shift where the flag holds and hands the plan back
    unchanged elsewhere). ``{name: (mean total inner iterations per draw,
    mean failures, mean converged fraction)}``, draw 0 the unmoved
    lanes."""
    import dataclasses

    params = VehicleParams()
    f_d = discretize(pacejka_dynamics)
    cl = straight_centerline(100)
    base = build_vehicle_controller(
        n_horiz=12, alm_cfg=AlmConfig(eps=1e-4),
        panoc_cfg=PanocConfig(lbfgs_memory=12, max_iter=300))
    y0s = jax_initial_states(cl)
    draws = [y0s]
    for comp, direction in MOVES:
        moved = y0s.copy()
        moved[:, comp] = np.nextafter(moved[:, comp], np.float32(direction))
        draws.append(moved)
    n_verbatim = BATCH * len(draws)
    ys = jnp.asarray(np.concatenate(draws + [y0s]))
    shifted = jnp.arange(ys.shape[0]) >= n_verbatim

    def one(y, c, shift):
        ctrl = dataclasses.replace(base, warm_prep=lambda z, p, cold: (
            jnp.where(shift, jax_shift(z, p, cold), z)))
        o = ctrl.step(c, {"y0": y, "p": params, "centerline": cl})
        return f_d(y, o.u0, params), o.carry, o.result.converged

    step = jax.jit(jax.vmap(one))
    carries = jax.vmap(lambda _: base.init_carry())(jnp.arange(ys.shape[0]))
    convs = []
    for _ in range(N_SIM):
        ys, carries, conv = step(ys, carries, shifted)
        convs.append(np.asarray(conv, np.float32))
    convs = np.stack(convs)                       # (N_SIM, lanes)
    tot = np.asarray(carries.tot_it, np.float64).reshape(-1, BATCH)
    fails = np.asarray(carries.failures, np.float64).reshape(-1, BATCH)
    conv = convs.reshape(N_SIM, -1, BATCH).mean(axis=(0, 2))
    k = len(draws)
    return {"straight_verbatim": (tot[:k].mean(axis=1), float(fails[0].mean()),
                                  float(conv[0])),
            "straight_shifted": (tot[k:].mean(axis=1), float(fails[k].mean()),
                                 float(conv[k]))}


#: one start of the port's script in a process of its own: its ``run``
#: with its controllers, as its ``main`` calls them
PORT_START = """
import sys
import torch
from mpc_tpu_torch.examples import exp_shift_warm as m
from mpc_tpu_torch.ops.road import straight_centerline
start, n_sim, batch = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dev = torch.device("cpu")
with torch.no_grad():
    m.run("straight_" + start, m.controllers(dev)[start],
          straight_centerline(100), dev, n_sim, batch)
"""


@pytest.fixture(scope="module")
def runs():
    """``(port's rows by name, JAX's runs)``: the port's two starts run in
    processes of their own while the JAX package compiles."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", PORT_START, start, str(N_SIM), str(BATCH)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for start in ("verbatim", "shifted")]
    try:
        ref = jax_runs()
        outs = [p.communicate(timeout=PORT_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    rows = {}
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        row = json.loads(out.splitlines()[-1])
        rows[row["exp"]] = row
    return rows, ref


def test_rows_carry_the_jax_keys(runs):
    port, _ = runs
    assert sorted(port) == ["straight_shifted", "straight_verbatim"]
    for r in port.values():
        assert {"exp", "batch", "n_sim", "mean_total_inner_iters",
                "mean_failures", "mean_converged_fraction"} <= set(r)
        assert (r["batch"], r["n_sim"]) == (BATCH, N_SIM)
        assert r["states_finite"] and r["k1_launches"] == 0


def test_shift_is_the_jax_scripts():
    from mpc_tpu_torch.examples import exp_shift_warm as m
    z = np.random.default_rng(11).standard_normal((BATCH, 24)).astype(
        np.float32)
    got = m.shift(torch.from_numpy(z), None, None).numpy()
    for lane in range(BATCH):
        want = np.asarray(jax_shift(jnp.asarray(z[lane]), None, None))
        assert np.array_equal(got[lane].view(np.int32),
                              want.view(np.int32)), lane
    ctrls = m.controllers(torch.device("cpu"))
    assert ctrls["shifted"].warm_prep is m.shift
    assert ctrls["verbatim"].warm_prep is None


@pytest.mark.parametrize("name", ["straight_verbatim", "straight_shifted"])
def test_shift_warm_matches_jax(runs, name):
    port, ref = runs
    spread = ref["straight_verbatim"][0]
    band = 2.0 * float(np.abs(spread[1:] - spread[0]).max())
    tot, fails, conv = ref[name]
    r = port[name]
    assert r["mean_failures"] == round(fails, 3)
    assert r["mean_converged_fraction"] == round(conv, 4)
    assert abs(r["mean_total_inner_iters"] - tot[0]) <= band, (
        r["mean_total_inner_iters"], tot[0], band)
