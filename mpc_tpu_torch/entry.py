"""The port's entry-point contracts (port of the repository's
``__graft_entry__.py``): a single-card step check and a multi-rank dry run.

    from mpc_tpu_torch.entry import entry, dryrun_multichip
    fn, args = entry()                  # the card; entry(device="cpu")
    u0, U = fn(*args)
    dryrun_multichip(1)                 # every card: torch.cuda.device_count()

Both run on the card unless the caller names the CPU.
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

from mpc_tpu_torch.config import AlmConfig, IlqrConfig, PanocConfig
from mpc_tpu_torch.control.mpc import (build_vehicle_controller,
                                       build_vehicle_ilqr_controller,
                                       resolve_device)
from mpc_tpu_torch.models.params import VehicleParams
from mpc_tpu_torch.ops.road import straight_centerline

#: seconds the ranks of a multi-rank dry run may take before all are killed
DRYRUN_TIMEOUT = 300


def entry(device=None):
    """One warm-started MPC solve (ALM + PANOC) of the Pacejka vehicle on a
    straight centerline, the headline's controller with ``max_iter=100``
    (``__graft_entry__.py:8-33``), as a batch of one lane. Returns ``(fn,
    (carry, y0))``; ``fn(carry, y0) -> (u0 (1, 2), U (1, 24))``. Its fan is
    kernel K1 on the card."""
    dev = resolve_device(device)
    ctrl = build_vehicle_controller(
        n_horiz=12, alm_cfg=AlmConfig(eps=1e-4),
        panoc_cfg=PanocConfig(lbfgs_memory=12, max_iter=100), device=dev)
    params = VehicleParams()
    cl = straight_centerline(100, device=dev)
    y0 = torch.tensor([[0.0, 0.0, 0.0, 0.5, 0.0, 0.0]], device=dev)
    carry = ctrl.init_carry(1)

    @torch.no_grad()
    def fn(carry, y0):
        out = ctrl.step(carry, {"y0": y0, "p": params, "centerline": cl})
        return out.u0, out.carry.U

    return fn, (carry, y0)


def dryrun_parts(dev: torch.device) -> dict:
    """The dry run's three parts on this rank of the world, at the JAX
    function's shapes (``__graft_entry__.py:36-131``); every rank runs it,
    and each part checks the shape and finiteness of its outputs. Returns
    the outputs' shapes, keyed by part."""
    import torch.distributed as dist
    from mpc_tpu_torch.parallel.lqr_sharded import make_lqt_horizon_sharded
    from mpc_tpu_torch.parallel.mesh import make_horizon_mesh, make_mesh
    from mpc_tpu_torch.parallel.sharding import make_sharded_vehicle_solver

    def check(name, t, shape):
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"dryrun {name}: shape {tuple(t.shape)} "
                               f"(expected {shape}), finite "
                               f"{bool(torch.isfinite(t).all())}")

    n_devices = dist.get_world_size()
    params = VehicleParams()
    # (scenario x model): scenarios over ranks, the centerline in chunks
    # over the model axis (the sequence-parallel road search)
    n_model = 2 if n_devices % 2 == 0 else 1
    n_scenario = n_devices // n_model
    mesh = make_mesh(n_scenario, n_model, device_type=dev.type)
    n_horiz, size, B = 4, 8 * n_model, 2 * n_scenario
    solve_batch = make_sharded_vehicle_solver(
        mesh, n_horiz=n_horiz, centerline_size=size,
        alm_cfg=AlmConfig(eps=1e-2),
        panoc_cfg=PanocConfig(lbfgs_memory=4, max_iter=5), device=dev)
    cl = straight_centerline(size, device=dev)
    y0s = torch.zeros((B, 6), device=dev)
    y0s[:, 3] = 0.5
    U0s = torch.tensor([1.0, 0.0], device=dev).repeat(n_horiz) \
        .expand(B, -1).clone()
    lam0s = torch.zeros((B, 6 * n_horiz), device=dev)
    us = solve_batch(y0s, cl, params, U0s, lam0s)[0]
    check("solver", us, (B, 2 * n_horiz))

    # (scenario x horizon): the horizon-sharded parallel-scan LQT
    n_h = 2 if n_devices % 2 == 0 else 1
    hmesh = make_horizon_mesh(n_devices // n_h, n_h, device_type=dev.type)
    rng = np.random.default_rng(0)
    Bb, N, n, m = 2 * (n_devices // n_h), 5, 4, 2
    A = (np.eye(n, dtype=np.float32)
         + 0.1 * rng.normal(0, 1, (Bb, N, n, n)).astype(np.float32))
    Bm = rng.normal(0, 0.3, (Bb, N, n, m)).astype(np.float32)
    x0 = rng.normal(0, 0.5, (Bb, n)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)          # noqa: E731
    eye = lambda k: torch.eye(k, device=dev)              # noqa: E731
    sol = make_lqt_horizon_sharded(hmesh)(
        t(x0), t(A), t(Bm), torch.zeros((Bb, N, n), device=dev),
        eye(n).expand(Bb, N, n, n), torch.zeros((Bb, N, n), device=dev),
        eye(m).expand(Bb, N, m, m), torch.zeros((Bb, N, m), device=dev),
        eye(n).expand(Bb, n, n), torch.zeros((Bb, n), device=dev))
    check("lqt", sol.us, (Bb, N, m))

    # one warm-started batched AL-iLQR MPC step on the constrained vehicle
    # OCP, every Riccati backward pass over the same horizon mesh
    bctrl = build_vehicle_ilqr_controller(
        n_horiz=4, bound_state_constraints=True,
        alm_cfg=AlmConfig(delta=1e-2, max_iter=2, sigma_0=1e3),
        ilqr_cfg=IlqrConfig(max_iter=3), mesh=hmesh, device=dev)
    Bv = 2 * (n_devices // n_h)
    y0v = torch.zeros((Bv, 6), device=dev)
    y0v[:, 3] = 0.5
    out = bctrl.step(bctrl.init_carry(Bv),
                     {"y0": y0v, "p": params, "centerline": cl})
    check("ilqr", out.u0, (Bv, 2))
    return {"solver": tuple(us.shape), "lqt": tuple(sol.us.shape),
            "ilqr": tuple(out.u0.shape)}


@torch.no_grad()
def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One full mesh-sharded MPC step at tiny shapes over ``n_devices``
    ranks (``__graft_entry__.py:36-131``): the (scenario x model) sharded
    vehicle solve, the horizon-sharded LQT and the batched AL-iLQR step
    (:func:`dryrun_parts`). The JAX function's ``devices=`` are the ranks
    here: one rank is one process with one device. ``n_devices = 1`` runs
    in this process as a world of one (reusing a world of one that is
    already set up); more start that many processes of
    ``parallel/_dist_worker.py``, NCCL with one rank per card, or gloo
    with ``device="cpu"``. Returns the parts' output shapes; a failed part
    raises."""
    import torch.distributed as dist
    from mpc_tpu_torch.parallel import _dist_worker
    from mpc_tpu_torch.parallel.distributed import initialize, rank_device

    dev = resolve_device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} ranks need as many cards; "
                         f"{torch.cuda.device_count()} present")
    if n_devices == 1:
        # the card of this process (cuda:LOCAL_RANK), as a rank takes it
        dev = rank_device(None if dev.type == "cuda" else dev)
        own = not dist.is_initialized()
        if own:
            initialize(None, dev, store=dist.HashStore(), rank=0,
                       world_size=1)
        elif dist.get_world_size() != 1:
            raise RuntimeError("dryrun_multichip(1) inside a world of "
                               f"{dist.get_world_size()} ranks")
        try:
            return dryrun_parts(dev)
        finally:
            if own:
                dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as work:
        out = _dist_worker.launch("dryrun", n_devices, work,
                                  device=dev.type, timeout=DRYRUN_TIMEOUT)
    return {k: tuple(int(v) for v in a) for k, a in out.items()}


if __name__ == "__main__":
    fn, args = entry()
    u0, U = fn(*args)
    print("entry ok:", tuple(u0.shape), tuple(U.shape))
