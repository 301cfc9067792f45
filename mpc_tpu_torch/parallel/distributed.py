"""Process-group set-up and per-rank data placement (port of
mpc_tpu/parallel/distributed.py).

The JAX package initialises ``jax.distributed`` and builds one mesh over
every host's devices. Here each rank is a process with one device:

    from mpc_tpu_torch.parallel.distributed import initialize, pod_mesh
    initialize()                  # nothing to do in a single process
    mesh = pod_mesh(n_model=1)    # scenario axis over every rank

run under ``torchrun --nproc_per_node=<gpus>``, which sets ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``. The backend
is NCCL for ranks on a card and gloo for ranks on the CPU, unless the caller
names one; nothing switches backend silently, and a failed NCCL
initialisation raises. A rank's device is ``cuda:{LOCAL_RANK}`` unless the
caller asks for the CPU.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from mpc_tpu_torch.parallel.mesh import GROUP_TIMEOUT, make_mesh


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` where the caller names one, else the
    card of index ``LOCAL_RANK`` (modulo the cards present). Without a card
    a default call raises, as the port's entry points do."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("mpc_tpu_torch.parallel: no CUDA device; pass "
                           "device=\"cpu\" to run a rank on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize(backend: Optional[str] = None, device=None, *,
               store=None, rank: Optional[int] = None,
               world_size: Optional[int] = None) -> None:
    """Initialise the default process group of a multi-process run.

    Without arguments it reads torchrun's environment and does nothing in a
    single process (``WORLD_SIZE`` unset or 1), so that one script runs
    everywhere. ``store``, ``rank`` and ``world_size`` set the group up
    without that environment (the tests' ``FileStore``, or a
    ``HashStore`` for a world of one in a single process). ``backend``
    defaults to NCCL for a rank on a card and gloo on the CPU; ``device`` is
    :func:`rank_device`'s. Every group gets ``mesh.GROUP_TIMEOUT``."""
    if dist.is_initialized():
        return
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if store is None and rank is None and world_size == 1:
        return
    if rank is None:
        rank = int(os.environ["RANK"])
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(store=store) if store is not None else dict(init_method="env://")
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            timeout=GROUP_TIMEOUT, **kw)


def initialize_world(device=None, backend: Optional[str] = None) -> None:
    """:func:`initialize` from torchrun's environment where it is set, else a
    world of one rank in this process (an in-memory ``HashStore``): the
    sharded entry points then run over the one device, their collectives
    copies."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        initialize(backend, device)
    else:
        initialize(backend, device, store=dist.HashStore(), rank=0,
                   world_size=1)


def pod_mesh(n_model: int = 1, device_type: Optional[str] = None):
    """The (scenario, model) mesh over every rank of the world, the model
    axis innermost: with ranks numbered by host, a model group stays on one
    host and only the scenario axis, which does not communicate during a
    solve, spans hosts."""
    n = dist.get_world_size()
    if n % n_model:
        raise ValueError(f"{n} devices not divisible by model axis "
                         f"{n_model}")
    return make_mesh(n // n_model, n_model, device_type)


def local_batch_slice(global_batch: int) -> slice:
    """The rows of a global scenario batch this process feeds: its share by
    rank (``jax.make_array_from_process_local_data``'s hosting)."""
    p = dist.get_rank() if dist.is_initialized() else 0
    n = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    per = global_batch // n
    return slice(p * per, (p + 1) * per)
