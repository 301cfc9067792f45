"""ctypes loader of the native C++ scenario generator (port of
mpc_tpu/io/native_scenarios.py).

Both packages draw their scenario suites from one source,
``native/scenario_gen.cpp``: a C++ thread pool that fills the roads,
initial states and obstacles of a batch, deterministic per (seed, scenario)
and independent of the thread count. This loader compiles it with ``g++``
on first use into ``build/mpc_tpu_torch/`` (git-ignored), under a name that
hashes the source and the flags, so an edited source is rebuilt; the flags
are the JAX loader's, so both libraries give the same bits. A missing
compiler, a failed build or a wrong ABI version raises: there is no
fallback to another generator.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np
import torch

from mpc_tpu_torch.kernels.build import BUILD_DIR

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC = os.path.join(_REPO_ROOT, "native", "scenario_gen.cpp")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread")
ABI_VERSION = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build(src: str) -> str:
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"libscenario_gen_{tag.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *CXX_FLAGS, src, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"mpc_tpu_torch: g++ failed for {src} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The generator's library, built from :data:`SRC` on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build(SRC))
            lib.mpc_generate_scenarios.argtypes = [
                ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int]
            lib.mpc_generate_scenarios.restype = None
            lib.mpc_scenario_gen_abi_version.restype = ctypes.c_int
            abi = lib.mpc_scenario_gen_abi_version()
            if abi != ABI_VERSION:
                raise RuntimeError(f"mpc_tpu_torch: scenario generator ABI "
                                   f"{abi}, expected {ABI_VERSION}")
            _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the generator builds and loads here
    (mpc_tpu/io/native_scenarios.py:70-71). Where it does not,
    :func:`generate_scenarios` raises."""
    try:
        load()
    except (OSError, RuntimeError):     # no g++, a failed build, a wrong ABI
        return False
    return True


def generate_scenarios(seed: int, batch: int, size: int = 100,
                       n_obstacles: int = 2, n_threads: int = 0,
                       device=None):
    """A ``sim.scenarios.ScenarioBatch`` from the native generator: roads
    (batch, size, 2), initial states (batch, 6), obstacles
    (batch, n_obstacles, 4), float32 tensors on ``device`` (None: the card,
    as the port's entry points default; pass ``device="cpu"`` for the
    CPU). ``n_threads <= 0`` uses every hardware thread."""
    from mpc_tpu_torch.control.mpc import resolve_device
    from mpc_tpu_torch.sim.scenarios import ScenarioBatch

    device = resolve_device(device)
    lib = load()
    cl = np.empty((batch, size, 2), np.float32)
    y0 = np.empty((batch, 6), np.float32)
    obs = np.empty((batch, n_obstacles, 4), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.mpc_generate_scenarios(
        ctypes.c_uint64(seed), batch, size, n_obstacles,
        cl.ctypes.data_as(fp), y0.ctypes.data_as(fp), obs.ctypes.data_as(fp),
        n_threads)
    return ScenarioBatch(y0=torch.as_tensor(y0, device=device),
                         centerline=torch.as_tensor(cl, device=device),
                         obstacles=torch.as_tensor(obs, device=device))


class ScenarioPrefetcher:
    """Double-buffered background generation: the next batch is produced on
    a host thread while the device consumes the current one."""

    def __init__(self, seed: int, batch: int, size: int = 100,
                 n_obstacles: int = 2, device=None):
        self._seed = seed
        self._batch = batch
        self._size = size
        self._n_obs = n_obstacles
        self._device = device
        self._idx = 0
        self._pending = None
        self._kick()

    def _gen(self, idx):
        return generate_scenarios(self._seed + idx, self._batch, self._size,
                                  self._n_obs, device=self._device)

    def _kick(self):
        idx = self._idx
        result = {}

        def run():
            try:
                result["batch"] = self._gen(idx)
            except Exception as e:      # raised again by next()
                result["error"] = e

        t = threading.Thread(target=run, daemon=True)
        t.start()
        self._pending = (t, result)

    def next(self):
        t, result = self._pending
        t.join()
        if "error" in result:
            raise result["error"]
        out = result["batch"]
        self._idx += 1
        self._kick()
        return out
