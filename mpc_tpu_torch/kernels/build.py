"""Build and load the port's CUDA kernels.

Each kernel is a ``.cu`` file under ``mpc_tpu_torch/csrc`` with a plain C
entry point. It is compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library on first use and bound with ``ctypes``; no PyTorch headers
are involved, so a build takes seconds. The library is named by a hash of
the source and the flags, in ``build/mpc_tpu_torch/`` beside the package
(listed in ``.gitignore``), so an edited source is rebuilt and an unchanged
one is loaded as it is. A missing ``nvcc``, a failed build or a failed load
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "mpc_tpu_torch")

#: -fmad=false: no multiply-add contraction, so the kernels round each
#: operation as PyTorch's elementwise kernels do (see csrc/fused_psi.cu)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: the toolkit PyTorch found (``CUDA_HOME``), else PATH."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("mpc_tpu_torch: nvcc not found (no CUDA toolkit); "
                           "the CUDA kernels cannot be built")
    return path


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags exists. Returns ``{"path", "built", "seconds", "log"}``; ``log``
    holds nvcc's output (``-Xptxas -v``: registers, shared memory, spills)."""
    src = os.path.join(_CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return {"path": out, "built": False, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"mpc_tpu_torch: nvcc failed for {src} "
                           f"(exit {proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return {"path": out, "built": True, "seconds": seconds,
            "log": proc.stdout + proc.stderr}


def check_operand(who: str, name: str, t, shape, device, dtype=None):
    """Raise unless ``t`` is a contiguous tensor of ``shape`` and ``dtype``
    (float32 by default) on ``device``: what a kernel's wrapper checks of
    each operand before it hands the kernel a pointer (``who`` names the
    wrapper in the message)."""
    import torch
    dtype = torch.float32 if dtype is None else dtype
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{who}: {name} must be a tensor")
    if t.dtype != dtype:
        raise TypeError(f"{who}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{who}: {name} is on {t.device}, u is on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def load_fused_psi() -> ctypes.CDLL:
    """The fan kernels' library (``csrc/fused_psi.cu``: K1
    ``mpc_fused_psi_fan``, on one road or per-lane roads, and K2
    ``mpc_fused_psi_fan_kin``, instances of the phased kernel, with its
    ``mpc_fused_psi_fan_plan``; K3 ``mpc_fused_psi_fan_al``, three kernels
    through a device scratch), built on first use."""
    with _lock:
        lib = _loaded.get("fused_psi")
        if lib is None:
            lib = ctypes.CDLL(build("fused_psi")["path"])
            # after the pointers: E, n_horiz, n_cl, substeps, h, v_ref,
            # the 6 weights and the stream
            tail = ([ctypes.c_int] * 4 + [ctypes.c_double]
                    + [ctypes.c_float] * 7 + [ctypes.c_void_p])
            lib.mpc_fused_psi_fan_kin.argtypes = [ctypes.c_void_p] * 6 + tail
            lib.mpc_fused_psi_fan_kin.restype = ctypes.c_int
            # K3: 12 device pointers (the scratch last), then the scratch's
            # floats
            lib.mpc_fused_psi_fan_al.argtypes = (
                [ctypes.c_void_p] * 12 + [ctypes.c_longlong] + tail)
            lib.mpc_fused_psi_fan_al.restype = ctypes.c_int
            # K1: the road stride before the stream
            lib.mpc_fused_psi_fan.argtypes = (
                [ctypes.c_void_p] * 6 + tail[:-1]
                + [ctypes.c_int, ctypes.c_void_p])
            lib.mpc_fused_psi_fan.restype = ctypes.c_int
            # sd, E, n_horiz, n_cl, road stride -> lanes per block,
            # shared-memory bytes
            lib.mpc_fused_psi_fan_plan.argtypes = (
                [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2)
            lib.mpc_fused_psi_fan_plan.restype = ctypes.c_int
            _loaded["fused_psi"] = lib
        return lib


def load_panoc_direction() -> ctypes.CDLL:
    """PANOC's direction kernel's library (``csrc/panoc_direction.cu``:
    ``mpc_panoc_direction``), built on first use."""
    with _lock:
        lib = _loaded.get("panoc_direction")
        if lib is None:
            lib = ctypes.CDLL(build("panoc_direction")["path"])
            # 15 tensors; B, n, M; tr_mult; the taus' two float arrays and
            # their count; the stream
            lib.mpc_panoc_direction.argtypes = (
                [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3 + [ctypes.c_float]
                + [ctypes.POINTER(ctypes.c_float)] * 2
                + [ctypes.c_int, ctypes.c_void_p])
            lib.mpc_panoc_direction.restype = ctypes.c_int
            _loaded["panoc_direction"] = lib
        return lib
