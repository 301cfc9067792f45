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


def load_fused_psi() -> ctypes.CDLL:
    """The fan kernel's library (``csrc/fused_psi.cu``), built on first use."""
    with _lock:
        lib = _loaded.get("fused_psi")
        if lib is None:
            lib = ctypes.CDLL(build("fused_psi")["path"])
            fn = lib.mpc_fused_psi_fan
            fn.argtypes = ([ctypes.c_void_p] * 6
                           + [ctypes.c_int] * 4
                           + [ctypes.c_double]
                           + [ctypes.c_float] * 7
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _loaded["fused_psi"] = lib
        return lib
