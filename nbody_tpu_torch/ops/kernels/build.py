"""Build and load the port's CUDA kernels.

Each ``nbody_tpu_torch/csrc/<name>.cu`` has a plain ``extern "C"``
interface.  At first use it is compiled with nvcc for Hopper
(``sm_90a``) into ``build/nbody_tpu_torch/lib<name>-<hash>.so`` at the
repository root and loaded with ctypes; the hash covers the source, the
headers of csrc/ and the flags, so an edited source or header is rebuilt
and a stale library is never loaded.
Nothing is compiled at import time: the CPU tests import every module and
this machine class has no nvcc.

The C entries take raw pointers and PyTorch's current stream (``stream``)
and return ``cudaGetLastError()`` after their launch; the Python wrappers
raise when it is not 0 (a refused launch never runs, and a later
synchronize would not report it).  A loaded library is returned without
taking a lock: at the narrow widths a wrapper's host work outlasts its
kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "nbody_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_name_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}
# per library: seconds nvcc took in this process (0.0 when it was cached)
# and the compiler's output (ptxas register / shared-memory report)
BUILD_INFO: Dict[str, dict] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(nvcc):
        return nvcc
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "nbody_tpu_torch build only where the CUDA toolkit is installed")


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    """Content-addressed library path for csrc/<name>.cu: the hash covers
    the source and every header of csrc/ (a .cu file includes them)."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [source_path(name)] + [os.path.join(CSRC_DIR, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _compile(name: str, out: str) -> dict:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed for {name}.cu "
                               f"(rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)   # atomic against a concurrent build
    return {"seconds": secs, "log": log}


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Build csrc/<name>.cu if needed, load it, and declare each entry's
    argument types (``signatures``: entry -> ctypes types).  Every entry
    returns an int (a cudaError_t).  Libraries of different names may be
    built concurrently from several threads (one nvcc each)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        path = library_path(name)
        info = {"seconds": 0.0, "log": ""}
        if not os.path.exists(path):
            info = _compile(name, path)
        lib = ctypes.CDLL(path)
        for entry, argtypes in signatures.items():
            fn = getattr(lib, entry)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        BUILD_INFO[name] = {"path": path, **info}
        _libs[name] = lib
        return lib


def stream(device_index: int) -> int:
    """The raw cudaStream_t of PyTorch's current stream on the device (what
    torch.cuda.current_stream(...).cuda_stream gives, without building a
    Stream object)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def check_launch(err: int, entry: str):
    if err != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed to launch: "
                           f"cudaError_t {err}")
