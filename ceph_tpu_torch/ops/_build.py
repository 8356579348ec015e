"""Builds and loads the port's CUDA kernels (ops/csrc/*.cu).

Each source is compiled on first use by `nvcc` for Hopper (`sm_90a`) into
a shared library with a plain C interface, and loaded with ctypes. The
libraries go to `ceph_tpu_torch/_build/`, which git ignores; a library
older than its source is rebuilt. Every C entry point returns
`cudaGetLastError()` after its launch, and `check` raises if it is not 0.

A failed build raises `BuildError`. Nothing falls back to a kernel's plain
version on a CUDA tensor.

Pointers and the stream cross the C interface as `c_void_p`, lengths and
strides as `c_longlong`, so nothing is cut to 32 bits.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
KERNELS = ("gf_bitmatrix", "gf_bitmatrix_csum", "crc32c_blocks")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise BuildError("nvcc not found (looked on PATH and in CUDA_HOME)")


def so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def log_path(name: str) -> str:
    """nvcc's output for the last build of `name` (ptxas register and
    shared-memory counts)."""
    return os.path.join(BUILD_DIR, f"lib{name}.log")


def _stale(name: str) -> bool:
    src = os.path.join(CSRC, f"{name}.cu")
    so = so_path(name)
    return not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src)


def build(names=KERNELS) -> float:
    """Compile every stale source in `names`, one nvcc each, all started
    together. Returns the wall seconds taken (0 when nothing was stale)."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        tmp = f"{so_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        text = out.decode(errors="replace")
        with open(log_path(name), "w") as f:
            f.write(text)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, so_path(name))   # atomic: concurrent loaders see
                                         # the old library or the new one
    if failed:
        raise BuildError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed. `signatures`
    maps each C function to its argtypes; every one returns a C int (a
    cudaError_t)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(so_path(name))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            strerror = getattr(lib, f"{name}_strerror")
            strerror.argtypes = [ctypes.c_int]
            strerror.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = getattr(lib, f"{name}_strerror")(rc).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def ptr(tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(tensor.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current stream on `device`: kernels launch there and do
    not synchronise."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
