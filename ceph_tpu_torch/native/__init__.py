"""ctypes loader for the repo's native host C++ kernels (native/ec_native.cc).

The port's own copy of the JAX package's loader: it builds the same
source, `native/ec_native.cc` at the repository root, with g++ on first
use into the port's build directory `ceph_tpu_torch/_build/` (rebuilt
when the source is newer). `ec_native` wraps the GF(2^8) host codec and
the crc32c helpers, `frame_native` the msgr2 frame codec (`frame_pack` /
`frame_verify_body`); they raise NativeUnavailable cleanly if no
compiler exists.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(_HERE))
_SRC = os.path.join(_REPO, "native", "ec_native.cc")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_SO = os.path.join(_BUILD_DIR, "libec_native.so")

_lock = threading.Lock()
_lib = None


class NativeUnavailable(RuntimeError):
    pass


def _build() -> str:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        raise NativeUnavailable(
            f"building {_SO} failed: {e} {detail.decode(errors='replace')}") from e
    os.replace(tmp, _SO)   # atomic: concurrent loaders see old or new
    return _SO


def load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            u8p = ctypes.POINTER(ctypes.c_uint8)
            u32p = ctypes.POINTER(ctypes.c_uint32)
            lib.gf256_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                         u8p, u8p, u8p, ctypes.c_size_t]
            lib.gf256_encode.restype = None
            lib.crc32c.restype = ctypes.c_uint32
            lib.crc32c.argtypes = [ctypes.c_uint32, u8p, ctypes.c_size_t]
            lib.crc32c_blocks.argtypes = [u8p, ctypes.c_size_t,
                                          ctypes.c_size_t, ctypes.c_uint32,
                                          u32p]
            lib.crc32c_blocks.restype = None
            # msgr2 frame codec: pointer-sized arguments must be declared,
            # or ctypes passes them as C ints
            u64p = ctypes.POINTER(ctypes.c_uint64)
            lib.frame_pack.restype = ctypes.c_uint64
            lib.frame_pack.argtypes = [
                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
                u64p, ctypes.POINTER(ctypes.c_char_p), u64p,
                ctypes.c_void_p]
            lib.frame_verify_body.restype = ctypes.c_int
            lib.frame_verify_body.argtypes = [ctypes.c_void_p, u64p,
                                              ctypes.c_int]
            _lib = lib
    return _lib
