"""numpy-facing wrappers over the native C++ host kernels.

The port's copy of ceph_tpu/native/ec_native.py. `encode(M, data, out)` is
the host-CPU equivalent of the reference isa plugin's `ec_encode_data`
call (src/erasure-code/isa/ErasureCodeIsa.cc:129): split-nibble SIMD
multiply tables, precomputed per coefficient. It is the jerasure plugin's
codec for host arrays and the benchmark's `--mode native` baseline;
`crc32c` is the byte-serial seeded crc behind HashInfo and the
Checksummer's host path.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from ceph_tpu_torch import native
from ceph_tpu_torch.ec import gf256

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


@functools.lru_cache(maxsize=1)
def _split_tables() -> np.ndarray:
    """(256, 32) uint8: row c = [c*v for v<16] + [c*(v<<4) for v<16]."""
    t = np.zeros((256, 32), dtype=np.uint8)
    lo = np.arange(16, dtype=np.uint8)
    for c in range(256):
        t[c, :16] = gf256.GF_MUL_TABLE[c, lo]
        t[c, 16:] = gf256.GF_MUL_TABLE[c, lo << 4]
    return np.ascontiguousarray(t)


def encode(M: np.ndarray, data: np.ndarray, out: np.ndarray) -> np.ndarray:
    """out(m,n) = M(m,k) @ data(k,n) over GF(2^8), via the C++ kernel."""
    lib = native.load()
    M = np.ascontiguousarray(M, dtype=np.uint8)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    m, k = M.shape
    kd, n = data.shape
    if kd != k:
        raise ValueError(f"matrix expects {k} chunks, data has {kd}")
    if out.shape != (m, n) or out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError("out must be C-contiguous uint8 of shape (m, n)")
    lib.gf256_encode(_ptr(M), m, k, _ptr(_split_tables()), _ptr(data),
                     _ptr(out), n)
    return out


def crc32c(data: bytes | np.ndarray, crc: int = 0xFFFFFFFF) -> int:
    """Castagnoli CRC with ceph's seed convention (crc32c(-1) default).
    Accepts bytes-likes (strided memoryviews are materialized), arrays
    and the sanitizer's guarded views."""
    lib = native.load()
    if type(data).__name__ == "GuardedView":
        # sanitizer-guarded rx view: checked unwrap at the native
        # boundary (lazy import: native must not depend on utils)
        from ceph_tpu_torch.utils.sanitizer import unwrap
        data = unwrap(data)
    if isinstance(data, memoryview) and not data.c_contiguous:
        data = bytes(data)
    if isinstance(data, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(data, dtype=np.uint8)
    else:
        arr = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    return int(lib.crc32c(ctypes.c_uint32(crc & 0xFFFFFFFF), _ptr(arr),
                          arr.size))


def crc32c_blocks(data: np.ndarray, block_size: int,
                  seed: int = 0xFFFFFFFF) -> np.ndarray:
    """Per-block CRCs of a (nblocks*block_size,) or (nblocks, block_size)
    buffer — the Checksummer batch path."""
    lib = native.load()
    arr = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    if arr.size % block_size:
        raise ValueError("buffer not a multiple of block_size")
    nb = arr.size // block_size
    out = np.zeros(nb, dtype=np.uint32)
    lib.crc32c_blocks(_ptr(arr), nb, block_size,
                      ctypes.c_uint32(seed & 0xFFFFFFFF),
                      out.ctypes.data_as(_u32p))
    return out


def available() -> bool:
    try:
        native.load()
        return True
    except native.NativeUnavailable:
        return False
