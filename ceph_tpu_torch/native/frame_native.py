"""ctypes wrapper over the native msgr2 frame codec (native/ec_native.cc
`frame_pack` / `frame_verify_body`).

One C call packs a whole frame — preamble build, every segment copy, and
every crc32c pass — or verifies a received body's per-segment crcs, in
place of the per-segment Python/ctypes loop frames.py otherwise runs.
The call releases the GIL (plain ctypes CDLL semantics), which is what
lets reactor shards overlap their frame hot paths. The wire layout is
bit-identical to the pure-Python path; frames.py probes `available()`
at import and silently keeps the Python fallback when the library (or a
compiler to build it) is missing.

Segments are bytes-likes or LISTS of bytes-likes (scatter segments, the
sub-op batch envelope's concatenated message datas): parts are flattened
into one pointer array so each byte is copied exactly once, straight
into the wire blob.

This wrapper is on the per-frame hot path, so pointer extraction avoids
numpy where it can: bytes ride ctypes' native c_char_p conversion
(zero-copy, ~0.5µs) and writable buffers go through c_char.from_buffer
(~0.4µs); only READ-ONLY non-bytes buffers (rx memoryview windows) pay
the np.frombuffer fallback (~2.7µs) — profiled, the difference was ~10µs
a frame, real money at tens of thousands of frames per second.

The port's copy of ceph_tpu/native/frame_native.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import ctypes

_lib = None
_checked = False

_c_char = ctypes.c_char
_c_char_p = ctypes.c_char_p
_c_u64 = ctypes.c_uint64
_addressof = ctypes.addressof
_cast = ctypes.cast


def available() -> bool:
    """True when the native library loads and carries the frame codec.
    Never raises: callers use this as the import-time probe."""
    global _lib, _checked
    if _checked:
        return _lib is not None
    _checked = True
    try:
        from ceph_tpu_torch import native
        lib = native.load()
    except Exception:
        return False
    if not hasattr(lib, "frame_pack"):
        return False
    _lib = lib
    return True


def _fill_ptr(ptrs, i, part, keep) -> None:
    """Point ptrs[i] at `part`'s buffer without copying."""
    if type(part) is bytes:
        ptrs[i] = part              # ctypes borrows the bytes' pointer
        keep.append(part)
        return
    try:
        c = _c_char.from_buffer(part)       # writable buffers
    except (TypeError, ValueError, BufferError):
        import numpy as np
        arr = np.frombuffer(part, dtype=np.uint8)   # read-only views
        keep.append(arr)
        ptrs[i] = _cast(arr.ctypes.data, _c_char_p)
        return
    keep.append(c)
    ptrs[i] = _cast(_addressof(c), _c_char_p)


def pack(magic: int, tag: int, segments: list) -> bytearray:
    """Wire form of one frame: preamble + segments with trailing crcs,
    built in a single native call. A segment may be a list/tuple of
    parts (scatter segment); its crc chains across the parts."""
    nseg = len(segments)
    seg_parts = (_c_u64 * nseg)() if nseg else None
    flat: list = []
    for i, seg in enumerate(segments):
        if isinstance(seg, (list, tuple)):
            seg_parts[i] = len(seg)
            flat.extend(seg)
        else:
            seg_parts[i] = 1
            flat.append(seg)
    n = len(flat)
    ptrs = (_c_char_p * n)() if n else None
    lens = (_c_u64 * n)() if n else None
    keep: list = []
    total = 8 + 8 * nseg
    for i, part in enumerate(flat):
        ln = len(part)
        lens[i] = ln
        total += ln
        if ln:
            _fill_ptr(ptrs, i, part, keep)
    out = bytearray(total)
    wrote = _lib.frame_pack(
        magic, tag, nseg, seg_parts, ptrs, lens,
        _addressof(_c_char.from_buffer(out)))
    assert wrote == total, (wrote, total)
    return out


def verify_body(body, seg_lens: list[int]) -> int:
    """Per-segment crc verification of a received frame body (runs of
    [seg bytes | crc u32]): -1 = all good, else the index of the first
    bad segment. The caller validated the preamble (and with it the
    lengths) already."""
    n = len(seg_lens)
    if not n:
        return -1
    lens = (_c_u64 * n)(*seg_lens)
    if type(body) is bytes:
        return _lib.frame_verify_body(body, lens, n)
    try:
        addr = _addressof(_c_char.from_buffer(body))
    except (TypeError, ValueError, BufferError):
        import numpy as np
        arr = np.frombuffer(body, dtype=np.uint8)
        return _lib.frame_verify_body(arr.ctypes.data, lens, n)
    return _lib.frame_verify_body(addr, lens, n)
