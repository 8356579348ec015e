"""bufferlist-lite: zero-copy scatter/gather byte buffers.

Re-creation of the reference's `ceph::bufferlist` core semantics
(src/include/buffer.h, src/common/buffer.cc): a list of refcounted
segments (`Ptr` = memoryview window) supporting O(1) append/claim,
zero-copy `substr_of`, lazily cached crc32c, and `rebuild_aligned` for
kernels that need contiguous aligned memory. numpy-backed so segments
interop directly with the codec data path.

The port's copy of ceph_tpu/utils/buffer.py (jax-free; the
port imports nothing of the JAX package).
"""
from __future__ import annotations

import time

import numpy as np

from ceph_tpu_torch.utils import copytrack, sanitizer


class Ptr:
    """A window onto a shared byte buffer (buffer::ptr). `owned` marks
    memory this module allocated itself (safe to cache checksums over);
    windows onto caller arrays are unowned — an external writer can mutate
    them at any time."""

    __slots__ = ("raw", "offset", "length", "owned")

    def __init__(self, raw: np.ndarray, offset: int = 0,
                 length: int | None = None, owned: bool = False):
        self.raw = raw
        self.offset = offset
        self.length = raw.size - offset if length is None else length
        self.owned = owned

    def view(self) -> np.ndarray:
        return self.raw[self.offset:self.offset + self.length]

    def substr(self, off: int, length: int) -> "Ptr":
        if off + length > self.length:
            raise ValueError("substr out of range")
        return Ptr(self.raw, self.offset + off, length, self.owned)


class BufferList:
    """Segment list with zero-copy substr + cached crc32c."""

    def __init__(self, data: bytes | bytearray | np.ndarray | None = None):
        self._ptrs: list[Ptr] = []
        self._length = 0
        self._crc_cache: dict[tuple[int, int], int] = {}
        if data is not None:
            self.append(data)

    def __len__(self) -> int:
        return self._length

    @property
    def num_segments(self) -> int:
        return len(self._ptrs)

    def _invalidate(self) -> None:
        self._crc_cache.clear()

    # -- building ------------------------------------------------------------

    def append(self, data) -> "BufferList":
        """Append bytes/array/Ptr/BufferList. Arrays and Ptrs are shared
        zero-copy; bytes are copied once into a new segment."""
        # numpy boundary: a sanitizer-guarded rx view unwraps here with
        # its use-after-recycle check, then adopts reference-only like
        # any other memoryview
        data = sanitizer.unwrap(data)
        if isinstance(data, BufferList):
            self._ptrs.extend(data._ptrs)
            self._length += data._length
            copytrack.referenced("frame_to_buffer", data._length)
        elif isinstance(data, Ptr):
            self._ptrs.append(data)
            self._length += data.length
            copytrack.referenced("frame_to_buffer", data.length)
        elif isinstance(data, np.ndarray):
            arr = data.reshape(-1).view(np.uint8)
            self._ptrs.append(Ptr(arr))
            self._length += arr.size
            copytrack.referenced("frame_to_buffer", arr.size)
        elif isinstance(data, memoryview):
            # zero-copy rx discipline: a frame segment window is adopted
            # reference-only (frame_rx -> frame_to_buffer without a
            # bytes() materialization); the recv buffer stays alive via
            # the view's refcount. Read-only by construction — exactly
            # like an unowned caller-array window.
            arr = np.frombuffer(data, dtype=np.uint8)
            self._ptrs.append(Ptr(arr))
            self._length += arr.size
            copytrack.referenced("frame_to_buffer", arr.size)
        else:
            t0 = time.perf_counter()
            arr = np.frombuffer(bytes(data), dtype=np.uint8).copy()
            self._ptrs.append(Ptr(arr, owned=True))
            self._length += arr.size
            copytrack.copied("frame_to_buffer", arr.size,
                             time.perf_counter() - t0)
        self._invalidate()
        return self

    def claim_append(self, other: "BufferList") -> "BufferList":
        """Move other's segments onto the end of self (claim_append)."""
        self._ptrs.extend(other._ptrs)
        self._length += other._length
        other._ptrs = []
        other._length = 0
        other._invalidate()
        self._invalidate()
        return self

    # -- slicing -------------------------------------------------------------

    def substr_of(self, other: "BufferList", off: int, length: int) -> None:
        """Make self a zero-copy window [off, off+length) of other."""
        if off + length > other._length:
            raise ValueError(
                f"substr [{off},{off + length}) exceeds {other._length}")
        source = list(other._ptrs)  # snapshot: `other` may alias self
        self._ptrs = []
        self._length = 0
        self._invalidate()
        pos = 0
        for ptr in source:
            seg_end = pos + ptr.length
            if seg_end <= off:
                pos = seg_end
                continue
            if pos >= off + length:
                break
            lo = max(off, pos) - pos
            hi = min(off + length, seg_end) - pos
            self._ptrs.append(ptr.substr(lo, hi - lo))
            self._length += hi - lo
            pos = seg_end

    def substr(self, off: int, length: int) -> "BufferList":
        out = BufferList()
        out.substr_of(self, off, length)
        return out

    # -- materializing -------------------------------------------------------

    def is_contiguous(self) -> bool:
        return len(self._ptrs) <= 1

    def to_array(self) -> np.ndarray:
        """Contiguous uint8 array; zero-copy when single-segment."""
        if not self._ptrs:
            return np.zeros(0, dtype=np.uint8)
        if len(self._ptrs) == 1:
            return self._ptrs[0].view()
        t0 = time.perf_counter()
        out = np.concatenate([p.view() for p in self._ptrs])
        copytrack.copied("buffer_to_staging", out.size,
                         time.perf_counter() - t0)
        return out

    def to_bytes(self) -> bytes:
        return self.to_array().tobytes()

    def rebuild(self) -> None:
        """Coalesce into one contiguous segment (buffer::list::rebuild)."""
        if len(self._ptrs) > 1:
            t0 = time.perf_counter()
            arr = np.concatenate([p.view() for p in self._ptrs])
            copytrack.copied("buffer_to_staging", arr.size,
                             time.perf_counter() - t0)
            self._ptrs = [Ptr(arr, owned=True)]
            self._invalidate()

    def rebuild_aligned(self, align: int) -> np.ndarray:
        """Contiguous view whose length is padded up to `align` — the
        rebuild_aligned_size_and_memory entry the EC path uses. Returns the
        padded array (original length stays len(self))."""
        arr = self.to_array()
        pad = (-arr.size) % align
        owned = pad > 0 or len(self._ptrs) != 1 or self._ptrs[0].owned
        if pad:
            t0 = time.perf_counter()
            arr = np.concatenate([arr, np.zeros(pad, dtype=np.uint8)])
            copytrack.copied("buffer_to_staging", arr.size,
                             time.perf_counter() - t0)
            self._ptrs = [Ptr(arr, 0, self._length, owned=True)]
        else:
            self._ptrs = [Ptr(arr, owned=owned)]
        self._invalidate()
        return arr

    # -- integrity -----------------------------------------------------------

    def crc32c(self, seed: int = 0xFFFFFFFF) -> int:
        """crc32c of the content, cached per (seed, length) until the list
        is modified (bufferlist crc caching semantics)."""
        cacheable = all(p.owned for p in self._ptrs)
        key = (seed, self._length)
        if cacheable:
            cached = self._crc_cache.get(key)
            if cached is not None:
                return cached
        from ceph_tpu_torch.native import ec_native
        crc = ec_native.crc32c(self.to_array(), seed)
        if cacheable:
            self._crc_cache[key] = crc
        return crc

    def contents_equal(self, other: "BufferList") -> bool:
        if self._length != other._length:
            return False
        return np.array_equal(self.to_array(), other.to_array())
