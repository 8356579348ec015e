"""Erasure-code plugin interface + base class.

Re-creation of the reference's plugin contract in idiomatic Python
(reference: src/erasure-code/ErasureCodeInterface.h:170-476 and
src/erasure-code/ErasureCode.{h,cc}); the C++ ABI mirror lives under
native/. A code is *systematic*: k data chunks + m coding chunks; any k of
the k+m suffice to reconstruct. Profiles are string->string maps
(ErasureCodeInterface.h:155). Buffers cross the interface as `bytes`;
device tensors stay internal to plugins. The port's copy of
ceph_tpu/ec/interface.py.

Sub-chunk support (ErasureCodeInterface.h:297 minimum_to_decode): each chunk
is logically divided into `get_sub_chunk_count()` sub-chunks; regenerating
codes (clay) request only some sub-chunk ranges from helpers during repair.
"""
from __future__ import annotations

import math
from typing import Iterable, Mapping, Sequence

import numpy as np

# Reference pads chunks to SIMD_ALIGN=32 (ErasureCode.cc:42). The JAX
# package pads to 128 for its lane tiles; the port keeps 128 so both
# packages lay out the same chunks (and 16-byte kernel loads stay aligned).
# Padding is imposed through get_chunk_size, the sanctioned place per
# ErasureCodeIsa.cc:66-78.
TPU_ALIGN = 128

ErasureCodeProfile = dict  # str -> str


class ErasureCodeError(Exception):
    """Raised for profile/argument errors (stand-in for -EINVAL etc.)."""


class ErasureCodeInterface:
    """Abstract systematic erasure-code API (ErasureCodeInterface.h:170)."""

    def init(self, profile: Mapping[str, str]) -> None:
        raise NotImplementedError

    def get_profile(self) -> ErasureCodeProfile:
        raise NotImplementedError

    def get_chunk_count(self) -> int:
        """k + m (ErasureCodeInterface.h:227)."""
        raise NotImplementedError

    def get_data_chunk_count(self) -> int:
        raise NotImplementedError

    def get_coding_chunk_count(self) -> int:
        raise NotImplementedError

    def get_sub_chunk_count(self) -> int:
        """Sub-chunks per chunk; 1 for scalar codes, q^t for clay."""
        return 1

    def get_chunk_size(self, stripe_width: int) -> int:
        """Chunk size for an object of `stripe_width` bytes, including
        alignment padding (ErasureCodeInterface.h:278)."""
        raise NotImplementedError

    def minimum_to_decode(self, want_to_read: Iterable[int],
                          available: Iterable[int]) -> dict[int, list[tuple[int, int]]]:
        """Minimum chunks (with per-chunk sub-chunk (offset,count) ranges)
        needed to decode `want_to_read` given `available`
        (ErasureCodeInterface.h:297)."""
        raise NotImplementedError

    def minimum_to_decode_with_cost(self, want_to_read: Iterable[int],
                                    available: Mapping[int, int]) -> list[int]:
        """Like minimum_to_decode but `available` maps chunk -> retrieval cost
        (ErasureCodeInterface.h:326)."""
        raise NotImplementedError

    def encode(self, want_to_encode: Iterable[int], data: bytes) -> dict[int, bytes]:
        """Pad+split `data` into k chunks, compute m parity chunks, return the
        requested subset (ErasureCodeInterface.h:365)."""
        raise NotImplementedError

    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        """Kernel entry: chunks 0..k-1 hold data; fill chunks k..k+m-1
        in place (ErasureCodeInterface.h:370)."""
        raise NotImplementedError

    def decode(self, want_to_read: Iterable[int], chunks: Mapping[int, bytes],
               chunk_size: int) -> dict[int, bytes]:
        """Reconstruct `want_to_read` from available `chunks`
        (ErasureCodeInterface.h:407)."""
        raise NotImplementedError

    def decode_chunks(self, want_to_read: Iterable[int],
                      chunks: dict[int, np.ndarray],
                      available: set[int]) -> None:
        """Kernel entry: reconstruct the `want_to_read` arrays in place.
        `chunks` holds every chunk id (zero-filled holes for missing ones);
        `available` is the set of ids holding real data."""
        raise NotImplementedError

    def get_chunk_mapping(self) -> list[int]:
        """Chunk index remapping, empty list = identity
        (ErasureCodeInterface.h:448)."""
        raise NotImplementedError

    def decode_concat(self, chunks: Mapping[int, bytes],
                      chunk_size: int) -> bytes:
        """Decode data chunks and concatenate in rank order
        (ErasureCodeInterface.h:464)."""
        raise NotImplementedError


class ErasureCode(ErasureCodeInterface):
    """Default behavior shared by plugins (src/erasure-code/ErasureCode.cc).

    Subclasses set self.k / self.m in init() and implement encode_chunks /
    decode_chunks (and optionally override minimum_to_decode & friends).
    """

    #: profile keys consumed by the framework, excluded from "unknown key" checks
    _COMMON_KEYS = {
        "plugin", "technique", "k", "m", "w", "packetsize", "mapping",
        "crush-root", "crush-failure-domain", "crush-device-class",
        "crush-num-failure-domains", "crush-osds-per-failure-domain",
        "ruleset-root", "ruleset-failure-domain", "directory", "device",
    }

    def __init__(self):
        self.k = 0
        self.m = 0
        self._profile: ErasureCodeProfile = {}
        self.chunk_mapping: list[int] = []

    # -- profile plumbing ---------------------------------------------------

    def init(self, profile: Mapping[str, str]) -> None:
        self._profile = dict(profile)
        mapping = self._profile.get("mapping")
        if mapping:
            self._parse_mapping(mapping)

    def get_profile(self) -> ErasureCodeProfile:
        return self._profile

    def _parse_mapping(self, mapping: str) -> None:
        """Profile `mapping=DD_D...`: position i of the generated chunk vector
        is stored at shard i only where pattern has 'D' (ErasureCode.cc:280)."""
        positions = [i for i, c in enumerate(mapping) if c == "D"]
        self.chunk_mapping = positions

    def to_int(self, name: str, profile: Mapping[str, str], default: int,
               minimum: int | None = None, maximum: int | None = None) -> int:
        raw = profile.get(name)
        if raw is None or raw == "":
            return default
        try:
            val = int(raw)
        except ValueError as e:
            raise ErasureCodeError(f"{name}={raw!r} is not an integer") from e
        if minimum is not None and val < minimum:
            raise ErasureCodeError(f"{name}={val} is below minimum {minimum}")
        if maximum is not None and val > maximum:
            raise ErasureCodeError(f"{name}={val} is above maximum {maximum}")
        return val

    def to_bool(self, name: str, profile: Mapping[str, str], default: bool) -> bool:
        raw = profile.get(name)
        if raw is None or raw == "":
            return default
        return str(raw).lower() in ("true", "1", "yes", "on")

    # -- geometry -----------------------------------------------------------

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_coding_chunk_count(self) -> int:
        return self.m

    def get_alignment(self) -> int:
        """Per-chunk byte alignment this plugin requires."""
        return TPU_ALIGN

    def get_chunk_size(self, stripe_width: int) -> int:
        align = self.get_alignment()
        padded = self.k * align * math.ceil(stripe_width / (self.k * align))
        return padded // self.k

    def get_chunk_mapping(self) -> list[int]:
        return list(self.chunk_mapping)

    # -- minimum_to_decode --------------------------------------------------

    def _minimum_to_decode(self, want_to_read: set[int],
                           available: set[int]) -> set[int]:
        """Default policy (ErasureCode.cc:122): if everything wanted is
        available return it; else any k available chunks (lowest ids first)."""
        if want_to_read <= available:
            return set(want_to_read)
        if len(available) < self.k:
            raise ErasureCodeError(
                f"cannot decode: {len(available)} chunks available, need {self.k}")
        return set(sorted(available)[: self.k])

    def minimum_to_decode(self, want_to_read: Iterable[int],
                          available: Iterable[int]) -> dict[int, list[tuple[int, int]]]:
        chosen = self._minimum_to_decode(set(want_to_read), set(available))
        sub = self.get_sub_chunk_count()
        return {c: [(0, sub)] for c in sorted(chosen)}

    def minimum_to_decode_with_cost(self, want_to_read: Iterable[int],
                                    available: Mapping[int, int]) -> list[int]:
        want = set(want_to_read)
        avail = set(available)
        if want <= avail:
            return sorted(want)
        if len(avail) < self.k:
            raise ErasureCodeError("not enough chunks to decode")
        # cheapest k chunks
        return sorted(sorted(avail, key=lambda c: (available[c], c))[: self.k])

    # -- encode/decode ------------------------------------------------------

    def encode_prepare(self, data: bytes) -> dict[int, np.ndarray]:
        """Split + zero-pad input into k aligned chunks (ErasureCode.cc:170).

        Data rank i lands at position chunk_mapping[i] when a mapping is
        set (lrc's sparse layouts); all other positions are zero-initialized
        coding chunks.
        """
        chunk_size = self.get_chunk_size(len(data))
        mapping = self.get_chunk_mapping()
        chunks: dict[int, np.ndarray] = {
            i: np.zeros(chunk_size, dtype=np.uint8)
            for i in range(self.get_chunk_count())}
        for i in range(self.k):
            pos = mapping[i] if mapping else i
            lo = i * chunk_size
            hi = min(len(data), lo + chunk_size)
            if hi > lo:
                chunks[pos][: hi - lo] = np.frombuffer(data[lo:hi],
                                                       dtype=np.uint8)
        return chunks

    def encode(self, want_to_encode: Iterable[int], data: bytes) -> dict[int, bytes]:
        chunks = self.encode_prepare(data)
        self.encode_chunks(chunks)
        want = set(want_to_encode)
        return {i: chunks[i].tobytes() for i in sorted(want)}

    def _decode(self, want_to_read: set[int],
                chunks: Mapping[int, bytes], chunk_size: int) -> dict[int, np.ndarray]:
        """Fill holes then decode_chunks (ErasureCode.cc:225)."""
        arrays: dict[int, np.ndarray] = {}
        for i, buf in chunks.items():
            # zero-copy read-only view; only the holes below get (writable)
            # fresh buffers — avoids a full-stripe memcpy on the degraded-read
            # hot path (the reference avoids the same via bufferlist views)
            arr = np.frombuffer(buf, dtype=np.uint8)
            if len(arr) != chunk_size:
                raise ErasureCodeError(
                    f"chunk {i} has size {len(arr)}, expected {chunk_size}")
            arrays[i] = arr
        if want_to_read <= set(arrays):
            return {i: arrays[i] for i in want_to_read}
        for i in range(self.get_chunk_count()):
            if i not in arrays:
                arrays[i] = np.zeros(chunk_size, dtype=np.uint8)
        self.decode_chunks(want_to_read, dict(arrays),
                           available=set(chunks))
        return {i: arrays[i] for i in want_to_read}

    def decode(self, want_to_read: Iterable[int], chunks: Mapping[int, bytes],
               chunk_size: int) -> dict[int, bytes]:
        out = self._decode(set(want_to_read), chunks, chunk_size)
        return {i: a.tobytes() for i, a in out.items()}

    def decode_chunks(self, want_to_read: Iterable[int],
                      chunks: dict[int, np.ndarray],
                      available: set[int]) -> None:
        """Kernel entry: reconstruct the `want_to_read` arrays in `chunks` in
        place. `chunks` holds every chunk id with zero-filled holes for the
        missing ones; `available` is the set of ids holding real data."""
        raise NotImplementedError

    def decode_concat(self, chunks: Mapping[int, bytes], chunk_size: int) -> bytes:
        want = list(range(self.k))
        mapping = self.get_chunk_mapping()
        if mapping:
            want = [mapping[i] for i in range(self.k)]
        decoded = self.decode(want, chunks, chunk_size)
        return b"".join(decoded[i] for i in want)
