"""msgr2-subset frame format: TLV preamble + crc32c-protected segments,
plus the negotiated on-wire modes (AES-GCM secure, zlib compression).

Modeled on the reference's frames_v2.h (src/msg/async/frames_v2.h:39-115):
a frame is a fixed preamble block — tag, segment count, segment lengths,
preamble crc — followed by the segment payloads, each with its own
trailing crc32c. After the handshake a connection may negotiate an
`Onwire` transform over whole encoded frames: AES-128-GCM with
per-direction keys + counter nonces (the crypto_onwire.cc secure mode;
keys derived from the cephx-lite shared secret and both handshake
nonces) and/or zlib compression (compression_onwire.cc). Differences
from the reference, by design: at most 4 segments (same
MAX_NUM_SEGMENTS), no multi-block preambles, little-endian fixed-width
ints via struct rather than ceph's dencoder, and the onwire transform
wraps the whole frame behind a tiny flags+length header instead of
rewriting the preamble.

Layout (little-endian):

  preamble:  magic u16 = 0xEC02 | tag u8 | seg_count u8
             | seg_len u32 * seg_count | crc32c(preamble so far) u32
  body:      for each segment: raw bytes | crc32c(bytes) u32

crc32c is the same Castagnoli polynomial the reference uses everywhere,
provided by the in-repo C++ kernel (native/ec_native.cc).

The port's copy of ceph_tpu/msg/frames.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import enum
import os
import struct
import time
import zlib
from dataclasses import dataclass, field

from ceph_tpu_torch.native import ec_native
from ceph_tpu_torch.utils import copytrack

MAGIC = 0xEC02
MAX_SEGMENTS = 4
_PRE_FIXED = struct.Struct("<HBB")
_U32 = struct.Struct("<I")

# -- native frame codec selection --------------------------------------------
# The frame hot path (preamble pack/parse + the crc32c-over-scatter-list
# pass) runs as ONE GIL-releasing C call when native/ec_native.cc is
# available; the pure-Python path below stays the bit-identical fallback
# (and the reference the fuzz tests hold the native codec to). Chosen at
# import like the ec_native probe; CEPH_TPU_FRAME_NATIVE=0 force-disables
# (the tier-1 fallback suite runs under exactly that).
_frame_native = None
if os.environ.get("CEPH_TPU_FRAME_NATIVE", "1") != "0":
    try:
        from ceph_tpu_torch.native import frame_native as _fn_mod
        if _fn_mod.available():
            _frame_native = _fn_mod
    except Exception:
        _frame_native = None


def native_active() -> bool:
    """True when frames encode/verify through the native codec."""
    return _frame_native is not None


def set_native(enabled: bool) -> bool:
    """Select the frame codec at runtime (tests/bench A-B the two
    paths); returns the resulting native_active(). Enabling is a no-op
    when the native library is unavailable."""
    global _frame_native
    if not enabled:
        _frame_native = None
        return False
    try:
        from ceph_tpu_torch.native import frame_native as _fn_mod
        _frame_native = _fn_mod if _fn_mod.available() else None
    except Exception:
        _frame_native = None
    return _frame_native is not None


def _seg_len(seg) -> int:
    """Byte length of a segment; scatter segments (a list/tuple of
    bytes-likes, e.g. the sub-op batch envelope's concatenated message
    datas) count the sum of their parts."""
    if isinstance(seg, (list, tuple)):
        return sum(len(p) for p in seg)
    return len(seg)

# trace-context TLV segment (the Message.h otel_trace analog): an
# OPTIONAL trailing frame segment `magic u16 | trace_id u64 | span_id
# u64 [| flags u8]` stamped on MESSAGE frames when tracing is on. The
# trailing flags byte (tracing v2) carries the head-sampling decision
# so a trace is never half-sampled across processes; peers that
# predate it sent the 18-byte form, which decodes with flags=0.
# Receivers that don't know the magic drop the segment — the op itself
# is untouched either way.
TRACE_MAGIC = 0xEC7C
_TRACE_SEG = struct.Struct("<HQQ")        # legacy v1: magic, trace, span
_TRACE_SEG_F = struct.Struct("<HQQB")     # v2: + sampling-flags byte


def encode_trace_ctx(ctx: dict) -> bytes:
    """Pack a tracer wire context ({"t": trace, "s": span[, "f": flags]})."""
    return _TRACE_SEG_F.pack(TRACE_MAGIC, ctx["t"], ctx["s"],
                             int(ctx.get("f", 0) or 0) & 0xFF)


def decode_trace_ctx(seg: bytes) -> dict | None:
    """Unpack a trace segment; None when it isn't one (unknown magic or
    wrong size — forward/backward compatible by construction). Both the
    18-byte v1 and 19-byte v2 forms are accepted."""
    if len(seg) == _TRACE_SEG.size:
        magic, trace_id, span_id = _TRACE_SEG.unpack(seg)
        flags = 0
    elif len(seg) == _TRACE_SEG_F.size:
        magic, trace_id, span_id, flags = _TRACE_SEG_F.unpack(seg)
    else:
        return None
    if magic != TRACE_MAGIC:
        return None
    return {"t": trace_id, "s": span_id, "f": flags}


def crc32c(data: bytes, seed: int = 0) -> int:
    return ec_native.crc32c(data, seed)


class Tag(enum.IntEnum):
    """Frame tags (frames_v2.h:39-60 subset)."""
    HELLO = 1
    RECONNECT = 2
    RECONNECT_OK = 3
    RESET = 4
    AUTH = 5            # initiator's auth proof (cephx-lite 3rd leg)
    ACK = 8
    KEEPALIVE = 9
    KEEPALIVE_ACK = 10
    MESSAGE = 16


class FrameError(Exception):
    """Framing violation: bad magic, crc mismatch, oversized segment."""


@dataclass
class Frame:
    tag: Tag
    segments: list[bytes] = field(default_factory=list)

    MAX_SEGMENT_SIZE = 128 << 20   # sanity bound; a segment is <= one op

    def _parts(self) -> list:
        """Wire form as a scatter list: [preamble, seg0, crc0, seg1,
        crc1, ...] — the preamble/crc trailers are fresh small bytes,
        every segment is passed BY REFERENCE (no ledger accounting
        here; encode/encode_parts meter their own copy behavior).
        Scatter segments flatten into consecutive parts under one
        chained crc — their bytes never join before the transport."""
        if not 0 <= len(self.segments) <= MAX_SEGMENTS:
            raise FrameError(f"{len(self.segments)} segments (max "
                             f"{MAX_SEGMENTS})")
        pre = bytearray(_PRE_FIXED.pack(MAGIC, int(self.tag),
                                        len(self.segments)))
        for seg in self.segments:
            pre += _U32.pack(_seg_len(seg))
        pre += _U32.pack(crc32c(bytes(pre)))
        parts: list = [bytes(pre)]
        for seg in self.segments:
            if isinstance(seg, (list, tuple)):
                crc = 0
                for p in seg:
                    parts.append(p)
                    crc = crc32c(p, crc)
                parts.append(_U32.pack(crc))
            else:
                parts.append(seg)
                parts.append(_U32.pack(crc32c(seg)))
        return parts

    def _payload_len(self) -> int:
        return sum(_seg_len(s) for s in self.segments)

    def encode_parts(self) -> list:
        """Scatter-gather wire form for the plain-crc transport path:
        the write loop hands these buffers to the transport
        (writelines), whose single outbound join is the ONE copy each
        segment pays — down from two in the old assemble-then-bytes()
        encode(). Metered as one tx copy either way; with the native
        codec the preamble build + every crc pass + the single copy
        happen in ONE GIL-releasing C call and the transport gets the
        finished blob."""
        if _frame_native is not None:
            if not 0 <= len(self.segments) <= MAX_SEGMENTS:
                raise FrameError(f"{len(self.segments)} segments (max "
                                 f"{MAX_SEGMENTS})")
            t0 = time.perf_counter()
            blob = _frame_native.pack(MAGIC, int(self.tag), self.segments)
            copytrack.copied("frame_tx", self._payload_len(),
                             time.perf_counter() - t0)
            return [blob]
        parts = self._parts()
        copytrack.copied("frame_tx", self._payload_len())
        return parts

    def encode(self) -> bytes | bytearray:
        if _frame_native is not None:
            # the packed bytearray is returned AS-IS (bytes-like):
            # every consumer — transport write, Onwire compress/
            # encrypt/concat — takes a buffer, and a bytes() round
            # trip here would re-copy the whole frame on exactly the
            # hot path the native codec exists to shrink
            t0 = time.perf_counter()
            if not 0 <= len(self.segments) <= MAX_SEGMENTS:
                raise FrameError(f"{len(self.segments)} segments (max "
                                 f"{MAX_SEGMENTS})")
            blob = _frame_native.pack(MAGIC, int(self.tag), self.segments)
            copytrack.copied("frame_tx", self._payload_len(),
                             time.perf_counter() - t0)
            return blob
        # crcs/preamble are built OUTSIDE the timed window: the
        # ledger's frame_tx seconds must meter byte movement only, or a
        # zero-copy change that leaves CRC alone under-reports its win
        parts = self._parts()
        t0 = time.perf_counter()
        blob = b"".join(parts)
        # one join: each segment byte is copied exactly once into the
        # wire blob (the old bytearray-accumulate + bytes() paid twice)
        copytrack.copied("frame_tx", self._payload_len(),
                         time.perf_counter() - t0)
        return blob

    @classmethod
    async def read(cls, reader) -> "Frame":
        """Read one frame from an asyncio StreamReader. The preamble is
        read and validated separately from the body, and segments come
        back as MEMORYVIEWS over the single body buffer — the receive
        side never re-slices payload bytes into fresh objects (the
        copy ledger meters frame_rx as referenced, not copied)."""
        fixed = await reader.readexactly(_PRE_FIXED.size)
        magic, tag, nseg = _PRE_FIXED.unpack(fixed)
        if magic != MAGIC:
            raise FrameError(f"bad magic {magic:#x}")
        if nseg > MAX_SEGMENTS:
            raise FrameError(f"{nseg} segments (max {MAX_SEGMENTS})")
        rest = await reader.readexactly(4 * nseg + 4)
        seg_lens = [_U32.unpack_from(rest, 4 * i)[0] for i in range(nseg)]
        for ln in seg_lens:
            if ln > cls.MAX_SEGMENT_SIZE:
                raise FrameError(f"segment of {ln} bytes exceeds bound")
        (pre_crc,) = _U32.unpack_from(rest, 4 * nseg)
        if crc32c(fixed + rest[:4 * nseg]) != pre_crc:
            raise FrameError("preamble crc mismatch")
        body = await reader.readexactly(sum(ln + 4 for ln in seg_lens))
        try:
            tag = Tag(tag)
        except ValueError as e:
            raise FrameError(f"unknown tag {tag}") from e
        return cls(tag, cls._parse_segments(seg_lens, memoryview(body)))

    @classmethod
    def _parse_segments(cls, seg_lens: list[int],
                        body: memoryview) -> list[memoryview]:
        """crc-verify and window each segment out of the body buffer —
        zero-copy: every returned segment is a view, and the buffer
        stays alive exactly as long as any segment does (refcounted).
        With the native codec the whole crc-over-segments pass is one
        GIL-releasing C call; the view windowing stays in Python."""
        want = sum(ln + 4 for ln in seg_lens)
        if len(body) < want:
            raise FrameError("truncated segment")
        if _frame_native is not None:
            base = body.obj if isinstance(body, memoryview) else None
            # the streamed-read path hands a view over EXACTLY the body
            # bytes: pass the bytes object itself (ctypes converts it
            # without the numpy fallback the sliced decode path needs)
            buf = base if type(base) is bytes and len(base) == want \
                else body[:want]
            bad = _frame_native.verify_body(buf, seg_lens)
            if bad >= 0:
                raise FrameError("segment crc mismatch")
            segments = []
            off = 0
            for ln in seg_lens:
                segments.append(body[off:off + ln])
                off += ln + 4
            copytrack.referenced("frame_rx", sum(seg_lens))
            return segments
        try:
            segments: list[memoryview] = []
            off = 0
            for ln in seg_lens:
                seg = body[off:off + ln]
                if len(seg) != ln:
                    raise FrameError("truncated segment")
                (seg_crc,) = _U32.unpack_from(body, off + ln)
                if crc32c(seg) != seg_crc:
                    raise FrameError("segment crc mismatch")
                segments.append(seg)
                off += ln + 4
        except struct.error as e:
            raise FrameError(f"truncated frame: {e}") from e
        # rx-side: segments are windows over the recv buffer, no copy
        copytrack.referenced("frame_rx", sum(seg_lens))
        return segments

    @classmethod
    def decode(cls, blob: bytes) -> "Frame":
        """Parse one whole frame from bytes — the Onwire unwrap path
        (the transform already materialized the plaintext blob) and any
        caller holding a complete frame. Segments are memoryviews over
        `blob`."""
        try:
            if len(blob) < _PRE_FIXED.size:
                raise FrameError("short frame")
            magic, tag, nseg = _PRE_FIXED.unpack_from(blob, 0)
            if magic != MAGIC:
                raise FrameError(f"bad magic {magic:#x}")
            if nseg > MAX_SEGMENTS:
                raise FrameError(f"{nseg} segments (max {MAX_SEGMENTS})")
            off = _PRE_FIXED.size
            seg_lens = [_U32.unpack_from(blob, off + 4 * i)[0]
                        for i in range(nseg)]
            for ln in seg_lens:
                if ln > cls.MAX_SEGMENT_SIZE:
                    raise FrameError(f"segment of {ln} bytes exceeds "
                                     f"bound")
            (pre_crc,) = _U32.unpack_from(blob, off + 4 * nseg)
            if crc32c(blob[:off + 4 * nseg]) != pre_crc:
                raise FrameError("preamble crc mismatch")
            off += 4 * nseg + 4
        except struct.error as e:
            raise FrameError(f"truncated frame: {e}") from e
        try:
            tag = Tag(tag)
        except ValueError as e:
            raise FrameError(f"unknown tag {tag}") from e
        return cls(tag, cls._parse_segments(seg_lens,
                                            memoryview(blob)[off:]))


class Onwire:
    """Post-handshake whole-frame transform: AES-128-GCM secure mode
    (crypto_onwire.cc) and/or zlib compression (compression_onwire.cc).

    Envelope: u8 flags | u32 payload_len | payload. Per-direction keys
    derive from the cephx-lite shared secret + both handshake nonces;
    nonces are a 4-byte per-direction salt plus a monotone 8-byte
    counter, so every frame of a transport encrypts uniquely and replay
    or reorder breaks the GCM tag. The flags byte rides as AAD."""

    HDR = struct.Struct("<BI")
    F_COMPRESSED = 0x1
    F_SECURE = 0x2
    COMPRESS_MIN = 512          # don't bloat small control frames
    MAX_WIRE = 256 << 20

    def __init__(self, compress: bool = False,
                 secret: bytes | None = None, role: str = "cli",
                 nonces: tuple[str, str] = ("", "")):
        self.compress = compress
        self.secure = secret is not None
        if self.secure:
            import hashlib
            from cryptography.exceptions import InvalidTag
            from cryptography.hazmat.primitives.ciphers.aead import AESGCM
            self._InvalidTag = InvalidTag
            cli_nonce, srv_nonce = nonces
            base = secret + cli_nonce.encode() + srv_nonce.encode()
            k_c2s = hashlib.sha256(b"ceph-tpu-c2s" + base).digest()[:16]
            k_s2c = hashlib.sha256(b"ceph-tpu-s2c" + base).digest()[:16]
            tx_key, rx_key = (k_c2s, k_s2c) if role == "cli" \
                else (k_s2c, k_c2s)
            self._tx = AESGCM(tx_key)
            self._rx = AESGCM(rx_key)
            self._tx_salt = hashlib.sha256(b"iv" + tx_key).digest()[:4]
            self._rx_salt = hashlib.sha256(b"iv" + rx_key).digest()[:4]
            self._tx_ctr = 0
            self._rx_ctr = 0

    def wrap(self, blob: bytes) -> bytes:
        flags = 0
        if self.compress and len(blob) >= self.COMPRESS_MIN:
            packed = zlib.compress(blob, 1)
            if len(packed) < len(blob):
                blob = packed
                flags |= self.F_COMPRESSED
        if self.secure:
            nonce = self._tx_salt + self._tx_ctr.to_bytes(8, "little")
            self._tx_ctr += 1
            blob = self._tx.encrypt(nonce, blob, bytes([flags]))
            flags |= self.F_SECURE
        return self.HDR.pack(flags, len(blob)) + blob

    async def read_frame(self, reader) -> Frame:
        hdr = await reader.readexactly(self.HDR.size)
        flags, length = self.HDR.unpack(hdr)
        if length > self.MAX_WIRE:
            raise FrameError(f"onwire payload of {length} bytes")
        blob = await reader.readexactly(length)
        if flags & self.F_SECURE:
            if not self.secure:
                raise FrameError("unexpected secure frame")
            nonce = self._rx_salt + self._rx_ctr.to_bytes(8, "little")
            self._rx_ctr += 1
            try:
                blob = self._rx.decrypt(
                    nonce, blob, bytes([flags & ~self.F_SECURE]))
            except self._InvalidTag as e:
                raise FrameError("GCM auth tag mismatch "
                                 "(tamper/replay/desync)") from e
        elif self.secure:
            raise FrameError("plaintext frame on a secure transport")
        if flags & self.F_COMPRESSED:
            # bounded inflate: compression negotiates without auth, so
            # an unauthenticated peer must not be able to bomb us into
            # a multi-GB allocation from a small wire payload
            d = zlib.decompressobj()
            try:
                blob = d.decompress(blob, self.MAX_WIRE)
            except zlib.error as e:
                raise FrameError(f"decompress failed: {e}") from e
            if d.unconsumed_tail:
                raise FrameError("decompressed frame exceeds bound")
        return Frame.decode(blob)


BANNER = b"ceph_tpu msgr2.0\n"
