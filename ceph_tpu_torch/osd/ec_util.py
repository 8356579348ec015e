"""Stripe layout + stripe codec — the ECUtil equivalent.

StripeInfo reproduces the offset math of the reference's
`ECUtil::stripe_info_t` (src/osd/ECUtil.h:27-119): an object's logical byte
stream is striped over k data shards, stripe_width = k * chunk_size;
logical offsets map to per-shard chunk offsets.

encode/decode are the reference's `ECUtil::encode`/`decode`
(src/osd/ECUtil.cc:21-170) — the site SURVEY §2.2 names as "the batching
site for TPU dispatch". The reference loops stripe-by-stripe calling the
plugin per stripe; here, when the plugin exposes the batched stripe APIs
(`encode_stripes`/`decode_stripes`, the `cuda` plugin), ALL stripes go to
the device in one dispatch and come back as per-shard contiguous buffers.
Plugins without the batched API fall back to the reference's per-stripe
loop, so any registered plugin works.

HashInfo mirrors `ECUtil::HashInfo` (src/osd/ECUtil.h:141-199): cumulative
per-shard crc32c maintained across appends, stored in object metadata and
checked on reads/deep-scrub.

Port of ceph_tpu/osd/ec_util.py, with the `cuda` plugin's batched APIs
carrying the stripes to the card. The `*_async` variants route the
device dispatch through the offload service (ceph_tpu_torch.offload),
where it coalesces with concurrent callers. Tracer spans (`ec_encode`,
`ec_decode`, `ec_recover`) and the copy ledger's `frame_to_buffer` and
`reply_assemble` stages are the reference's, and so are the checked
unwraps of sanitizer-guarded views at the three numpy boundaries.
"""
from __future__ import annotations

import time
from typing import Iterable, Mapping

import numpy as np

from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.utils import copytrack, sanitizer, tracer


class StripeInfo:
    """Logical <-> chunk offset arithmetic (ECUtil.h:27-119).

    Constructed from (k, stripe_width); stripe_width must be a multiple
    of k and of the plugin's alignment so chunk_size divides evenly.
    """

    def __init__(self, data_chunks: int, stripe_width: int):
        if stripe_width % data_chunks:
            raise ValueError(
                f"stripe_width {stripe_width} not divisible by k={data_chunks}")
        self.stripe_width = stripe_width
        self.chunk_size = stripe_width // data_chunks
        self.k = data_chunks

    # -- predicates --
    def logical_offset_is_stripe_aligned(self, logical: int) -> bool:
        return logical % self.stripe_width == 0

    def offset_length_is_same_stripe(self, off: int, length: int) -> bool:
        if length == 0:
            return True
        return off // self.stripe_width == (off + length - 1) // self.stripe_width

    # -- logical -> chunk --
    def logical_to_prev_chunk_offset(self, offset: int) -> int:
        return (offset // self.stripe_width) * self.chunk_size

    def logical_to_next_chunk_offset(self, offset: int) -> int:
        return -(-offset // self.stripe_width) * self.chunk_size

    def logical_to_prev_stripe_offset(self, offset: int) -> int:
        return offset - (offset % self.stripe_width)

    def logical_to_next_stripe_offset(self, offset: int) -> int:
        return -(-offset // self.stripe_width) * self.stripe_width

    def aligned_logical_offset_to_chunk_offset(self, offset: int) -> int:
        if offset % self.stripe_width:
            raise ValueError(f"offset {offset} not stripe aligned")
        return (offset // self.stripe_width) * self.chunk_size

    def aligned_chunk_offset_to_logical_offset(self, offset: int) -> int:
        if offset % self.chunk_size:
            raise ValueError(f"chunk offset {offset} not chunk aligned")
        return (offset // self.chunk_size) * self.stripe_width

    def chunk_aligned_offset_len_to_chunk(self, off: int, length: int) -> tuple[int, int]:
        """(rounds offset down, length up) — ECUtil.cc:14."""
        if (off % self.stripe_width) % self.chunk_size:
            raise ValueError("offset residue not chunk aligned")
        if (length % self.stripe_width) % self.chunk_size:
            raise ValueError("length residue not chunk aligned")
        return ((off // self.stripe_width) * self.chunk_size,
                -(-length // self.stripe_width) * self.chunk_size)

    # -- range expansion --
    def offset_len_to_stripe_bounds(self, off: int, length: int) -> tuple[int, int]:
        start = self.logical_to_prev_stripe_offset(off)
        length = self.logical_to_next_stripe_offset((off - start) + length)
        return start, length

    def offset_len_to_chunk_bounds(self, off: int, length: int) -> tuple[int, int]:
        start = off - (off % self.chunk_size)
        tmp = (off - start) + length
        return start, -(-tmp // self.chunk_size) * self.chunk_size

    def offset_length_to_data_chunk_indices(self, off: int, length: int) -> tuple[int, int]:
        """[first, last) global data-chunk indices touched by the range."""
        return (off // self.chunk_size,
                (self.chunk_size - 1 + off + length) // self.chunk_size)


# ---------------------------------------------------------------------------
# Stripe codec
# ---------------------------------------------------------------------------

def _encode_frame(sinfo: StripeInfo, ec_impl, data, want):
    """Shared validation/framing for encode(): returns
    (stripes (S,k,C) | None, want set, k, n_chunks, mapping, batched)."""
    # numpy boundary: a sanitizer-guarded view unwraps HERE (with its
    # use-after-recycle check); np.frombuffer can't take the proxy
    data = sanitizer.unwrap(data)
    if isinstance(data, (bytes, bytearray, memoryview)):
        # np.frombuffer windows the message bytes — no copy, read-only:
        # the plugin copies them into its staging memory
        buf = np.frombuffer(data, dtype=np.uint8)
        copytrack.referenced("frame_to_buffer", buf.size)
    else:
        t0 = time.perf_counter()
        buf = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
        if np.shares_memory(buf, data):
            copytrack.referenced("frame_to_buffer", buf.size)
        else:
            copytrack.copied("frame_to_buffer", buf.size,
                             time.perf_counter() - t0)
    if buf.size % sinfo.stripe_width:
        raise ErasureCodeError(
            f"input size {buf.size} not a multiple of stripe width "
            f"{sinfo.stripe_width}")
    k = ec_impl.get_data_chunk_count()
    n_chunks = ec_impl.get_chunk_count()
    if k != sinfo.k:
        raise ErasureCodeError(f"plugin k={k} != stripe k={sinfo.k}")
    want = set(want) if want is not None else set(range(n_chunks))
    if any(not 0 <= w < n_chunks for w in want):
        raise ErasureCodeError(f"want ids {sorted(want)} out of range "
                               f"0..{n_chunks - 1}")
    n_stripes = buf.size // sinfo.stripe_width
    mapping = ec_impl.get_chunk_mapping()
    batched = callable(getattr(ec_impl, "encode_stripes", None)) \
        and not mapping
    stripes = None if n_stripes == 0 else \
        buf.reshape(n_stripes, k, sinfo.chunk_size)
    return stripes, want, k, n_chunks, mapping, batched


def _encode_assemble(stripes: np.ndarray, parity: np.ndarray, k: int,
                     want, sp=None) -> dict[int, memoryview]:
    """Shard planes -> per-shard reply buffers, AT MOST one copy per
    byte — and zero for contiguous planes.

    A shard's chunks-per-stripe plane `stripes[:, i, :]` (or
    `parity[:, i-k, :]`) is C-contiguous whenever the write is a single
    stripe (S == 1, every one-stripe client op) or the axis being
    indexed has size 1 (m == 1 parity) — in that case the plane IS the
    reply buffer and a memoryview over it goes downstream as-is
    (message frames, object-store writes and crc all take buffer
    objects), metered referenced. Strided planes (multi-stripe, k or
    m >= 2) still pay the single extraction copy into a fresh
    bytearray — the remaining reply_assemble ledger entry."""
    t0 = time.perf_counter()
    S, _, C = stripes.shape
    out: dict[int, memoryview] = {}
    copied = 0
    referenced = 0
    for i in sorted(want):
        src = stripes[:, i, :] if i < k else parity[:, i - k, :]
        if src.flags.c_contiguous:
            # no materialization: the plane is a window over the encode
            # input (data shards) or the device result (parity)
            out[i] = memoryview(src.reshape(S * C))
            referenced += S * C
            continue
        buf = bytearray(S * C)
        np.copyto(np.frombuffer(buf, dtype=np.uint8).reshape(S, C), src)
        out[i] = memoryview(buf)
        copied += S * C
    dt = time.perf_counter() - t0
    if referenced:
        copytrack.referenced("reply_assemble", referenced)
    if copied:
        copytrack.copied("reply_assemble", copied, dt)
    if sp is not None:
        sp.set_tag("copy_bytes", copied)
        sp.set_tag("copy_us", round(dt * 1e6, 1))
    return out


def _encode_scalar(sinfo: StripeInfo, ec_impl, stripes, want, k, n_chunks,
                   mapping) -> dict[int, bytes]:
    """The reference's per-stripe loop through the scalar contract."""
    data_pos = mapping if mapping else list(range(k))
    out_chunks = []
    for s in range(stripes.shape[0]):
        chunks = {i: np.zeros(sinfo.chunk_size, dtype=np.uint8)
                  for i in range(n_chunks)}
        for rank, pos in enumerate(data_pos):
            chunks[pos] = stripes[s, rank].copy()
        ec_impl.encode_chunks(chunks)
        out_chunks.append(np.stack([chunks[i] for i in range(n_chunks)]))
    full = np.stack(out_chunks)
    # shard i = chunks of all stripes, contiguous (S major)
    return {i: full[:, i, :].tobytes() for i in sorted(want)}


def _encode_framed(sinfo: StripeInfo, ec_impl, stripes, want, k, n_chunks,
                   mapping, batched) -> dict[int, bytes]:
    """Inline dispatch of an already-validated frame."""
    with tracer.span("ec_encode") as sp:
        if sp is not None:
            sp.set_tag("bytes", int(stripes.size))
            sp.set_tag("k", k)
            sp.set_tag("m", n_chunks - k)
            sp.set_tag("stripes", stripes.shape[0])
            sp.set_tag("batched", batched)
        if batched:
            parity = np.asarray(ec_impl.encode_stripes(stripes))
            return _encode_assemble(stripes, parity, k, want, sp=sp)
        return _encode_scalar(sinfo, ec_impl, stripes, want, k, n_chunks,
                              mapping)


def encode(sinfo: StripeInfo, ec_impl, data: bytes | np.ndarray,
           want: Iterable[int] | None = None) -> dict[int, bytes]:
    """Encode a stripe-aligned logical buffer into per-shard buffers.

    Equivalent of ECUtil::encode (ECUtil.cc:134): input length must be a
    multiple of stripe_width; output maps shard id -> contiguous buffer of
    one chunk per stripe. One batched device dispatch when the plugin
    supports it, else the reference's per-stripe loop.
    """
    stripes, want, k, n_chunks, mapping, batched = _encode_frame(
        sinfo, ec_impl, data, want)
    if stripes is None:
        return {i: b"" for i in sorted(want)}
    return _encode_framed(sinfo, ec_impl, stripes, want, k, n_chunks,
                          mapping, batched)


async def encode_async(sinfo: StripeInfo, ec_impl,
                       data: bytes | np.ndarray,
                       want: Iterable[int] | None = None,
                       service=None) -> dict[int, bytes]:
    """encode() through the offload service: the device dispatch enters
    the admission queue and coalesces with concurrent callers' stripes
    (one staged device batch across PGs) instead of dispatching inline.
    Without a service, or on a plugin with no batched API, this is
    exactly encode()."""
    stripes, want, k, n_chunks, mapping, batched = _encode_frame(
        sinfo, ec_impl, data, want)
    if stripes is None:
        return {i: b"" for i in sorted(want)}
    if not (batched and service is not None):
        return _encode_framed(sinfo, ec_impl, stripes, want, k, n_chunks,
                              mapping, batched)
    with tracer.span("ec_encode") as sp:
        if sp is not None:
            sp.set_tag("bytes", int(stripes.size))
            sp.set_tag("k", k)
            sp.set_tag("m", n_chunks - k)
            sp.set_tag("stripes", stripes.shape[0])
            sp.set_tag("batched", True)
            sp.set_tag("offload", True)
        parity = np.asarray(await service.encode(ec_impl, stripes))
        return _encode_assemble(stripes, parity, k, want, sp=sp)


def _reconstruct_stack(ec_impl, stacked: Mapping[int, np.ndarray],
                       helpers) -> tuple[tuple[int, ...], np.ndarray]:
    """The dispatch contract of batched reconstruction, in ONE place
    (first-k helper order, (n, k, C) stacking), shared by the inline and
    offload-service paths of both degraded read and shard recovery."""
    k = ec_impl.get_data_chunk_count()
    use = tuple(helpers[:k])
    if len(use) < k:
        raise ErasureCodeError(
            f"cannot decode: {len(use)} shards available, need {k}")
    return use, np.stack([stacked[i] for i in use], axis=1)  # (n, k, C)


def _reconstruct_unstack(rec: np.ndarray, want) -> dict[int, np.ndarray]:
    return {wid: rec[:, j, :] for j, wid in enumerate(want)}


def _batched_reconstruct(ec_impl, stacked: Mapping[int, np.ndarray],
                         helpers: list[int], want: list[int]) -> dict[int, np.ndarray]:
    """One-dispatch reconstruction of `want` shards from per-shard
    (n, chunk_size) planes via the plugin's decode_stripes batch API."""
    use, src = _reconstruct_stack(ec_impl, stacked, helpers)
    rec = np.asarray(ec_impl.decode_stripes(use, tuple(want), src))
    return _reconstruct_unstack(rec, want)


def _decode_concat_frame(sinfo: StripeInfo, ec_impl,
                         to_decode: Mapping[int, bytes]):
    """Shared framing for decode_concat(): validates the shard buffers
    and resolves the healthy-read case. Returns (done_bytes, work):
    exactly one is non-None; `work` is (stacked, avail_ids, missing,
    want, k, n_stripes, mapping)."""
    k = ec_impl.get_data_chunk_count()
    arrays = {i: np.frombuffer(sanitizer.unwrap(b), dtype=np.uint8)
              for i, b in to_decode.items()}
    if not arrays:
        raise ErasureCodeError("no chunks to decode")
    total = next(iter(arrays.values())).size
    if total % sinfo.chunk_size:
        raise ErasureCodeError("shard buffer not chunk aligned")
    for i, a in arrays.items():
        if a.size != total:
            raise ErasureCodeError(f"shard {i} length {a.size} != {total}")
    n_stripes = total // sinfo.chunk_size
    if n_stripes == 0:
        return b"", None

    mapping = ec_impl.get_chunk_mapping()
    want = [mapping[i] if mapping else i for i in range(k)]
    avail_ids = sorted(arrays)
    missing = [i for i in want if i not in arrays]

    stacked = {i: arrays[i].reshape(n_stripes, sinfo.chunk_size)
               for i in avail_ids}
    if not missing:
        # healthy read: the result is just the rank-ordered interleave of
        # the data shards — no plugin call needed
        out = np.empty((n_stripes, k, sinfo.chunk_size), dtype=np.uint8)
        for rank, cid in enumerate(want):
            out[:, rank, :] = stacked[cid]
        return out.tobytes(), None
    return None, (stacked, avail_ids, missing, want, k, n_stripes, mapping)


def _decode_concat_assemble(sinfo: StripeInfo, stacked, recovered, want,
                            k: int, n_stripes: int) -> bytes:
    out = np.empty((n_stripes, k, sinfo.chunk_size), dtype=np.uint8)
    for rank, cid in enumerate(want):
        out[:, rank, :] = stacked[cid] if cid in stacked \
            else recovered[cid]
    return out.tobytes()


def decode_concat(sinfo: StripeInfo, ec_impl,
                  to_decode: Mapping[int, bytes]) -> bytes:
    """Reconstruct and concatenate the data shards in rank order — the
    ECUtil::decode concat variant (ECUtil.cc:21-59) feeding degraded reads.

    `to_decode` maps shard id -> equal-length multi-chunk buffer.
    """
    done, work = _decode_concat_frame(sinfo, ec_impl, to_decode)
    if done is not None:
        return done
    return _decode_concat_framed(sinfo, ec_impl, work)


def _decode_concat_framed(sinfo: StripeInfo, ec_impl, work) -> bytes:
    """Inline reconstruction of an already-validated frame."""
    stacked, avail_ids, missing, want, k, n_stripes, mapping = work
    with tracer.span("ec_decode") as sp:
        if sp is not None:
            sp.set_tag("bytes", int(n_stripes * sinfo.chunk_size
                                    * len(stacked)))
            sp.set_tag("k", k)
            sp.set_tag("missing", missing)
            sp.set_tag("stripes", n_stripes)
        if callable(getattr(ec_impl, "decode_stripes", None)) \
                and not mapping:
            recovered = _batched_reconstruct(ec_impl, stacked, avail_ids,
                                             missing)
            return _decode_concat_assemble(sinfo, stacked, recovered,
                                           want, k, n_stripes)

        # per-stripe fallback through the scalar contract (reference loop)
        parts = []
        for s in range(n_stripes):
            chunks = {i: stacked[i][s].tobytes() for i in avail_ids}
            parts.append(ec_impl.decode_concat(chunks, sinfo.chunk_size))
        return b"".join(parts)


async def decode_concat_async(sinfo: StripeInfo, ec_impl,
                              to_decode: Mapping[int, bytes],
                              service=None) -> bytes:
    """decode_concat() with the reconstruction dispatch routed through
    the offload service (degraded reads coalesce across PGs when they
    share an erasure pattern). Healthy reads never touch the device and
    return synchronously either way."""
    done, work = _decode_concat_frame(sinfo, ec_impl, to_decode)
    if done is not None:
        return done
    stacked, avail_ids, missing, want, k, n_stripes, mapping = work
    if not (service is not None and not mapping
            and callable(getattr(ec_impl, "decode_stripes", None))):
        return _decode_concat_framed(sinfo, ec_impl, work)
    with tracer.span("ec_decode") as sp:
        if sp is not None:
            sp.set_tag("k", k)
            sp.set_tag("missing", missing)
            sp.set_tag("stripes", n_stripes)
            sp.set_tag("offload", True)
        use, src = _reconstruct_stack(ec_impl, stacked, avail_ids)
        rec = np.asarray(await service.decode(ec_impl, use,
                                              tuple(missing), src))
        recovered = _reconstruct_unstack(rec, missing)
        return _decode_concat_assemble(sinfo, stacked, recovered, want,
                                       k, n_stripes)


def _decode_shards_frame(sinfo: StripeInfo, ec_impl,
                         to_decode: Mapping[int, bytes], need: list[int],
                         fragments: bool = False):
    """Shared repair-plan validation for decode_shards(): returns
    (arrays, helpers, plan_counts, sub, repair_per_chunk, n_chunks).

    `fragments` declares that the buffers were FETCHED per the plugin's
    sub-chunk repair plan (strided runs). Without it, whole-chunk
    buffers that happen to satisfy a repair plan's preconditions (a
    gather that topped up to >= d shards on a clay pool) must NOT be
    sliced by that plan — contiguous chunk thirds are not the plan's
    strided sub-chunk runs, and the mis-slice would silently decode
    garbage (and inflate the output q-fold)."""
    arrays = {i: np.frombuffer(sanitizer.unwrap(b), dtype=np.uint8)
              for i, b in to_decode.items()}
    if not arrays:
        raise ErasureCodeError("no chunks to decode")
    sub = ec_impl.get_sub_chunk_count()
    minimum = ec_impl.minimum_to_decode(need, set(arrays))
    if not fragments and any(
            sum(cnt for _, cnt in runs) != sub
            for runs in minimum.values()):
        # sub-chunk plan over whole-chunk buffers: decode from the
        # provided whole chunks instead
        minimum = {i: [(0, sub)] for i in sorted(arrays)}
    missing_helpers = sorted(set(minimum) - set(arrays))
    if missing_helpers:
        raise ErasureCodeError(
            f"repair plan needs shards {missing_helpers} that were not "
            f"fetched (have {sorted(arrays)})")
    subchunk_size = sinfo.chunk_size // sub
    # the repair plan must be homogeneous: every helper contributes the
    # same number of sub-chunks per chunk, or the fixed-stride slicing
    # below would mis-slice the fetched buffers
    plan_counts = {i: sum(cnt for _, cnt in runs)
                   for i, runs in minimum.items()}
    if len(set(plan_counts.values())) != 1:
        raise ErasureCodeError(
            f"heterogeneous repair plan (sub-chunks per chunk by shard): "
            f"{plan_counts}")
    repair_per_chunk = next(iter(plan_counts.values())) * subchunk_size
    helpers = sorted(minimum)
    sizes = {arrays[i].size for i in helpers}
    if len(sizes) != 1:
        raise ErasureCodeError(
            f"helper shard buffers differ in length: "
            f"{ {i: arrays[i].size for i in helpers} }")
    total = sizes.pop()
    if total % repair_per_chunk:
        raise ErasureCodeError("shard buffer not aligned to repair unit")
    return arrays, helpers, plan_counts, sub, repair_per_chunk, \
        total // repair_per_chunk


async def decode_shards_async(sinfo: StripeInfo, ec_impl,
                              to_decode: Mapping[int, bytes],
                              need: Iterable[int],
                              service=None,
                              fragments: bool = False) -> dict[int, bytes]:
    """decode_shards() with the repair dispatch routed through the
    offload service. Whole-chunk plans on batch-capable plugins ride the
    decode job's (n, k, C) shape; single-shard SUB-CHUNK plans (a
    regenerating repair fed with only repair_per_chunk bytes per helper
    chunk, declared by `fragments=True`) ride the service's repair job,
    coalesced per erasure pattern and run off the event loop. Mapped
    plugins and multi-shard sub-chunk plans keep the inline path."""
    need_l = sorted(set(need))
    if (fragments and service is not None and len(need_l) == 1
            and ec_impl.get_sub_chunk_count() > 1
            and not ec_impl.get_chunk_mapping()):
        arrays, helpers, plan_counts, sub, rpc, n_chunks = \
            _decode_shards_frame(sinfo, ec_impl, to_decode, need_l,
                                 fragments=True)
        if n_chunks > 0 and rpc < sinfo.chunk_size:
            with tracer.span("ec_recover") as sp:
                if sp is not None:
                    sp.set_tag("need", need_l)
                    sp.set_tag("helpers", helpers)
                    sp.set_tag("chunks", n_chunks)
                    sp.set_tag("sub_chunks", sub)
                    sp.set_tag("sub_chunks_fetched_per_chunk",
                               next(iter(plan_counts.values())))
                    sp.set_tag("offload", True)
                frags = np.stack([arrays[h].reshape(n_chunks, rpc)
                                  for h in helpers], axis=1)
                out = np.asarray(await service.repair(
                    ec_impl, tuple(helpers), tuple(need_l), frags,
                    sinfo.chunk_size))
                return {need_l[0]:
                        np.ascontiguousarray(out).tobytes()}
    if not (service is not None
            and ec_impl.get_sub_chunk_count() == 1
            and not ec_impl.get_chunk_mapping()
            and callable(getattr(ec_impl, "decode_stripes", None))):
        return decode_shards(sinfo, ec_impl, to_decode, need_l,
                             fragments=fragments)
    arrays, helpers, _plan, _sub, _rpc, n_chunks = _decode_shards_frame(
        sinfo, ec_impl, to_decode, need_l)
    if n_chunks == 0:
        return decode_shards(sinfo, ec_impl, to_decode, need_l,
                             fragments=fragments)
    with tracer.span("ec_recover") as sp:
        if sp is not None:
            sp.set_tag("need", need_l)
            sp.set_tag("helpers", helpers)
            sp.set_tag("chunks", n_chunks)
            sp.set_tag("offload", True)
        stacked = {i: arrays[i].reshape(n_chunks, sinfo.chunk_size)
                   for i in helpers}
        use, src = _reconstruct_stack(ec_impl, stacked, helpers)
        rec = np.asarray(await service.decode(ec_impl, use, tuple(need_l),
                                              src))
        return {nid: np.ascontiguousarray(plane).tobytes()
                for nid, plane in
                _reconstruct_unstack(rec, need_l).items()}


def decode_shards(sinfo: StripeInfo, ec_impl, to_decode: Mapping[int, bytes],
                  need: Iterable[int],
                  fragments: bool = False) -> dict[int, bytes]:
    """Reconstruct whole shards (data or parity) — the per-shard
    ECUtil::decode variant (ECUtil.cc:61-131) used by shard recovery.

    `to_decode` holds whole-chunk shard buffers, or — with
    `fragments=True` — sub-chunk fragments fetched per
    minimum_to_decode (each shard buffer contains
    repair_data_per_chunk bytes per chunk); `need` lists shard ids to
    rebuild. Returns full-size rebuilt shards.
    """
    need = sorted(set(need))
    arrays, helpers, plan_counts, sub, repair_per_chunk, n_chunks = \
        _decode_shards_frame(sinfo, ec_impl, to_decode, need,
                             fragments=fragments)

    with tracer.span("ec_recover") as sp:
        if sp is not None:
            sp.set_tag("need", need)
            sp.set_tag("helpers", helpers)
            sp.set_tag("chunks", n_chunks)
            # the sub-chunk repair plan (CLAY fetches fractions of each
            # helper chunk; RS fetches whole chunks = sub_chunks)
            sp.set_tag("sub_chunks", sub)
            sp.set_tag("sub_chunks_fetched_per_chunk",
                       next(iter(plan_counts.values())))
        if (sub == 1 and not ec_impl.get_chunk_mapping()
                and callable(getattr(ec_impl, "decode_stripes", None))
                and n_chunks > 0):
            # whole-chunk repair on a batch-capable plugin: ONE device
            # dispatch for all n_chunks repair units instead of a host
            # round trip per chunk — the recovery path is the most
            # bandwidth-hungry consumer (reference batching site:
            # src/osd/ECUtil.cc:61-131)
            stacked = {i: arrays[i].reshape(n_chunks, sinfo.chunk_size)
                       for i in helpers}
            recovered = _batched_reconstruct(ec_impl, stacked, helpers,
                                             need)
            return {nid: np.ascontiguousarray(plane).tobytes()
                    for nid, plane in recovered.items()}

        outs = {i: [] for i in need}
        for c in range(n_chunks):
            chunks = {i: arrays[i][c * repair_per_chunk:
                                   (c + 1) * repair_per_chunk].tobytes()
                      for i in helpers}
            decoded = ec_impl.decode(need, chunks, sinfo.chunk_size)
            for i in need:
                if len(decoded[i]) != sinfo.chunk_size:
                    raise ErasureCodeError(
                        f"decode returned {len(decoded[i])} bytes for "
                        f"shard {i}")
                outs[i].append(decoded[i])
        return {i: b"".join(parts) for i, parts in outs.items()}


# ---------------------------------------------------------------------------
# Per-shard cumulative chunk hashes
# ---------------------------------------------------------------------------

class HashInfo:
    """Cumulative per-shard crc32c across appends (ECUtil.h:141-199).

    Seeds at -1 like the reference's bufferlist crc32c; `append` must be
    called with the shard map of every append in order, with old_size
    equal to the pre-append per-shard size (torn-write detection).
    """

    def __init__(self, num_chunks: int = 0):
        self.total_chunk_size = 0
        self.cumulative_shard_hashes = [0xFFFFFFFF] * num_chunks
        self.projected_total_chunk_size = 0

    def has_chunk_hash(self) -> bool:
        return bool(self.cumulative_shard_hashes)

    def append(self, old_size: int, to_append: Mapping[int, bytes]) -> None:
        if old_size != self.total_chunk_size:
            raise ValueError(
                f"append at {old_size} but shard size is {self.total_chunk_size}")
        if not to_append:
            return
        sizes = {len(b) for b in to_append.values()}
        if len(sizes) != 1:
            raise ValueError(f"unequal shard append sizes {sizes}")
        size = sizes.pop()
        if self.has_chunk_hash():
            if set(to_append) != set(range(len(self.cumulative_shard_hashes))):
                raise ValueError(
                    f"append must cover shards 0.."
                    f"{len(self.cumulative_shard_hashes) - 1}, got "
                    f"{sorted(to_append)}")
            from ceph_tpu_torch.native import ec_native
            for shard, buf in to_append.items():
                self.cumulative_shard_hashes[shard] = ec_native.crc32c(
                    buf, self.cumulative_shard_hashes[shard])
        self.total_chunk_size += size

    def clear(self) -> None:
        self.total_chunk_size = 0
        self.cumulative_shard_hashes = [0xFFFFFFFF] * len(
            self.cumulative_shard_hashes)

    def get_chunk_hash(self, shard: int) -> int:
        return self.cumulative_shard_hashes[shard]

    def get_total_chunk_size(self) -> int:
        return self.total_chunk_size

    def get_total_logical_size(self, sinfo: StripeInfo) -> int:
        return self.total_chunk_size * (sinfo.stripe_width // sinfo.chunk_size)

    def set_projected_total_logical_size(self, sinfo: StripeInfo,
                                         logical: int) -> None:
        self.projected_total_chunk_size = \
            sinfo.aligned_logical_offset_to_chunk_offset(logical)

    def to_dict(self) -> dict:
        return {"total_chunk_size": self.total_chunk_size,
                "cumulative_shard_hashes": list(self.cumulative_shard_hashes)}

    @classmethod
    def from_dict(cls, d: dict) -> "HashInfo":
        h = cls()
        h.total_chunk_size = int(d["total_chunk_size"])
        h.cumulative_shard_hashes = [int(x) for x in
                                     d["cumulative_shard_hashes"]]
        return h
