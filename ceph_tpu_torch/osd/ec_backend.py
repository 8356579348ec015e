"""ECBackend: the erasure-coded PGBackend — the device codec's production
caller.

Re-creation of the reference EC write/read pipeline
(src/osd/ECBackend.cc, src/osd/ECCommon.cc, src/osd/ECTransaction.cc):
  * writes are PLANNED (ECTransaction::get_write_plan,
    src/osd/ECTransaction.h:34): the touched logical range is
    stripe-aligned, missing stripe fragments are read back from shards
    (the RMW pipeline, ECCommon.cc:704 start_rmw / :715
    try_state_to_reads), only the affected stripes are re-encoded — in
    ONE batched device dispatch — and per-shard extent sub-writes fan
    out to the acting set (ECCommon.cc:890-921); append and ranged
    overwrite are first-class (ECTransaction.cc:498-535 stripe-aligned
    zero-padding);
  * reads fetch ONLY the chunk extents of touched stripes
    (ECCommon.cc:281 get_min_avail_to_read_shards, :503
    get_want_to_read_shards); degraded reads reconstruct missing chunks
    from any k survivors via the plugin decode;
  * shard integrity rides a per-chunk crc32c list in an object attr,
    verified shard-side whenever a chunk is served — the analog of the
    reference's BlueStore Checksummer protection that ec_overwrites
    pools rely on (src/os/bluestore/Checksummer.h; the append-only
    HashInfo of src/osd/ECUtil.h:141 survives in ec_util for the tools
    layer, but a cumulative hash cannot absorb partial overwrites);
  * recovery reconstructs a lost position's chunk from k survivors and
    pushes it (RecoveryOp, ECBackend.h:191).

Idiomatic divergences: chunks live in the PG's collection with their
shard index as an attr instead of shard-suffixed collections (one OSD
holds at most one shard of a PG); no ExtentCache — the RMW read leans
on the batched gather instead; encode/decode go through the batched
ec_util driver — on a device plugin one device dispatch per stripe batch.

The port's copy of ceph_tpu/osd/ec_backend.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import asyncio
import json
import time

from ceph_tpu_torch.crush.crush import CRUSH_NONE
from ceph_tpu_torch.ec import registry
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.offload import get_service_or_none
from ceph_tpu_torch.qa import faultinject
from ceph_tpu_torch.msg.messages import (MOSDECSubOpRead, MOSDECSubOpReadReply,
                                         MOSDECSubOpWrite, MOSDECSubOpWriteReply)
from ceph_tpu_torch.objectstore.store import StoreError
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.osd.backend import (SUBOP_TIMEOUT, IntervalChange, PGBackend)
from ceph_tpu_torch.osd.pglog import LogEntry
from ceph_tpu_torch.utils import tracer
from ceph_tpu_torch.utils.dout import dout
from ceph_tpu_torch.utils.work_queue import mark_op_event

READ_TIMEOUT = 5.0

# shard-side rollback generation: before every sub-write apply, the
# current shard state is cloned to <oid>+PREV_SUFFIX. A divergent chain
# of partial fan-outs can otherwise fragment shard versions until NO
# version holds k chunks — with in-place overwrites the old consistent
# stripes would be gone for good (the reference keeps rollback extents
# in ECTransaction / rolls forward via ECDummyOp for the same reason;
# found by the thrashing model checker).
PREV_SUFFIX = "\x00prev"


class ECBackend(PGBackend):
    """Erasure-coded writes/reads over the acting set's shard positions."""

    def __init__(self, pg):
        super().__init__(pg)
        profile = dict(pg.host.osdmap.ec_profiles[pg.pool.ec_profile])
        self.ec_impl = registry.factory(profile.get("plugin", "jerasure"),
                                        profile)
        self.k = self.ec_impl.get_data_chunk_count()
        self.n = self.ec_impl.get_chunk_count()
        width = pg.pool.stripe_width or self.k * 4096
        self.sinfo = ec_util.StripeInfo(self.k, width)
        from ceph_tpu_torch.native import ec_native
        self._crc32c = ec_native.crc32c
        # the per-chunk shard csum engine (BlueStore Checksummer analog);
        # its async path submits through the offload service. None when
        # the chunk size isn't a power of two (bitmatrix techniques pad
        # to w*64, e.g. liberation's 4480): Checksummer enforces the
        # reference's pow2 csum_block_size, and those pools take the
        # native sync path anyway. It runs on the OSD's device.
        from ceph_tpu_torch.utils.checksummer import Checksummer
        c = self.sinfo.chunk_size
        self._checksummer = Checksummer("crc32c", c, device=pg.host.device) \
            if c & (c - 1) == 0 else None
        # crc of an all-zero chunk: hole stripes materialize as zeros
        self._zcrc = self._crc32c(b"\x00" * self.sinfo.chunk_size)
        # read gather plumbing: tid -> future resolving to (payload, data)
        self._read_waiters: dict[int, asyncio.Future] = {}
        # per-object write ordering lives in PGBackend._obj_locks now
        # (obj_lock): the PG's modify path holds it across log intent +
        # this backend's RMW/fan-out, and the replicated backend shares
        # the same discipline under pipelined execution
        # observability: extent bytes served to sub-reads (tests assert
        # ranged reads move << object size)
        self.sub_read_bytes_served = 0
        # repair-bandwidth accounting (the failure-storm bench's
        # repair-bytes ratio): actual bytes fetched by recovery
        # reconstruction gathers vs what a full-stripe gather (k whole
        # chunks) would have moved for the same repairs
        self.repair_bytes_fetched = 0
        self.repair_bytes_full = 0

    # -- helpers -------------------------------------------------------------

    def _live_positions(self) -> dict[int, int]:
        """shard index -> osd id for every non-hole acting position."""
        return {i: o for i, o in enumerate(self.pg.acting)
                if o != CRUSH_NONE and self.host.osdmap.is_up(o)}


    def _pad(self, data: bytes) -> bytes:
        w = self.sinfo.stripe_width
        pad = (-len(data)) % w
        # already aligned (every full-stripe client write): hand the
        # buffer through untouched — the `data + b""` form copied the
        # whole payload on the encode hot path. Unaligned tails arrive
        # as zero-copy memoryviews off the wire; only they pay the
        # materialize-and-pad.
        if not pad:
            return data
        return bytes(data) + b"\x00" * pad

    def _offload_svc(self):
        """The offload service, for DEVICE-batched plugins only: the
        jerasure family exposes the same batched API but computes on
        host, where queueing per-op work behind a linger deadline only
        adds latency."""
        if getattr(self.ec_impl, "device_batched", False):
            return get_service_or_none()
        return None

    async def _encode(self, data: bytes) -> dict[int, bytes]:
        """One batched encode dispatch through the process-wide offload
        service — concurrent PGs' stripes coalesce into one device
        batch — sampled into the daemon's `ec_encode_us` histogram
        (ec_util opens the per-dispatch span with bytes/k/m tags)."""
        t0 = time.perf_counter()
        shards = await ec_util.encode_async(self.sinfo, self.ec_impl, data,
                                            service=self._offload_svc())
        self.host.perf.hist_add("ec_encode_us",
                                (time.perf_counter() - t0) * 1e6)
        return shards

    def _csums(self, shard_buf: bytes) -> list[int]:
        """Per-chunk crc32c list of a shard buffer (Checksummer analog).
        One native batch call per buffer: a per-chunk Python/ctypes loop
        was ~25us per chunk and dominated the write path (profiled)."""
        c = self.sinfo.chunk_size
        if shard_buf and len(shard_buf) % c == 0:
            from ceph_tpu_torch.native import ec_native
            import numpy as np
            return [int(x) for x in ec_native.crc32c_blocks(
                np.frombuffer(shard_buf, dtype=np.uint8), c)]
        return [self._crc32c(shard_buf[i:i + c])
                for i in range(0, len(shard_buf), c)]

    async def _csums_shards(
            self, shards: dict[int, bytes]) -> dict[int, list[int]]:
        """Per-chunk crc32c lists for ALL shards of one write in a
        single CrcJob through the offload service: the n per-shard
        checksum calls become one batch that also coalesces with
        concurrent writers and runs off the event loop (the BlueStore
        Checksummer's batch shape, src/common/Checksummer.h:195-234)."""
        c = self.sinfo.chunk_size
        # only the device-plugin pools ride the queue (a jerasure pool
        # gains nothing from the linger wait its writes would pay), and
        # only when the crc work is big enough to beat the queue round
        # trip — the native kernel does a tiny op's csums in ~30 µs,
        # cheaper than any linger
        svc = self._offload_svc()
        lens = {len(b) for b in shards.values()}
        total_blocks = sum(len(b) for b in shards.values()) // c
        if (svc is None or self._checksummer is None or not shards
                or lens == {0} or any(ln % c for ln in lens)
                or (total_blocks < 256 and not svc.crc_device)):
            return {i: self._csums(b) for i, b in shards.items()}
        order = sorted(shards)
        # ONE scatter CrcJob over the per-shard buffers: the fragments
        # stack straight into the offload service's warm staging pages
        # (the old b"".join here paid an unmetered full copy of every
        # csum'd byte before the job was even submitted)
        crcs = await self._checksummer.calculate_async(
            [shards[i] for i in order], service=svc)
        out: dict[int, list[int]] = {}
        row = 0
        for i in order:
            n = len(shards[i]) // c
            out[i] = [int(x) for x in crcs[row:row + n]]
            row += n
        return out

    def _chunk_attrs(self, shard: int, size: int, version,
                     csums: list[int]) -> dict:
        return {"shard": str(shard).encode(),
                "ec_size": str(size).encode(),
                "csum": json.dumps(csums).encode(),
                "version": json.dumps(list(version)).encode()}

    def _verified_local_extent(
            self, oid: str, chunk_off: int, chunk_len: int,
            prev: bool = False,
            snap: int | None = None) -> tuple[bytes, int, int, tuple] | None:
        """Read [chunk_off, chunk_off+chunk_len) of the local shard blob
        (or its rollback generation, or a snap CLONE's chunk — clones
        carry the head's attrs from clone time, so the same crc/version
        verification applies) with per-chunk crc verification; None if
        absent or corrupt."""
        if prev:
            oid = oid + PREV_SUFFIX
        cid = self.coll()
        if snap is not None:
            from ceph_tpu_torch.osd import snaps as snapmod
            gh = snapmod.clone_gh(self.ghobject(oid), snap)
            if not self.host.store.exists(cid, gh):
                return None
        else:
            if not self.local_exists(oid):
                return None
            gh = self.ghobject(oid)
        try:
            data = self.host.store.read(cid, gh, chunk_off,
                                        None if chunk_len < 0 else chunk_len)
            attrs = self.host.store.getattrs(cid, gh)
        except StoreError as e:
            # a FileStore blob whose crc gate refuses the read: treat as
            # a missing local chunk and reconstruct around it
            dout("osd", 1, f"ec local shard of {oid} unreadable: {e}")
            return None
        shard = int(attrs["shard"])
        csums = json.loads(attrs.get("csum", b"[]"))
        c = self.sinfo.chunk_size
        haves = self._csums(data) if data else []
        for i, have in enumerate(haves):
            s = chunk_off // c + i
            want = csums[s] if s < len(csums) else None
            if have != want:
                dout("osd", 1, f"ec shard {shard} of {oid}: chunk {s} crc "
                               f"{have:#x} != {want} (EIO)")
                return None
        return (data, shard, int(attrs["ec_size"]),
                tuple(json.loads(attrs.get("version", b"[0, 0]"))))

    # -- write path (RMWPipeline) --------------------------------------------

    async def execute_write(self, oid: str, op: str, data: bytes,
                            entry: LogEntry, off: int = 0) -> None:
        """Runs under the caller's obj_lock (PG._do_modify holds it
        across log intent + this call; _rewrite_consistent takes it for
        the recovery-side rewrite) — pipelined ops to DIFFERENT objects
        overlap here, same-object RMWs serialize."""
        with tracer.span("ec_write", f"osd.{self.host.whoami}") as sp:
            if sp is not None:
                sp.set_tag("op", op)
                sp.set_tag("oid", oid)
                sp.set_tag("bytes", len(data))
                sp.set_tag("k", self.k)
                sp.set_tag("m", self.n - self.k)
            await self._execute_write_locked(oid, op, data, entry, off)

    async def _execute_write_locked(self, oid: str, op: str, data: bytes,
                                    entry: LogEntry, off: int) -> None:
        if not isinstance(data, (bytes, bytearray)) and \
                op not in ("write_full", "push", "write"):
            # control-kind payloads (json / decimal-coded op args —
            # setxattr, zero lengths, clone/rollback args) arrive as
            # zero-copy memoryviews off the wire; their decoders below
            # need bytes semantics. The bulk kinds keep the view all
            # the way into the encode batch.
            data = bytes(data)
        live = self._live_positions()
        if len(live) < self.pg.pool.min_size:
            # the reference blocks the op until min_size is met; our
            # client resends until the interval heals
            raise IntervalChange(
                f"ec pg {self.pg.pgid}: {len(live)} live shards < "
                f"min_size {self.pg.pool.min_size}")

        if op in ("write_full", "push"):
            padded = self._pad(data)
            shards = await self._encode(padded) \
                if padded else {i: b"" for i in range(self.n)}
            csums = await self._csums_shards(shards)
            # WRITEFULL replaces data, not xattrs: the full-state shard
            # rewrite must carry the user attrs forward (the primary's
            # copy is authoritative — xattrs replicate to every shard)
            uattrs = self._local_user_attrs(oid)
            payloads = {
                i: ({"op": "write_full",
                     "attrs": self._encode_attrs({**self._chunk_attrs(
                         i, len(data), entry.version,
                         csums[i]), **uattrs})},
                    shards[i])
                for i in live}
        elif op in ("delete", "remove"):
            payloads = {i: ({"op": "delete"}, b"") for i in live}
        elif op == "setxattr":
            kv = json.loads(data)
            size, ver = await self._current_state(oid)
            if tuple(ver) == (0, 0):
                # xattr-on-absent creates the object: ONE sub-op writes
                # empty shards carrying the attr, atomically under this
                # object's lock (a separate exists-check + create would
                # race a concurrent data write)
                uat = {"u:" + kv["name"]: kv["value"].encode("latin1"),
                       **self._local_user_attrs(oid)}
                payloads = {
                    i: ({"op": "write_full",
                         "attrs": self._encode_attrs({
                             **self._chunk_attrs(i, 0, entry.version,
                                                 self._csums(b"")),
                             **uat})}, b"")
                    for i in live}
            else:
                payloads = {i: ({"op": "setxattr", "name": kv["name"],
                                 "value": kv["value"]}, b"")
                            for i in live}
        elif op == "rmxattr":
            payloads = {i: ({"op": "rmxattr",
                             "name": bytes(data).decode()}, b"")
                        for i in live}
        elif op == "zero":
            # same store semantics as the replicated txn.zero here: a
            # ranged write of zeros (extends past the end like a write)
            payloads = await self._plan_rmw(oid, "write",
                                            off, b"\x00" * int(data),
                                            entry, live)
            if payloads is None:
                return
        elif op == "truncate":
            cur_size, _ver = await self._current_state(oid)
            if off == cur_size:
                return
            if off > cur_size:
                # GROW rides the zero-fill RMW: the old tail stripe may
                # carry residue past cur_size (a prior mid-stripe
                # shrink keeps the stripe's bytes), and growing the
                # logical size would expose it as data — the RMW plan
                # re-encodes that stripe with explicit zeros (found by
                # the thrashing model checker)
                payloads = await self._plan_rmw(
                    oid, "write", cur_size, b"\x00" * (off - cur_size),
                    entry, live, cur_state=(cur_size, _ver))
            else:
                payloads = self._plan_shrink(off, entry, live)
        elif op in ("write", "append"):
            payloads = await self._plan_rmw(oid, op, off, data, entry, live)
            if payloads is None:        # zero-length no-op past the plan
                return
        elif op == "rollback":
            # EC rollback re-asserts the CLONE'S CONTENT as a fresh full
            # write instead of a per-shard clone-to-head copy: a shard
            # whose clone chunk is a recovery hole would silently no-op
            # the copy and diverge from the acting set (found in review).
            # The gather reconstructs the clone from any k holders.
            from ceph_tpu_torch.osd import snaps as snapmod
            ss = await self.gather_snapset(oid)
            src = snapmod.resolve_read(ss, int(data), True)
            if src is None or src == "head":
                return                  # caller pre-resolved; no-op here
            content = await self.execute_read(oid, 0, 0, snap=src)
            await self._execute_write_locked(oid, "write_full", content,
                                             entry, 0)
            return
        elif op == "clone":
            # stamp the LOGICAL size into the per-shard clone record
            # (each shard would otherwise record its chunk-blob size and
            # list_snaps would report padded nonsense)
            args = json.loads(data)
            args["size"], _ = await self._current_state(oid)
            payloads = {i: ({"op": "clone", "args": json.dumps(args),
                             "version": list(entry.version)}, b"")
                        for i in live}
        elif op in ("snaptrim", "purge"):
            # snapshot maintenance ops are deterministic per-shard STORE
            # ops: every shard trims/purges ITS OWN chunk blobs, and the
            # SnapSet replicates onto every shard's snapdir — exactly how
            # chunk data and xattrs already replicate (the reference
            # generates the same per-shard transactions in
            # ECTransaction::generate_transactions for ec pool snaps)
            payloads = {i: ({"op": op,
                             "args": bytes(data).decode("latin1"),
                             "version": list(entry.version)}, b"")
                        for i in live}
        else:
            raise StoreError("EINVAL", f"unknown ec op {op!r}")
        await self._fan_out(oid, payloads, entry, live)

    @staticmethod
    def _encode_attrs(attrs: dict) -> dict:
        return {k: v.decode("latin1") for k, v in attrs.items()}

    async def _plan_rmw(self, oid: str, op: str, off: int, data: bytes,
                        entry: LogEntry, live: dict,
                        cur_state: tuple | None = None) -> dict | None:
        """get_write_plan + generate_transactions analog
        (src/osd/ECTransaction.h:34, :97): stripe-align the touched
        range, read back only the stripe fragments the new data does not
        fully cover, re-encode the touched stripes in one batched
        dispatch, and emit per-shard extent sub-writes. `cur_state`
        passes an already-gathered (size, version) to avoid a second
        gather under the same object lock."""
        w, c = self.sinfo.stripe_width, self.sinfo.chunk_size
        cur_size, cur_ver = cur_state if cur_state is not None \
            else await self._current_state(oid)
        if op == "append":
            off = cur_size
        if not data:
            return None                     # zero-length write: no-op
        new_size = max(cur_size, off + len(data))
        first = off // w
        last = -(-(off + len(data)) // w)   # exclusive
        if new_size > cur_size and cur_size % w and cur_size // w < first:
            # growing past a mid-stripe tail: that tail stripe must be
            # rewritten too, or its residue past cur_size (left by a
            # shrink) surfaces as logical data once the size grows over
            # it (found by the thrashing model checker). The in-between
            # hole stripes get dense explicit zeros — O(gap) work,
            # acceptable at this stripe scale (a sparse two-extent plan
            # is the optimization if huge seeks ever matter).
            first = cur_size // w
        old_n = -(-cur_size // w)
        read_upto = min(last, old_n)
        need_read = any(
            not (off <= s * w and (s + 1) * w <= off + len(data))
            for s in range(first, read_upto))
        existing = b""
        if need_read:
            got, _, _ = await self._gather_chunks(
                oid, chunk_off=first * c,
                chunk_len=(read_upto - first) * c)
            existing = await ec_util.decode_concat_async(
                self.sinfo, self.ec_impl, got,
                service=self._offload_svc())
        region = bytearray((last - first) * w)
        region[:len(existing)] = existing
        if existing:
            # bytes past the CURRENT logical size are stale tail-stripe
            # residue (a mid-stripe truncate keeps the stripe's
            # data+parity consistent but logically cut): they must read
            # back as zeros or a gap-leaving write resurrects them into
            # the zero-filled gap (found by the thrashing model checker)
            base_tail = cur_size - first * w
            if 0 <= base_tail < len(region):
                region[base_tail:] = b"\x00" * (len(region) - base_tail)
        start = off - first * w
        region[start:start + len(data)] = data
        # bytes past new_size inside the tail stripe are padding: zero
        # them explicitly in case the read-back carried old padding
        tail = new_size - first * w
        if tail < len(region):
            region[tail:] = b"\x00" * (len(region) - tail)

        # the bufferlist region goes to the codec as-is (np.frombuffer
        # views a bytearray zero-copy); the old bytes(region) paid a
        # full extra copy per RMW merge
        shards = await self._encode(region)
        csums = await self._csums_shards(shards)
        new_n = -(-new_size // w)
        payloads = {}
        for i in live:
            # hole stripes between the old tail and the write need no
            # updates: _apply_extent fills missing csum slots with the
            # zero-chunk crc, matching the store's gap zero-fill
            updates = [[first + s_rel, crc]
                       for s_rel, crc in enumerate(csums[i])]
            payloads[i] = ({"op": "extent_write",
                            "chunk_off": first * c,
                            "new_size": new_size,
                            "new_chunks": new_n,
                            "csum_updates": updates,
                            "shard": i,
                            "version": list(entry.version)}, shards[i])
        return payloads

    def _plan_shrink(self, size: int, entry: LogEntry,
                     live: dict) -> dict:
        """Per-shard shrink plan: an extent_write with no data — the
        shared apply path truncates the blob to the new chunk count and
        trims/refreshes the csum list (the reference's EC truncate rides
        generate_transactions the same way, src/osd/ECTransaction.cc).
        No re-encode is needed: whole tail stripes drop, and the
        partially-cut tail stripe keeps consistent data+parity — reads
        slice to ec_size, and every RMW re-zeroes past it before reuse
        (see _plan_rmw's residue handling)."""
        w = self.sinfo.stripe_width
        new_chunks = -(-size // w)
        return {i: ({"op": "extent_write", "chunk_off": 0,
                     "new_size": size, "new_chunks": new_chunks,
                     "csum_updates": [], "shard": i,
                     "version": list(entry.version)}, b"")
                for i in live}

    def _local_user_attrs(self, oid: str) -> dict[str, bytes]:
        """This OSD's copy of the object's user xattrs (replicated onto
        every shard, so any live holder — the primary included — is an
        authoritative source)."""
        try:
            attrs = self.host.store.getattrs(self.coll(),
                                             self.ghobject(oid))
        except StoreError:
            return {}
        return {k: v for k, v in attrs.items() if k.startswith("u:")}

    async def verify_dup_committed(self, oid, version) -> bool:
        """A dup hit is answerable only when the write is actually
        READABLE at its version: an EC entry is logged before the shard
        fan-out, so a failure can leave it applied on too few (or zero)
        shards. ENOENT means a later delete committed — done. A gather
        at an OLDER version means the write never landed — re-execute.
        A gather at a NEWER version is AMBIGUOUS (the entry may have
        been cleanly superseded, or may never have applied before the
        later write): neither "done" nor re-execution is safe, so the
        op errors out honestly and the client's model keeps both
        outcomes. Gather EIO is the same ambiguity."""
        try:
            _, _, meta = await self._gather_chunks(oid, chunk_off=0,
                                                   chunk_len=0)
        except StoreError as e:
            if e.code == "ENOENT":
                # no shard anywhere: EITHER a later delete committed
                # (done) OR this very entry was a first write that
                # never applied (must re-execute). The log's newest
                # entry for the oid tells them apart.
                return self._log_tombstoned(oid)
            raise StoreError(
                "EIO", f"{oid}: dup retry unverifiable ({e})")
        got = tuple(meta["version"])
        want = tuple(version)
        if got == want:
            return True
        if got < want:
            return False              # never landed: safe to re-execute
        raise StoreError(
            "EIO", f"{oid}: dup retry at {want} superseded by {got}; "
            f"outcome unknowable")

    async def _current_state(self, oid: str) -> tuple[int, tuple]:
        """(logical size, version) of the object, 0/(0,0) if absent."""
        loc = self._verified_local_extent(oid, 0, 0)
        if loc is not None:
            return loc[2], loc[3]
        try:
            got, size, meta = await self._gather_chunks(
                oid, chunk_off=0, chunk_len=0)
            return size, meta["version"]
        except StoreError as e:
            if e.code == "ENOENT":
                return 0, (0, 0)
            raise

    async def _fan_out(self, oid: str, payloads: dict, entry: LogEntry,
                       live: dict) -> None:
        tid = self.new_tid()
        peers = {o for o in live.values() if o != self.host.whoami}
        fut = self._start_waiting(tid, peers)
        failed = []
        entry_dict = entry.to_dict()    # once, not per peer
        for idx, osd in live.items():
            sub, chunk = payloads[idx]
            if osd == self.host.whoami:
                self._apply_sub_write(oid, idx, sub, chunk)
                continue
            try:
                await self.host.send_osd(osd, MOSDECSubOpWrite(
                    {"pgid": [self.pg.pgid.pool, self.pg.pgid.ps],
                     "tid": tid, "from": self.host.whoami, "oid": oid,
                     "shard": idx, "sub": sub,
                     "entry": entry_dict}, chunk))
            except Exception as e:
                # an unreachable peer the map hasn't caught up on: the
                # write must NOT be acked with a subset of live shards —
                # a fake ack here lets an acked write become undecodable
                # after m more failures. Fail the op; the
                # client retries until heartbeats push the peer out of
                # the acting set (the reference blocks degraded EC writes
                # the same way).
                dout("osd", 3, f"ec sub-write to osd.{osd} failed: "
                               f"{type(e).__name__} {e}")
                failed.append(osd)
        if failed:
            self._inflight.pop(tid, None)
            raise IntervalChange(
                f"ec sub-writes to osds {failed} failed; "
                f"retry next interval")
        mark_op_event("sub_ops_sent")
        await asyncio.wait_for(fut, SUBOP_TIMEOUT)
        mark_op_event("commit")

    def _stash_prev(self, oid: str) -> None:
        """Clone the current shard state to the rollback generation."""
        cid = self.coll()
        gh, pgh = self.ghobject(oid), self.ghobject(oid + PREV_SUFFIX)
        if not self.host.store.exists(cid, gh):
            return
        from ceph_tpu_torch.objectstore.store import Transaction
        txn = Transaction()
        if self.host.store.exists(cid, pgh):
            txn.remove(cid, pgh)
        txn.clone(cid, gh, pgh)
        self.host.store.queue_transaction(txn)

    def _apply_sub_write(self, oid: str, shard: int, sub: dict,
                         chunk: bytes) -> None:
        kind = sub["op"]
        self._stash_prev(oid)
        if kind == "write_full":
            attrs = {k: v.encode("latin1") for k, v in sub["attrs"].items()}
            self.local_apply(oid, "push", chunk, attrs=attrs)
        elif kind == "extent_write":
            self._apply_extent(oid, sub, chunk)
        elif kind == "setxattr":
            # user xattrs replicate onto EVERY shard (the reference
            # stores object attrs alongside each shard the same way)
            self.local_apply(oid, "setxattr", json.dumps(
                {"name": sub["name"], "value": sub["value"]}).encode())
        elif kind == "rmxattr":
            self.local_apply(oid, "rmxattr", sub["name"].encode())
        elif kind == "delete":
            self.local_apply(oid, "delete", b"")
        elif kind in ("clone", "snaptrim", "purge"):
            self.local_apply(oid, kind, sub["args"].encode("latin1"))
        else:
            raise StoreError("EINVAL", f"unknown ec sub-op {kind!r}")
        if chunk and faultinject.armed():
            # injected shard bit-rot AFTER the apply: the per-chunk crc
            # attr now disagrees with the blob, exactly like silent
            # media rot — the read/scrub crc gates must catch it
            off = faultinject.maybe_bitrot(len(chunk))
            if off is not None:
                self.host.store.corrupt(
                    self.coll(), self.ghobject(oid),
                    sub.get("chunk_off", 0) + off)

    def _apply_extent(self, oid: str, sub: dict, chunk: bytes) -> None:
        """Apply a per-shard extent sub-write: splice the chunk extent
        into the shard blob (gaps zero-fill via store semantics), merge
        the per-chunk csum updates, refresh size/version attrs
        (the per-shard ObjectStore::Transaction of
        src/osd/ECTransaction.cc:97 generate_transactions)."""
        from ceph_tpu_torch.objectstore.store import Transaction
        cid, gh = self.coll(), self.ghobject(oid)
        store = self.host.store
        old_csum: list[int] = []
        if store.exists(cid, gh):
            try:
                old_csum = json.loads(store.getattr(cid, gh, "csum"))
            except StoreError:
                old_csum = []
        new_chunks = sub["new_chunks"]
        csums = [old_csum[s] if s < len(old_csum) else self._zcrc
                 for s in range(new_chunks)]
        for s, crc in sub["csum_updates"]:
            if s < new_chunks:
                csums[s] = crc
        txn = Transaction()
        if not store.exists(cid, gh):
            txn.touch(cid, gh)
        if chunk:
            txn.write(cid, gh, sub["chunk_off"], chunk)
        c = self.sinfo.chunk_size
        txn.truncate(cid, gh, new_chunks * c)
        txn.setattrs(cid, gh, self._chunk_attrs(
            sub["shard"], sub["new_size"], sub["version"], csums))
        store.queue_transaction(txn)

    # -- read path (ReadPipeline) --------------------------------------------

    async def _gather_chunks(
            self, oid: str,
            exclude_osds: frozenset = frozenset(),
            allow_rollback: bool = False,
            chunk_off: int = 0,
            chunk_len: int = -1,
            snap: int | None = None,
    ) -> tuple[dict[int, bytes], int, dict]:
        """Collect shard chunk EXTENTS [chunk_off, chunk_off+chunk_len)
        until a version-consistent decodable set exists; returns
        ({shard: extent}, logical size, meta). chunk_len < 0 means to the
        end of the shard; chunk_len == 0 fetches no data (stat).

        Shards carry the eversion of the write that produced them: mixing
        chunks of two writes would decode garbage (the reference guards
        with per-shard hashes), so only the newest version holding >= k
        extents is used. `exclude_osds` keeps a recovery target's own
        stale chunk out of its reconstruction. Raises StoreError ENOENT
        when no shard exists anywhere, EIO when shards exist but no
        version is decodable (transient: peers down/slow — NOT proof of
        deletion).

        If a NEWER version than the best decodable one was observed, the
        default is EIO (serving the older version would roll back a
        possibly-acked write). Recovery passes `allow_rollback=True`: a
        partial never-acked fan-out must not wedge peering forever, so
        the divergent suffix is rewound to the older consistent version
        (the reference's peering rewinds uncommitted divergent entries
        the same way); meta["rolled_back"] reports it.
        """
        # per observed version: {shard: (extent, ec_size)}
        by_version: dict[tuple, dict[int, tuple]] = {}
        uattrs_by: dict[tuple, dict] = {}

        def add(shard: int, data: bytes, size: int, ver,
                uattrs: dict | None = None) -> None:
            by_version.setdefault(tuple(ver), {})[shard] = (data, size)
            if uattrs:
                uattrs_by.setdefault(tuple(ver), {}).update(uattrs)

        def best() -> tuple | None:
            for ver in sorted(by_version, reverse=True):
                if len(by_version[ver]) >= self.k:
                    return ver
            return None

        if self.host.whoami not in exclude_osds:
            loc = self._verified_local_extent(oid, chunk_off, chunk_len,
                                              snap=snap)
            if loc is not None:
                data, shard, size, ver = loc
                add(shard, data, size, ver,
                    {k[2:]: v.decode("latin1") for k, v in
                     self._local_user_attrs(oid).items()})

        # two rounds: ask a minimum set first (k shards total, preferring
        # data positions), top up with the remaining positions only when
        # the first round can't decode — the reference reads exactly
        # minimum_to_decode and falls back to extra shards on miss
        candidates = [(idx, osd)
                      for idx, osd in sorted(self._live_positions().items())
                      if osd != self.host.whoami
                      and osd not in exclude_osds]
        need_first = max(0, self.k - sum(len(v) for v in
                                         by_version.values()))
        rounds = [candidates[:need_first], candidates[need_first:]]
        waits: dict[asyncio.Future, int] = {}
        deadline = asyncio.get_running_loop().time() + READ_TIMEOUT

        async def send_round(batch) -> set:
            futs = set()
            for idx, osd in batch:
                tid = self.new_tid()
                fut = asyncio.get_running_loop().create_future()
                self._read_waiters[tid] = fut
                waits[fut] = tid
                try:
                    await self.host.send_osd(osd, MOSDECSubOpRead(
                        {"pgid": [self.pg.pgid.pool, self.pg.pgid.ps],
                         "tid": tid, "from": self.host.whoami, "oid": oid,
                         "chunk_off": chunk_off, "chunk_len": chunk_len,
                         "snap": snap}))
                    futs.add(fut)
                except Exception as e:
                    # unreachable peer: just a missing chunk, not a failed
                    # read — the top-up round covers it
                    dout("osd", 3, f"ec sub-read to osd.{osd} failed: "
                                   f"{type(e).__name__} {e}")
                    fut.cancel()
            return futs

        try:
            pending = await send_round(rounds[0])
            topped_up = False
            half = deadline - READ_TIMEOUT / 2
            # early exit at k decodable chunks: one slow-but-up shard must
            # not stall every read for the full timeout
            while True:
                now = asyncio.get_running_loop().time()
                # top up when the minimum round can no longer decode on
                # its own: chunks of DIFFERENT versions don't combine, so
                # count the best single version, not the cross-version
                # sum; a half-spent deadline also triggers the top-up
                # (slow peer + stale local chunk could otherwise starve
                # a servable read)
                have_best = max((len(v) for v in by_version.values()),
                                default=0)
                if best() is None and not topped_up and (
                        not pending
                        or len(pending) + have_best < self.k
                        or now > half):
                    pending |= await send_round(rounds[1])
                    topped_up = True
                if not pending or best() is not None:
                    break
                wake = deadline if topped_up else min(deadline, half)
                timeout = wake - asyncio.get_running_loop().time()
                if timeout <= 0:
                    if topped_up:
                        break
                    continue    # hit the half mark: run the top-up branch
                done, pending = await asyncio.wait(
                    pending, timeout=timeout,
                    return_when=asyncio.FIRST_COMPLETED)
                for fut in done:
                    payload, data = fut.result()
                    if payload.get("found"):
                        add(payload["shard"], data, payload["ec_size"],
                            payload.get("version", (0, 0)),
                            payload.get("uattrs"))
        finally:
            for fut, tid in waits.items():
                fut.cancel()
                self._read_waiters.pop(tid, None)
        if best() is None and by_version and allow_rollback:
            # no MAIN version is decodable: a chain of partial fan-outs
            # fragmented the shard versions. Pull the shards' rollback
            # generations — every sub-write stashed its predecessor — so
            # an older consistent version can be reassembled instead of
            # wedging peering forever (the reference's rollback-extent
            # machinery serves the same purpose)
            await self._gather_prev_pass(oid, exclude_osds, chunk_off,
                                         chunk_len, add)
        ver = best()
        if ver is None:
            if not by_version:
                raise StoreError("ENOENT", f"{oid} has no shards anywhere")
            raise StoreError(
                "EIO", f"{oid}: no version has {self.k} shards "
                f"(saw {({v: sorted(s) for v, s in by_version.items()})})")
        newest = max(by_version)
        rolled_back = False
        if newest > ver:
            # a NEWER committed write exists but is currently undecodable:
            # serving the older decodable version would silently roll back
            # an acked write — answer EIO until recovery restores it
            # (the reference's rollforward machinery guarantees
            # the same by never exposing a pre-rollforward state)
            if not allow_rollback:
                raise StoreError(
                    "EIO", f"{oid}: newest version {newest} has only "
                    f"{len(by_version[newest])} of {self.k} shards; "
                    f"refusing to serve older {ver}")
            rolled_back = True
            dout("osd", 1, f"ec {oid}: rolling divergent partial write "
                           f"{newest} ({len(by_version[newest])} shards) "
                           f"back to {ver}")
        shards = by_version[ver]
        got = {shard: data for shard, (data, _) in shards.items()}
        any_shard = next(iter(shards.values()))
        return got, any_shard[1], {"version": ver,
                                   "rolled_back": rolled_back,
                                   "uattrs": uattrs_by.get(ver, {})}

    async def _gather_prev_pass(self, oid: str, exclude_osds: frozenset,
                                chunk_off: int, chunk_len: int,
                                add) -> None:
        """One round asking every live shard for its rollback
        generation; results merge into the caller's version table."""
        if self.host.whoami not in exclude_osds:
            loc = self._verified_local_extent(oid, chunk_off, chunk_len,
                                              prev=True)
            if loc is not None:
                data, shard, size, ver = loc
                add(shard, data, size, ver)
        waits: dict[asyncio.Future, int] = {}
        pending: set = set()
        for idx, osd in sorted(self._live_positions().items()):
            if osd == self.host.whoami or osd in exclude_osds:
                continue
            tid = self.new_tid()
            fut = asyncio.get_running_loop().create_future()
            self._read_waiters[tid] = fut
            waits[fut] = tid
            try:
                await self.host.send_osd(osd, MOSDECSubOpRead(
                    {"pgid": [self.pg.pgid.pool, self.pg.pgid.ps],
                     "tid": tid, "from": self.host.whoami, "oid": oid,
                     "chunk_off": chunk_off, "chunk_len": chunk_len,
                     "prev": True}))
                pending.add(fut)
            except Exception:
                fut.cancel()
        try:
            deadline = asyncio.get_running_loop().time() + READ_TIMEOUT / 2
            while pending:
                timeout = deadline - asyncio.get_running_loop().time()
                if timeout <= 0:
                    break
                done, pending = await asyncio.wait(
                    pending, timeout=timeout,
                    return_when=asyncio.ALL_COMPLETED)
                for fut in done:
                    payload, data = fut.result()
                    if payload.get("found"):
                        add(payload["shard"], data, payload["ec_size"],
                            payload.get("version", (0, 0)),
                            payload.get("uattrs"))
        finally:
            for fut, tid in waits.items():
                fut.cancel()
                self._read_waiters.pop(tid, None)

    async def execute_read(self, oid: str, offset: int,
                           length: int, snap: int | None = None) -> bytes:
        """Ranged read: fetch only the chunk extents of touched stripes
        (the reference computes the same bounds via
        offset_len_to_stripe_bounds, ECCommon.cc:281,503). With `snap`,
        the same gather runs against a snap CLONE's chunk blobs."""
        w, c = self.sinfo.stripe_width, self.sinfo.chunk_size
        first = offset // w
        if length <= 0:
            chunk_off, chunk_len = first * c, -1
        else:
            last = -(-(offset + length) // w)
            chunk_off, chunk_len = first * c, (last - first) * c
        got, ec_size, _ = await self._gather_chunks(
            oid, chunk_off=chunk_off, chunk_len=chunk_len, snap=snap)
        data = await ec_util.decode_concat_async(
            self.sinfo, self.ec_impl, got, service=self._offload_svc())
        start = offset - first * w
        end = (ec_size if length <= 0 else min(offset + length, ec_size)) \
            - first * w
        return data[start:max(start, end)]

    async def gather_snapset(self, oid: str, authoritative: bool = False):
        """The object's SnapSet. Default (read path): local snapdir
        first — clone sub-ops replicate it to every live shard and an
        ACTIVE primary processes every snap mutation, so its local copy
        is fresh — else the first live peer holding one. With
        `authoritative` (recovery pull on a possibly-stale primary):
        query local AND every live peer, adopt the highest seq (ties →
        fewest clones: a same-seq divergence means this holder missed a
        TRIM, never a clone — clones always advance seq). None = no
        snapshot state anywhere reachable."""
        from ceph_tpu_torch.osd import snaps as snapmod
        local = snapmod.load_snapset(self.host.store, self.coll(),
                                     self.ghobject(oid))
        if local is not None and not authoritative:
            return local
        found = [local] if local is not None else []
        for idx, osd in sorted(self._live_positions().items()):
            if osd == self.host.whoami:
                continue
            tid = self.new_tid()
            fut = asyncio.get_running_loop().create_future()
            self._read_waiters[tid] = fut
            try:
                await self.host.send_osd(osd, MOSDECSubOpRead(
                    {"pgid": [self.pg.pgid.pool, self.pg.pgid.ps],
                     "tid": tid, "from": self.host.whoami, "oid": oid,
                     "want_ss": True}))
                payload, _ = await asyncio.wait_for(fut, READ_TIMEOUT / 2)
                if payload.get("ss"):
                    ss = snapmod.SnapSet.from_json(payload["ss"].encode())
                    if not authoritative:
                        return ss
                    found.append(ss)
            except Exception:
                continue
            finally:
                self._read_waiters.pop(tid, None)
        if not found:
            return None
        return max(found, key=lambda ss: (ss.seq, -len(ss.clones)))

    async def execute_stat(self, oid: str, snap: int | None = None) -> int:
        loc = self._verified_local_extent(oid, 0, 0, snap=snap)
        if loc is not None:
            return loc[2]
        _, ec_size, _ = await self._gather_chunks(oid, chunk_off=0,
                                                  chunk_len=0, snap=snap)
        return ec_size

    async def object_exists(self, oid: str) -> bool:
        if self.local_exists(oid):
            return True
        try:
            await self._gather_chunks(oid, chunk_off=0, chunk_len=0)
            return True
        except StoreError as e:
            # EIO = shards exist but are (transiently) undecodable: the
            # object exists; only authoritative absence is False
            return e.code != "ENOENT"

    def object_size(self, oid: str) -> int:
        _, attrs = self.read_for_push(oid)
        return int(attrs["ec_size"])

    # -- sub-op handlers (shard side) ----------------------------------------

    async def handle_sub_op(self, conn, msg) -> None:
        p = msg.payload
        if isinstance(msg, MOSDECSubOpWrite):
            self._apply_sub_write(p["oid"], p["shard"], p["sub"], msg.data)
            entry = LogEntry.from_dict(p["entry"])
            # out-of-order-tolerant insert: pipelined same-PG fan-outs
            # to different objects can arrive v6-before-v5 (see
            # ReplicatedBackend.handle_rep_op)
            self.pg.log.insert(entry)
            if p["sub"]["op"] in ("write_full", "delete"):
                # full-state sub-ops supersede whatever was missing;
                # an EXTENT write does not restore the base, so a
                # recovering shard stays in the missing set
                self.pg.log.mark_recovered(p["oid"])
            # coalesced: one meta persist per batch drain, not per
            # sub-op (pipelined primaries ship ~depth entries per
            # envelope; the apply above is already durable store
            # state). The reply rides the flush: the ack never outruns
            # the durable log entry
            self.pg.persist_meta_soon(ack=(conn, MOSDECSubOpWriteReply(
                {"pgid": p["pgid"], "tid": p["tid"],
                 "from": self.host.whoami})))
            return
        # sub-read: serve our chunk extent, crc-verified per chunk
        # (ECBackend.cc:1015 handle_sub_read, crc verify :1092)
        if p.get("want_ss"):
            from ceph_tpu_torch.osd import snaps as snapmod
            ss = snapmod.load_snapset(self.host.store, self.coll(),
                                      self.ghobject(p["oid"]))
            conn.send_message(MOSDECSubOpReadReply(
                {"pgid": p["pgid"], "tid": p["tid"],
                 "from": self.host.whoami, "oid": p["oid"],
                 "found": ss is not None,
                 "ss": ss.to_json().decode() if ss else None}))
            return
        payload = {"pgid": p["pgid"], "tid": p["tid"],
                   "from": self.host.whoami, "oid": p["oid"],
                   "found": False, "shard": -1, "ec_size": -1}
        loc = self._verified_local_extent(
            p["oid"], p.get("chunk_off", 0), p.get("chunk_len", -1),
            prev=p.get("prev", False), snap=p.get("snap"))
        if loc is not None and p.get("runs"):
            # regenerating-code repair fetch: serve only the requested
            # sub-chunk byte runs of each chunk (crc-verified above on
            # the whole extent) — the d-helper fragment the CLAY plan
            # reconstructs from, ~q x less data than the full chunk
            sliced = self._slice_runs(loc[0], p["runs"])
            loc = None if sliced is None \
                else (sliced, loc[1], loc[2], loc[3])
        data = b""
        if loc is not None:
            data, shard, size, ver = loc
            payload.update({"found": True, "shard": shard,
                            "ec_size": size, "version": list(ver),
                            "uattrs": {k[2:]: v.decode("latin1")
                                       for k, v in
                                       self._local_user_attrs(
                                           p["oid"]).items()}})
            self.sub_read_bytes_served += len(data)
        conn.send_message(MOSDECSubOpReadReply(payload, data))

    def handle_sub_op_reply(self, msg) -> None:
        p = msg.payload
        if isinstance(msg, MOSDECSubOpWriteReply):
            self.sub_op_ack(p["tid"], p["from"])
            return
        fut = self._read_waiters.get(p["tid"])
        if fut is not None and not fut.done():
            fut.set_result((p, msg.data))

    # -- recovery (RecoveryOp-lite: reconstruct + push) ----------------------

    async def _rewrite_consistent(self, oid: str, got: dict[int, bytes],
                                  ec_size: int, rolled_to: tuple) -> None:
        """Converge every live shard on one consistent state by
        re-asserting the rolled-back content as a fresh full write: a
        divergent partial fan-out leaves SOME shards at the newer
        version, and reconstructing just one position would leave the
        acting set mixed (every later read would EIO)."""
        # log entries NEWER than the surviving content were rolled back:
        # their reqids must leave the dup index, or the client's retry
        # of that very write would be answered "already done" while its
        # data is gone (found by the thrashing model checker)
        self.pg.log.invalidate_reqids_for(oid, newer_than=rolled_to)
        data = (await ec_util.decode_concat_async(
            self.sinfo, self.ec_impl, got,
            service=self._offload_svc()))[:ec_size]
        # recovery-side writer: execute_write no longer locks itself,
        # so take the object's ordering lock here — a pipelined client
        # write to the same oid must not interleave with the rewrite
        async with self.obj_lock(oid):
            version = self.pg.next_version()
            entry = LogEntry(version=version, op="modify", oid=oid,
                             prior_version=self.pg._prior(oid))
            # log-intent-first, like every write (allocation + append
            # in one slice keeps the log monotonic)
            self.pg.log.append(entry, complete=False)
            self.pg.persist_meta()
            try:
                await self.execute_write(oid, "write_full", data, entry)
            finally:
                self.pg.log.mark_complete(version)

    def _slice_runs(self, data: bytes,
                    runs: list) -> bytes | None:
        """Per-chunk sub-chunk byte runs of a whole-chunk shard blob:
        for each chunk of `data`, concatenate the [off, off+len) runs.
        None when the blob is not whole-chunk aligned or a run falls
        outside the chunk (caller falls back to a full fetch)."""
        c = self.sinfo.chunk_size
        if not data or len(data) % c:
            return None
        out = bytearray()
        for base in range(0, len(data), c):
            for off, ln in runs:
                if off < 0 or ln <= 0 or off + ln > c:
                    return None
                out += data[base + off:base + off + ln]
        return bytes(out)

    def _note_repair(self, fetched: int, full_equiv: int) -> None:
        self.repair_bytes_fetched += fetched
        self.repair_bytes_full += full_equiv
        self.host.perf.inc("recovery_bytes_fetched", fetched)
        self.host.perf.inc("recovery_bytes_full_equiv", full_equiv)

    async def _maybe_repair_reconstruct(
            self, oid: str, idx: int) -> tuple[bytes, dict] | None:
        """Bandwidth-optimal single-shard reconstruction: when the
        plugin exposes a sub-chunk repair plan (CLAY regenerating
        codes), fetch only the plan's (offset, count) sub-chunk runs
        from the d helpers — repair_per_chunk = sub_chunk_no/q bytes of
        each helper chunk instead of k whole chunks — and rebuild the
        lost position through the offload service's repair job.

        Strictly an optimization with a conservative applicability
        gate: every helper must answer with ONE uniform version, every
        other live shard (the target included) is version-stat'ed in
        the same round and must not hold anything NEWER (a partial
        fan-out is the full gather's rollback business, not ours), and
        any miss, mismatch, or timeout returns None so the caller runs
        the existing full-stripe gather."""
        if not self.host.config.get("osd_ec_repair_subchunks"):
            return None
        sub = self.ec_impl.get_sub_chunk_count()
        c = self.sinfo.chunk_size
        if sub <= 1 or c % sub or self.ec_impl.get_chunk_mapping():
            return None
        live = self._live_positions()
        avail = set(live) - {idx}
        try:
            minimum = self.ec_impl.minimum_to_decode([idx], avail)
        except ErasureCodeError:
            return None
        if set(minimum) - avail:
            return None
        runs = next(iter(minimum.values()))
        per_chunk_subs = sum(cnt for _, cnt in runs)
        if per_chunk_subs >= sub:
            return None             # whole-chunk plan: nothing to save
        ssz = c // sub
        rpc = per_chunk_subs * ssz
        byte_runs = [[off * ssz, cnt * ssz] for off, cnt in runs]

        frags: dict[int, bytes] = {}
        metas: dict[int, tuple] = {}    # helper shard -> (size, version)
        others: list[tuple] = []        # non-helper shard versions
        uattrs: dict = {}
        waits: dict[asyncio.Future, tuple] = {}
        pending: set = set()
        ok = True
        for shard, osd in sorted(live.items()):
            helper = shard in minimum
            if osd == self.host.whoami:
                loc = self._verified_local_extent(oid, 0,
                                                  -1 if helper else 0)
                if loc is None:
                    if helper:
                        ok = False
                        break
                    continue
                data, lshard, size, ver = loc
                if helper:
                    frag = self._slice_runs(data, byte_runs) \
                        if lshard == shard else None
                    if frag is None:
                        ok = False
                        break
                    frags[shard] = frag
                    metas[shard] = (size, tuple(ver))
                    uattrs.update(
                        {k[2:]: v.decode("latin1") for k, v in
                         self._local_user_attrs(oid).items()})
                else:
                    others.append(tuple(ver))
                continue
            tid = self.new_tid()
            fut = asyncio.get_running_loop().create_future()
            self._read_waiters[tid] = fut
            waits[fut] = (tid, shard, helper)
            try:
                await self.host.send_osd(osd, MOSDECSubOpRead(
                    {"pgid": [self.pg.pgid.pool, self.pg.pgid.ps],
                     "tid": tid, "from": self.host.whoami, "oid": oid,
                     "chunk_off": 0,
                     "chunk_len": -1 if helper else 0,
                     "runs": byte_runs if helper else None}))
                pending.add(fut)
            except Exception:
                # an unreachable shard — helper OR version-stat — makes
                # the "no newer version anywhere" gate unverifiable:
                # the full gather (which owns divergence rollback) must
                # decide instead
                fut.cancel()
                ok = False
                break
        try:
            deadline = asyncio.get_running_loop().time() \
                + READ_TIMEOUT / 2
            while ok and pending:
                timeout = deadline - asyncio.get_running_loop().time()
                if timeout <= 0:
                    break
                done, pending = await asyncio.wait(
                    pending, timeout=timeout,
                    return_when=asyncio.ALL_COMPLETED)
                for fut in done:
                    _tid, shard, helper = waits[fut]
                    try:
                        payload, data = fut.result()
                    except Exception:
                        ok = False      # cancelled mid-gather
                        continue
                    if helper:
                        if not payload.get("found") or \
                                payload.get("shard") != shard:
                            ok = False
                            continue
                        frags[shard] = data
                        metas[shard] = (payload["ec_size"], tuple(
                            payload.get("version", (0, 0))))
                        uattrs.update(payload.get("uattrs") or {})
                    elif payload.get("found"):
                        others.append(tuple(
                            payload.get("version", (0, 0))))
        finally:
            for fut, (tid, _, _) in waits.items():
                fut.cancel()
                self._read_waiters.pop(tid, None)
        if pending:
            # an unanswered live shard — even a mere version stat —
            # leaves the newer-version check unproven
            ok = False
        if not ok or set(frags) != set(minimum):
            return None
        vers = {v for _, v in metas.values()}
        sizes = {s for s, _ in metas.values()}
        lens = {len(b) for b in frags.values()}
        if len(vers) != 1 or len(sizes) != 1 or len(lens) != 1:
            return None
        version = vers.pop()
        if any(v > version for v in others):
            return None     # newer partial state: full gather decides
        blen = lens.pop()
        if blen == 0 or blen % rpc:
            return None
        chunk = (await ec_util.decode_shards_async(
            self.sinfo, self.ec_impl, frags, [idx],
            service=get_service_or_none(), fragments=True))[idx]
        fetched = blen * len(frags)
        full_equiv = self.k * (blen // rpc) * c
        self._note_repair(fetched, full_equiv)
        attrs = self._chunk_attrs(idx, sizes.pop(), version,
                                  self._csums(chunk))
        for name, val in uattrs.items():
            attrs["u:" + name] = val.encode("latin1")
        dout("osd", 4, f"ec {oid}: sub-chunk repair of shard {idx} "
                       f"fetched {fetched}B vs {full_equiv}B full-gather")
        return chunk, attrs

    async def _reconstruct(self, oid: str, idx: int,
                           exclude: frozenset) -> tuple[bytes, dict] | None:
        """Chunk for position `idx` + its attrs, reconstructed from any k
        version-consistent survivors — INCLUDING the target itself when
        its chunk is crc-valid at the needed version (version attrs keep
        stale copies from combining; a target holding the newest version
        must count toward decodability or partial fan-outs look
        rollback-worthy when they are not). None when the acting set was
        instead converged by a divergence rewrite (the caller's push is
        already done). Transient <k availability (EIO with no rollback
        possible) propagates so peering retries instead of recording a
        deletion.

        Regenerating-code fast path first: a sub-chunk repair plan
        (CLAY) moves repair_per_chunk bytes from d helpers instead of k
        whole chunks; any applicability doubt falls back here."""
        if not exclude:
            rec = await self._maybe_repair_reconstruct(oid, idx)
            if rec is not None:
                return rec
        got, ec_size, meta = await self._gather_chunks(
            oid, exclude_osds=exclude, allow_rollback=True)
        if meta["rolled_back"]:
            await self._rewrite_consistent(oid, got, ec_size,
                                           meta["version"])
            return None
        blob = len(next(iter(got.values()))) if got else 0
        if blob:
            self._note_repair(sum(len(b) for b in got.values()),
                              self.k * blob)
        if idx in got:
            chunk = got[idx]
        else:
            chunk = (await ec_util.decode_shards_async(
                self.sinfo, self.ec_impl, got, [idx],
                service=self._offload_svc()))[idx]
        attrs = self._chunk_attrs(idx, ec_size, meta["version"],
                                  self._csums(chunk))
        for name, val in meta.get("uattrs", {}).items():
            attrs["u:" + name] = val.encode("latin1")
        return chunk, attrs

    def _log_tombstoned(self, oid: str) -> bool:
        """True when the authoritative log's newest word on `oid` is a
        delete: recovery must then push the DELETION, never a
        reconstruction — the surviving shards' rollback generations
        (stashed by _stash_prev before every apply, the delete included)
        could otherwise reassemble the pre-delete object and resurrect
        it onto the recovering peer as a lone undecodable shard, turning
        every later read into a permanent EIO (found by the thrashing
        model checker; the reference's recovery honors delete log
        entries the same way, PGLog missing `is_delete`)."""
        for ent in reversed(self.pg.log.entries):
            if ent.oid == oid:
                return ent.op == "delete"
        return False

    async def _reconstruct_clone(self, oid: str, idx: int,
                                 cloneid: int) -> tuple[bytes, dict] | None:
        """Position `idx`'s chunk of a snap clone, reconstructed from
        any k version-consistent clone holders; None when currently
        unreconstructable. Callers SKIP a None (reduced clone redundancy
        for the target, not a correctness hole: snap reads only need
        any k holders — if k were reachable, this reconstruct would
        have succeeded — and rollback re-asserts gathered content as a
        full write rather than depending on per-shard clones)."""
        try:
            got, ec_size, meta = await self._gather_chunks(
                oid, snap=cloneid)
        except StoreError:
            return None
        if idx in got:
            chunk = got[idx]
        else:
            chunk = (await ec_util.decode_shards_async(
                self.sinfo, self.ec_impl, got, [idx],
                service=self._offload_svc()))[idx]
        return chunk, self._chunk_attrs(idx, ec_size, meta["version"],
                                        self._csums(chunk))

    async def _push_snap_state(self, peer: int, idx: int,
                               oid: str) -> None:
        """Recovery of snapshot state: the peer's positional chunk of
        every clone, then the SnapSet (the replicated backend ships the
        same payload inline via snap_state; clones are chunks here).
        LOCAL snapdir only — a peer-querying gather here would cost
        every snap-less object O(peers) round trips per recovery push;
        the primary's own snapdir is restored by _pull_snap_state before
        it pushes anyone else."""
        from ceph_tpu_torch.osd import snaps as snapmod
        ss = snapmod.load_snapset(self.host.store, self.coll(),
                                  self.ghobject(oid))
        if ss is None:
            return
        for clone in ss.clones:
            rec = await self._reconstruct_clone(oid, idx, clone["id"])
            if rec is None:
                continue
            chunk, attrs = rec
            await self.pg.send_push(peer, oid, chunk, attrs,
                                    delete=False, snap=clone["id"])
        await self.pg.send_push(peer, oid, b"", None, delete=False,
                                ss_blob=ss.to_json().decode())

    async def _pull_snap_state(self, oid: str, me: int) -> None:
        """Primary-side snapshot-state recovery: rebuild our own
        positional clone chunks + snapdir from the peers'. The gather
        is AUTHORITATIVE — a primary revived after missing clone ops
        would otherwise trust its stale local snapdir and serve wrong
        snap resolutions (found in review)."""
        ss = await self.gather_snapset(oid, authoritative=True)
        if ss is None:
            return
        for clone in ss.clones:
            rec = await self._reconstruct_clone(oid, me, clone["id"])
            if rec is None:
                continue
            chunk, attrs = rec
            self.apply_push(oid, chunk, attrs, False, snap=clone["id"])
        self.apply_push(oid, b"", None, False,
                        ss_blob=ss.to_json().decode())

    async def push_object(self, peer: int, oid: str) -> None:
        """Reconstruct `peer`'s positional chunk from k survivors and
        push it (the reference recovery reads min-to-decode and
        re-encodes the missing shard, RecoveryOp ECBackend.h:191)."""
        try:
            idx = self.pg.acting.index(peer)
        except ValueError:
            return
        await self._push_snap_state(peer, idx, oid)
        if self._log_tombstoned(oid):
            await self.pg.send_push(peer, oid, b"", None, delete=True)
            return
        try:
            # the target is NOT excluded from the gather: version attrs
            # keep a stale copy from combining with newer shards, and the
            # per-chunk crc gate keeps a corrupt one out — but a target
            # holding the newest version must still count toward its
            # decodability, or a partial fan-out looks rollback-worthy
            # when it is not (found by the thrashing model checker)
            rec = await self._reconstruct(oid, idx, exclude=frozenset())
        except StoreError as e:
            if e.code != "ENOENT":
                raise
            await self.pg.send_push(peer, oid, b"", None, delete=True)
            return
        if rec is None:
            return      # divergence rewrite already updated every shard
        chunk, attrs = rec
        await self.pg.send_push(peer, oid, chunk, attrs, delete=False)

    async def pull_object(self, auth_peer: int, oid: str, need,
                          fallbacks=()) -> None:
        """We (the primary) lack this object: reconstruct OUR positional
        chunk from the survivors instead of copying the auth peer's (its
        chunk is a different position; the gather already consults every
        live shard, so `fallbacks` is implicit here)."""
        me = self.pg.acting.index(self.host.whoami)
        await self._pull_snap_state(oid, me)
        if self._log_tombstoned(oid):
            # authoritative history deleted it (belt-and-braces: the
            # caller's ZERO-need tombstone normally catches this)
            self.local_apply(oid, "delete", b"")
            return
        try:
            rec = await self._reconstruct(oid, me, exclude=frozenset())
        except StoreError as e:
            if e.code != "ENOENT":
                raise
            self.local_apply(oid, "delete", b"")
            return
        if rec is None:
            return      # divergence rewrite already updated every shard
        chunk, attrs = rec
        self.local_apply(oid, "push", chunk, attrs=attrs)
