"""PGBackend: how a PG applies ops to its acting set.

Re-creation of the reference's backend split (src/osd/PGBackend.cc:570
build_pg_backend: replicated vs erasure by pool type):

  * ReplicatedBackend (src/osd/ReplicatedBackend.cc): the primary applies
    the transaction locally and sends the whole logical op to every
    replica (MOSDRepOp); the client is acked when ALL live replicas
    commit.
  * ECBackend lives in ec_backend.py.

Idiomatic divergences: replicas re-execute the logical op (write_full /
remove are full-state, so re-execution == transaction shipping);
sub-op acks resolve asyncio futures instead of Context callbacks.

The port's copy of ceph_tpu/osd/backend.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import asyncio
import contextlib
import json
from typing import TYPE_CHECKING

from ceph_tpu_torch.crush.crush import CRUSH_NONE
from ceph_tpu_torch.msg.messages import MOSDRepOp, MOSDRepOpReply
from ceph_tpu_torch.objectstore.store import StoreError, Transaction
from ceph_tpu_torch.objectstore.types import CollectionId, Ghobject
from ceph_tpu_torch.osd.pglog import LogEntry
from ceph_tpu_torch.utils.dout import dout
from ceph_tpu_torch.utils.work_queue import mark_op_event

if TYPE_CHECKING:
    from ceph_tpu_torch.osd.pg import PGInstance

SUBOP_TIMEOUT = 10.0


class IntervalChange(Exception):
    """The peering interval changed under an in-flight op; the op is not
    failed to the client — the primary (possibly a new one) re-runs it
    (the reference re-queues ops across intervals instead of erroring)."""


class PGBackend:
    """Common plumbing; subclasses implement the write/read fan-out."""

    def __init__(self, pg: "PGInstance"):
        self.pg = pg
        self._tid = 0
        # tid -> (pending peer set, future)
        self._inflight: dict[int, tuple[set[int], asyncio.Future]] = {}
        # per-object write ordering (the reference's ObjectContext rw
        # locks): pipelined PG execution runs ops to DIFFERENT objects
        # concurrently; the commit section of same-object mutations —
        # log intent + apply/fan-out — must serialize or interleave
        # into lost updates. oid -> [lock, users]; refcounted so churn
        # workloads don't grow the dict unboundedly.
        self._obj_locks: dict[str, list] = {}

    @contextlib.asynccontextmanager
    async def obj_lock(self, oid: str):
        """Acquire this object's write-ordering lock (FIFO-fair:
        asyncio.Lock wakes waiters in acquisition order, so same-object
        ops commit in arrival order). NOT reentrant — a holder must not
        re-enter the modify path for the same oid."""
        ent = self._obj_locks.get(oid)
        if ent is None:
            ent = self._obj_locks[oid] = [asyncio.Lock(), 0]
        ent[1] += 1
        try:
            async with ent[0]:
                yield
        finally:
            ent[1] -= 1
            if ent[1] == 0 and self._obj_locks.get(oid) is ent:
                del self._obj_locks[oid]

    # -- identity ------------------------------------------------------------

    @property
    def host(self):
        return self.pg.host

    def coll(self, shard: int = -1) -> CollectionId:
        return CollectionId.make_pg(self.pg.pgid.pool, self.pg.pgid.ps,
                                    shard)

    def ghobject(self, oid: str, shard: int = -1) -> Ghobject:
        return Ghobject(pool=self.pg.pgid.pool, name=oid, shard=shard)

    def new_tid(self) -> int:
        self._tid += 1
        return self._tid

    # -- sub-op ack plumbing -------------------------------------------------

    def _start_waiting(self, tid: int, peers: set[int]) -> asyncio.Future:
        fut = asyncio.get_running_loop().create_future()
        if peers:
            self._inflight[tid] = (set(peers), fut)
        else:
            fut.set_result(None)
        return fut

    def sub_op_ack(self, tid: int, from_osd: int) -> None:
        ent = self._inflight.get(tid)
        if ent is None:
            return
        pending, fut = ent
        pending.discard(from_osd)
        if not pending:
            del self._inflight[tid]
            if not fut.done():
                fut.set_result(None)

    def fail_inflight(self, why: str) -> None:
        for pending, fut in self._inflight.values():
            if not fut.done():
                fut.set_exception(IntervalChange(why))
        self._inflight.clear()

    # -- local store helpers -------------------------------------------------

    def ensure_collections(self) -> None:
        cid = self.coll()
        if not self.host.store.collection_exists(cid):
            txn = Transaction().create_collection(cid)
            self.host.store.queue_transaction(txn)

    def local_apply(self, oid: str, op: str, data: bytes,
                    attrs: dict[str, bytes] | None = None,
                    shard: int = -1, off: int = 0,
                    omap: dict[str, bytes] | None = None) -> None:
        cid = self.coll(shard)
        gh = self.ghobject(oid, shard)
        if not isinstance(data, (bytes, bytearray)) and \
                op not in ("write_full", "push", "write"):
            # control-kind payloads (json / decimal-coded op args)
            # arrive as zero-copy memoryviews off the wire and their
            # decoders below need bytes semantics; the BULK kinds above
            # keep the view — the store writes straight from it
            data = bytes(data)
        txn = Transaction()
        if op == "write_full":
            # WRITEFULL replaces the DATA only — xattrs and omap survive
            # (the reference's CEPH_OSD_OP_WRITEFULL; an RBD header
            # rewrite must not wipe its cls-lock omap state)
            if self.host.store.exists(cid, gh):
                txn.truncate(cid, gh, 0)
            else:
                txn.touch(cid, gh)
            txn.write(cid, gh, 0, data)
        elif op == "push":
            # recovery push IS full-state: replace everything
            if self.host.store.exists(cid, gh):
                txn.remove(cid, gh)
            txn.touch(cid, gh)
            txn.write(cid, gh, 0, data)
            if attrs:
                txn.setattrs(cid, gh, attrs)
            if omap:
                txn.omap_setkeys(cid, gh, omap)
        elif op == "write":
            if not self.host.store.exists(cid, gh):
                txn.touch(cid, gh)
            txn.write(cid, gh, off, data)
        elif op == "truncate":
            if not self.host.store.exists(cid, gh):
                txn.touch(cid, gh)
            txn.truncate(cid, gh, off)
        elif op == "zero":
            # data carries the length as decimal bytes (ops re-execute on
            # replicas; zero has no payload of its own)
            if not self.host.store.exists(cid, gh):
                txn.touch(cid, gh)
            txn.zero(cid, gh, off, int(data))
        elif op == "create":
            txn.touch(cid, gh)
        elif op == "setxattr":
            kv = json.loads(data)
            if not self.host.store.exists(cid, gh):
                txn.touch(cid, gh)
            txn.setattrs(cid, gh,
                         {"u:" + kv["name"]:
                          kv["value"].encode("latin1")})
        elif op == "rmxattr":
            name = "u:" + bytes(data).decode()
            try:
                self.host.store.getattr(cid, gh, name)
            except StoreError:
                pass        # absent attr (or object): rm is a no-op
            else:
                txn.rmattr(cid, gh, name)
        elif op == "omap_set":
            kv = json.loads(data)
            if not self.host.store.exists(cid, gh):
                txn.touch(cid, gh)
            txn.omap_setkeys(cid, gh, {k: v.encode("latin1")
                                       for k, v in kv.items()})
        elif op == "omap_rm":
            if self.host.store.exists(cid, gh):
                txn.omap_rmkeys(cid, gh, json.loads(data))
        elif op in ("delete", "remove"):
            # client delete removes HEAD only; clones/snapdir survive
            # (make_writeable has already cloned when a snapc required)
            if self.host.store.exists(cid, gh):
                txn.remove(cid, gh)
        elif op == "clone":
            from ceph_tpu_torch.osd import snaps
            p = json.loads(data)
            snaps.apply_clone(self.host.store, cid, gh, self.pg._meta_gh(),
                              p["cloneid"], p["snaps"], p["seq_only"],
                              size=p.get("size"))
            return
        elif op == "rollback":
            from ceph_tpu_torch.osd import snaps
            snaps.apply_rollback(self.host.store, cid, gh, int(data))
            return
        elif op == "snaptrim":
            from ceph_tpu_torch.osd import snaps
            snaps.apply_snaptrim(self.host.store, cid, gh,
                                 self.pg._meta_gh(), int(data))
            return
        elif op == "purge":
            from ceph_tpu_torch.osd import snaps
            snaps.purge_object(self.host.store, cid, gh, self.pg._meta_gh())
            return
        else:
            raise StoreError("EINVAL", f"unknown backend op {op!r}")
        self.host.store.queue_transaction(txn)

    def local_read(self, oid: str, shard: int = -1) -> bytes:
        return self.host.store.read(self.coll(shard),
                                    self.ghobject(oid, shard))

    def local_exists(self, oid: str, shard: int = -1) -> bool:
        return self.host.store.exists(self.coll(shard),
                                      self.ghobject(oid, shard))

    # -- interface subclasses implement --------------------------------------

    async def execute_write(self, oid: str, op: str, data: bytes,
                            entry: LogEntry, off: int = 0) -> None:
        raise NotImplementedError

    async def execute_read(self, oid: str, offset: int, length: int) -> bytes:
        raise NotImplementedError

    async def object_exists(self, oid: str) -> bool:
        """Whether the object logically exists in this PG. The EC backend
        overrides: the primary's own positional chunk can be missing or
        corrupt while >= k shards exist on peers."""
        return self.local_exists(oid)

    def object_size(self, oid: str) -> int:
        raise NotImplementedError

    async def execute_stat(self, oid: str) -> int:
        return self.object_size(oid)

    async def verify_dup_committed(self, oid: str, version) -> bool:
        """Whether a dup-index hit may be answered as done. The
        replicated primary applies locally in the same event-loop slice
        as the log append, so a logged entry is always applied here and
        recovery rolls it forward — always answerable."""
        return True

    # -- recovery hooks (PG peering calls these) -----------------------------

    def read_for_push(self, oid: str, shard: int = -1) -> tuple[bytes, dict]:
        """Object payload + attrs for a recovery push."""
        cid, gh = self.coll(shard), self.ghobject(oid, shard)
        return (self.host.store.read(cid, gh),
                self.host.store.getattrs(cid, gh))

    def omap_for_push(self, oid: str, shard: int = -1) -> dict[str, bytes]:
        return self.host.store.omap_get(self.coll(shard),
                                        self.ghobject(oid, shard))

    def apply_push(self, oid: str, data: bytes, attrs: dict,
                   delete: bool, shard: int = -1,
                   omap: dict[str, bytes] | None = None,
                   snap_state: dict | None = None,
                   snap: int | None = None,
                   ss_blob: str | None = None) -> None:
        if snap is not None or ss_blob is not None:
            # EC snapshot-state push: a reconstructed CLONE chunk for
            # this position, or the replicated SnapSet for the snapdir
            # (clones ride recovery one push per clone, like head chunks)
            from ceph_tpu_torch.osd import snaps
            cid = self.coll(shard)
            head = self.ghobject(oid, shard)
            txn = Transaction()
            if snap is not None:
                cgh = snaps.clone_gh(head, snap)
                if self.host.store.exists(cid, cgh):
                    txn.remove(cid, cgh)
                txn.touch(cid, cgh)
                if data:
                    txn.write(cid, cgh, 0, data)
                if attrs:
                    txn.setattrs(cid, cgh, attrs)
            if ss_blob is not None:
                ss = snaps.SnapSet.from_json(ss_blob.encode())
                # the pushed SnapSet REPLACES local snapshot state:
                # stale clone blobs (e.g. a trim that ran while this
                # peer was down) and this object's SnapMapper keys must
                # go, or they leak forever and re-trigger trims
                old = snaps.load_snapset(self.host.store, cid, head)
                keep = {c["id"] for c in ss.clones}
                if old is not None:
                    rm = []
                    for clone in old.clones:
                        rm.extend(snaps.sm_key(s, oid)
                                  for s in clone["snaps"])
                        if clone["id"] in keep:
                            continue
                        cgh = snaps.clone_gh(head, clone["id"])
                        if self.host.store.exists(cid, cgh):
                            txn.remove(cid, cgh)
                    if rm:
                        txn.omap_rmkeys(cid, self.pg._meta_gh(), rm)
                sd = snaps.snapdir_gh(head)
                if not self.host.store.exists(cid, sd):
                    txn.touch(cid, sd)
                txn.setattr(cid, sd, snaps.SS_ATTR, ss.to_json())
                sm = {snaps.sm_key(s, oid): b"1"
                      for clone in ss.clones for s in clone["snaps"]}
                if sm:
                    txn.omap_setkeys(cid, self.pg._meta_gh(), sm)
            self.host.store.queue_transaction(txn)
            return
        if delete:
            self.local_apply(oid, "delete", b"", shard=shard)
        else:
            self.local_apply(oid, "push", data, attrs=attrs, shard=shard,
                             omap=omap)
        if self.pg.pool.type == "replicated":
            # full-state push replaces snapshot state too (clears stale
            # clones when the authoritative object has none)
            from ceph_tpu_torch.osd import snaps
            snaps.apply_snap_push(self.host.store, self.coll(shard),
                                  self.ghobject(oid, shard),
                                  self.pg._meta_gh(), snap_state)

    def snap_state_for_push(self, oid: str) -> dict | None:
        if self.pg.pool.type != "replicated":
            return None
        from ceph_tpu_torch.osd import snaps
        return snaps.snap_state_for_push(self.host.store, self.coll(),
                                         self.ghobject(oid))

    async def push_object(self, peer: int, oid: str) -> None:
        """Push this object's local state (or its absence) to `peer`.
        The EC backend overrides this to reconstruct the peer's
        positional chunk instead."""
        snap_state = self.snap_state_for_push(oid)
        if self.local_exists(oid):
            data, attrs = self.read_for_push(oid)
            await self.pg.send_push(peer, oid, data, attrs, delete=False,
                                    omap=self.omap_for_push(oid),
                                    snap_state=snap_state)
        else:
            await self.pg.send_push(peer, oid, b"", None, delete=True,
                                    snap_state=snap_state)

    async def pull_object(self, auth_peer: int, oid: str, need,
                          fallbacks=()) -> None:
        """Fetch this object's authoritative state from `auth_peer`,
        trying `fallbacks` before accepting absence: a single source
        that happens to lack the object must not tombstone a copy
        another peer still holds."""
        for peer in [auth_peer, *fallbacks]:
            await self.pg.pull_transport(peer, oid)
            if self.local_exists(oid):
                return


class ReplicatedBackend(PGBackend):
    """Primary fans the logical op to all live replicas and waits for
    every commit (src/osd/ReplicatedBackend.cc submit_transaction)."""

    async def execute_write(self, oid: str, op: str, data: bytes,
                            entry: LogEntry, off: int = 0) -> None:
        pg = self.pg
        if op == "append":
            # resolve the append offset at the primary so every replica
            # splices at the same position regardless of its local state
            op = "write"
            off = self.object_size(oid) if self.local_exists(oid) else 0
        peers = {o for o in pg.acting
                 if o not in (CRUSH_NONE, self.host.whoami)}
        tid = self.new_tid()
        fut = self._start_waiting(tid, peers)
        # local first (the primary is always a replica of itself). The
        # caller logged the entry synchronously before this call, so a
        # retry after ANY mid-fan-out failure dup-detects instead of
        # re-executing against polluted local state (an unlogged
        # applied APPEND made a retry resolve its offset one payload
        # too far — found by the thrashing model checker). The
        # reference writes pg log entries in the same ObjectStore
        # transaction as the data for the same reason; here entry
        # append + local apply run in one event-loop slice.
        self.local_apply(oid, op, data, off=off)
        msg_payload = {
            "pgid": [pg.pgid.pool, pg.pgid.ps],
            "tid": tid,
            "epoch": self.host.osdmap.epoch,
            "from": self.host.whoami,
            "oid": oid,
            "op": op,
            "off": off,
            "entry": entry.to_dict(),
        }
        for peer in peers:
            await self.host.send_osd(peer, MOSDRepOp(dict(msg_payload),
                                                     data))
        mark_op_event("sub_ops_sent")
        await asyncio.wait_for(fut, SUBOP_TIMEOUT)
        mark_op_event("commit")

    async def execute_read(self, oid: str, offset: int,
                           length: int) -> bytes:
        data = self.local_read(oid)
        if length <= 0:
            return data[offset:]
        return data[offset:offset + length]

    def object_size(self, oid: str) -> int:
        return self.host.store.stat(self.coll(), self.ghobject(oid))["size"]

    # -- replica side --------------------------------------------------------

    async def handle_rep_op(self, conn, msg: MOSDRepOp) -> None:
        p = msg.payload
        entry = LogEntry.from_dict(p["entry"])
        self.local_apply(p["oid"], p["op"], msg.data, off=p.get("off", 0))
        # insert, not append: a pipelined primary's concurrent fan-outs
        # can deliver v6 before v5 — the old `> head` guard dropped the
        # late entry, leaving this replica's log (and dup index) with a
        # hole a failover would promote
        self.pg.log.insert(entry)
        if p["op"] in ("push", "delete", "create"):
            # only FULL-state ops supersede a missing base; an extent
            # write — and now write_full too, since it preserves
            # xattrs/omap it cannot supply — leaves a missing object
            # missing until recovery pushes the whole state
            self.pg.log.mark_recovered(p["oid"])
        # coalesced with any other sub-ops landing this loop slice; the
        # ack rides the flush so rc=0 never outruns the durable entry
        self.pg.persist_meta_soon(ack=(conn, MOSDRepOpReply(
            {"pgid": p["pgid"], "tid": p["tid"],
             "from": self.host.whoami, "rc": 0})))
