"""PGInstance: one placement group living on one OSD.

Re-creation of the reference's PG/PrimaryLogPG/PeeringState essentials
(src/osd/PG.cc, src/osd/PrimaryLogPG.cc:1816,1982 do_request/do_op,
src/osd/PeeringState.h:452 GetInfo->GetLog->GetMissing->Activate):

  * the primary serializes client ops, stamps each with an eversion,
    appends to the PGLog and fans the write out through its PGBackend;
  * on every map change the PG re-peers: the primary collects peer
    infos+logs, elects the authoritative log (max last_update, the
    reference's find_best_info), merges it (PGLog::merge_log), pulls
    what it is missing, pushes what the replicas are missing, and only
    then goes active;
  * ops arriving while peering are queued (waiting_for_active), not
    failed — clients never see transient peering (src/osd/PG.cc
    waiting_for_active semantics).

Idiomatic divergences: peering is one coroutine instead of a
boost::statechart; a replica whose log is unmergeable (behind the tail)
is backfilled by full-collection push; object data rides the message
data segment one object at a time.

The port's copy of ceph_tpu/osd/pg.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import asyncio
import json
from typing import TYPE_CHECKING

from ceph_tpu_torch.crush.crush import CRUSH_NONE
from ceph_tpu_torch.crush.osdmap import PG
from ceph_tpu_torch.msg.messages import (Message, MOSDPGInfo, MOSDPGLog,
                                         MOSDPGPush, MOSDPGPushReply, MOSDPGQuery,
                                         MOSDRepScrubMap)
from ceph_tpu_torch.objectstore.store import StoreError, Transaction
from ceph_tpu_torch.objectstore.types import CollectionId, Ghobject
from ceph_tpu_torch.osd.pglog import ZERO, Eversion, LogEntry, PGLog
from ceph_tpu_torch.qa import interleave
from ceph_tpu_torch.utils import tracer
from ceph_tpu_torch.utils.dout import dout
from ceph_tpu_torch.utils.work_queue import WRITE_OP_KINDS, mark_op_event

if TYPE_CHECKING:
    from ceph_tpu_torch.osd.daemon import OSD

PEER_TIMEOUT = 5.0
PGMETA_OID = "_pgmeta_"


class PeerSilent(Exception):
    """An up acting peer did not answer a peering round."""


class PGInstance:
    """One PG on one OSD: log + backend + peering driver."""

    def __init__(self, host: "OSD", pgid: PG, pool):
        self.host = host
        self.pgid = pgid
        self.pool = pool
        self.log = PGLog()
        self.acting: list[int] = []
        self.up: list[int] = []
        self.state = "initial"          # initial|peering|active|replica|stray
        self.last_epoch_started = 0
        self.seq = 0                    # per-PG op sequence (eversion minor)
        self._active_event = asyncio.Event()
        self._peer_task: asyncio.Task | None = None
        # acting member -> boot addr at the current interval (up_from
        # analog: a changed addr with an unchanged acting set means a
        # peer restarted and the interval must roll)
        self._interval_addrs: dict[int, str] = {}
        # peering scratch: peer osd -> {"info":..., "entries":...}
        self._peer_logs: dict[int, dict] = {}
        self._peer_waiters: dict[int, asyncio.Future] = {}
        self._push_waiters: dict[str, asyncio.Future] = {}
        # async recovery: oid -> behind peers still needing a push;
        # activation of those peers is deferred until their set drains
        self._pending_recovery: dict[str, set[int]] = {}
        # objects in the current recovery round at its start — with
        # len(_pending_recovery) remaining, this yields the completion
        # fraction published through the mgr report path
        self.recovery_total = 0
        self._deferred_activate: dict[int, dict] = {}
        self._recovery_inflight: dict[str, asyncio.Future] = {}
        self._recovery_task: asyncio.Task | None = None
        # scrub: (tid, peer) -> future resolving to the peer's scrub map
        self._scrub_waiters: dict[tuple, asyncio.Future] = {}
        # scrub reservations: (tid, peer) -> future resolving True on
        # grant / False on reject (MOSDScrubReserve round-trips)
        self._reserve_waiters: dict[tuple, asyncio.Future] = {}
        self.last_scrub: dict | None = None
        self._scrub_lock = asyncio.Lock()
        # scrub observability: live round progress, wall-clock stamps,
        # cumulative counters, and the inconsistent-object registry
        # (list-inconsistent-obj + the mgr PG_DAMAGED check source) —
        # entries persist until a clean same-or-deeper round retires
        # them, so health clears only on a verified-clean rescan
        self.scrub_progress = None
        self.last_scrub_stamp = 0.0
        self.last_deep_scrub_stamp = 0.0
        self.scrub_stats = {"objects_scrubbed": 0, "bytes_hashed": 0,
                            "errors_found": 0, "errors_repaired": 0}
        self.inconsistent_objects: dict[str, dict] = {}
        # write gate: scrub blocks new modifies and drains in-flight ones
        # so repairs never race an acknowledged write (the reference's
        # scrub-range write blocking)
        self._write_gate = asyncio.Event()
        self._write_gate.set()
        self._active_writes = 0
        self._writes_drained = asyncio.Event()
        self._writes_drained.set()
        # replica-side meta-persist coalescing: batched sub-op drains
        # deliver many entries in one loop slice — persist once per
        # slice, not once per sub-op (see persist_meta_soon). The flag
        # only dedupes the scheduled callback; acks ride the flush so
        # no sub-op is acknowledged before its entry is durable.
        self._persist_scheduled = False
        self._persist_acks: list[tuple] = []
        # snaps this primary has finished trimming (persisted in meta)
        self.purged_snaps: set[int] = set()
        self._snaptrim_task: asyncio.Task | None = None
        # watch/notify (primary, in-memory: clients linger-re-register
        # across primary changes): oid -> cookie -> watcher record
        self.watchers: dict[str, dict[int, dict]] = {}
        self._notify_seq = 0
        # notify_id -> {"pending": set[cookie], "acks": [...], "fut": ...}
        self._notifies: dict[int, dict] = {}
        if pool.type == "erasure":
            from ceph_tpu_torch.osd.ec_backend import ECBackend
            self.backend = ECBackend(self)
        else:
            from ceph_tpu_torch.osd.backend import ReplicatedBackend
            self.backend = ReplicatedBackend(self)
        self.backend.ensure_collections()
        self._load_meta()

    # -- identity ------------------------------------------------------------

    @property
    def primary(self) -> int:
        for o in self.acting:
            if o != CRUSH_NONE:
                return o
        return CRUSH_NONE

    def is_primary(self) -> bool:
        return self.primary == self.host.whoami

    def acting_peers(self) -> set[int]:
        return {o for o in self.acting
                if o not in (CRUSH_NONE, self.host.whoami)}

    def info(self) -> dict:
        return {"last_update": list(self.log.head),
                "last_complete": list(self.log.last_complete),
                "log_tail": list(self.log.tail),
                "last_epoch_started": self.last_epoch_started}

    def next_version(self) -> Eversion:
        self.seq += 1
        return (self.host.osdmap.epoch, self.seq)

    # -- persistence (superblock-style pg meta in the pg collection) ---------

    def _meta_gh(self) -> Ghobject:
        return Ghobject(pool=self.pgid.pool, name=PGMETA_OID)

    def persist_meta(self) -> None:
        """Durable PG meta: a small static attr (head/tail/missing/seq)
        plus ONE omap key per log entry, written incrementally — only
        entries that changed since the last persist are (re)written.
        Re-serializing the whole 1000-entry window per op dominated the
        write path (profiled); the reference stores log entries as
        individual omap keys for the same reason
        (src/osd/PGLog.cc _write_log_and_missing)."""
        blob = json.dumps({"seq": self.seq,
                           "les": self.last_epoch_started,
                           "head": list(self.log.head),
                           "tail": list(self.log.tail),
                           "missing": {o: list(v) for o, v in
                                       self.log.missing.items()},
                           "purged_snaps": sorted(self.purged_snaps)}
                          ).encode()
        cid = self.backend.coll()
        gh = self._meta_gh()
        txn = Transaction()
        if not self.host.store.exists(cid, gh):
            txn.touch(cid, gh)
        txn.setattr(cid, gh, "pgmeta", blob)
        full, dirty = self.log.take_dirty()
        if full:
            # the meta omap is shared (SnapMapper keys live there too):
            # remove only the log-prefixed keys, never omap_clear
            try:
                stale = [k for k in self.host.store.omap_get(cid, gh)
                         if k.startswith(PGLog.KEY_PREFIX)]
            except StoreError:
                stale = []
            if stale:
                txn.omap_rmkeys(cid, gh, stale)
            txn.omap_setkeys(cid, gh, {
                PGLog.entry_key(e.version):
                    json.dumps(e.to_dict()).encode()
                for e in self.log.entries})
        else:
            rm = [k for k, v in dirty.items() if v is None]
            if rm:
                txn.omap_rmkeys(cid, gh, rm)
            sets = {k: json.dumps(v.to_dict()).encode()
                    for k, v in dirty.items() if v is not None}
            if sets:
                txn.omap_setkeys(cid, gh, sets)
        try:
            self.host.store.queue_transaction(txn)
        except Exception:
            # the delta never reached disk: hand it back or those
            # entries vanish from the persisted omap forever
            self.log.restore_dirty(full, dirty)
            raise

    def persist_meta_soon(self, ack: tuple | None = None) -> None:
        """Coalesced replica-side persist: a pipelined primary's batch
        envelopes deliver many sub-ops per loop slice, and each used to
        re-serialize + write the meta blob individually. One call_soon
        flush per slice persists them all (the in-memory log is updated
        synchronously; only the disk write coalesces — the same
        window a journaling store batches into one commit). The PRIMARY
        path keeps its synchronous persist: the dup-replay invariant
        needs the intent durable within the ordered slice.

        `ack` is a deferred (conn, reply) pair sent only AFTER the
        persist succeeds: a sub-op is never acknowledged while its log
        entry is not durable — a persist failure drops the acks, the
        primary's sub-op wait times out, and the client resends
        (exactly the pre-coalescing failure behavior). Flushed
        explicitly by flush_persist() at daemon stop."""
        if ack is not None:
            self._persist_acks.append(ack)
        if self._persist_scheduled:
            return
        self._persist_scheduled = True
        asyncio.get_running_loop().call_soon(self._persist_flush)

    def _persist_flush(self) -> None:
        self._persist_scheduled = False
        acks, self._persist_acks = self._persist_acks, []
        try:
            self.persist_meta()
        except Exception as e:
            # the delta was handed back by persist_meta's failure path;
            # the UNSENT acks make the primary time the sub-ops out, so
            # nothing is counted replicated that is not persisted
            dout("osd", 1, f"pg {self.pgid} coalesced meta persist "
                           f"failed: {type(e).__name__} {e} (delta "
                           f"restored; sub-op acks withheld)")
            return
        for conn, reply in acks:
            try:
                conn.send_message(reply)
            except Exception:
                pass            # dead peer conn: its timeout handles it

    def flush_persist(self) -> None:
        """Synchronously flush the coalesced persist (daemon stop:
        nothing may stay dirty past umount; unconditional — a
        previously failed flush left dirty state behind with no
        callback armed)."""
        self._persist_flush()

    def _load_meta(self) -> None:
        cid = self.backend.coll()
        gh = self._meta_gh()
        try:
            blob = self.host.store.getattr(cid, gh, "pgmeta")
        except StoreError:
            return
        meta = json.loads(blob)
        if "log" in meta:           # legacy inline-entries format
            self.log = PGLog.from_dict(meta["log"])
        else:
            self.log = PGLog.from_omap(
                meta, self.host.store.omap_get(cid, gh))
        self.seq = meta.get("seq", self.log.head[1])
        self.last_epoch_started = meta.get("les", 0)
        self.purged_snaps = set(meta.get("purged_snaps", []))

    def list_objects(self) -> list[str]:
        from ceph_tpu_torch.objectstore.types import CEPH_NOSNAP
        from ceph_tpu_torch.osd.ec_backend import PREV_SUFFIX
        cid = self.backend.coll()
        return sorted(gh.name for gh in self.host.store.collection_list(cid)
                      if gh.name != PGMETA_OID
                      and not gh.name.endswith(PREV_SUFFIX)
                      and gh.snap == CEPH_NOSNAP)

    def recovery_objects(self) -> list[str]:
        """Everything recovery/backfill must move: heads plus headless
        objects whose clones/snapdir survive a head delete."""
        from ceph_tpu_torch.osd import snaps
        names = set(self.list_objects())
        names |= snaps.headless_snap_objects(self.host.store,
                                             self.backend.coll())
        names.discard(PGMETA_OID)
        return sorted(names)

    def _purge_stray(self, oid: str) -> None:
        """Drop a stray object found during backfill: unlike a client
        delete, its snapshot state goes with it."""
        self.backend.local_apply(oid, "purge", b"")

    # -- map advance ---------------------------------------------------------

    def advance_map(self, up: list[int], acting: list[int]) -> None:
        """New osdmap epoch: if the acting set changed — or any acting
        member RESTARTED without ever being marked down (same set, new
        boot address) — re-peer (the reference starts a new peering
        interval, PeeringState advance_map/start_peering_interval; a
        restart inside the heartbeat grace changes up_from and is a new
        interval per check_new_interval, which PastIntervals records —
        here the boot address plays the up_from role). Without this, a
        sub-op lost in a kill+revive-within-grace window is never
        repaired: no epoch changes the acting set, so no peering runs
        and the revived peer serves its stale shard forever (found by
        the thrashing model checker)."""
        addrs = {o: self.host.osdmap.get_addr(o) for o in acting
                 if o != CRUSH_NONE and o in self.host.osdmap.osds}
        restarted = addrs != self._interval_addrs
        if acting == self.acting and not restarted:
            if self.state in ("active", "replica"):
                return
            if (self.state == "peering" and self._peer_task is not None
                    and not self._peer_task.done()):
                # same interval, peering already in flight: a second task
                # would clobber the first's _peer_waiters
                return
        self._interval_addrs = addrs
        interval_changed = acting != self.acting or restarted
        self.up, self.acting = list(up), list(acting)
        if interval_changed:
            self.backend.fail_inflight("peering interval change")
        self._cancel_peering()
        if self.host.whoami not in self.acting:
            self.state = "stray"
            self._active_event.clear()
            return
        if self.is_primary():
            self.state = "peering"
            self._active_event.clear()
            self._peer_task = asyncio.get_running_loop().create_task(
                self._peer())
        else:
            # replica: wait for the primary's activation
            self.state = "replica"
            self._active_event.clear()

    def _cancel_peering(self) -> None:
        if self._peer_task is not None and not self._peer_task.done():
            self._peer_task.cancel()
        self._peer_task = None
        if self._recovery_task is not None and \
                not self._recovery_task.done():
            self._recovery_task.cancel()
        self._recovery_task = None
        if self._snaptrim_task is not None and \
                not self._snaptrim_task.done():
            self._snaptrim_task.cancel()
        self._snaptrim_task = None
        self._pending_recovery.clear()
        self.recovery_total = 0
        self._deferred_activate.clear()
        for fut in self._peer_waiters.values():
            if not fut.done():
                fut.cancel()
        self._peer_waiters.clear()

    async def wait_active(self, timeout: float = 30.0) -> None:
        await asyncio.wait_for(self._active_event.wait(), timeout)

    # -- peering (primary coroutine) -----------------------------------------

    async def _peer(self) -> None:
        """Retry until every acting peer answers: going active without a
        live acting peer's log would leave it permanently stale (the
        reference blocks in Peering until the interval changes)."""
        backoff = 0.2
        while True:
            try:
                await self._peer_inner()
                return
            except asyncio.CancelledError:
                raise
            except PeerSilent as e:
                dout("osd", 3, f"osd.{self.host.whoami} pg {self.pgid}: "
                               f"{e}; retrying peering")
            except Exception as e:
                dout("osd", 2, f"osd.{self.host.whoami} pg {self.pgid}: "
                               f"peering failed: {type(e).__name__} {e}")
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, 2.0)

    async def _peer_inner(self) -> None:
        # drain the pipelined execution window first: ops admitted in
        # the previous interval must settle (fail_inflight already
        # errored their sub-op futures, so this is fast) before peers
        # are queried — no op's fan-out may straddle two intervals, and
        # the authoritative log election must not race in-flight
        # appends. Bounded: a write wedged on a dead peer exits via its
        # own sub-op timeout, not ours.
        if self._active_writes:
            self._writes_drained.clear()
            try:
                await asyncio.wait_for(self._writes_drained.wait(), 2.0)
            except asyncio.TimeoutError:
                dout("osd", 2, f"pg {self.pgid}: {self._active_writes} "
                               f"pipelined writes still in flight at "
                               f"peering; proceeding (they fail out to "
                               f"resend)")
        pgid_key = [self.pgid.pool, self.pgid.ps]
        epoch = self.host.osdmap.epoch
        # GetInfo+GetLog: ask every acting peer for info + log in one round
        replies: dict[int, dict] = {}
        waits = []
        for peer in self.acting_peers():
            fut = asyncio.get_running_loop().create_future()
            self._peer_waiters[peer] = fut
            await self.host.send_osd(peer, MOSDPGQuery(
                {"pgid": pgid_key, "from": self.host.whoami,
                 "epoch": epoch}))
            waits.append((peer, fut))
        silent: list[int] = []
        for peer, fut in waits:
            try:
                replies[peer] = await asyncio.wait_for(fut, PEER_TIMEOUT)
            except asyncio.TimeoutError:
                if self.host.osdmap.is_up(peer):
                    silent.append(peer)
            finally:
                self._peer_waiters.pop(peer, None)
        if silent:
            raise PeerSilent(f"acting peers {silent} silent during peering")

        # find_best_info: max last_update wins (self is a candidate)
        auth_osd, auth_head = self.host.whoami, self.log.head
        for peer, rep in replies.items():
            head = tuple(rep["info"]["last_update"])
            if head > auth_head:
                auth_osd, auth_head = peer, head

        if auth_osd != self.host.whoami:
            # GetMissing: merge the authoritative log
            auth = replies[auth_osd]
            auth_entries = [LogEntry.from_dict(e) for e in auth["entries"]]
            auth_tail = tuple(auth["info"]["log_tail"])
            if auth_tail > self.log.head:
                # we are behind the auth's log TAIL: its retained entries
                # cannot bridge our gap, and a plain merge would silently
                # lose every write older than the window —
                # backfill the full authoritative object set instead
                await self._backfill_from(auth_osd, auth_entries,
                                          auth_head, auth_tail)
            else:
                self.log.merge_log(auth_entries, auth_head)
                self.seq = max(self.seq, self.log.head[1])
        # recover the PRIMARY itself before serving anything: merged
        # missing plus anything persisted from an earlier interval when
        # we were a recovering replica (the reference's own-missing set).
        # When we ARE the auth (recovering replica won the election),
        # pull from the peer with the highest head — most likely to
        # still hold the object
        source = auth_osd
        if source == self.host.whoami and replies:
            source = max(replies,
                         key=lambda p: tuple(
                             replies[p]["info"]["last_update"]))
        real_missing = {o: n for o, n in self.log.missing.items()
                        if tuple(n) != ZERO}
        if real_missing and source == self.host.whoami:
            # we are missing acked objects and have NO peer to pull from
            # (sole survivor): going active would serve ENOENT for them
            # and clearing the missing set would destroy the only record
            # — stay in peering until a peer returns or the interval
            # changes (the reference blocks on unfound objects likewise)
            raise PeerSilent(
                f"missing {len(real_missing)} objects with no pull "
                f"source (sole survivor)")
        for oid, need in list(self.log.missing.items()):
            if tuple(need) == ZERO:
                # rewind-to-none tombstone: the authoritative history
                # DELETED this object — reconstructing it from surviving
                # shards (or their rollback generations) would resurrect
                # an acked delete (found by the thrashing model checker)
                self.backend.local_apply(oid, "delete", b"")
            else:
                await self.backend.pull_object(
                    source, oid, need,
                    fallbacks=[p for p in sorted(replies) if p != source])
        self.log.clear_missing()

        # Activate: up-to-date replicas immediately; behind replicas get
        # a persisted `recovering` marker and their pushes run in the
        # BACKGROUND (reservation-throttled) so client I/O proceeds
        # while they backfill (the reference's async recovery/backfill
        # with AsyncReserver; activation per peer when its data is in)
        log_dict = self.log.to_dict()
        my_objects = None
        pending: dict[str, set[int]] = {}
        deferred: dict[int, dict] = {}
        for peer, rep in replies.items():
            peer_head = tuple(rep["info"]["last_update"])
            entries = self.log.entries_since(peer_head)
            act_payload = {"pgid": pgid_key, "op": "activate",
                           "epoch": epoch, "from": self.host.whoami,
                           "log": log_dict}
            if entries is None:
                # peer is behind the log tail: backfill everything, and
                # ship the authoritative object list so the replica can
                # drop strays (deletes it missed past the log window
                # would otherwise resurrect if it later became primary)
                if my_objects is None:
                    my_objects = self.recovery_objects()
                need_oids = list(my_objects)
                act_payload["objects"] = my_objects
            else:
                need_oids = sorted({e.oid for e in entries})
            if not need_oids:
                await self.host.send_osd(peer, MOSDPGInfo(act_payload))
                continue
            for oid in need_oids:
                pending.setdefault(oid, set()).add(peer)
            # only the SHAPE is remembered: the payload is rebuilt from
            # the live log/object set at activation time — a snapshot
            # from peering time would rewind the peer's log past writes
            # replicated to it during background recovery, and its
            # stale object list would delete legitimately-written
            # objects as strays
            deferred[peer] = {"backfill": entries is None}
            # the peer must KNOW it is missing these objects: if the
            # primary dies mid-backfill and the peer wins the next
            # election, its persisted missing set makes it pull them
            # before going active instead of serving ENOENT
            await self.host.send_osd(peer, MOSDPGInfo(
                {"pgid": pgid_key, "op": "recovering", "epoch": epoch,
                 "from": self.host.whoami,
                 "missing": {o: list(self.log.head) for o in need_oids}}))
        self._pending_recovery = pending
        self.recovery_total = len(pending)
        self._deferred_activate = deferred
        self.last_epoch_started = epoch
        self.persist_meta()
        self.state = "active"
        self._active_event.set()
        self.host.requeue_waiting(self)
        dout("osd", 3, f"osd.{self.host.whoami} pg {self.pgid} active "
                       f"(acting {self.acting}, head {self.log.head}, "
                       f"recovering {len(pending)} objects to "
                       f"{sorted(deferred)})")
        if pending:
            self._recovery_task = asyncio.get_running_loop().create_task(
                self._drain_recovery())
        self.maybe_snaptrim()

    # -- async recovery / backfill (primary side) ----------------------------

    async def _drain_recovery(self) -> None:
        """Push pending objects to behind peers under the host's
        recovery reservations; activate each peer once its set drains
        (AsyncReserver semantics, doc/dev/osd_internals/
        backfill_reservation.rst)."""
        try:
            while self._pending_recovery:
                oid = next(iter(self._pending_recovery))
                # reservation first (host-wide slot), THEN the op queue's
                # recovery class: the shard worker must never block on a
                # slot held by another PG's backfill
                await self.host.recovery_reservations.acquire()
                done = asyncio.get_running_loop().create_future()

                async def work(oid=oid, done=done):
                    try:
                        await self.recover_object_now(oid)
                    finally:
                        self.host.recovery_reservations.release()
                        if not done.done():
                            done.set_result(None)
                # obj=oid: the recovery item admits through the PG's
                # pipelined window alongside client ops to OTHER
                # objects, but serializes FIFO against any client op
                # touching the object being rebuilt
                # nbytes: a push moves whole shard chunks, so bill the
                # recovery entity one full per-IO byte budget (~2 cost
                # units) rather than metering the exact object size —
                # the tag clocks need relative pressure, not a ledger
                self.host.op_queue.enqueue(
                    (self.pgid.pool, self.pgid.ps), work,
                    klass="recovery", obj=oid,
                    nbytes=self.host.op_queue.sched.cost_per_io_bytes)
                await done
                if oid in self._pending_recovery:
                    # push failed and was re-queued: back off instead of
                    # hammering an unreachable peer
                    await asyncio.sleep(0.3)
            await self._activate_recovered()
        except asyncio.CancelledError:
            raise
        except Exception as e:
            dout("osd", 1, f"pg {self.pgid} background recovery failed: "
                           f"{type(e).__name__} {e} (interval change "
                           f"will retry)")

    async def recover_object_now(self, oid: str) -> None:
        """Recover one object to every behind peer NOW — also called by
        the write path before touching a degraded object (the
        reference's wait_for_degraded_object). A push already in flight
        is AWAITED, never raced: the push's reconstruct gathers shard
        state that a concurrent write could supersede mid-build."""
        inflight = self._recovery_inflight.get(oid)
        if inflight is not None:
            await asyncio.shield(inflight)
            return
        peers = self._pending_recovery.pop(oid, None)
        if not peers:
            return
        fut = asyncio.get_running_loop().create_future()
        self._recovery_inflight[oid] = fut
        failed: set[int] = set()
        try:
            for peer in sorted(peers):
                try:
                    await self.backend.push_object(peer, oid)
                    self.host.perf.inc("recovery_push")
                except Exception as e:
                    dout("osd", 3, f"recovery push of {oid} to osd.{peer} "
                                   f"failed: {type(e).__name__} {e}")
                    failed.add(peer)
        finally:
            if failed:
                # a swallowed failure must NOT let the peer activate
                # with a hole (activation clears its missing record):
                # keep the oid pending so the drain retries — a truly
                # dead peer exits via the next interval change
                self._pending_recovery.setdefault(oid, set()).update(
                    failed)
            self._recovery_inflight.pop(oid, None)
            if not fut.done():
                fut.set_result(None)

    async def _activate_recovered(self) -> None:
        deferred, self._deferred_activate = self._deferred_activate, {}
        log_dict = self.log.to_dict()
        for peer, shape in deferred.items():
            act_payload = {"pgid": [self.pgid.pool, self.pgid.ps],
                           "op": "activate",
                           "epoch": self.last_epoch_started,
                           "from": self.host.whoami, "log": log_dict}
            if shape.get("backfill"):
                act_payload["objects"] = self.recovery_objects()
            try:
                await self.host.send_osd(peer, MOSDPGInfo(act_payload))
            except Exception as e:
                dout("osd", 3, f"deferred activate to osd.{peer} failed: "
                               f"{type(e).__name__} {e}")

    async def _backfill_from(self, auth_osd: int, auth_entries, auth_head,
                             auth_tail) -> None:
        """Full-resync path for a primary behind the auth peer's log tail:
        adopt the auth log wholesale, pull every object the auth holds,
        delete local strays (the reference falls through to backfill when
        `entries_since` cannot bridge the gap, PGLog.h:1254)."""
        fut = asyncio.get_running_loop().create_future()
        self._peer_waiters[auth_osd] = fut
        try:
            await self.host.send_osd(auth_osd, MOSDPGQuery(
                {"pgid": [self.pgid.pool, self.pgid.ps],
                 "from": self.host.whoami,
                 "epoch": self.host.osdmap.epoch, "want": "objects"}))
            reply = await asyncio.wait_for(fut, PEER_TIMEOUT)
        except asyncio.TimeoutError:
            raise PeerSilent(f"auth peer {auth_osd} silent during backfill")
        finally:
            self._peer_waiters.pop(auth_osd, None)
        if "objects" not in reply:
            # a stale reply from an earlier peering round can resolve this
            # waiter (handle_log matches on peer, not round); treating it
            # as an empty object set would delete every local object
            raise PeerSilent(
                f"auth peer {auth_osd} answered backfill query without "
                f"an object list (stale reply)")
        auth_objects = set(reply["objects"])
        for oid in sorted(auth_objects):
            await self.backend.pull_object(auth_osd, oid, None)
        for oid in self.recovery_objects():
            if oid not in auth_objects:
                self._purge_stray(oid)
        new_log = PGLog()
        new_log.entries = list(auth_entries)
        new_log.head, new_log.tail = auth_head, auth_tail
        new_log._rebuild_reqids()
        self.log = new_log
        self.seq = max(self.seq, auth_head[1])

    async def pull_transport(self, peer: int, oid: str) -> None:
        """Fetch one object's state from `peer` (replicated pull; the EC
        backend reconstructs instead — see ECBackend.pull_object)."""
        key = f"pull:{oid}"
        fut = asyncio.get_running_loop().create_future()
        self._push_waiters[key] = fut
        try:
            await self.host.send_osd(peer, MOSDPGPush(
                {"pgid": [self.pgid.pool, self.pgid.ps], "op": "pull",
                 "from": self.host.whoami, "oid": oid}))
            await asyncio.wait_for(fut, PEER_TIMEOUT)
        finally:
            self._push_waiters.pop(key, None)

    async def send_push(self, peer: int, oid: str, data: bytes,
                        attrs: dict | None, delete: bool,
                        omap: dict | None = None,
                        snap_state: dict | None = None,
                        snap: int | None = None,
                        ss_blob: str | None = None) -> None:
        payload = {"pgid": [self.pgid.pool, self.pgid.ps], "op": "push",
                   "from": self.host.whoami, "oid": oid, "delete": delete}
        if attrs:
            payload["attrs"] = {k: v.decode("latin1")
                                for k, v in attrs.items()}
        if omap is not None:
            payload["omap"] = {k: v.decode("latin1")
                               for k, v in omap.items()}
        if snap_state is not None:
            payload["snap_state"] = snap_state
        if snap is not None:        # EC: this push carries a CLONE chunk
            payload["snap"] = snap
        if ss_blob is not None:     # EC: replicate the SnapSet/snapdir
            payload["ss"] = ss_blob
        if data:
            # recovery-bandwidth observability: the failure-storm bench
            # derives recovery MB/s from this counter's delta
            self.host.perf.inc("recovery_bytes_pushed", len(data))
        await self.host.send_osd(peer, MOSDPGPush(payload, data))

    # -- peering message handlers (both roles) -------------------------------

    async def handle_query(self, conn, msg: MOSDPGQuery) -> None:
        """A primary wants our info + log (GetInfo+GetLog combined);
        `want: objects` additionally returns the collection listing (the
        backfill scan)."""
        payload = {"pgid": [self.pgid.pool, self.pgid.ps],
                   "from": self.host.whoami, "info": self.info(),
                   "entries": [e.to_dict() for e in self.log.entries]}
        if msg.payload.get("want") == "objects":
            payload["objects"] = self.recovery_objects()
        conn.send_message(MOSDPGLog(payload))

    def handle_log(self, msg: MOSDPGLog) -> None:
        peer = msg.payload["from"]
        fut = self._peer_waiters.get(peer)
        if fut is not None and not fut.done():
            fut.set_result(msg.payload)

    async def handle_push(self, conn, msg: MOSDPGPush) -> None:
        p = msg.payload
        if p["op"] == "pull":
            # serve the object back to the puller
            oid = p["oid"]
            snap_state = self.backend.snap_state_for_push(oid)
            if self.backend.local_exists(oid):
                data, attrs = self.backend.read_for_push(oid)
                omap = self.backend.omap_for_push(oid)
                payload = {"pgid": p["pgid"], "op": "push",
                           "from": self.host.whoami, "oid": oid,
                           "delete": False,
                           "attrs": {k: v.decode("latin1")
                                     for k, v in attrs.items()},
                           "omap": {k: v.decode("latin1")
                                    for k, v in omap.items()},
                           "reply_to": "pull"}
            else:
                payload = {"pgid": p["pgid"], "op": "push",
                           "from": self.host.whoami, "oid": oid,
                           "delete": True, "reply_to": "pull"}
                data = b""
            if snap_state is not None:
                payload["snap_state"] = snap_state
            conn.send_message(MOSDPGPush(payload, data))
            return
        # incoming object state
        attrs = {k: v.encode("latin1")
                 for k, v in p.get("attrs", {}).items()}
        omap = ({k: v.encode("latin1") for k, v in p["omap"].items()}
                if "omap" in p else None)
        self.backend.apply_push(p["oid"], msg.data, attrs, p["delete"],
                                omap=omap, snap_state=p.get("snap_state"),
                                snap=p.get("snap"), ss_blob=p.get("ss"))
        if p.get("snap") is None and p.get("ss") is None:
            # only the HEAD push resolves the missing record: clone/
            # snapdir pushes are auxiliary state for the same object
            self.log.mark_recovered(p["oid"])
        if p.get("reply_to") == "pull":
            fut = self._push_waiters.get(f"pull:{p['oid']}")
            if fut is not None and not fut.done():
                fut.set_result(None)
        else:
            conn.send_message(MOSDPGPushReply(
                {"pgid": p["pgid"], "oid": p["oid"],
                 "from": self.host.whoami}))

    # -- snaptrim (primary background task) ----------------------------------

    def maybe_snaptrim(self) -> None:
        """Start trimming snaps the monitor has removed (pool
        removed_snaps vs our purged set) — called on activation and on
        every map advance that updates the pool record."""
        if not self.is_primary() or self.state != "active":
            return
        todo = set(getattr(self.pool, "removed_snaps", ())) \
            - self.purged_snaps
        if not todo:
            return
        if self._snaptrim_task is not None and \
                not self._snaptrim_task.done():
            return
        self._snaptrim_task = asyncio.get_running_loop().create_task(
            self._snaptrim(sorted(todo)))

    async def _snaptrim(self, snapids: list[int]) -> None:
        from ceph_tpu_torch.osd import snaps as snapmod
        try:
            for snapid in snapids:
                names = snapmod.snapmapper_objects(
                    self.host.store, self.backend.coll(), self._meta_gh(),
                    snapid)
                for oid in names:
                    # each trim rides the op queue under the DECLARED
                    # snaptrim background class (profile.py): dmclock
                    # paces snap GC against client I/O, its reservation
                    # keeps it moving. obj=oid serializes against
                    # client ops touching the clone being trimmed; the
                    # done-future carries the trim's exception out so
                    # the retry-on-next-map-advance path still sees it
                    done = asyncio.get_running_loop().create_future()

                    async def work(oid=oid, snapid=snapid, done=done):
                        try:
                            await self._do_modify(
                                "snaptrim", oid,
                                {"oid": oid, "snapid": snapid}, b"")
                        except BaseException as e:
                            if not done.done():
                                done.set_exception(e)
                            if isinstance(e, asyncio.CancelledError):
                                raise
                        else:
                            if not done.done():
                                done.set_result(None)

                    if self.host.op_queue.enqueue(
                            (self.pgid.pool, self.pgid.ps), work,
                            klass="snaptrim", obj=oid,
                            nbytes=self.host.op_queue.sched
                            .cost_per_io_bytes):
                        await done
                    else:
                        await self._do_modify(
                            "snaptrim", oid,
                            {"oid": oid, "snapid": snapid}, b"")
                    await asyncio.sleep(0)     # yield between objects
                self.purged_snaps.add(snapid)
                self.persist_meta()
                dout("osd", 3, f"pg {self.pgid} snaptrim {snapid}: "
                               f"{len(names)} objects")
        except asyncio.CancelledError:
            raise
        except Exception as e:
            dout("osd", 2, f"pg {self.pgid} snaptrim failed: "
                           f"{type(e).__name__} {e} (retried on next "
                           f"map advance)")
        else:
            # a snap removed WHILE this batch ran would otherwise wait
            # for an unrelated future epoch: re-check before parking
            self._snaptrim_task = None
            self.maybe_snaptrim()

    # -- scrub ---------------------------------------------------------------

    async def block_writes(self, timeout: float = 10.0) -> None:
        self._write_gate.clear()
        if self._active_writes:
            self._writes_drained.clear()
            try:
                await asyncio.wait_for(self._writes_drained.wait(), timeout)
            except asyncio.TimeoutError:
                dout("scrub", 1, f"pg {self.pgid}: {self._active_writes} "
                                 f"writes still in flight after drain "
                                 f"timeout; scrubbing anyway")

    def unblock_writes(self) -> None:
        self._write_gate.set()

    async def scrub(self, deep: bool = False) -> dict:
        """Primary-driven scrub of this PG (scrub_pg in osd/scrub.py)."""
        from ceph_tpu_torch.osd.scrub import scrub_pg
        return await scrub_pg(self, deep)

    async def handle_scrub_request(self, conn, msg) -> None:
        # Replica side: scan exactly the name range the primary asked
        # for, unpaced — the primary takes the QoS grant per range and
        # holds the write gate while replies are outstanding, so local
        # pacing here would only stretch the gated window.
        from ceph_tpu_torch.osd.scrub import build_scrub_map
        p = msg.payload
        rng = p.get("range")
        conn.send_message(MOSDRepScrubMap(
            {"pgid": p["pgid"], "tid": p["tid"], "from": self.host.whoami,
             "map": await build_scrub_map(
                 self, p.get("deep", False),
                 oid_range=tuple(rng) if rng is not None else None,
                 paced=False)}))

    def handle_scrub_map(self, msg) -> None:
        p = msg.payload
        fut = self._scrub_waiters.get((p["tid"], p["from"]))
        if fut is not None and not fut.done():
            fut.set_result(p["map"])

    def handle_recovering(self, msg: MOSDPGInfo) -> None:
        """Primary says: you are a recovery/backfill target for these
        objects. Persisting the missing set means a failover to THIS
        replica pulls them before going active instead of silently
        serving ENOENT (pg_missing_t persistence)."""
        p = msg.payload
        if p.get("epoch", 0) < self.last_epoch_started:
            # a delayed marker from a PREVIOUS interval's primary must
            # not poison a node that has since re-peered with newer data
            return
        for oid, need in p.get("missing", {}).items():
            self.log.missing[oid] = tuple(need)
        self.persist_meta()

    def handle_activate(self, msg: MOSDPGInfo) -> None:
        """Primary says: adopt this log, you are consistent now."""
        p = msg.payload
        if p.get("epoch", 0) < self.last_epoch_started:
            return      # stale activation from a superseded interval
        if "objects" in p:
            # backfill activation: anything we hold outside the
            # authoritative set is a stray from before our outage
            auth_objects = set(p["objects"])
            for oid in self.recovery_objects():
                if oid not in auth_objects:
                    self._purge_stray(oid)
        auth = PGLog.from_dict(p["log"])
        self.log = auth
        self.log.clear_missing()
        self.seq = max(self.seq, self.log.head[1])
        self.last_epoch_started = p["epoch"]
        self.state = "replica"
        self.persist_meta()
        self._active_event.set()

    # -- client op execution (primary only) ----------------------------------

    # ops that mutate object state and therefore get a log entry —
    # derived from the canonical mutating set (work_queue, which the
    # per-client accountant also classifies by) minus "call": a class
    # method's ENVELOPE is not logged, the mutations it stages
    # server-side get their own entries
    MOD_OPS = WRITE_OP_KINDS - {"call"}
    # the reference rejects omap on EC pools (PrimaryLogPG.cc
    # pool.info.supports_omap()). truncate/zero ride the EC write plan
    # (per-shard truncate sub-ops / zero-fill RMW); snapshots work via
    # per-shard clone/rollback/trim sub-ops with the SnapSet replicated
    # onto every shard's snapdir. User xattrs replicate onto every
    # shard, like the reference.
    EC_UNSUPPORTED = frozenset({"omap_set", "omap_rm", "omap_get",
                                "omap_vals"})

    async def do_op(self, op: dict, data: bytes,
                    conn=None) -> tuple[int, dict, bytes]:
        """Execute one client op; returns (rc, out, outdata) — the
        do_osd_ops dispatch table (src/osd/PrimaryLogPG.cc:5989). Traced
        as the `pg_op` stage of the op's trace (nested under the
        daemon's osd_op span; the EC/store spans nest under this)."""
        if not tracer.active():
            return await self._do_op(op, data, conn)
        # structural span (no stage claim of its own): elided on
        # unsampled traces — osd_op spans the same interval and the
        # EC/store children reparent under it via the live context
        with tracer.span_sampled_only("pg_op",
                                      f"osd.{self.host.whoami}") as sp:
            if sp is not None:      # hot-toggle race: may disable mid-call
                sp.set_tag("pg", f"{self.pgid.pool}.{self.pgid.ps}")
                sp.set_tag("op", op.get("op"))
                sp.set_tag("oid", op.get("oid"))
                sp.set_tag("bytes", len(data))
            rc, out, outdata = await self._do_op(op, data, conn)
            if sp is not None:
                sp.set_tag("rc", rc)
            return rc, out, outdata

    async def _do_op(self, op: dict, data: bytes,
                     conn=None) -> tuple[int, dict, bytes]:
        if not self._active_event.is_set():
            # never BLOCK a queue shard on a peering PG: the daemon parks
            # ops at ingest and re-parks at dequeue; an op that still
            # races an interval flip bounces to the client, which
            # refreshes the map and resends (landing parked)
            from ceph_tpu_torch.osd.backend import IntervalChange
            raise IntervalChange(f"pg {self.pgid} not active ({self.state})")
        mark_op_event("started")
        oid = op["oid"]
        kind = op["op"]
        if self.pool.type == "erasure" and kind in self.EC_UNSUPPORTED:
            return -95, {"error": f"EOPNOTSUPP: {kind} on an ec pool"}, b""

        if kind in self.MOD_OPS:
            return await self._do_modify(kind, oid, op, data)

        snapid = op.get("snapid")
        if snapid is not None and kind in ("read", "stat"):
            return await self._do_snap_read(kind, oid, op, snapid)

        if kind == "read":
            try:
                out = await self.backend.execute_read(
                    oid, op.get("off", 0), op.get("len", 0))
            except StoreError as e:
                return self._store_rc(e), {"error": str(e)}, b""
            return 0, {}, out
        if kind == "stat":
            try:
                size = await self.backend.execute_stat(oid)
            except StoreError as e:
                return self._store_rc(e), {"error": str(e)}, b""
            return 0, {"size": size}, b""
        if kind == "list_snaps":
            from ceph_tpu_torch.osd import snaps
            if self.pool.type == "erasure":
                ss = await self.backend.gather_snapset(oid)
                head_exists = await self.backend.object_exists(oid)
            else:
                ss = snaps.load_snapset(self.host.store,
                                        self.backend.coll(),
                                        self.backend.ghobject(oid))
                head_exists = self.backend.local_exists(oid)
            if ss is None and not head_exists:
                return -2, {"error": "ENOENT"}, b""
            return 0, {"seq": ss.seq if ss else 0,
                       "clones": list(ss.clones) if ss else [],
                       "head_exists": head_exists}, b""
        if kind == "getxattr":
            if not await self.backend.object_exists(oid):
                return -2, {"error": "ENOENT"}, b""
            try:
                val = self.host.store.getattr(
                    self.backend.coll(), self.backend.ghobject(oid),
                    "u:" + op["name"])
            except StoreError as e:
                # only a MISSING LOCAL CHUNK falls back to the shard
                # gather: an ENODATA from a healthy chunk is already
                # authoritative (attrs replicate to every shard) and
                # must not cost a cluster round trip per negative probe
                if self.pool.type == "erasure" and e.code == "ENOENT":
                    try:
                        uattrs = await self._ec_gather_uattrs(oid)
                    except StoreError as ge:
                        if ge.code == "ENOENT":
                            return -2, {"error": str(ge)}, b""
                        return -5, {"error": f"EIO: {ge}"}, b""
                    if op["name"] in uattrs:
                        return 0, {}, uattrs[op["name"]].encode("latin1")
                return -61, {"error": f"ENODATA: xattr {op['name']!r}"}, b""
            return 0, {}, val
        if kind == "getxattrs":
            try:
                attrs = self.host.store.getattrs(
                    self.backend.coll(), self.backend.ghobject(oid))
                xattrs = {k[2:]: v.decode("latin1")
                          for k, v in attrs.items()
                          if k.startswith("u:")}
            except StoreError as e:
                if self.pool.type == "erasure" and e.code == "ENOENT":
                    try:
                        return 0, {"xattrs":
                                   await self._ec_gather_uattrs(oid)}, b""
                    except StoreError as ge:
                        if ge.code == "ENOENT":
                            return -2, {"error": str(ge)}, b""
                        return -5, {"error": f"EIO: {ge}"}, b""
                return self._store_rc(e), {"error": str(e)}, b""
            return 0, {"xattrs": xattrs}, b""
        if kind == "omap_get":
            try:
                omap = self.host.store.omap_get(
                    self.backend.coll(), self.backend.ghobject(oid))
            except StoreError as e:
                return self._store_rc(e), {"error": str(e)}, b""
            return 0, {"omap": {k: v.decode("latin1")
                                for k, v in omap.items()}}, b""
        if kind == "omap_vals":
            try:
                omap = self.host.store.omap_get_values(
                    self.backend.coll(), self.backend.ghobject(oid),
                    op.get("keys", []))
            except StoreError as e:
                return self._store_rc(e), {"error": str(e)}, b""
            return 0, {"omap": {k: v.decode("latin1")
                                for k, v in omap.items()}}, b""
        if kind == "call":
            return await self._do_call(oid, op, data)
        if kind in ("watch", "unwatch", "notify", "list_watchers"):
            return await self._do_watch_op(kind, oid, op, data, conn)
        if kind == "list":
            return 0, {"objects": self.list_objects()}, b""
        return -22, {"error": f"unknown op {kind!r}"}, b""

    # -- watch/notify (primary, src/osd/Watch.h + PrimaryLogPG
    # do_osd_ops WATCH/NOTIFY/NOTIFY_ACK; divergence: watcher state is
    # in-memory on the primary — clients linger-re-register across
    # primary changes instead of the reference's persisted obc watchers)

    async def _do_watch_op(self, kind: str, oid: str, op: dict,
                           data: bytes, conn) -> tuple[int, dict, bytes]:
        from ceph_tpu_torch.msg.messages import MWatchNotify
        if kind == "watch":
            if not await self.backend.object_exists(oid):
                return -2, {"error": "ENOENT"}, b""
            if conn is None:
                return -22, {"error": "watch needs a connection"}, b""
            self.watchers.setdefault(oid, {})[int(op["cookie"])] = {
                "conn": conn, "peer": getattr(conn, "peer_addr", None)}
            return 0, {}, b""
        if kind == "unwatch":
            ws = self.watchers.get(oid, {})
            ws.pop(int(op["cookie"]), None)
            self._abandon_watcher(int(op["cookie"]))
            if not ws:
                self.watchers.pop(oid, None)
            return 0, {}, b""
        if kind == "list_watchers":
            ws = self.watchers.get(oid, {})
            return 0, {"watchers": [
                {"cookie": c, "peer": list(w["peer"]) if w["peer"]
                 else None} for c, w in sorted(ws.items())]}, b""
        # notify: fan out to every live watcher, gather acks until all
        # answer or the (bounded) timeout passes; dead connections are
        # dropped immediately rather than waited out
        self._notify_seq += 1
        notify_id = self._notify_seq
        ws = self.watchers.get(oid, {})
        stale = [c for c, w in ws.items() if w["conn"]._closed]
        for c in stale:
            ws.pop(c, None)
        pending = set(ws)
        if not pending:
            return 0, {"notify_id": notify_id, "acks": [],
                       "timeouts": []}, b""
        fut = asyncio.get_running_loop().create_future()
        st = {"pending": pending, "acks": [], "dead": [], "fut": fut}
        self._notifies[notify_id] = st
        try:
            for cookie, w in list(ws.items()):
                w["conn"].send_message(MWatchNotify(
                    {"oid": oid, "notify_id": notify_id,
                     "cookie": cookie,
                     "pgid": [self.pgid.pool, self.pgid.ps]}, data))
            timeout = min(float(op.get("timeout", 3.0)), 30.0)
            try:
                await asyncio.wait_for(fut, timeout)
            except asyncio.TimeoutError:
                pass
            return 0, {"notify_id": notify_id, "acks": st["acks"],
                       "timeouts": sorted(set(st["pending"])
                                          | set(st["dead"]))}, b""
        finally:
            self._notifies.pop(notify_id, None)

    def handle_notify_ack(self, msg) -> None:
        """MWatchNotifyAck from a watcher (arrives on its own
        connection, outside the op queue)."""
        p = msg.payload
        n = self._notifies.get(int(p["notify_id"]))
        if n is None:
            return
        cookie = int(p["cookie"])
        if cookie in n["pending"]:
            n["pending"].discard(cookie)
            n["acks"].append([cookie, msg.data.decode("latin1")])
            if not n["pending"] and not n["fut"].done():
                n["fut"].set_result(None)

    def _abandon_watcher(self, cookie: int) -> None:
        """A watcher died or unwatched: any in-flight notify gather must
        stop waiting for it NOW, not at its timeout."""
        for st in self._notifies.values():
            if cookie in st["pending"]:
                st["pending"].discard(cookie)
                st["dead"].append(cookie)
                if not st["pending"] and not st["fut"].done():
                    st["fut"].set_result(None)

    def drop_watchers_for_conn(self, conn) -> None:
        """Connection reset: its watches die with it (the reference's
        watch timeout/disconnect handling)."""
        for oid in list(self.watchers):
            ws = self.watchers[oid]
            for cookie in [c for c, w in ws.items() if w["conn"] is conn]:
                ws.pop(cookie, None)
                self._abandon_watcher(cookie)
            if not ws:
                self.watchers.pop(oid, None)

    async def _do_call(self, oid: str, op: dict,
                       data: bytes) -> tuple[int, dict, bytes]:
        """CEPH_OSD_OP_CALL: run a registered object-class method on the
        primary; its staged mutations apply atomically through the
        normal modify path (PrimaryLogPG do_osd_ops CALL dispatch ->
        ClassHandler)."""
        from ceph_tpu_torch.cls import ClassCallError, ClassHandler, MethodContext
        from ceph_tpu_torch.cls.registry import CLS_METHOD_WR
        if not isinstance(data, (bytes, bytearray)):
            # the registry contract hands cls methods BYTES indata
            # (they json.loads it); zero-copy rx delivers a memoryview,
            # and cls inputs are small control blobs — materialize
            data = bytes(data)
        if op.get("reqid"):
            # a retried CALL whose first execution committed must not
            # re-run the method against post-commit state: its first
            # staged mutation always carries sub-reqid [.., 100]
            done_ver = self.log.lookup_reqid((*op["reqid"], 100))
            if done_ver is not None:
                return 0, {"version": list(done_ver), "dup": True}, b""
        try:
            m = ClassHandler.resolve(op.get("cls", ""), op.get("method", ""))
        except ClassCallError as e:
            return e.rc, {"error": str(e)}, b""
        ctx = MethodContext(self, oid)
        try:
            out = await m.fn(ctx, data)
        except ClassCallError as e:
            return e.rc, {"error": str(e)}, b""
        if not ctx.has_writes:
            return 0, {}, out or b""
        if not (m.flags & CLS_METHOD_WR):
            return -1, {"error": "EPERM: read-only method staged writes"}, \
                b""
        if self.pool.type == "erasure" and (ctx._staged_xattrs
                                            or ctx._staged_omap):
            return -95, {"error": "EOPNOTSUPP: xattr/omap on ec pool"}, b""
        sub = [0]

        async def apply(kind2: str, extra: dict, data2: bytes) -> dict:
            o = {"oid": oid, **extra}
            if op.get("snapc"):
                # staged cls mutations clone-on-write like plain ops
                o["snapc"] = op["snapc"]
            if op.get("reqid"):
                # distinct dup-index key per staged sub-mutation
                o["reqid"] = [*op["reqid"], 100 + sub[0]]
            sub[0] += 1
            rc2, out2, _ = await self._do_modify(kind2, oid, o, data2)
            if rc2 < 0:
                raise ClassCallError(rc2, str(out2))
            return out2
        try:
            last = {}
            if ctx.staged is not None:
                if ctx.staged[0] == "delete":
                    last = await apply("delete", {}, b"")
                else:
                    last = await apply("write_full", {}, ctx.staged[1])
            for name, value in ctx._staged_xattrs.items():
                last = await apply("setxattr", {"name": name}, value)
            if ctx._staged_omap:
                last = await apply(
                    "omap_set",
                    {"kv": {k: v.decode("latin1")
                            for k, v in ctx._staged_omap.items()}}, b"")
        except ClassCallError as e:
            return e.rc, {"error": str(e)}, b""
        return 0, last, out or b""

    async def _ec_gather_uattrs(self, oid: str) -> dict:
        """User xattrs from any live shard (the degraded-primary path:
        the local chunk is gone but >= k shards still exist). Raises
        StoreError on gather failure — a transient EIO must surface as
        EIO, never masquerade as "attr does not exist"."""
        _, _, meta = await self.backend._gather_chunks(
            oid, chunk_off=0, chunk_len=0)
        return meta.get("uattrs", {})

    async def _do_snap_read(self, kind: str, oid: str, op: dict,
                            snapid: int) -> tuple[int, dict, bytes]:
        """Snap-directed read/stat (find_object_context: head, covering
        clone, or ENOENT when the object did not exist at that snap).
        On EC pools the clone is striped like the head: resolution uses
        the replicated snapdir, the data comes from a clone-chunk
        gather + decode."""
        from ceph_tpu_torch.osd import snaps
        store, cid = self.host.store, self.backend.coll()
        head = self.backend.ghobject(oid)
        if self.pool.type == "erasure":
            ss = await self.backend.gather_snapset(oid)
            if ss is not None and snapid <= ss.seq:
                # clone resolution never consults head existence: skip
                # that gather (it costs a cluster round trip when the
                # primary's local chunk is missing)
                head_exists = False
            else:
                head_exists = await self.backend.object_exists(oid)
            src = snaps.resolve_read(ss, snapid, head_exists)
            if src is None:
                return -2, {"error": f"ENOENT at snap {snapid}"}, b""
            off, ln = op.get("off", 0), op.get("len", 0)
            snap = None if src == "head" else src
            try:
                if kind == "stat":
                    return 0, {"size": await self.backend.execute_stat(
                        oid, snap=snap)}, b""
                return 0, {}, await self.backend.execute_read(
                    oid, off, ln, snap=snap)
            except StoreError as e:
                return self._store_rc(e), {"error": str(e)}, b""
        ss = snaps.load_snapset(store, cid, head)
        src = snaps.resolve_read(ss, snapid, store.exists(cid, head))
        if src is None:
            return -2, {"error": f"ENOENT at snap {snapid}"}, b""
        gh = head if src == "head" else snaps.clone_gh(head, src)
        try:
            if kind == "stat":
                return 0, {"size": store.stat(cid, gh)["size"]}, b""
            data = store.read(cid, gh)
        except StoreError as e:
            return self._store_rc(e), {"error": str(e)}, b""
        off, ln = op.get("off", 0), op.get("len", 0)
        return 0, {}, data[off:off + ln] if ln > 0 else data[off:]

    @staticmethod
    def _store_rc(e: StoreError) -> int:
        return -2 if e.code == "ENOENT" else -5

    async def _do_modify(self, kind: str, oid: str, op: dict,
                         data: bytes) -> tuple[int, dict, bytes]:
        reqid = tuple(op["reqid"]) if op.get("reqid") else None
        if reqid is not None:
            done_ver = self.log.lookup_reqid(reqid)
            if done_ver is not None and \
                    await self.backend.verify_dup_committed(oid,
                                                            done_ver):
                # client retry of an op that already committed (its reply
                # was lost in a failover): answer from the log instead of
                # re-executing — appends would double-apply, deletes
                # would answer ENOENT for a success (PrimaryLogPG dup-op
                # check via the pg log's reqid index). An unverifiable
                # EC dup (entry logged, shards never applied) falls
                # through and re-executes at a fresh version.
                return 0, {"version": list(done_ver), "dup": True}, b""
        deadline = asyncio.get_running_loop().time() + 30.0
        while True:
            if self._write_gate.is_set():
                # fast path first: the open-gate case (every write
                # outside a scrub drain) pays NO await — wait_for spun
                # up a task + timer per modify (profiled on the
                # pipelined hot path). The is_set check + increment run
                # in one resume slice (no await between), so
                # block_writes cannot observe a zero counter while this
                # write proceeds (TOCTOU)
                self._active_writes += 1
                break
            await asyncio.wait_for(
                self._write_gate.wait(),
                max(0.1, deadline - asyncio.get_running_loop().time()))
        try:
            return await self._do_modify_inner(kind, oid, op, data)
        finally:
            self._active_writes -= 1
            if self._active_writes == 0:
                self._writes_drained.set()

    async def _do_modify_inner(self, kind: str, oid: str, op: dict,
                               data: bytes) -> tuple[int, dict, bytes]:
        if oid in self._pending_recovery or oid in self._recovery_inflight:
            # degraded object: an extent write to a peer missing the
            # base would splice into zeros — recover it everywhere
            # first (the reference's wait_for_degraded_object)
            await self.recover_object_now(oid)
        if kind == "create":
            exists = await self.backend.object_exists(oid)
            if exists:
                if op.get("exclusive"):
                    return -17, {"error": "EEXIST"}, b""
                return 0, {}, b""
            if self.pool.type == "erasure":
                kind, data = "write_full", b""
        elif kind in ("delete", "rmxattr", "omap_rm", "truncate", "zero"):
            # mutations of an object's EXISTING state require the object
            # (the reference returns ENOENT; setxattr/omap_set create)
            if not await self.backend.object_exists(oid):
                return -2, {"error": "ENOENT"}, b""
        if kind == "rollback":
            from ceph_tpu_torch.osd import snaps as snapmod
            head = self.backend.ghobject(oid)
            if self.pool.type == "erasure":
                ss = await self.backend.gather_snapset(oid)
                head_exists = await self.backend.object_exists(oid)
            else:
                ss = snapmod.load_snapset(self.host.store,
                                          self.backend.coll(), head)
                head_exists = self.backend.local_exists(oid)
            if snapmod.resolve_read(ss, op["snapid"],
                                    head_exists) is None:
                return -2, {"error": f"ENOENT at snap {op['snapid']}"}, b""
            data = str(op["snapid"]).encode()
        elif kind == "snaptrim":
            data = str(op["snapid"]).encode()
        # make_writeable (PrimaryLogPG.cc): the first mutation after new
        # snaps appear in the client's SnapContext preserves the current
        # state as a clone, via its own logged+replicated op
        snapc = op.get("snapc")
        if snapc and snapc.get("snaps") and kind != "snaptrim":
            await self._make_writeable(oid, snapc, op.get("reqid"))
        if kind == "zero":
            # re-executed on replicas: the length rides the data segment
            data = str(op.get("len", 0)).encode()
        elif kind == "truncate" and op.get("size") is not None:
            op = dict(op, off=op["size"])
        elif kind == "setxattr":
            data = json.dumps({"name": op["name"],
                               "value": bytes(data).decode("latin1")
                               }).encode()
        elif kind == "rmxattr":
            data = op["name"].encode()
        elif kind == "omap_set":
            data = json.dumps(op["kv"]).encode()
        elif kind == "omap_rm":
            data = json.dumps(op["keys"]).encode()
        # the commit section: the object's write-ordering lock (FIFO —
        # same-object ops commit in arrival order; pipelined ops to
        # OTHER objects proceed concurrently) held across the ordered
        # slice AND the execution slice, so log intent and local apply
        # can never interleave with another writer of this object
        async with self.backend.obj_lock(oid):
            version, entry = self._log_intent(kind, oid, op)
            try:
                if interleave.armed():
                    # schedule explorer: widen the gap between the
                    # ordered slice and the execution slice, where
                    # pipelined same-PG ops genuinely overlap
                    await interleave.yield_point("pg_execute")
                await self.backend.execute_write(oid, kind, data, entry,
                                                 off=op.get("off", 0))
            finally:
                # completions land in ANY order under pipelining (a
                # failed execution settles too — peering owns its
                # entry's fate); last_complete advances contiguously
                self.log.mark_complete(version)
        return 0, {"version": list(version)}, b""

    def _log_intent(self, kind: str, oid: str,
                    op: dict) -> tuple[Eversion, LogEntry]:
        """The ordered synchronous slice of a modify: version
        allocation, log-intent append, dup-index stamp, and the durable
        meta persist run in ONE event-loop slice (no await), so
        concurrent pipelined ops can never interleave inside it —
        appends stay strictly monotonic per PG and a retry of an op
        that failed anywhere past this point hits the dup index instead
        of re-executing against partially-applied state. The EC backend
        verifies a dup hit is actually readable before answering it
        (see verify_dup_committed) since its entry can be logged while
        no shard applied. The entry starts INCOMPLETE: the pipelined
        execution slice settles it via log.mark_complete, in any
        order."""
        version = self.next_version()
        entry = LogEntry(version=version,
                         op="delete" if kind == "delete" else "modify",
                         oid=oid, prior_version=self._prior(oid),
                         reqid=tuple(op["reqid"]) if op.get("reqid")
                         else None)
        self.log.append(entry, complete=False)
        self.persist_meta()
        return version, entry

    async def _make_writeable(self, oid: str, snapc: dict,
                              reqid) -> None:
        from ceph_tpu_torch.osd import snaps as snapmod
        if self.pool.type == "erasure":
            ss = await self.backend.gather_snapset(oid)
        else:
            ss = snapmod.load_snapset(self.host.store, self.backend.coll(),
                                      self.backend.ghobject(oid))
        seq = ss.seq if ss else 0
        new = [s for s in snapc["snaps"] if s > seq]
        if not new:
            return
        head_exists = await self.backend.object_exists(oid)
        payload = json.dumps({"cloneid": max(new), "snaps": sorted(new),
                              "seq_only": not head_exists}).encode()
        async with self.backend.obj_lock(oid):
            entry = LogEntry(version=self.next_version(), op="modify",
                             oid=oid, prior_version=self._prior(oid),
                             reqid=(*reqid, 90) if reqid else None)
            self.log.append(entry, complete=False)
            self.persist_meta()
            try:
                await self.backend.execute_write(oid, "clone", payload,
                                                 entry)
            finally:
                self.log.mark_complete(entry.version)

    def _prior(self, oid: str) -> Eversion:
        # O(1) via the log's per-object index — the reverse entry scan
        # ran once per write and dominated the ordered slice at a full
        # 1000-entry window (profiled under the pipelined hot path)
        return self.log.last_version_of(oid)
