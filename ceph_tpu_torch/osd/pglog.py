"""PGLog: per-PG ordered op log with missing-set tracking.

Re-creation of the reference's PGLog essentials (src/osd/PGLog.{h,cc},
pg_log_entry_t at src/osd/osd_types.h:4325): every write appends an
entry stamped with an eversion (map epoch, per-PG sequence); peers
compare logs during peering, divergent entries are rewound, and the
objects whose entries one side lacks become its *missing set*, repaired
by log-driven recovery (push of the authoritative object) instead of a
full resync (PGLog::merge_log, src/osd/PGLog.h:1254).

Idiomatic divergences: entries are JSON-able dataclasses; rollback is
whole-object re-push (the reference's per-op rollback info is an
optimization on top of the same authority rules); the log is bounded by
entry count, with a fallthrough to backfill when a peer is behind the
tail.

The port's copy of ceph_tpu/osd/pglog.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable

Eversion = tuple[int, int]      # (epoch, seq) — totally ordered
ZERO: Eversion = (0, 0)


@dataclasses.dataclass
class LogEntry:
    """pg_log_entry_t-lite: what happened to which object, when.

    `reqid` is the client's stable request id (nonce, seq) — the dup-op
    index key (osd_reqid_t in pg_log_entry_t): a client retry whose
    first attempt actually committed must NOT re-execute (appends would
    double-apply, deletes would answer ENOENT for a success)."""

    version: Eversion
    op: str                     # "modify" | "delete"
    oid: str                    # object name within the PG
    prior_version: Eversion = ZERO
    reqid: tuple | None = None

    def to_dict(self) -> dict:
        d = {"version": list(self.version), "op": self.op,
             "oid": self.oid, "prior_version": list(self.prior_version)}
        if self.reqid is not None:
            d["reqid"] = list(self.reqid)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "LogEntry":
        return cls(version=tuple(d["version"]), op=d["op"], oid=d["oid"],
                   prior_version=tuple(d.get("prior_version", [0, 0])),
                   reqid=tuple(d["reqid"]) if d.get("reqid") else None)


class PGLog:
    """Bounded ordered log + missing set (PGLog.h)."""

    MAX_ENTRIES = 1000          # osd_max_pg_log_entries analog

    def __init__(self):
        self.entries: list[LogEntry] = []
        self.tail: Eversion = ZERO      # everything <= tail is implicit
        self.head: Eversion = ZERO      # last_update
        # oid -> (need version, have prior) — objects this replica must
        # recover before it can serve them (pg_missing_t)
        self.missing: dict[str, Eversion] = {}
        # dup-op index: reqid -> version of the entry that executed it
        # (PGLog dups; horizon = the retained entry window)
        self._reqids: dict[tuple, Eversion] = {}
        # pipelined-execution completion tracking: versions whose
        # log-intent is appended but whose execution slice has not yet
        # settled (the primary marks them complete in ANY order;
        # `last_complete` advances only over the contiguous settled
        # prefix — the reference's pg_info_t.last_complete)
        self._incomplete: set[Eversion] = set()
        # newest retained entry per object (prior_version lookups ran a
        # reverse scan of the whole window PER WRITE — profiled on the
        # pipelined hot path); kept in sync with `entries` by
        # append/insert/trim and rebuilt with the reqid index
        self._last_by_oid: dict[str, Eversion] = {}
        # incremental-persistence dirty state: persist_meta writes ONE
        # omap key per changed entry instead of re-serializing the whole
        # window per op (the reference stores pg log entries as
        # individual omap keys the same way, src/osd/PGLog.cc
        # _write_log_and_missing). A fresh/replaced log starts
        # dirty_full so wholesale adoption rewrites everything.
        self._dirty_full = True
        self._dirty: dict[str, LogEntry | None] = {}    # key -> entry|del

    # omap key namespace: the pgmeta object's omap is shared with the
    # SnapMapper ("sm_..." keys) — log keys carry their own prefix
    KEY_PREFIX = "log."

    @classmethod
    def entry_key(cls, v: Eversion) -> str:
        """Lexically-sortable omap key of one entry."""
        return f"{cls.KEY_PREFIX}{v[0]:012d}.{v[1]:012d}"

    def take_dirty(self) -> tuple[bool, dict[str, "LogEntry | None"]]:
        """Consume the pending persistence delta: (full_rewrite, {key ->
        entry or None=deleted}). The caller must durably apply it (or a
        full rewrite) in the same transaction as the static meta — and
        hand it back via restore_dirty() if that transaction fails, or
        the entries silently vanish from the persisted omap forever."""
        full, dirty = self._dirty_full, self._dirty
        self._dirty_full, self._dirty = False, {}
        return full, dirty

    def restore_dirty(self, full: bool,
                      dirty: dict[str, "LogEntry | None"]) -> None:
        """Re-merge a delta whose transaction failed; dirt recorded
        since the failed take wins on key collisions."""
        self._dirty_full = self._dirty_full or full
        merged = dict(dirty)
        merged.update(self._dirty)
        self._dirty = merged

    @classmethod
    def from_omap(cls, meta: dict, omap: dict[str, bytes]) -> "PGLog":
        """Rebuild from the persisted form written by the incremental
        path: static fields from the pgmeta blob, entries from the
        log-prefixed omap keys (lexicographic key order IS version
        order). The loaded instance starts clean — disk already
        matches."""
        log = cls()
        log.entries = [LogEntry.from_dict(json.loads(v))
                       for k, v in sorted(omap.items())
                       if k.startswith(cls.KEY_PREFIX)]
        log.head = tuple(meta.get("head", [0, 0]))
        log.tail = tuple(meta.get("tail", [0, 0]))
        log.missing = {o: tuple(v)
                       for o, v in meta.get("missing", {}).items()}
        log._rebuild_reqids()
        log._dirty_full = False
        return log

    # -- append path ---------------------------------------------------------

    def append(self, entry: LogEntry, complete: bool = True) -> None:
        assert entry.version > self.head, (entry, self.head)
        self.entries.append(entry)
        self._dirty[self.entry_key(entry.version)] = entry
        self.head = entry.version
        self._last_by_oid[entry.oid] = entry.version
        if entry.reqid is not None:
            self._reqids[entry.reqid] = entry.version
        if not complete:
            # a pipelined primary appends the log INTENT before the
            # execution slice runs; mark_complete settles it later
            self._incomplete.add(entry.version)
        if len(self.entries) > self.MAX_ENTRIES:
            drop = len(self.entries) - self.MAX_ENTRIES
            self.tail = self.entries[drop - 1].version
            for e in self.entries[:drop]:
                if e.reqid is not None:
                    self._reqids.pop(e.reqid, None)
                self._dirty[self.entry_key(e.version)] = None
                self._incomplete.discard(e.version)
                # only when the dropped entry IS the object's newest:
                # a later retained entry keeps the mapping alive
                if self._last_by_oid.get(e.oid) == e.version:
                    del self._last_by_oid[e.oid]
            del self.entries[:drop]

    def insert(self, entry: LogEntry) -> None:
        """Adopt an entry that may arrive OUT OF ORDER: a pipelined
        primary fans sub-ops for different objects out concurrently, so
        a replica can see v6 before v5. In-order entries append; an
        out-of-order entry splices into version position (the old
        `version > head` guard silently DROPPED it, leaving the replica
        log with a hole a failover would promote — its dup index would
        re-execute the lost entry's request)."""
        if entry.version > self.head:
            self.append(entry)
            return
        if entry.version <= self.tail:
            return              # trimmed past: implicit
        lo, hi = 0, len(self.entries)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.entries[mid].version < entry.version:
                lo = mid + 1
            else:
                hi = mid
        if lo < len(self.entries) and \
                self.entries[lo].version == entry.version:
            return              # duplicate delivery
        self.entries.insert(lo, entry)
        self._dirty[self.entry_key(entry.version)] = entry
        if entry.version > self._last_by_oid.get(entry.oid, ZERO):
            self._last_by_oid[entry.oid] = entry.version
        if entry.reqid is not None:
            self._reqids[entry.reqid] = entry.version

    def mark_complete(self, version: Eversion) -> None:
        """The execution slice of `version` settled (committed or
        failed out to the client for resend) — completions arrive in
        any order under pipelining."""
        self._incomplete.discard(tuple(version))

    @property
    def last_complete(self) -> Eversion:
        """Newest version with no unsettled predecessor: advances
        CONTIGUOUSLY no matter what order executions complete in."""
        if not self._incomplete:
            return self.head
        lo = min(self._incomplete)
        best = self.tail
        for e in self.entries:
            if e.version >= lo:
                break
            best = e.version
        return best

    def lookup_reqid(self, reqid: tuple) -> Eversion | None:
        """Version recorded for a client request id, if it already
        executed within the retained log window (dup-op detection)."""
        return self._reqids.get(reqid)

    def _rebuild_reqids(self) -> None:
        """Rebuild the derived per-entry indexes (reqid dup table AND
        the per-object newest-version map) after wholesale entry-list
        surgery: load, authoritative merge, backfill adoption."""
        self._reqids = {e.reqid: e.version for e in self.entries
                        if e.reqid is not None}
        self._last_by_oid = {e.oid: e.version for e in self.entries}

    def last_version_of(self, oid: str) -> Eversion:
        """Newest retained entry version for `oid` (ZERO if none) —
        the O(1) prior_version lookup."""
        return self._last_by_oid.get(oid, ZERO)

    def invalidate_reqids_for(self, oid: str, newer_than: Eversion) -> None:
        """Divergence rollback rewound this object past these entries:
        their requests did NOT survive, so retries must re-execute
        rather than be answered from the dup index. The reqid is
        stripped from the ENTRY too — _rebuild_reqids (log reload,
        authoritative merge) would otherwise resurrect the stale dup
        answer."""
        for e in self.entries:
            if e.oid == oid and e.version > newer_than \
                    and e.reqid is not None:
                self._reqids.pop(e.reqid, None)
                e.reqid = None
                self._dirty[self.entry_key(e.version)] = e

    # -- peering -------------------------------------------------------------

    def entries_since(self, since: Eversion) -> list[LogEntry] | None:
        """Entries with version > since, or None if `since` predates the
        tail (log too short -> caller must backfill)."""
        if since < self.tail:
            return None
        return [e for e in self.entries if e.version > since]

    def merge_log(self, auth_entries: Iterable[LogEntry],
                  auth_head: Eversion) -> dict[str, Eversion]:
        """Adopt the authoritative log (PGLog::merge_log semantics):

        * entries we lack (version > our head) are applied to the log and
          their objects become missing (to be pushed);
        * our entries PAST the authoritative head are divergent (we
          accepted writes the quorum never finished): the touched objects
          must be rewound to the authoritative version -> also missing.

        Returns the resulting missing map (oid -> need version).
        """
        auth_entries = list(auth_entries)
        # divergent suffix: anything we have beyond the auth head
        divergent = [e for e in self.entries if e.version > auth_head]
        if divergent:
            self.entries = [e for e in self.entries
                            if e.version <= auth_head]
            self.head = self.entries[-1].version if self.entries \
                else self.tail
            # a rewind invalidates persisted suffix keys: rewrite whole
            self._dirty_full = True
            self._incomplete = {v for v in self._incomplete
                                if v <= auth_head}
            self._last_by_oid = {e.oid: e.version for e in self.entries}
        for e in divergent:
            # latest authoritative version of that object, if any
            auth_v = ZERO
            for a in reversed(auth_entries):
                if a.oid == e.oid:
                    auth_v = a.version
                    break
            if auth_v == ZERO:
                for mine in reversed(self.entries):
                    if mine.oid == e.oid:
                        auth_v = mine.version
                        break
            self.missing[e.oid] = auth_v    # ZERO = delete/rewind to none
        for e in auth_entries:
            if e.version <= self.head:
                continue
            self.append(e)
            if e.op == "delete":
                self.missing.pop(e.oid, None)
                self.missing[e.oid] = ZERO
            else:
                self.missing[e.oid] = e.version
        return dict(self.missing)

    def mark_recovered(self, oid: str) -> None:
        self.missing.pop(oid, None)

    def clear_missing(self) -> None:
        self.missing.clear()

    # -- persistence ---------------------------------------------------------

    def to_dict(self) -> dict:
        return {"entries": [e.to_dict() for e in self.entries],
                "tail": list(self.tail), "head": list(self.head),
                "missing": {o: list(v) for o, v in self.missing.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "PGLog":
        log = cls()
        log.entries = [LogEntry.from_dict(e) for e in d.get("entries", [])]
        log.tail = tuple(d.get("tail", [0, 0]))
        log.head = tuple(d.get("head", [0, 0]))
        log.missing = {o: tuple(v)
                       for o, v in d.get("missing", {}).items()}
        log._rebuild_reqids()
        return log
