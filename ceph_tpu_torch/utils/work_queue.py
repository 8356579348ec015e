"""Sharded op queue, Finisher, and OpTracker — the OSD's intra-node
parallelism + per-op observability substrate.

Re-creations of:
  * ShardedThreadPool / op shards (src/common/WorkQueue.h:569,
    src/osd/OSD.h:1282 osd_op_tp): ops are hashed to a shard by PG so
    same-PG ops stay FIFO while shards run concurrently; every shard
    worker checks into the HeartbeatMap so a wedged shard is detected
    (src/common/HeartbeatMap.h contract);
  * Finisher (src/common/Finisher.h): ordered completion-callback
    drain, decoupling completions from the paths that queue them;
  * OpTracker / TrackedOp (src/common/TrackedOp.h, src/osd/OpRequest.h):
    per-op event timelines, in-flight dump, bounded historic ring and
    slow-op accounting, exposed via the admin socket
    (`dump_ops_in_flight`, `dump_historic_ops` — the reference's
    debugging workhorse);
  * per-client accountant (ClientTable): the OpTracker grown into the
    multi-tenant lens — a bounded top-K table attributing ops, bytes,
    in-flight depth, and read/write latency histograms to individual
    `client.<id>` entities (identity negotiated at the msgr2 handshake,
    stamped on MOSDOp), with a configurable SLO engine
    (`slo_read_ms`/`slo_write_ms`) counting good-vs-violating ops per
    client. This is the accounting substrate an mClock-style QoS
    scheduler arbitrates on (src/osd/scheduler/mClockScheduler.h needs
    exactly these per-client tallies), surfaced via the admin-socket
    `dump_clients` verb and the MgrReport `client_metrics` path.

Idiomatic divergences: shards are asyncio tasks on one loop rather than
threads (the loop is the concurrency substrate everywhere in this
stack); timeline stamps come from time.monotonic with wall-clock start.
All age/duration math derives from the monotonic `_t0` ONLY — the
wall-clock `initiated_at` is display metadata (an NTP step must never
turn into a phantom slow op or a negative latency).

The port's copy of ceph_tpu/utils/work_queue.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import asyncio
import collections
import contextvars
import threading
import time
from typing import Awaitable, Callable

from ceph_tpu_torch.osd.scheduler import MClockScheduler, default_profile
from ceph_tpu_torch.utils import flight
from ceph_tpu_torch.utils.async_util import being_cancelled
from ceph_tpu_torch.utils.dout import dout
from ceph_tpu_torch.utils.perf_counters import (TYPE_GAUGE, PerfCounters,
                                                pow2_bucket)
from ceph_tpu_torch.utils.throttle import HeartbeatMap

#: op kinds that mutate state — a client op carrying any of these is
#: accounted as a WRITE (bytes = the data segment it shipped); pure
#: reads are accounted by the bytes they returned. Watch/notify and
#: listing ops are "other": they gather for seconds by design, and
#: folding them into the read histogram would poison every read SLO.
#: This is the ONE mutating-op set: PG.MOD_OPS (the ops that get a log
#: entry) derives from it, so the two can never drift apart.
WRITE_OP_KINDS = frozenset({
    "write_full", "write", "append", "truncate", "zero", "create",
    "delete", "setxattr", "rmxattr", "omap_set", "omap_rm", "rollback",
    "snaptrim", "call"})
OTHER_OP_KINDS = frozenset({"watch", "unwatch", "notify", "list",
                            "list_watchers", "list_snaps"})


def classify_ops(ops: list[dict]) -> str:
    """'write' | 'read' | 'other' for a client op vector."""
    kinds = {o.get("op") for o in ops}
    if kinds & WRITE_OP_KINDS:
        return "write"
    if kinds and kinds <= OTHER_OP_KINDS:
        return "other"
    return "read"

# the op being processed by the current task — backends stamp events on
# it without threading a handle through every call (the reference passes
# OpRequestRef the same way a thread-local trace context would)
_current_op: contextvars.ContextVar["TrackedOp | None"] = \
    contextvars.ContextVar("tracked_op", default=None)


def set_current_op(op: "TrackedOp | None"):
    return _current_op.set(op)


def reset_current_op(token) -> None:
    _current_op.reset(token)


def mark_op_event(event: str) -> None:
    """Stamp `event` on the current task's TrackedOp, if any."""
    op = _current_op.get()
    if op is not None and not op.done:
        op.mark_event(event)


def current_op() -> "TrackedOp | None":
    """The TrackedOp the current task is executing (None outside one).
    Op-execution paths use this to stamp per-client byte/kind
    accounting without threading the handle through every call."""
    return _current_op.get()


def _win_quantile(window, q: float) -> float:
    """Quantile (µs) over a rolling latency window; 0 when empty."""
    if not window:
        return 0.0
    vals = sorted(window)
    return vals[min(len(vals) - 1, int(q * (len(vals) - 1)))]


class _ClientEntry:
    """One client's running tallies (all timing monotonic-derived)."""

    __slots__ = ("name", "tenant", "ops", "rd_ops", "wr_ops",
                 "rd_bytes", "wr_bytes", "in_flight",
                 "rd_buckets", "wr_buckets", "rd_win", "wr_win",
                 "slo_good", "slo_violations", "viol_stamps",
                 "last_active", "folded_from")

    def __init__(self, name: str, tenant: str | None,
                 window: int) -> None:
        self.name = name
        self.tenant = tenant
        self.ops = 0
        self.rd_ops = 0
        self.wr_ops = 0
        self.rd_bytes = 0
        self.wr_bytes = 0
        self.in_flight = 0
        self.rd_buckets: dict[int, int] = {}
        self.wr_buckets: dict[int, int] = {}
        self.rd_win: collections.deque[float] = \
            collections.deque(maxlen=window)
        self.wr_win: collections.deque[float] = \
            collections.deque(maxlen=window)
        self.slo_good = 0
        self.slo_violations = 0
        # monotonic stamps of recent violations: the health surface
        # reports violations within a sliding window, so SLO_VIOLATIONS
        # clears by itself once an overload ends
        self.viol_stamps: collections.deque[float] = \
            collections.deque(maxlen=512)
        self.last_active = time.monotonic()
        self.folded_from = 0        # entries merged into this one

    def absorb(self, other: "_ClientEntry") -> None:
        """Fold `other`'s tallies into this (the `_other` overflow row).
        in_flight is deliberately NOT absorbed: the victim's still-open
        ops re-materialize its row at finish time with a clamped
        decrement, so moving the count here would strand it in `_other`
        forever (a gauge that only ever rises). In-flight depth is a
        property of LIVE identities; a folded client forfeits its
        snapshot and restarts at zero."""
        self.ops += other.ops
        self.rd_ops += other.rd_ops
        self.wr_ops += other.wr_ops
        self.rd_bytes += other.rd_bytes
        self.wr_bytes += other.wr_bytes
        for b, n in other.rd_buckets.items():
            self.rd_buckets[b] = self.rd_buckets.get(b, 0) + n
        for b, n in other.wr_buckets.items():
            self.wr_buckets[b] = self.wr_buckets.get(b, 0) + n
        self.slo_good += other.slo_good
        self.slo_violations += other.slo_violations
        self.viol_stamps.extend(other.viol_stamps)
        self.folded_from += 1 + other.folded_from


class ClientTable(PerfCounters):
    """Bounded top-K per-client accountant + SLO engine.

    A PerfCounters subclass so the process-wide collection owns its
    aggregate counters AND `perf reset` (admin socket) zeroes the
    per-client tables with everything else. The per-client detail
    travels the MgrReport `client_metrics` path (mgr merges across
    OSDs; exporter renders `ceph_client_*` families), never the
    counter delta path — 64-bucket histograms per client would bloat
    every report.

    Thread contract: mutation happens on the OSD loop; `dump_clients`
    and `perf dump`/`perf reset` arrive from admin-socket threads. A
    dedicated table lock (separate from the PerfCounters counter lock,
    which `self.inc` takes internally) covers the entry dict; lock
    order is always table -> counter, never the reverse.
    """

    WINDOW = 512                   # rolling-latency samples per client
    SLO_RECENT_S = 30.0            # violation freshness window (health)
    SLOW_CLIENT_FACTOR = 4.0       # p99 > factor*SLO => SLOW_CLIENT
    OTHER = "_other"               # the overflow fold row

    def __init__(self, name: str = "optracker.clients",
                 max_entries: int = 256):
        super().__init__(name)
        self.add("clients", type=TYPE_GAUGE,
                 description="distinct client entities tracked")
        self.add("client_ops",
                 description="client ops accounted to an entity")
        self.add("client_read_bytes",
                 description="bytes returned to clients by reads")
        self.add("client_written_bytes",
                 description="bytes accepted from clients by writes "
                             "(dup-op replays excluded)")
        self.add("client_slo_good",
                 description="ops that met their class SLO")
        self.add("client_slo_violations",
                 description="ops that blew their class SLO")
        self.add("clients_folded",
                 description="client entries folded into _other by "
                             "the top-K table bound")
        self._tlock = threading.Lock()
        self._entries: dict[str, _ClientEntry] = {}
        self.max_entries = max(2, int(max_entries))
        # SLO thresholds in SECONDS (0 = class unguarded); set from the
        # slo_read_ms / slo_write_ms config observer, hot
        self.slo_read_s = 0.0
        self.slo_write_s = 0.0

    # -- config hooks --------------------------------------------------------

    def set_slo(self, read_ms: float | None = None,
                write_ms: float | None = None) -> None:
        if read_ms is not None:
            self.slo_read_s = max(0.0, float(read_ms)) / 1e3
        if write_ms is not None:
            self.slo_write_s = max(0.0, float(write_ms)) / 1e3

    def resize(self, max_entries: int) -> None:
        self.max_entries = max(2, int(max_entries))
        with self._tlock:
            while len(self._entries) > self.max_entries:
                if not self._fold_one_locked():
                    break

    # -- accounting (OSD loop) -----------------------------------------------

    def _entry_locked(self, client: str,
                      tenant: str | None) -> _ClientEntry:
        e = self._entries.get(client)
        if e is None:
            # fold until the INSERT below lands within the bound — the
            # first fold may be size-neutral (it creates `_other`), so
            # loop; _fold_one_locked returning False (only `_other`
            # left) breaks the loop
            while len(self._entries) >= self.max_entries:
                if not self._fold_one_locked():
                    break
            e = self._entries[client] = _ClientEntry(client, tenant,
                                                     self.WINDOW)
        elif tenant and e.tenant is None:
            e.tenant = tenant
        return e

    def _fold_one_locked(self) -> bool:
        """Evict the least-recently-active entry into `_other` (bounded
        top-K: identities churn, tallies are never dropped)."""
        victim = min(
            (e for k, e in self._entries.items() if k != self.OTHER),
            key=lambda e: e.last_active, default=None)
        if victim is None:
            return False
        del self._entries[victim.name]
        other = self._entries.get(self.OTHER)
        if other is None:
            other = self._entries[self.OTHER] = _ClientEntry(
                self.OTHER, None, self.WINDOW)
        other.absorb(victim)
        other.last_active = time.monotonic()
        self.inc("clients_folded")
        return True

    def op_start(self, client: str, tenant: str | None = None) -> None:
        with self._tlock:
            e = self._entry_locked(client, tenant)
            e.in_flight += 1
            e.last_active = time.monotonic()
            n = len(self._entries)
        self.set("clients", n)

    def op_finished(self, op: "TrackedOp") -> None:
        """Account a finished tracked op: latency into the client's
        kind histogram + rolling window, bytes, SLO verdict. Duration
        is the op's monotonic duration — wall time never enters."""
        dur_s = op.duration
        us = dur_s * 1e6
        now = time.monotonic()
        viol = good = 0
        with self._tlock:
            # a folded (or reset-raced) client re-materializes: its
            # in-flight decrement must land on the row that carries it
            e = self._entries.get(op.client) \
                or self._entry_locked(op.client, op.tenant)
            e.in_flight = max(0, e.in_flight - 1)
            e.last_active = now
            e.ops += 1
            if op.kind == "read":
                e.rd_ops += 1
                e.rd_bytes += op.rd_bytes
                b = pow2_bucket(us)
                e.rd_buckets[b] = e.rd_buckets.get(b, 0) + 1
                e.rd_win.append(us)
                slo = self.slo_read_s
                if slo > 0:
                    if dur_s > slo:
                        viol, e.slo_violations = 1, e.slo_violations + 1
                        e.viol_stamps.append(now)
                    else:
                        good, e.slo_good = 1, e.slo_good + 1
            elif op.kind == "write":
                e.wr_ops += 1
                e.wr_bytes += op.wr_bytes
                b = pow2_bucket(us)
                e.wr_buckets[b] = e.wr_buckets.get(b, 0) + 1
                e.wr_win.append(us)
                slo = self.slo_write_s
                if slo > 0:
                    if dur_s > slo:
                        viol, e.slo_violations = 1, e.slo_violations + 1
                        e.viol_stamps.append(now)
                    else:
                        good, e.slo_good = 1, e.slo_good + 1
        self.inc("client_ops")
        if op.rd_bytes:
            self.inc("client_read_bytes", op.rd_bytes)
        if op.wr_bytes:
            self.inc("client_written_bytes", op.wr_bytes)
        if viol:
            self.inc("client_slo_violations")
        elif good:
            self.inc("client_slo_good")

    # -- surfaces ------------------------------------------------------------

    def dump_clients(self, limit: int | None = None) -> dict:
        """Admin-socket `dump_clients`: the top-K table, ops-sorted,
        with rolling-window p50/p99 per class and the SLO ledger."""
        now = time.monotonic()
        with self._tlock:
            entries = sorted(self._entries.values(),
                             key=lambda e: e.ops, reverse=True)
            if limit:
                entries = entries[:int(limit)]
            rows = []
            for e in entries:
                rows.append({
                    "client": e.name, "tenant": e.tenant,
                    "ops": e.ops, "read_ops": e.rd_ops,
                    "write_ops": e.wr_ops,
                    "read_bytes": e.rd_bytes,
                    "written_bytes": e.wr_bytes,
                    "in_flight": e.in_flight,
                    "read_ms": {
                        "p50": round(_win_quantile(e.rd_win, 0.5) / 1e3,
                                     3),
                        "p99": round(_win_quantile(e.rd_win, 0.99) / 1e3,
                                     3)},
                    "write_ms": {
                        "p50": round(_win_quantile(e.wr_win, 0.5) / 1e3,
                                     3),
                        "p99": round(_win_quantile(e.wr_win, 0.99) / 1e3,
                                     3)},
                    "slo": {"good": e.slo_good,
                            "violations": e.slo_violations},
                    "idle_s": round(now - e.last_active, 3),
                    "folded_from": e.folded_from})
            return {"num_clients": len(self._entries),
                    "table_bound": self.max_entries,
                    "slo_read_ms": round(self.slo_read_s * 1e3, 3),
                    "slo_write_ms": round(self.slo_write_s * 1e3, 3),
                    "clients": rows}

    def mgr_metrics(self) -> dict:
        """Per-client tallies for the MgrReport `client_metrics` path.
        Ships raw histogram buckets (power-of-two µs exponents) so the
        mgr can merge a client's latency distribution ACROSS OSDs and
        quote honest cross-cluster percentiles."""
        with self._tlock:
            out = {}
            for e in self._entries.values():
                out[e.name] = {
                    "tenant": e.tenant, "ops": e.ops,
                    "read_ops": e.rd_ops, "write_ops": e.wr_ops,
                    "read_bytes": e.rd_bytes,
                    "written_bytes": e.wr_bytes,
                    "in_flight": e.in_flight,
                    "slo_good": e.slo_good,
                    "slo_violations": e.slo_violations,
                    "read_buckets": {str(b): n for b, n
                                     in sorted(e.rd_buckets.items())},
                    "write_buckets": {str(b): n for b, n
                                      in sorted(e.wr_buckets.items())}}
            return out

    def health_metrics(self) -> dict:
        """The SLO health surface for the mgr digest: violations inside
        the freshness window (self-clearing once an overload ends) and
        clients whose rolling p99 sits far beyond the SLO."""
        now = time.monotonic()
        horizon = now - self.SLO_RECENT_S
        recent = 0
        violating = []
        slow = []
        with self._tlock:
            for e in self._entries.values():
                r = sum(1 for t in e.viol_stamps if t >= horizon)
                if r:
                    recent += r
                    violating.append({"client": e.name, "recent": r})
                for kind, win, slo in (("read", e.rd_win,
                                        self.slo_read_s),
                                       ("write", e.wr_win,
                                        self.slo_write_s)):
                    if slo <= 0 or len(win) < 8:
                        continue
                    p99_us = _win_quantile(win, 0.99)
                    if p99_us > self.SLOW_CLIENT_FACTOR * slo * 1e6:
                        slow.append({
                            "client": e.name, "kind": kind,
                            "p99_ms": round(p99_us / 1e3, 1),
                            "slo_ms": round(slo * 1e3, 1)})
            tracked = len(self._entries)
        violating.sort(key=lambda v: v["recent"], reverse=True)
        return {"tracked": tracked,
                "recent_violations": recent,
                "violating_clients": violating[:16],
                "slow_clients": slow[:16]}

    def reset(self) -> None:
        """`perf reset` contract: the aggregate counters AND the whole
        per-client table (histogram buckets, rolling windows, SLO
        ledgers) go to zero — a reset scrape shows empty buckets."""
        super().reset()
        with self._tlock:
            self._entries.clear()


class TrackedOp:
    """One op's lifetime: description + stamped event timeline."""

    __slots__ = ("tracker", "seq", "description", "initiated_at",
                 "_t0", "events", "done", "trace",
                 "client", "tenant", "kind", "rd_bytes", "wr_bytes")

    def __init__(self, tracker: "OpTracker", seq: int, description: str,
                 client: str | None = None, tenant: str | None = None):
        self.tracker = tracker
        self.seq = seq
        self.description = description
        # wall-clock stamp for DISPLAY ONLY (historic-op dumps show a
        # human-readable start time); every age/duration derives from
        # the monotonic _t0 so a wall-clock step cannot fake a slow op
        self.initiated_at = time.time()
        self._t0 = time.monotonic()
        self.events: list[tuple[float, str]] = [(0.0, "initiated")]
        self.done = False
        # tracer wire context ({"t","s"}) captured at ingest: carries the
        # trace through the sharded queue (closures run in a different
        # task, so the contextvar alone cannot), and lets historic-op
        # dumps name the trace an op belongs to
        self.trace: dict | None = None
        # per-client accounting: identity from the session handshake,
        # kind/bytes filled in by the op execution path (rd/wr bytes
        # stay zero on dup-op replays so a retry never double-counts)
        self.client = client
        self.tenant = tenant
        self.kind: str | None = None
        self.rd_bytes = 0
        self.wr_bytes = 0

    def mark_event(self, event: str) -> None:
        self.events.append((round(time.monotonic() - self._t0, 6), event))

    @property
    def duration(self) -> float:
        return self.events[-1][0] if self.done else \
            time.monotonic() - self._t0

    def finish(self) -> None:
        if not self.done:
            self.mark_event("done")
            self.done = True
            self.tracker._finished(self)

    def to_dict(self) -> dict:
        # "age" is monotonic-derived; "initiated_at" is the wall stamp
        # for humans correlating dumps with logs, nothing computes on it
        out = {"seq": self.seq, "description": self.description,
               "initiated_at": self.initiated_at,
               "age": round(self.duration, 6),
               "events": [{"t": t, "event": e} for t, e in self.events]}
        if self.client:
            out["client"] = self.client
            if self.tenant:
                out["tenant"] = self.tenant
        if self.trace is not None:
            out["trace_id"] = format(self.trace["t"], "016x")
            # per-stage durations from the op's span SKELETON (tracing
            # v2 tail reservoir: name -> max µs) — slow-op triage works
            # even on daemons whose traces were never sampled/promoted
            try:
                from ceph_tpu_torch.utils import tracer
                stages = tracer.op_stages(self.trace["t"])
            except Exception:
                stages = None
            if stages:
                out["stages_us"] = stages
        return out


class OpTracker:
    """In-flight registry + bounded historic ring (TrackedOp.h)."""

    def __init__(self, history_size: int = 20, history_slow_size: int = 20,
                 slow_threshold: float = 1.0,
                 clients: ClientTable | None = None):
        self._seq = 0
        self.ops_in_flight: dict[int, TrackedOp] = {}
        self.historic: collections.deque[TrackedOp] = \
            collections.deque(maxlen=history_size)
        self.historic_slow: collections.deque[TrackedOp] = \
            collections.deque(maxlen=history_slow_size)
        self.slow_threshold = slow_threshold
        self.slow_count = 0
        # the per-client accountant rides the tracker: every tracked op
        # carrying a client identity lands in its table on finish
        self.clients = clients if clients is not None else ClientTable()

    def create(self, description: str, client: str | None = None,
               tenant: str | None = None) -> TrackedOp:
        self._seq += 1
        op = TrackedOp(self, self._seq, description,
                       client=client, tenant=tenant)
        self.ops_in_flight[op.seq] = op
        if client:
            self.clients.op_start(client, tenant)
        return op

    def _finished(self, op: TrackedOp) -> None:
        self.ops_in_flight.pop(op.seq, None)
        self.historic.append(op)
        if op.client:
            self.clients.op_finished(op)
        if op.duration >= self.slow_threshold:
            self.slow_count += 1
            self.historic_slow.append(op)
            dout("optracker", 2,
                 f"slow op ({op.duration:.3f}s): {op.description}")
            flight.record("slow_op", op.client or "",
                          duration_s=round(op.duration, 3),
                          description=op.description)

    def dump_ops_in_flight(self) -> dict:
        return {"num_ops": len(self.ops_in_flight),
                "ops": [op.to_dict()
                        for op in self.ops_in_flight.values()]}

    def dump_historic_ops(self) -> dict:
        return {"size": len(self.historic),
                "slow_count": self.slow_count,
                "ops": [op.to_dict() for op in self.historic]}

    def dump_historic_slow_ops(self) -> dict:
        return {"ops": [op.to_dict() for op in self.historic_slow]}

    def get_health_metrics(self) -> dict:
        """Daemon health metrics for the mgr report (the reference's
        OSDService::get_health_metrics feeding MMgrReport): in-flight
        ops older than the slow threshold + the oldest such age. These
        drive the mon's SLOW_OPS check."""
        now_slow = [op.duration for op in self.ops_in_flight.values()
                    if op.duration >= self.slow_threshold]
        return {"slow_ops": len(now_slow),
                "oldest_age_s": round(max(now_slow, default=0.0), 3)}


class Finisher:
    """Ordered async completion drain (Finisher.h). queue() preserves
    submission order; callbacks run on the finisher task, never inline."""

    def __init__(self, name: str = "finisher",
                 hb_map: HeartbeatMap | None = None):
        self.name = name
        self._q: asyncio.Queue = asyncio.Queue()
        self._task: asyncio.Task | None = None
        self._hb_map = hb_map
        self._hb_id: int | None = None

    def start(self) -> None:
        if self._hb_map is not None:
            self._hb_id = self._hb_map.add_worker(self.name, grace=30.0)
        self._task = asyncio.get_running_loop().create_task(self._drain())

    async def stop(self) -> None:
        if self._task is not None:
            await self._q.put(None)
            await self._task
            self._task = None
        if self._hb_map is not None and self._hb_id is not None:
            self._hb_map.remove_worker(self._hb_id)

    def queue(self, fn: Callable[[], object]) -> None:
        self._q.put_nowait(fn)

    async def _drain(self) -> None:
        while True:
            fn = await self._q.get()
            if fn is None:
                return
            if self._hb_map is not None and self._hb_id is not None:
                self._hb_map.touch(self._hb_id)
            try:
                res = fn()
                if asyncio.iscoroutine(res):
                    await res
            except Exception as e:
                dout("finisher", 1, f"{self.name}: callback raised "
                                    f"{type(e).__name__}: {e}")


class _KeyWindow:
    """Per-key (per-PG) in-flight execution state of one shard: how many
    items of each class are running, which object streams are occupied,
    and whether an exclusive (obj=None) item holds the key."""

    __slots__ = ("counts", "objs", "exclusive")

    def __init__(self):
        self.counts = collections.Counter()     # klass -> in-flight
        self.objs: set = set()                  # objects in execution
        self.exclusive = False                  # obj=None item running

    @property
    def total(self) -> int:
        return sum(self.counts.values())


class ShardedOpQueue:
    """N shards drained concurrently; work is routed by key hash so
    same-key (same-PG) items keep their order (osd_op_tp semantics).

    Each shard holds one FIFO per OP CLASS, drained by weighted round
    robin — the mClock-lite QoS split (src/osd/scheduler/
    mClockScheduler.h:92, OpSchedulerItem op classes): client traffic
    gets `WEIGHTS["client"]` dequeues for every 1 a background class
    gets, so recovery/backfill can neither starve clients nor be
    starved by them.

    Pipelined admission (`pipeline_depth` > 1, the PrimaryLogPG
    concurrent-op analog): instead of awaiting each item to completion,
    a shard worker ADMITS up to `pipeline_depth` items per key per
    class into concurrently-running tasks, with ordering guarantees:

      * FIFO within an object: an item is never started while an
        earlier same-key item for the same `obj` is queued or running
        (the obc write-lock ordering — same-object ops serialize in
        arrival order; different objects of one PG overlap);
      * an item with `obj=None` is an exclusive barrier for its key
        WITHIN ITS CLASS: it waits for the key to fully drain, runs
        alone, and no later item of its class starts until it
        completes (multi-object/unkeyed ops keep the old whole-PG
        serial semantics). Admission order ACROSS classes stays
        WRR-arbitrated, exactly as it was pre-pipelining — a recovery
        item enqueued after a client barrier may run first, and
        cannot starve it: recovery serializes per PG with the key
        going idle between items, at which point the barrier (scanned
        first, client credits) admits;
      * windows are per (key, class), so a saturated client window
        cannot starve recovery admission for the same PG — but object
        conflicts span classes (a recovery rebuild of X still
        serializes against a client write of X);
      * QoS credits are spent at START time only: a class whose head is
        window-blocked burns no credits, so weighted round robin
        arbitrates over STARTABLE work (the credit-holding stall bug).

    `pipeline_depth=1` runs the exact legacy path: the worker awaits
    each item inline, one in flight per shard, bit-identical ordering.
    Hot-resizable via set_pipeline_depth (the osd_pg_pipeline_depth
    observer); completions refill the window (completion-driven
    admission, no polling).

    dmclock mode (`osd_mclock_enabled`, set_mclock_enabled): the WRR
    class split is replaced by per-ENTITY tag-clock arbitration
    (osd/scheduler/dmclock.py) — an entity is a client tenant or a
    background class's pseudo-entity; each shard keeps one FIFO per
    entity and the scheduler orders entities by reservation/limit/
    weight tags, byte-cost normalized. The window/ordering guarantees
    above carry over per entity queue: same-object FIFO and obj=None
    barriers hold WITHIN an entity (Ceph's ordering contract is
    per-client; cross-tenant same-object execution still serializes on
    the windows, only admission order is QoS-arbitrated). Overload:
    limit-blocked shards sleep until the earliest l_tag matures
    (backpressure) or enqueue refuses past a depth cap (shed — the
    caller replies EAGAIN-style). Toggling is hot: queued items
    migrate between the class and entity queues preserving arrival
    order, and with the scheduler OFF this code path is bit-identical
    to the legacy WRR queue.
    """

    #: legacy-path class weights, derived from the declared profile
    #: (satellite fix: classes are registered in
    #: osd/scheduler/profile.py, not hardcoded — the phantom `scrub`
    #: entry with no producer is gone)
    WEIGHTS = default_profile().wrr_weights()

    def __init__(self, name: str = "osd_op_tp", num_shards: int = 5,
                 hb_map: HeartbeatMap | None = None,
                 hb_grace: float = 30.0, pipeline_depth: int = 1,
                 perf: "PerfCounters | None" = None,
                 profile=None, clock=time.monotonic):
        self.name = name
        self.num_shards = num_shards
        self.profile = profile if profile is not None \
            else default_profile()
        self._weights = self.profile.wrr_weights()
        # each queued item is (key, obj, work, entity, cost, seq);
        # entity/cost ride along even on the legacy path so a hot
        # toggle can migrate queued work without losing attribution
        self._queues: list[dict[str, collections.deque]] = [
            {k: collections.deque() for k in self._weights}
            for _ in range(num_shards)]
        self._wake = [asyncio.Event() for _ in range(num_shards)]
        self._credits: list[dict[str, int]] = [
            dict(self._weights) for _ in range(num_shards)]
        # dmclock mode: per-shard entity -> deque of
        # (key, obj, work, klass, cost, seq)
        self.sched = MClockScheduler(self.profile, clock=clock)
        self.mclock_enabled = False
        self._ent_queues: list[dict[str, collections.deque]] = [
            {} for _ in range(num_shards)]
        self._defer: list[float | None] = [None] * num_shards
        self._seq = 0
        self._last_defer_flight = 0.0
        self.deferred_waits = 0
        self._inflight: list[dict] = [{} for _ in range(num_shards)]
        self._exec_tasks: list[set] = [set() for _ in range(num_shards)]
        self._stalled = [False] * num_shards
        self._stopping = False
        self._tasks: list[asyncio.Task] = []
        self._hb_map = hb_map
        self._hb_grace = hb_grace
        self._hb_ids: list[int] = []
        self.pipeline_depth = max(1, int(pipeline_depth))
        # optional daemon counters: pg_pipeline_inflight gauge +
        # pg_pipeline_window_stalls (declared by the OSD)
        self.perf = perf
        self._inflight_total = 0
        self.window_stalls = 0
        # flight-recorder rate limit: a saturated window can stall
        # thousands of times a second, and the black box wants "the
        # queue was stalling around t", not a flooded ring
        self._last_stall_flight = 0.0
        self.processed = 0
        self.processed_by_class = collections.Counter()

    def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._stopping = False
        for i in range(self.num_shards):
            if self._hb_map is not None:
                self._hb_ids.append(self._hb_map.add_worker(
                    f"{self.name}.{i}", grace=self._hb_grace))
            self._tasks.append(loop.create_task(self._worker(i)))

    async def stop(self) -> None:
        self._stopping = True
        for ev in self._wake:
            ev.set()
        # workers exit via the wake events, not cancellation. Unlike
        # drain(), an unexpected worker crash must PROPAGATE out of
        # stop() — swallowing it would report clean shutdown over a
        # dead shard; only our own cancellation contract applies
        for t in self._tasks:
            try:
                await t
            except asyncio.CancelledError:
                if being_cancelled() or not t.done():
                    raise       # a cancelled stop() stays cancellable
        self._tasks.clear()
        # pipelined executions the workers spawned: _run_one swallows
        # work exceptions, so awaiting these only propagates our own
        # cancellation — nothing may stay pending past stop()
        for tasks in self._exec_tasks:
            for t in list(tasks):
                try:
                    await t
                except asyncio.CancelledError:
                    if being_cancelled() or not t.done():
                        raise
            tasks.clear()
        for hid in self._hb_ids:
            self._hb_map.remove_worker(hid)
        self._hb_ids.clear()

    def shard_of(self, key) -> int:
        return hash(key) % self.num_shards

    def set_pipeline_depth(self, depth: int) -> None:
        """Hot-resize the per-PG execution window (config observer).
        Growing wakes every shard so blocked work admits immediately;
        shrinking takes effect as in-flight items complete."""
        self.pipeline_depth = max(1, int(depth))
        for ev in self._wake:
            ev.set()

    def set_mclock_enabled(self, enabled: bool) -> None:
        """Hot-toggle the dmclock arbiter (osd_mclock_enabled
        observer). Queued work MIGRATES between the legacy class
        queues and the per-entity queues preserving arrival order
        (every item carries its enqueue seq), so a toggle mid-storm
        loses nothing and reorders nothing within an entity."""
        enabled = bool(enabled)
        if enabled == self.mclock_enabled:
            return
        self.mclock_enabled = enabled
        for shard in range(self.num_shards):
            if enabled:
                items = []
                for klass, q in self._queues[shard].items():
                    while q:
                        key, obj, work, entity, nbytes, seq = \
                            q.popleft()
                        items.append((seq, entity,
                                      (key, obj, work, klass,
                                       nbytes, seq)))
                for seq, entity, item in sorted(items,
                                                key=lambda t: t[0]):
                    klass = item[3]
                    self.sched.entity(entity, klass).queued += 1
                    self._ent_queues[shard].setdefault(
                        entity, collections.deque()).append(item)
            else:
                items = []
                for entity, q in self._ent_queues[shard].items():
                    while q:
                        key, obj, work, klass, nbytes, seq = \
                            q.popleft()
                        self.sched.note_drop(entity)
                        items.append((seq,
                                      (key, obj, work, entity,
                                       nbytes, seq), klass))
                self._ent_queues[shard].clear()
                for seq, item, klass in sorted(items,
                                               key=lambda t: t[0]):
                    if klass not in self._weights:
                        self._register_class(klass)
                    self._queues[shard][klass].append(item)
                self._defer[shard] = None
            self._wake[shard].set()
        flight.record("qos_toggle", self.name, enabled=enabled)

    def configure_qos(self, **kw) -> None:
        """Forward knob values to the scheduler (config observer path)
        and re-arbitrate: a loosened limit must unblock a deferred
        shard without waiting out its old sleep."""
        self.sched.configure(**kw)
        for ev in self._wake:
            ev.set()

    def qos_status(self) -> dict:
        """Admin-socket `qos status` body."""
        st = self.sched.status()
        st["enabled"] = self.mclock_enabled
        st["deferred_waits"] = self.deferred_waits
        st["queued"] = {
            "legacy": sum(len(q) for shard in self._queues
                          for q in shard.values()),
            "mclock": sum(len(q) for shard in self._ent_queues
                          for q in shard.values())}
        return st

    def total_in_flight(self) -> int:
        """Items currently in pipelined execution across all shards."""
        return self._inflight_total

    def in_flight(self, key) -> int:
        """Items of `key` currently in execution (window occupancy)."""
        st = self._inflight[self.shard_of(key)].get(key)
        return st.total if st is not None else 0

    def enqueue(self, key, work: Callable[[], Awaitable],
                klass: str = "client", obj=None, entity: str | None = None,
                nbytes: int = 0) -> bool:
        """Queue an async thunk on the shard owning `key`. `obj` names
        the object stream the item belongs to (same-obj items stay
        FIFO); None makes the item an exclusive barrier for its key.
        `entity` is the QoS accounting identity (client tenant;
        background classes default to a class pseudo-entity) and
        `nbytes` its payload size for byte-cost normalization.

        Returns False when admission control SHED the op (dmclock mode,
        shed policy, entity backlog past the depth cap) — the caller
        owes the client an EAGAIN-style throttle reply. Always True on
        the legacy path."""
        shard = self.shard_of(key)
        if entity is None:
            entity = f"class:{klass}" if klass != "client" else "client"
        self._seq += 1
        if self.mclock_enabled:
            if not self.sched.note_enqueue(entity, klass):
                if self.perf is not None:
                    self.perf.inc("qos_shed")
                flight.record("qos_shed", self.name, tenant=entity,
                              klass=klass,
                              depth=self.sched.shed_queue_depth)
                return False
            self._ent_queues[shard].setdefault(
                entity, collections.deque()).append(
                (key, obj, work, klass, nbytes, self._seq))
        else:
            if klass not in self._weights:
                self._register_class(klass)
            self._queues[shard][klass].append(
                (key, obj, work, entity, nbytes, self._seq))
        self._wake[shard].set()
        return True

    def _register_class(self, klass: str) -> None:
        """A producer enqueued a class no profile declared: register it
        late (wrr=1 best-effort) on every shard rather than KeyError —
        see QosProfile.ensure."""
        self.profile.ensure(klass)
        self._weights = self.profile.wrr_weights()
        for shard in range(self.num_shards):
            self._queues[shard].setdefault(klass, collections.deque())
            self._credits[shard].setdefault(
                klass, self._weights[klass])

    # -- admission -----------------------------------------------------------

    def _startable(self, infl: dict, key, obj, klass: str,
                   depth: int) -> bool:
        st = infl.get(key)
        if st is None:
            return True
        if st.exclusive or st.counts[klass] >= depth:
            return False
        if obj is None:
            return st.total == 0        # barrier: needs the key idle
        return obj not in st.objs

    def _scan(self, q: collections.deque, infl: dict, klass: str,
              depth: int) -> tuple | None:
        """First startable item of one class queue, honoring per-object
        FIFO: a skipped item shadows everything behind it that must not
        overtake it (its object stream; its whole key when the skip was
        a full window or a waiting barrier).

        O(queued) per admission — acceptable at OSD queue depths (a
        shard's class backlog is client-concurrency / (osds × shards));
        if deep backlogs ever profile here, the structural fix is
        per-key subqueues with a ready list so blocked streams are
        skipped without rescanning."""
        blocked_keys: set = set()
        blocked_objs: set = set()
        for i, item in enumerate(q):
            key, obj = item[0], item[1]
            if key in blocked_keys:
                continue
            if obj is not None and (key, obj) in blocked_objs:
                continue
            if self._startable(infl, key, obj, klass, depth):
                del q[i]
                return item
            if obj is None:
                # a waiting barrier: nothing behind it for this key
                # may overtake (it is a sync point)
                blocked_keys.add(key)
                continue
            st = infl.get(key)
            if st is not None and (st.exclusive
                                   or st.counts[klass] >= depth):
                blocked_keys.add(key)   # whole window full
            else:
                blocked_objs.add((key, obj))
        return None

    def _admit(self, shard: int, klass: str, key, obj) -> None:
        st = self._inflight[shard].setdefault(key, _KeyWindow())
        st.counts[klass] += 1
        if obj is None:
            st.exclusive = True
        else:
            st.objs.add(obj)
        self._inflight_total += 1
        if self.perf is not None:
            self.perf.set("pg_pipeline_inflight", self._inflight_total)

    def _complete(self, shard: int, klass: str, key, obj) -> None:
        infl = self._inflight[shard]
        st = infl.get(key)
        if st is not None:
            st.counts[klass] -= 1
            if obj is None:
                st.exclusive = False
            else:
                st.objs.discard(obj)
            if st.total <= 0:
                del infl[key]
        self._inflight_total -= 1
        if self.perf is not None:
            self.perf.set("pg_pipeline_inflight", self._inflight_total)
        self._wake[shard].set()         # completion-driven refill

    def _pick(self, shard: int) -> tuple | None:
        """Weighted round robin over STARTABLE work: class credits are
        spent only when an item actually admits (a window-blocked class
        holds its credits — satellite audit: the old picker charged the
        class before knowing the item could run); refill when no
        credited class can start anything. Sets the shard's stall flag
        when queued work existed but every item was window-blocked."""
        if self.mclock_enabled:
            return self._pick_mclock(shard)
        queues, credits = self._queues[shard], self._credits[shard]
        infl = self._inflight[shard]
        depth = self.pipeline_depth
        self._stalled[shard] = False
        blocked = False
        for attempt in range(2):
            blocked = False
            for klass in self._weights:
                if not queues[klass] or credits[klass] <= 0:
                    continue
                item = self._scan(queues[klass], infl, klass, depth)
                if item is None:
                    blocked = True
                    continue
                credits[klass] -= 1
                self.processed_by_class[klass] += 1
                self._admit(shard, klass, *item[:2])
                return (klass, *item[:3])
            # nothing admitted on credits: refill and retry once (an
            # uncredited class may hold startable work); a second dry
            # pass with blocked work means everything queued is
            # window-blocked
            self._credits[shard] = dict(self._weights)
            credits = self._credits[shard]
        self._stalled[shard] = blocked
        return None

    def _pick_mclock(self, shard: int) -> tuple | None:
        """dmclock admission: the scheduler orders entities by tag
        clocks; the first entity whose head-of-queue survives the
        ordering windows admits. Window semantics (same-obj FIFO,
        obj=None barriers) are enforced per entity queue by the same
        _scan shadowing — see the class docstring for the ordering
        contract. Sets the shard's defer hint when every queued entity
        is limit-blocked (backpressure sleep)."""
        queues = self._ent_queues[shard]
        infl = self._inflight[shard]
        depth = self.pipeline_depth
        self._stalled[shard] = False
        self._defer[shard] = None
        ready = [e for e, q in queues.items() if q]
        if not ready:
            return None
        order, defer_s, defer_ent = self.sched.schedule(ready)
        if not order and self._stopping:
            # shutdown drains ignore limit tags: stop() must not wait
            # out a throttle horizon to finish queued work
            order, defer_s = [(e, "weight") for e in sorted(ready)], None
        blocked = False
        for entity, phase in order:
            q = queues.get(entity)
            if not q:
                continue
            item = self._scan_entity(q, infl, depth)
            if item is None:
                blocked = True
                continue
            key, obj, work, klass, nbytes, _seq = item
            if not q:
                del queues[entity]
            self.sched.charge(entity, self.sched.cost_of(nbytes),
                              phase=phase)
            if self.perf is not None:
                self.perf.inc("qos_dequeue_reservation"
                              if phase == "reservation"
                              else "qos_dequeue_weight")
            self.processed_by_class[klass] += 1
            self._admit(shard, klass, key, obj)
            return (klass, key, obj, work)
        if defer_s is not None:
            self._defer[shard] = defer_s
            self.deferred_waits += 1
            if self.perf is not None:
                self.perf.inc("qos_deferred_waits")
            now = time.monotonic()
            if now - self._last_defer_flight >= 0.5:
                self._last_defer_flight = now
                flight.record("qos_backpressure", self.name,
                              shard=shard, tenant=defer_ent,
                              defer_ms=round(defer_s * 1000, 3))
        self._stalled[shard] = blocked
        return None

    def _scan_entity(self, q: collections.deque, infl: dict,
                     depth: int) -> tuple | None:
        """_scan for a per-entity queue: items carry their own class
        (an entity queue is single-class in practice, but the window
        check keys on the item's class either way)."""
        blocked_keys: set = set()
        blocked_objs: set = set()
        for i, item in enumerate(q):
            key, obj, klass = item[0], item[1], item[3]
            if key in blocked_keys:
                continue
            if obj is not None and (key, obj) in blocked_objs:
                continue
            if self._startable(infl, key, obj, klass, depth):
                del q[i]
                return item
            if obj is None:
                blocked_keys.add(key)
                continue
            st = infl.get(key)
            if st is not None and (st.exclusive
                                   or st.counts[klass] >= depth):
                blocked_keys.add(key)
            else:
                blocked_objs.add((key, obj))
        return None

    async def _run_one(self, shard: int, klass: str, key, obj,
                       work) -> None:
        try:
            await work()
        except Exception as e:
            dout("osd", 1, f"{self.name}.{shard}: work raised "
                           f"{type(e).__name__}: {e}")
        finally:
            self.processed += 1
            self._complete(shard, klass, key, obj)

    def _shard_empty(self, shard: int) -> bool:
        return not any(self._queues[shard].values()) and \
            not any(self._ent_queues[shard].values())

    async def _worker(self, shard: int) -> None:
        loop = asyncio.get_running_loop()
        while True:
            picked = self._pick(shard)
            if picked is None:
                if self._stopping and self._shard_empty(shard):
                    return
                self._wake[shard].clear()
                picked = self._pick(shard)      # close the enqueue race
            if picked is None:
                if self._stopping and self._shard_empty(shard):
                    return
                if self._stalled[shard]:
                    # queued work exists but every item is blocked
                    # behind a full window: a completion will wake us
                    self.window_stalls += 1
                    if self.perf is not None:
                        self.perf.inc("pg_pipeline_window_stalls")
                    now = time.monotonic()
                    if now - self._last_stall_flight >= 0.5:
                        self._last_stall_flight = now
                        flight.record(
                            "pg_window_stall", self.name, shard=shard,
                            stalls=self.window_stalls,
                            depth=self.pipeline_depth)
                defer = self._defer[shard]
                if defer is not None:
                    # backpressure: every queued entity is at its
                    # limit — sleep until the earliest l_tag matures
                    # (or an enqueue/completion wakes us early), then
                    # re-arbitrate
                    try:
                        await asyncio.wait_for(
                            self._wake[shard].wait(),
                            timeout=min(defer, 1.0))
                    except (asyncio.TimeoutError, TimeoutError):
                        pass
                    continue
                await self._wake[shard].wait()
                continue
            klass, key, obj, work = picked
            if self._hb_ids:
                self._hb_map.touch(self._hb_ids[shard])
            if self.pipeline_depth <= 1:
                # legacy serial path: bit-identical to the pre-pipeline
                # queue (one in-flight item per shard, awaited inline)
                await self._run_one(shard, klass, key, obj, work)
            else:
                t = loop.create_task(
                    self._run_one(shard, klass, key, obj, work))
                self._exec_tasks[shard].add(t)
                t.add_done_callback(self._exec_tasks[shard].discard)
