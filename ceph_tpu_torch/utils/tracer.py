"""Distributed op tracing: spans, context propagation, bounded collection.

Re-creation of the reference's tracing integration (src/common/tracer.cc
wrapping Jaeger/OpenTelemetry, doc/jaegertracing): a root span opened in
the client threads through the messenger (the trace context rides the
message frame, src/msg/Message.h otel_trace), the OSD op pipeline, the
EC backend's encode dispatch and the objectstore commit, so "where did
this 1 MiB EC write spend its time" is answerable per stage.

Design:
  * `Span`: trace/span/parent ids, service + name, wall-clock start,
    monotonic duration, free-form tags, and optional *links* to other
    traces (a coalesced offload batch span links every rider op's
    trace, OTel span-link style). Finished spans land in a
    process-wide bounded `SpanCollector` (the in-memory stand-in for a
    Jaeger agent; every daemon in this stack can dump it over its admin
    socket as `trace dump`, and MgrClient ships it incrementally via
    `export_since`).
  * context propagation: a contextvar carries (trace_id, span_id,
    flags); tasks inherit it at creation, `span()` nests under it, and
    `current_context()` / `span(parent=ctx)` move it across the wire
    (msg/frames.py encodes it as an optional trailing TLV segment that
    old peers simply never send). The SAMPLED flag rides along so a
    trace is decided once, at its root, and never half-sampled.
  * sampling policy (tracing v2): three regimes, cheapest first.
      - off: `tracer_enabled=false`, `tracer_sample_rate=0`,
        `tracer_tail_slow_ms=0` — `span()` returns one shared no-op
        context manager, nothing is allocated.
      - head sampling: each new root draws once against
        `tracer_sample_rate`; sampled traces go straight to the
        collector, the rest record a lightweight skeleton.
      - tail retention: every traced op's spans land in a small
        per-process reservoir keyed by trace id; when a *local root*
        (a span whose parent lives in another process, e.g. `osd_op`
        under a remote client) completes slow (>= `tracer_tail_slow_ms`)
        or errored, the whole skeleton is promoted to the collector —
        p99 outliers are captured at ~100% without full-trace cost.
    Promotion is the ONLY transition (never eager drop): a client's
    reply `ms_dispatch` is a local root that finishes long before the
    `rados_op` above it. None of this implies `profile_dispatch` — the
    serialized-pipeline attribution mode stays a deliberate opt-in.
  * gating: `enabled()` is the legacy always-sample switch;
    `active()` is what hot paths gate on (any regime but off).

The port's copy of ceph_tpu/utils/tracer.py (jax-free; the port imports
nothing of the JAX package). Spans time on the host clock; under
`profile_dispatch` the device legs (h2d, kernel, d2h) are timed with
CUDA events on the streams they run on and land in span tags.
"""
from __future__ import annotations

import asyncio
import collections
import contextvars
import os
import random
import threading
import time
import weakref
from typing import Any, Iterator

#: context flag: this trace was head-sampled at its root — every span
#: goes straight to the collector (and to the mgr), no tail gamble.
FLAG_SAMPLED = 1

#: (trace_id, span_id, flags) of the span the current task is inside
_current: contextvars.ContextVar[tuple[int, int, int] | None] = \
    contextvars.ContextVar("trace_ctx", default=None)

#: task -> NAME of the span it is currently inside. The loop profiler
#: attributes sampled wall time to this ("which span kind was running
#: when the loop stalled") by reading the loop's current task from its
#: sampler thread — a contextvar can't serve that on 3.10 (no
#: Task.get_context), so the span CM mirrors its name here. Weak keys:
#: a finished task drops its entry with it. Mirrored ONLY while a
#: sampler is armed (`set_task_naming`): three WeakKeyDictionary ops +
#: current_task() per span is real money on the always-on tail path,
#: and nobody reads the mirror unless loopprof is sampling.
_task_spans: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_name_tasks = False


def set_task_naming(on: bool) -> None:
    """Armed by loopprof while any stall sampler is installed; the span
    CM skips the task-name mirror entirely when this is off."""
    global _name_tasks
    _name_tasks = bool(on)

_enabled = False
_sample_rate = 0.0
_tail_slow_ms = 0.0

#: process identity for cross-process assembly: the mgr dedups shipped
#: spans by (pid, boot, seq), so a daemon restart reusing a pid can
#: never alias an old cursor. Lazily re-derived after fork.
_boot_pid: int | None = None
_boot = ""


def boot_token() -> str:
    global _boot_pid, _boot
    pid = os.getpid()
    if pid != _boot_pid:
        _boot_pid, _boot = pid, f"{pid:x}.{os.urandom(4).hex()}"
    return _boot


def task_span_name(task) -> str | None:
    """Name of the span `task` is currently inside (None when it isn't
    in one, or tracing is off). Safe to call from a foreign thread —
    the sampler reads the loop's current task through this."""
    if task is None:
        return None
    try:
        return _task_spans.get(task)
    except Exception:
        return None


def _new_id() -> int:
    return random.getrandbits(63) or 1


_perf_counters = None
_perf_lock = threading.Lock()


def perf():
    """Process-wide `tracer` perf logger (created on first use; rides
    any daemon's mgr report via extra_loggers)."""
    global _perf_counters
    p = _perf_counters
    if p is not None:                   # lock-free fast path (hot)
        return p
    with _perf_lock:
        if _perf_counters is None:
            from ceph_tpu_torch.utils.perf_counters import (
                PerfCountersCollection)
            coll = PerfCountersCollection.instance()
            perf = coll.get("tracer")
            if perf is None:
                perf = coll.create("tracer")
                perf.add("trace_sampled",
                         description="trace roots head-sampled into the "
                                     "collector")
                perf.add("trace_unsampled",
                         description="trace roots that lost the head-"
                                     "sampling draw (skeleton only)")
                perf.add("trace_skeleton_spans",
                         description="lightweight spans recorded into the "
                                     "tail reservoir")
                perf.add("trace_tail_promoted",
                         description="traces promoted to the collector by "
                                     "the tail policy (slow or errored)")
                perf.add("trace_tail_evicted",
                         description="reservoir traces evicted unpromoted "
                                     "(fast-path ops, by design)")
                perf.add("trace_shipped_spans",
                         description="spans exported to the mgr on the "
                                     "report leg")
            _perf_counters = perf
        return _perf_counters


#: wall-clock anchor: spans store only the perf_counter stamp (one
#: clock read instead of two on the hot path) and derive wall time
#: lazily in to_dict. Cross-process skew from anchor drift is bounded
#: by process uptime drift — the mgr's waterfall aligns on trace
#: structure, not absolute stamps, so display-grade accuracy is enough.
_WALL_ANCHOR = time.time() - time.perf_counter()


class Span:
    """One timed operation stage within a trace."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "service",
                 "_t0", "duration_us", "tags", "flags", "links",
                 "seq", "_done", "_emitted", "_seg")

    def __init__(self, name: str, service: str, trace_id: int,
                 parent_id: int | None, flags: int = 0):
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.name = name
        self.service = service
        self._t0 = time.perf_counter()
        self.duration_us = 0.0
        self.tags: dict[str, Any] = {}
        self.flags = flags
        self.links: list[dict] | None = None    # lazy: most spans never link
        self.seq = 0
        self._done = False
        self._emitted = False
        self._seg = None                # opener thread's segment buffer

    @property
    def start(self) -> float:
        return _WALL_ANCHOR + self._t0

    def set_tag(self, key: str, value: Any) -> None:
        self.tags[key] = value

    def add_link(self, ctx: dict | None) -> None:
        """Link this span to another trace (OTel span link): the
        offload batch span links every rider op's context so `trace
        get <rider>` can pull the shared device batch in."""
        if ctx is not None and "t" in ctx and "s" in ctx:
            if self.links is None:
                self.links = []
            self.links.append({"t": int(ctx["t"]), "s": int(ctx["s"]),
                               "f": int(ctx.get("f", 0) or 0)})

    def finish(self) -> None:
        if self._done:
            return
        self._done = True
        # raw float; rounded once at export (to_dict), not per span
        self.duration_us = (time.perf_counter() - self._t0) * 1e6
        _route(self)

    def context(self) -> dict:
        """Wire form of this span as a parent ({"t","s","f"})."""
        return {"t": self.trace_id, "s": self.span_id, "f": self.flags}

    def to_dict(self) -> dict:
        d = {"trace_id": format(self.trace_id, "016x"),
             "span_id": format(self.span_id, "016x"),
             "parent_id": (format(self.parent_id, "016x")
                           if self.parent_id else None),
             "name": self.name, "service": self.service,
             "start": self.start, "duration_us": round(self.duration_us, 1),
             "tags": dict(self.tags), "seq": self.seq}
        if self.links:
            d["links"] = [{"trace_id": format(l["t"], "016x"),
                           "span_id": format(l["s"], "016x")}
                          for l in self.links]
        return d


class SpanCollector:
    """Bounded per-process store of finished spans (Jaeger-agent role).

    Every admitted span gets a process-monotonic `seq`, so MgrClient
    can ship the collector incrementally (`export_since`), flight-ring
    style, and the mgr can dedup replays by (pid, boot, seq)."""

    def __init__(self, max_spans: int = 4096):
        self._lock = threading.Lock()
        self._spans: collections.deque[Span] = \
            collections.deque(maxlen=max_spans)
        self.dropped = 0
        self._seq = 0

    def set_max_spans(self, n: int) -> None:
        with self._lock:
            self._spans = collections.deque(self._spans, maxlen=max(n, 16))

    def add(self, span: Span) -> None:
        with self._lock:
            if span._emitted:       # linked into several promoted traces
                return
            span._emitted = True
            self._seq += 1
            span.seq = self._seq
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(span)

    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def export_since(self, cursor: int, limit: int = 512) -> dict:
        """Spans with seq > cursor (oldest first, bounded), wrapped in
        the process-identity envelope the mgr's TraceIndex dedups on."""
        with self._lock:
            new = [s for s in self._spans if s.seq > cursor]
        new = new[:max(limit, 1)]
        return {"pid": os.getpid(), "boot": boot_token(),
                "next": (new[-1].seq if new else cursor),
                "spans": [s.to_dict() for s in new]}

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def spans(self) -> list[dict]:
        with self._lock:
            return [s.to_dict() for s in self._spans]

    def reset(self) -> int:
        # _seq is NOT reset: the mgr's per-(pid, boot) cursor must stay
        # monotonic or a reset daemon would replay into the dedup hole.
        with self._lock:
            n = len(self._spans)
            self._spans.clear()
            self.dropped = 0
            return n


_collector = SpanCollector()


# -- tail reservoir -----------------------------------------------------------

class _Reservoir:
    """Per-process skeleton store for tail-based retention.

    Every finished unsampled span is noted here (name -> max duration
    per trace: the "skeleton" historic-ops triage reads) and retained
    until its trace is promoted (slow/errored local segment) or evicted
    (LRU — the fast path, by design). Promotion is one-way: once a
    trace promotes, later spans bypass the reservoir straight into the
    collector, so the client-side half of a slow op is captured too."""

    MAX_TRACES = 256
    MAX_SPANS_PER_TRACE = 128
    #: lock stripes keyed by trace_id: merges arrive from every reactor
    #: shard thread (one bulk merge per quiesced segment buffer, see
    #: _SegBuf), and unrelated traces shouldn't serialize on one lock.
    STRIPES = 16

    def __init__(self):
        self._stripes = [
            {"lock": threading.Lock(),
             "entries": collections.OrderedDict(),
             "promoted": 0, "evicted": 0}
            for _ in range(self.STRIPES)]

    def _stripe(self, trace_id: int) -> dict:
        return self._stripes[trace_id & (self.STRIPES - 1)]

    def _entry(self, st: dict, trace_id: int) -> dict:
        """Get-or-create under st["lock"] (held by the caller)."""
        entries = st["entries"]
        e = entries.get(trace_id)
        if e is None:
            e = {"spans": [], "stages": {},
                 "max_dur": 0.0, "promoted": False, "errored": False}
            entries[trace_id] = e
            while len(entries) > max(1, self.MAX_TRACES // self.STRIPES):
                _, old = entries.popitem(last=False)
                if not old["promoted"]:
                    st["evicted"] += 1
                    try:
                        perf().inc("trace_tail_evicted")
                    except Exception:
                        pass
        else:
            entries.move_to_end(trace_id)
        return e

    def _note_stages(self, e: dict, span: Span) -> None:
        st = e["stages"]
        if span.duration_us > st.get(span.name, -1.0):
            st[span.name] = span.duration_us
        qw = span.tags.get("queue_wait_us")
        if isinstance(qw, (int, float)) and qw > st.get("queue_wait", -1.0):
            st["queue_wait"] = float(qw)

    def note_sampled(self, span: Span) -> None:
        """Head-sampled span: keep the skeleton stages (historic-ops
        triage) but mark the entry promoted — spans already flow to
        the collector directly."""
        st = self._stripe(span.trace_id)
        with st["lock"]:
            e = self._entry(st, span.trace_id)
            e["promoted"] = True
            self._note_stages(e, span)

    def merge(self, groups: dict[int, list[Span]]) -> list[Span]:
        """Bulk-admit finished unsampled spans (one thread-local batch,
        grouped by trace_id); returns spans to emit to the collector
        ([] on the fast path). One lock round per touched trace, not
        per span — the hot path never takes a lock at all (see
        `_SegBuf`).

        Tail policy: evaluated at every merge, on the longest span the
        entry has seen (the spanning local parent: rados_op
        client-side, osd_op primary-side, store_commit on a replica —
        unsampled dispatch hops carry no span of their own).
        "Longest span so far" is the right signal, not "local
        root finished": an OSD's ms_dispatch local root returns in
        microseconds after ENQUEUEING the op, and the slow osd_op
        subtree runs later as a queued task — judged at dispatch
        completion, the primary path would never promote. Merging a
        half-built segment is harmless either way: a fast partial
        accumulates, a slow partial promotes now and its stragglers
        emit directly (promotion is one-way)."""
        emit: list[Span] = []
        promote_entries: list[tuple[int, dict, Span, list]] = []
        linked: list[Span] = []
        for trace_id, spans in groups.items():
            st = self._stripe(trace_id)
            with st["lock"]:
                e = self._entry(st, trace_id)
                slowest = spans[0]
                for span in spans:
                    self._note_stages(e, span)
                    if span.duration_us > e["max_dur"]:
                        e["max_dur"] = span.duration_us
                    if span.duration_us >= slowest.duration_us:
                        slowest = span
                    if "error" in span.tags:
                        # a child's swallowed error still marks the
                        # whole trace for promotion
                        e["errored"] = True
                    if span.links:
                        linked.append(span)
                    if e["promoted"]:
                        emit.append(span)
                    else:
                        e["spans"].append(span)
                if not e["promoted"]:
                    if len(e["spans"]) > self.MAX_SPANS_PER_TRACE:
                        e["spans"] = \
                            e["spans"][-self.MAX_SPANS_PER_TRACE:]
                    slow = (_tail_slow_ms > 0.0
                            and e["max_dur"] >= _tail_slow_ms * 1000.0)
                    if slow or e["errored"]:
                        e["promoted"] = True
                        st["promoted"] += 1
                        promoted = list(e["spans"])
                        emit.extend(promoted)
                        e["spans"] = []
                        promote_entries.append((trace_id, e, slowest,
                                                promoted))
        # span links (offload batch -> rider traces): register the span
        # under every linked trace too, so promoting a rider pulls the
        # shared batch span along. A link into a sampled trace emits
        # immediately. Linked traces live in OTHER stripes — handled
        # after the primary stripe unlocks (no nested stripe locks).
        for span in linked:
            for l in span.links:
                if l["t"] == span.trace_id:
                    continue
                lst = self._stripe(l["t"])
                with lst["lock"]:
                    le = self._entry(lst, l["t"])
                    if le["promoted"] or (l["f"] & FLAG_SAMPLED):
                        emit.append(span)
                    else:
                        le["spans"].append(span)
        for trace_id, e, root, promoted in promote_entries:
            _on_tail_promote(trace_id, e, root, promoted)
        return emit

    def stages(self, trace_id: int) -> dict | None:
        st = self._stripe(trace_id)
        with st["lock"]:
            e = st["entries"].get(trace_id)
            return dict(e["stages"]) if e else None

    @property
    def promoted_traces(self) -> int:
        return sum(st["promoted"] for st in self._stripes)

    @property
    def evicted_traces(self) -> int:
        return sum(st["evicted"] for st in self._stripes)

    def status(self) -> dict:
        return {"traces": sum(len(st["entries"])
                              for st in self._stripes),
                "promoted": self.promoted_traces,
                "evicted": self.evicted_traces}

    def reset(self) -> None:
        for st in self._stripes:
            with st["lock"]:
                st["entries"].clear()
                st["promoted"] = st["evicted"] = 0


_reservoir = _Reservoir()


def _on_tail_promote(trace_id: int, entry: dict, root: Span,
                     promoted: list[Span]) -> None:
    """A slow/errored trace just got promoted: count it and drop a
    `trace_slow` crumb into the flight recorder so `timeline dump`
    correlates slow ops with breaker trips and mark-downs. The crumb
    carries the critical-path top stage of the local skeleton."""
    try:
        perf().inc("trace_tail_promoted")
    except Exception:
        pass
    try:
        from ceph_tpu_torch.utils import critpath, flight
        cp = critpath.critical_path([s.to_dict() for s in promoted])
        flight.record("trace_slow", root.service,
                      trace_id=format(trace_id, "016x"),
                      op_class=cp["op_class"],
                      top_stage=cp["top_stage"],
                      duration_ms=round(root.duration_us / 1000.0, 3))
    except Exception:
        pass


# -- thread-local segment buffers ---------------------------------------------
#
# The unsampled hot path must touch NO shared state per span: with
# reactor shards, the client loop and N shard threads each finish
# thousands of spans a second, and any per-span lock (reservoir,
# collector, perf counter — even stripe-split) convoys under the
# pool's 0.5 ms GIL switch interval. So each thread buffers its
# finished spans locally (list append + int math, no locks) and
# bulk-merges into the striped
# reservoir only when it QUIESCES — its count of open unsampled spans
# drains to zero, i.e. every op it was running has completed — or
# every FLUSH_SPANS spans under continuous load. Merging early or late
# is always safe (see _Reservoir.merge): the drain trigger is a
# batching heuristic, not a correctness gate.

FLUSH_SPANS = 64

#: bumped by reset(): a buffer from a previous generation is stale and
#: is dropped, not merged (reset discards pending data by contract).
_gen = 0
_tls = threading.local()


class _SegBuf:
    """One thread's pending unsampled spans + its open-span count."""

    __slots__ = ("gen", "ident", "open", "buf", "roots")

    def __init__(self, gen: int):
        self.gen = gen
        self.ident = threading.get_ident()
        self.open = 0
        self.buf: list[Span] = []
        self.roots = 0          # unsampled roots opened, counted at flush


def _seg_state() -> _SegBuf:
    st = getattr(_tls, "seg", None)
    if st is None or st.gen != _gen:
        st = _tls.seg = _SegBuf(_gen)
    return st


def _flush_seg(st: _SegBuf) -> None:
    buf = st.buf
    if st.open < 0:         # cross-thread finish drift: self-heal
        st.open = 0
    if st.roots and st.gen == _gen:
        # root draws are batched here too — one counter lock per
        # segment flush instead of one per op
        perf().inc("trace_unsampled", st.roots)
    st.roots = 0
    if not buf:
        return
    st.buf = []
    if st.gen != _gen:      # reset() raced us: discard, don't merge
        return
    perf().inc("trace_skeleton_spans", len(buf))
    groups: dict[int, list[Span]] = {}
    for s in buf:
        groups.setdefault(s.trace_id, []).append(s)
    for s in _reservoir.merge(groups):
        _collector.add(s)


def _flush_local() -> None:
    """Merge the CURRENT thread's pending segment buffer (read paths:
    dump/op_stages/status must see this thread's completed spans)."""
    _flush_seg(_seg_state())


def _route(span: Span) -> None:
    """Finished-span routing: sampled -> collector, else the thread's
    segment buffer (merged into the reservoir on quiesce/cap)."""
    if span.flags & FLAG_SAMPLED:
        _reservoir.note_sampled(span)
        _collector.add(span)
        return
    st = span._seg
    if st is None:          # bare Span() (tests) — adopt locally
        st = _seg_state()
    else:
        st.open -= 1
    st.buf.append(span)
    # only the owner thread flushes: a foreign finisher may race the
    # owner's own append/flush, so it just deposits and leaves
    if st.ident == threading.get_ident() and \
            (st.open <= 0 or len(st.buf) >= FLUSH_SPANS):
        _flush_seg(st)


# -- span creation ------------------------------------------------------------

class _NoopSpanCM:
    """Shared do-nothing context manager returned while tracing is off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _NoopSpanCM()


class _SpanCM:
    """Context manager making a live span the current trace context."""

    __slots__ = ("span", "_token", "_task", "_prev_name")

    def __init__(self, span: Span):
        self.span = span

    def __enter__(self) -> Span:
        self._token = _current.set((self.span.trace_id, self.span.span_id,
                                    self.span.flags))
        self._task = self._prev_name = None
        if _name_tasks:                 # only while loopprof samples
            try:
                task = asyncio.current_task()
            except RuntimeError:
                task = None
            if task is not None:
                self._task = task
                self._prev_name = _task_spans.get(task)
                _task_spans[task] = self.span.name
        return self.span

    def __exit__(self, et, ev, tb) -> bool:
        _current.reset(self._token)
        if self._task is not None:
            if self._prev_name is None:
                _task_spans.pop(self._task, None)
            else:
                _task_spans[self._task] = self._prev_name
        if et is not None:
            self.span.tags.setdefault("error", f"{et.__name__}: {ev}")
        self.span.finish()
        return False


def _parse_parent(parent) -> tuple[int, int, int] | None:
    """Accept a wire dict {"t","s"[,"f"]}, a (trace, span[, flags])
    tuple, or a Span."""
    if parent is None:
        return None
    if isinstance(parent, Span):
        return (parent.trace_id, parent.span_id, parent.flags)
    if isinstance(parent, dict):
        try:
            return (int(parent["t"]), int(parent["s"]),
                    int(parent.get("f", 0) or 0))
        except (KeyError, TypeError, ValueError):
            return None
    try:
        vals = tuple(parent)
        if len(vals) == 2:
            return (int(vals[0]), int(vals[1]), 0)
        t, s, f = vals
        return (int(t), int(s), int(f))
    except (TypeError, ValueError):
        return None


def _root_flags() -> int:
    """The once-per-trace sampling decision, made at the root and then
    carried in the context (wire TLV included) forever after. Losing
    roots are counted by the segment buffer at flush (batched), not
    here — this runs once per op on the hot path."""
    if _enabled or (_sample_rate > 0.0 and random.random() < _sample_rate):
        perf().inc("trace_sampled")      # rare (head rate, e.g. 1%)
        return FLAG_SAMPLED
    return 0


def start_span(name: str, service: str = "",
               parent=None) -> Span | None:
    """Create a span (child of `parent`, else of the current context,
    else a new root). Returns None while tracing is inactive — callers
    on hot paths must treat None as "do nothing"."""
    if not active():
        return None
    ctx = _parse_parent(parent) or _current.get()
    if ctx is None:
        s = Span(name, service, _new_id(), None, _root_flags())
    else:
        s = Span(name, service, ctx[0], ctx[1], ctx[2])
    if not (s.flags & FLAG_SAMPLED):
        # lock-free open accounting on the opener's segment buffer:
        # the buffer merges when this count drains (thread quiesced)
        st = _seg_state()
        st.open += 1
        if ctx is None:
            st.roots += 1
        s._seg = st
    return s


def span(name: str, service: str = "", parent=None):
    """`with tracer.span("pg_op") as sp:` — sp is the Span, or None when
    tracing is off (the same shared no-op is returned, nothing is
    allocated)."""
    if not active():
        return _NOOP
    s = start_span(name, service, parent)
    if s is None:                       # deactivated raced mid-call
        return _NOOP
    return _SpanCM(s)


class _CtxCM:
    """Install a trace context WITHOUT allocating a span: descendants
    parent correctly, but this hop pays only a contextvar set/reset.
    __enter__ yields None, matching the `sp is None` convention."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: tuple[int, int, int]):
        self._ctx = ctx

    def __enter__(self) -> None:
        self._token = _current.set(self._ctx)
        return None

    def __exit__(self, *exc) -> bool:
        _current.reset(self._token)
        return False


def span_sampled_only(name: str, service: str = "", parent=None):
    """A span elided on unsampled traces: allocates only when full
    tracing is on or the enclosing trace is head-sampled. For
    decorative spans whose interval the parent already covers
    (e.g. the client aio wrapper under rados_op) — a tail-promoted
    waterfall tolerates their absence, and the unsampled hot path
    skips the whole span lifecycle."""
    if _enabled:
        return span(name, service, parent)
    if not active():
        return _NOOP
    ctx = _parse_parent(parent) or _current.get()
    if ctx is not None and not (ctx[2] & FLAG_SAMPLED):
        return _NOOP
    s = start_span(name, service, parent)
    return _SpanCM(s) if s is not None else _NOOP


def dispatch_scope(name: str, service: str = "", parent=None):
    """Receiver-side messenger scope: a real span when full tracing is
    on or the inbound context is head-sampled; otherwise just installs
    the sender's context (no span) so handler spans stay connected
    across the socket. Unsampled traces lose per-hop dispatch timing
    but keep the cross-process structure — the handler's own spans
    (osd_op, store_commit) are the tail signal that matters, and the
    receive path sheds one span per message."""
    if _enabled:
        return span(name, service, parent)
    ctx = _parse_parent(parent)
    if ctx is None:
        return span(name, service)
    if ctx[2] & FLAG_SAMPLED:
        s = start_span(name, service, parent)
        return _SpanCM(s) if s is not None else _NOOP
    return _CtxCM(ctx)


def current_context() -> dict | None:
    """The wire-form trace context of the current task, or None (also
    None whenever tracing is off, so callers can gate on it)."""
    if not active():
        return None
    ctx = _current.get()
    if ctx is None:
        return None
    return {"t": ctx[0], "s": ctx[1], "f": ctx[2]}


def op_stages(trace_id: int) -> dict | None:
    """Span-skeleton stage durations (name -> max us) of a trace, from
    the reservoir — dump_historic_ops triage on unsampled daemons."""
    _flush_local()
    return _reservoir.stages(trace_id)


def export_since(cursor: int, limit: int = 512) -> dict:
    """MgrClient's incremental span feed (see SpanCollector)."""
    _flush_local()          # ship this thread's quiesced-but-buffered tail
    out = _collector.export_since(cursor, limit)
    if out["spans"]:
        perf().inc("trace_shipped_spans", len(out["spans"]))
    return out


# -- gating + config ----------------------------------------------------------

def enabled() -> bool:
    return _enabled


def active() -> bool:
    """Any tracing regime on? This is the hot-path gate: head sampling
    and tail retention need spans even while `tracer_enabled` is off."""
    return _enabled or _sample_rate > 0.0 or _tail_slow_ms > 0.0


def enable(max_spans: int | None = None) -> None:
    global _enabled
    if max_spans is not None:
        _collector.set_max_spans(max_spans)
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def set_sampling(rate: float | None = None,
                 tail_slow_ms: float | None = None) -> None:
    global _sample_rate, _tail_slow_ms
    if rate is not None:
        _sample_rate = min(max(float(rate), 0.0), 1.0)
    if tail_slow_ms is not None:
        _tail_slow_ms = max(float(tail_slow_ms), 0.0)


def sampling() -> dict:
    _flush_local()
    return {"enabled": _enabled, "sample_rate": _sample_rate,
            "tail_slow_ms": _tail_slow_ms,
            "reservoir": _reservoir.status()}


#: attribution-profiler mode: when set, the cuda plugin's traced
#: dispatches synchronize each pipeline stage so spans carry REAL
#: h2d/kernel/d2h splits — at the cost of the transfer/compute overlap.
#: Deliberately NOT implied by `tracer_enabled` (nor by the v2 sampling
#: knobs): routine tracing must stay cheap enough to leave on, so only
#: the bench attribution stage (or an operator who wants the waterfall)
#: opts in.
_profile_dispatch = False


def profile_dispatch() -> bool:
    return _profile_dispatch


def set_profile_dispatch(on: bool) -> None:
    global _profile_dispatch
    _profile_dispatch = bool(on)


def register_config(config) -> None:
    """Declare the tracer options on `config` (idempotent) and watch
    them: `config set tracer_sample_rate 0.01` over an admin socket
    turns head sampling on live (md_config_obs_t-style hot reload)."""
    from ceph_tpu_torch.utils.config import ConfigError, Option
    for opt in (Option("tracer_enabled", "bool", False,
                       "collect every op trace span (hot-togglable)"),
                Option("tracer_max_spans", "int", 4096,
                       "bounded span collector size", minimum=16),
                Option("tracer_sample_rate", "float", 0.0,
                       "head-sampling probability decided once per "
                       "trace root and propagated in the wire context",
                       minimum=0.0, maximum=1.0),
                Option("tracer_tail_slow_ms", "float", 0.0,
                       "tail retention: promote a completed trace to "
                       "the collector when its local root ran at least "
                       "this long (0 = off)", minimum=0.0)):
        try:
            config.declare(opt)
        except ConfigError:
            pass                        # already declared by another daemon

    def _on_change(name: str, value) -> None:
        if name == "tracer_max_spans":
            _collector.set_max_spans(int(value))
        elif name == "tracer_enabled":
            enable() if value else disable()
        elif name == "tracer_sample_rate":
            set_sampling(rate=value)
        elif name == "tracer_tail_slow_ms":
            set_sampling(tail_slow_ms=value)

    config.add_observer(("tracer_enabled", "tracer_max_spans",
                         "tracer_sample_rate", "tracer_tail_slow_ms"),
                        _on_change)
    if config.get("tracer_enabled"):
        enable(config.get("tracer_max_spans"))
    set_sampling(rate=config.get("tracer_sample_rate"),
                 tail_slow_ms=config.get("tracer_tail_slow_ms"))


# -- dump surface (admin socket `trace dump` / `trace reset`) -----------------

def collector() -> SpanCollector:
    return _collector


def reset() -> dict:
    global _gen
    _gen += 1                   # stale thread buffers drop, not merge
    _reservoir.reset()
    return {"cleared": _collector.reset()}


def _group(spans: list[dict]) -> Iterator[tuple[str, list[dict]]]:
    by: dict[str, list[dict]] = {}
    for s in spans:
        by.setdefault(s["trace_id"], []).append(s)
    for tid, ss in by.items():
        ss.sort(key=lambda s: s["start"])
        yield tid, ss


def dump(trace_id: str | None = None) -> dict:
    """Collected spans grouped into traces (admin `trace dump`)."""
    _flush_local()
    traces = []
    for tid, ss in _group(_collector.spans()):
        if trace_id is not None and tid != trace_id:
            continue
        roots = [s for s in ss if s["parent_id"] is None]
        traces.append({
            "trace_id": tid,
            "root": roots[0]["name"] if roots else ss[0]["name"],
            "services": sorted({s["service"] for s in ss if s["service"]}),
            "num_spans": len(ss),
            "duration_us": max(s["duration_us"] for s in ss),
            "spans": ss,
        })
    traces.sort(key=lambda t: t["spans"][0]["start"], reverse=True)
    return {"enabled": _enabled, "num_spans": len(_collector),
            "dropped": _collector.dropped, "sampling": sampling(),
            "traces": traces}


def recent_traces(limit: int = 20) -> list[dict]:
    """Trace summaries (newest first) for the mgr dashboard table."""
    out = []
    for t in dump()["traces"][:limit]:
        out.append({k: t[k] for k in ("trace_id", "root", "services",
                                      "num_spans", "duration_us")})
    return out
