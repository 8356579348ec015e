"""Mgr daemon: cluster-state aggregation + hosted modules.

Re-creation of the reference mgr's architecture (src/mgr/): a daemon
that subscribes to cluster maps through a MonClient, aggregates health
and per-daemon metrics, and hosts MODULES that receive cluster-state
snapshots and act through mon commands (src/mgr/ActivePyModules.cc
giving modules get('osd_map') + mon_command). The prometheus exporter
(mgr/exporter.py) serves this daemon's view over HTTP.

Modules shipped (src/pybind/mgr/ equivalents):
  * balancer — upmap-lite: evens per-OSD PG counts by issuing
    `osd pg-temp` overrides that swap the most-loaded OSD out of a PG's
    acting set for the least-loaded one (the reference's upmap balancer
    optimizes the same objective via pg-upmap-items,
    src/pybind/mgr/balancer/module.py);
  * pg_autoscaler — recommends pg_num per pool from OSD count and pool
    size toward ~100 PGs/OSD (src/pybind/mgr/pg_autoscaler/module.py
    _get_pool_status); report-only, like the autoscaler in warn mode.

Daemon metrics arrive as MMgrReport messages over real sockets: every
daemon (osd, mon, mds, rgw) opens a session (MMgrOpen), ships its
perf-counter schema once, then changed values, plus a daemon_status
blob, health metrics, and progress events (src/mgr/DaemonServer.cc
handle_report -> DaemonStateIndex). The mgr aggregates health metrics
into a digest it ships to the mon (MMonMgrReport), where the health
engine turns them into SLOW_OPS / PG_DEGRADED / OSD_NEARFULL checks.

Idiomatic divergences: modules are plain Python objects ticked by the
mgr loop (no CPython-embedding/Gil machinery needed — the whole daemon
is Python).
"""
from __future__ import annotations

import asyncio
import collections
import time

from ceph_tpu_torch.crush.osdmap import Incremental, OSDMap, PG
from ceph_tpu_torch.mgr.exporter import MetricsExporter
from ceph_tpu_torch.mgr.history import MetricsHistory
from ceph_tpu_torch.mgr.history import bucket_quantile_ms as _bucket_quantile_ms
from ceph_tpu_torch.mon.mon_client import MonClient
from ceph_tpu_torch.msg.messages import (Message, MMgrConfigure, MMgrOpen,
                                   MMgrReport)
from ceph_tpu_torch.msg.messenger import Connection, Dispatcher, Messenger
from ceph_tpu_torch.utils import critpath, flight, tracer
from ceph_tpu_torch.utils.dout import dout
from ceph_tpu_torch.utils.perf_counters import pow2_bucket

import json


class DaemonState:
    """One reporting daemon's aggregated state (src/mgr/DaemonState.h)."""

    __slots__ = ("name", "service", "schema", "counters", "status",
                 "health_metrics", "progress", "device_metrics",
                 "client_metrics", "qos_metrics", "last_report_mono",
                 "reports")

    def __init__(self, name: str, service: str):
        self.name = name
        self.service = service
        self.schema: dict = {}
        self.counters: dict = {}
        self.status: dict = {}
        self.health_metrics: dict = {}
        self.progress: list = []
        self.device_metrics: dict = {}
        self.client_metrics: dict = {}
        self.qos_metrics: dict = {}
        self.last_report_mono = time.monotonic()
        self.reports = 0

    @property
    def age(self) -> float:
        return time.monotonic() - self.last_report_mono


# the ONE bucketing rule lives in mgr/history.py (bucket_quantile_ms),
# imported above under this module's historical name — the client
# aggregate, the digest, and the history window math must all quote
# the same 2^(i+1) µs upper edge


class DaemonStateIndex:
    """name -> DaemonState with staleness eviction
    (src/mgr/DaemonState.h DaemonStateIndex; entries whose reports stop
    are culled so a dead daemon's metrics never linger in /metrics)."""

    STALE_AFTER = 8.0           # seconds without a report before eviction
    #: distinct (pid, boot) flight rings retained; each bounded below.
    #: Rings are NOT culled with their daemon — a post-mortem wants
    #: exactly the events of daemons that stopped reporting — they
    #: rotate out oldest-update-first past this cap.
    MAX_FLIGHT_SOURCES = 64
    #: per-source retained events (>= any daemon's default ring so a
    #: full ring resend survives intact)
    FLIGHT_SOURCE_EVENTS = 1024

    def __init__(self, stale_after: float | None = None):
        self.stale_after = stale_after if stale_after is not None \
            else self.STALE_AFTER
        self.daemons: dict[str, DaemonState] = {}
        # time-resolved sample rings per (daemon, metric), fed from
        # report() at the history cadence
        self.history = MetricsHistory()
        # flight-recorder fan-in: {(pid, boot): {"events": [...],
        # "mono_now", "wall_now", "max_seq", "updated_mono"}} — one
        # entry per reporting OS process, deduped by seq (co-located
        # daemons ship the same process ring)
        self.flight_sources: dict[tuple, dict] = {}
        # cross-process trace assembly (tracing v2): spans shipped on
        # the report leg keyed by trace_id, (pid, boot, seq)-deduped
        self.traces = TraceIndex()

    def open(self, name: str, service: str) -> DaemonState:
        st = self.daemons.get(name)
        if st is None or st.service != service:
            st = self.daemons[name] = DaemonState(name, service)
        else:
            # a re-opened session (daemon restart) restarts the
            # staleness clock: the entry must not be culled in the gap
            # between MMgrOpen and the first MMgrReport
            st.last_report_mono = time.monotonic()
        return st

    def report(self, payload: dict) -> DaemonState:
        name = payload.get("daemon_name", "?")
        st = self.open(name, payload.get("service", "?"))
        schema = payload.get("schema")
        if schema is not None:
            # a schema resend means a fresh session (or a restarted
            # daemon re-registering): stored values are stale
            st.schema = schema
            st.counters = {}
        # deltas: only changed keys travel; merge into the stored copy
        st.counters.update(payload.get("counters") or {})
        st.status = payload.get("daemon_status") or {}
        st.health_metrics = payload.get("health_metrics") or {}
        st.progress = payload.get("progress") or []
        dm = payload.get("device_metrics")
        st.device_metrics = dm if isinstance(dm, dict) else {}
        cm = payload.get("client_metrics")
        st.client_metrics = cm if isinstance(cm, dict) else {}
        qm = payload.get("qos_metrics")
        st.qos_metrics = qm if isinstance(qm, dict) else {}
        st.last_report_mono = time.monotonic()
        st.reports += 1
        # time-resolved leg: sample the MERGED counter state at the
        # history cadence (maybe_sample also notices a counter moving
        # backwards — a daemon-side perf reset — and drops that
        # daemon's stale buckets)
        self.history.maybe_sample(name, st.counters, st.schema)
        ev = payload.get("events")
        if isinstance(ev, dict):
            self.ingest_events(ev)
        ts = payload.get("trace_spans")
        if isinstance(ts, dict):
            self.traces.ingest(ts)
        return st

    def ingest_events(self, ring: dict) -> int:
        """Merge one shipped flight-ring tail into its (pid, boot)
        source entry; returns the number of NEW events stored."""
        try:
            pid = int(ring.get("pid") or 0)
            boot = str(ring.get("boot") or pid)
            mono_now = float(ring["mono_now"])
            wall_now = float(ring["wall_now"])
        except (KeyError, TypeError, ValueError):
            return 0
        src = self.flight_sources.get((pid, boot))
        if src is None:
            src = self.flight_sources[(pid, boot)] = {
                "pid": pid, "boot": boot, "events": [],
                "mono_now": mono_now, "wall_now": wall_now,
                "max_seq": 0, "updated_mono": time.monotonic()}
        # anchors refresh every report: the merge offset should come
        # from the freshest dump-time clock pair
        src["mono_now"], src["wall_now"] = mono_now, wall_now
        src["updated_mono"] = time.monotonic()
        added = 0
        for e in ring.get("events") or []:
            if not isinstance(e, dict):
                continue
            seq = e.get("seq")
            if not isinstance(seq, int) or seq <= src["max_seq"]:
                continue        # dup from a co-located daemon's report
            src["events"].append(e)
            src["max_seq"] = seq
            added += 1
        del src["events"][:-self.FLIGHT_SOURCE_EVENTS]
        # rotate whole sources past the cap, oldest update first
        while len(self.flight_sources) > self.MAX_FLIGHT_SOURCES:
            oldest = min(self.flight_sources,
                         key=lambda k:
                         self.flight_sources[k]["updated_mono"])
            del self.flight_sources[oldest]
        return added

    def flight_rings(self) -> list[dict]:
        """Stored rings, shaped like flight.dump() output — the
        merge_timelines input."""
        return [{"pid": src["pid"], "boot": src["boot"],
                 "mono_now": src["mono_now"],
                 "wall_now": src["wall_now"],
                 "events": list(src["events"])}
                for src in self.flight_sources.values()]

    def cull(self) -> list[str]:
        """Evict daemons whose reports stopped; returns evicted names."""
        evicted = [name for name, st in self.daemons.items()
                   if st.age > self.stale_after]
        for name in evicted:
            del self.daemons[name]
            # its sample rings go with it (the flight ring does NOT:
            # events are the post-mortem record of exactly such deaths)
            self.history.drop(name)
        return evicted

    def render_sources(self) -> list[tuple[str, dict, dict]]:
        """(daemon, schema, counters) triples for the exporter."""
        return [(name, st.schema, st.counters)
                for name, st in sorted(self.daemons.items())]

    def device_sources(self) -> list[tuple[str, dict]]:
        """(daemon, {device: {counter: value}}) pairs for the exporter's
        ceph_device-labeled families."""
        return [(name, st.device_metrics)
                for name, st in sorted(self.daemons.items())
                if st.device_metrics]

    def client_sources(self) -> list[tuple[str, dict]]:
        """(daemon, {client: tallies}) pairs — one per reporting OSD."""
        return [(name, st.client_metrics)
                for name, st in sorted(self.daemons.items())
                if st.client_metrics]

    def qos_sources(self) -> list[tuple[str, dict]]:
        """(daemon, {tenant: qos ledger}) pairs — one per reporting
        OSD running the dmclock scheduler."""
        return [(name, st.qos_metrics)
                for name, st in sorted(self.daemons.items())
                if st.qos_metrics]

    #: numeric per-tenant QoS fields summed in the cross-OSD merge
    _QOS_SUM_FIELDS = ("shed", "deferred", "dequeue_reservation",
                       "dequeue_weight", "queued", "cost")

    def qos_aggregate(self) -> dict[str, dict]:
        """Cross-OSD merge per tenant: a tenant's ops spread over every
        primary it touches, so its cluster-wide shed/deferred/dequeue
        ledger is the SUM of each OSD's."""
        agg: dict[str, dict] = {}
        for _daemon, qm in self.qos_sources():
            for tenant, d in qm.items():
                if not isinstance(d, dict):
                    continue
                e = agg.setdefault(str(tenant),
                                   {f: 0 for f in self._QOS_SUM_FIELDS})
                for f in self._QOS_SUM_FIELDS:
                    v = d.get(f)
                    if isinstance(v, (int, float)) and \
                            not isinstance(v, bool):
                        e[f] += v
        return agg

    #: numeric per-pool scrub fields summed in the cross-OSD merge
    _SCRUB_SUM_FIELDS = ("objects_scrubbed", "bytes_hashed",
                         "errors_found", "errors_repaired",
                         "inconsistent", "unrepaired")

    def scrub_aggregate(self) -> dict[str, dict]:
        """Cross-OSD merge per pool: a pool's PGs spread their primaries
        over the cluster, so its scrub ledger (objects/bytes scanned,
        errors found/repaired, inconsistent registry counts) is the SUM
        of each reporting OSD's per-pool table; the freshness ages are
        the cluster-wide WORST (max)."""
        agg: dict[str, dict] = {}
        for _name, st in sorted(self.daemons.items()):
            sc = (st.health_metrics or {}).get("scrub") or {}
            for pool, d in (sc.get("pools") or {}).items():
                if not isinstance(d, dict):
                    continue
                e = agg.setdefault(str(pool), dict.fromkeys(
                    self._SCRUB_SUM_FIELDS, 0))
                for f in self._SCRUB_SUM_FIELDS:
                    v = d.get(f)
                    if isinstance(v, (int, float)) and \
                            not isinstance(v, bool):
                        e[f] += v
                for f in ("last_scrub_age_s", "last_deep_scrub_age_s"):
                    v = d.get(f)
                    if isinstance(v, (int, float)) and v >= 0:
                        e[f] = max(e.get(f, -1.0), v)
        return agg

    #: numeric per-client fields summed in the cross-OSD merge
    _CLIENT_SUM_FIELDS = ("ops", "read_ops", "write_ops", "read_bytes",
                          "written_bytes", "in_flight", "slo_good",
                          "slo_violations")

    def client_aggregate(self) -> dict[str, dict]:
        """Cross-OSD merge per client: a client's ops land on every
        primary it talks to, so its cluster-wide ledger is the SUM of
        each OSD's tallies, and its latency distribution is the merged
        histogram (power-of-two µs buckets add bucket-wise). p99 comes
        from the merged buckets — an honest cluster-wide percentile,
        not a max-of-maxes."""
        agg: dict[str, dict] = {}
        for _daemon, cm in self.client_sources():
            for client, d in cm.items():
                if not isinstance(d, dict):
                    continue
                e = agg.setdefault(str(client), {
                    "tenant": None,
                    **{f: 0 for f in self._CLIENT_SUM_FIELDS},
                    "read_buckets": {}, "write_buckets": {}})
                if d.get("tenant") and not e["tenant"]:
                    e["tenant"] = str(d["tenant"])
                for f in self._CLIENT_SUM_FIELDS:
                    v = d.get(f)
                    if isinstance(v, (int, float)) and \
                            not isinstance(v, bool):
                        e[f] += v
                for side in ("read_buckets", "write_buckets"):
                    for b, n in (d.get(side) or {}).items():
                        try:
                            b, n = int(b), int(n)
                        except (TypeError, ValueError):
                            continue
                        e[side][b] = e[side].get(b, 0) + n
        for e in agg.values():
            e["read_lat_p99_ms"] = _bucket_quantile_ms(
                e.pop("read_buckets"), 0.99)
            e["write_lat_p99_ms"] = _bucket_quantile_ms(
                e.pop("write_buckets"), 0.99)
        return agg

    def report_ages(self) -> dict[str, float]:
        return {name: round(st.age, 3)
                for name, st in sorted(self.daemons.items())}

    def progress_events(self) -> list[dict]:
        out = []
        for name, st in sorted(self.daemons.items()):
            for ev in st.progress:
                out.append(dict(ev, daemon=name))
        return out

    def summary(self) -> dict:
        return {name: {"service": st.service, "age_s": round(st.age, 2),
                       "reports": st.reports,
                       "num_counters": len(st.counters)}
                for name, st in sorted(self.daemons.items())}


class TraceIndex:
    """Cluster-wide trace assembly (tracing v2).

    Spans shipped on the MMgrReport leg — each envelope stamped with
    the sending process's (pid, boot) and a per-process monotonic seq —
    are keyed here by trace_id. Co-located daemons ship the same
    process collector, so ingest dedups on (pid, boot, seq) exactly
    like the flight-ring fan-in. Span *links* (an offload batch span
    linking every rider op's trace) are indexed in reverse so
    assembling a rider's trace pulls the shared batch span in.

    Attribution: once a trace goes quiet (`SETTLE_S` without new
    spans), its critical path is computed ONCE and banked into
    per-(op_class, stage) and per-(client, stage) power-of-two
    histograms — the `ceph_trace_critical_path_us` export. Stragglers
    arriving later still show in `trace get`, but never double-bank."""

    MAX_TRACES = 512            # mgr_max_traces overrides
    MAX_SPANS_PER_TRACE = 256
    SETTLE_S = 0.5              # quiet time before a trace attributes
    HIST_BUCKETS = 40           # pow2 µs buckets (2^40 us ≈ 13 days)

    def __init__(self, max_traces: int | None = None):
        self.max_traces = max_traces or self.MAX_TRACES
        #: trace_id -> {"spans": [dict], "ids": {(boot, seq)},
        #:  "updated": mono, "cp": dict|None, "banked": bool}
        self.traces: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        #: (pid, boot) -> max seq ingested (the dedup cursor)
        self.sources: dict[tuple, int] = {}
        #: target trace_id -> spans (owned by OTHER traces) linking it
        self.link_map: dict[str, list[dict]] = {}
        #: (op_class, stage) / (client, stage) -> pow2 histogram
        self.class_hists: dict[tuple, dict] = {}
        self.client_hists: dict[tuple, dict] = {}
        #: op_class -> slowest settled trace (exporter exemplars)
        self.exemplars: dict[str, dict] = {}
        self.banked_traces = 0

    def configure(self, max_traces: int | None = None) -> None:
        if max_traces:
            self.max_traces = max(int(max_traces), 4)
            self._evict()

    def _evict(self) -> None:
        while len(self.traces) > self.max_traces:
            tid, _ = self.traces.popitem(last=False)
            self.link_map.pop(tid, None)

    def ingest(self, envelope: dict) -> int:
        """Merge one shipped span batch; returns NEW spans stored."""
        try:
            pid = int(envelope.get("pid") or 0)
            boot = str(envelope.get("boot") or pid)
            spans = envelope.get("spans") or []
        except (TypeError, ValueError):
            return 0
        src = (pid, boot)
        max_seq = self.sources.get(src, 0)
        added = 0
        now = time.monotonic()
        for s in spans:
            if not isinstance(s, dict):
                continue
            seq = s.get("seq")
            if not isinstance(seq, int) or seq <= max_seq:
                continue        # dup from a co-located daemon's report
            max_seq = seq
            tid = s.get("trace_id")
            if not tid:
                continue
            s = dict(s, pid=pid, boot=boot)
            e = self.traces.get(tid)
            if e is None:
                e = self.traces[tid] = {"spans": [], "ids": set(),
                                        "updated": now, "cp": None,
                                        "banked": False}
            else:
                self.traces.move_to_end(tid)
            key = (boot, seq)
            if key in e["ids"]:
                continue
            e["ids"].add(key)
            e["spans"].append(s)
            del e["spans"][:-self.MAX_SPANS_PER_TRACE]
            e["updated"] = now
            e["cp"] = None      # re-render on next access
            added += 1
            for l in s.get("links") or ():
                lt = l.get("trace_id")
                if lt and lt != tid:
                    self.link_map.setdefault(lt, []).append(s)
        self.sources[src] = max_seq
        self._evict()
        return added

    def assembled(self, trace_id: str) -> list[dict]:
        """All spans of one trace: its own plus spans from other
        traces that LINK it (deduped by span identity)."""
        e = self.traces.get(trace_id)
        own = list(e["spans"]) if e else []
        seen = {s.get("span_id") for s in own}
        for s in self.link_map.get(trace_id, ()):
            if s.get("span_id") not in seen:
                seen.add(s.get("span_id"))
                own.append(s)
        return own

    def _hist_add(self, hists: dict, key: tuple, us: float) -> None:
        h = hists.get(key)
        if h is None:
            h = hists[key] = {"buckets": [0] * self.HIST_BUCKETS,
                              "sum": 0.0, "count": 0}
        if us > 0.0:
            b = min(pow2_bucket(us), self.HIST_BUCKETS - 1)
            h["buckets"][b] += 1
        h["sum"] += us
        h["count"] += 1

    def settle(self) -> int:
        """Bank critical-path attribution for traces that went quiet;
        idempotent per trace. Returns traces banked this call."""
        now = time.monotonic()
        banked = 0
        for tid, e in list(self.traces.items()):
            if e["banked"] or now - e["updated"] < self.SETTLE_S:
                continue
            cp = self.critical_path(tid)
            if cp is None or cp["total_us"] <= 0.0:
                continue
            e["banked"] = True
            self.banked_traces += 1
            banked += 1
            for stage, us in cp["stages"].items():
                self._hist_add(self.class_hists,
                               (cp["op_class"], stage), us)
                if cp["client"]:
                    self._hist_add(self.client_hists,
                                   (cp["client"], stage), us)
            ex = self.exemplars.get(cp["op_class"])
            if ex is None or cp["total_us"] >= ex["total_us"]:
                self.exemplars[cp["op_class"]] = {
                    "trace_id": tid, "total_us": cp["total_us"],
                    "top_stage": cp["top_stage"]}
        return banked

    def critical_path(self, trace_id: str) -> dict | None:
        """Cached per-trace attribution (recomputed after new spans)."""
        e = self.traces.get(trace_id)
        if e is None:
            return None
        if e["cp"] is None:
            e["cp"] = critpath.critical_path(self.assembled(trace_id))
        return e["cp"]

    def get(self, trace_id: str) -> dict | None:
        """`trace get <id>`: the assembled multi-process waterfall."""
        spans = self.assembled(trace_id)
        if not spans:
            return None
        cp = self.critical_path(trace_id)
        return {"trace_id": trace_id,
                "num_spans": len(spans),
                "processes": sorted({f"{s.get('pid')}:{s.get('boot')}"
                                     for s in spans}),
                "critical_path": cp,
                "waterfall": critpath.waterfall(spans)}

    def slowest(self, n: int = 10,
                op_class: str | None = None) -> list[dict]:
        """`trace slowest [n] [--class]`: settled traces by root
        total, the dashboard table feed."""
        self.settle()
        out = []
        for tid in self.traces:
            cp = self.critical_path(tid)
            if cp is None or cp["total_us"] <= 0.0:
                continue
            if op_class and cp["op_class"] != op_class:
                continue
            out.append({"trace_id": tid, "total_us": cp["total_us"],
                        "op_class": cp["op_class"],
                        "client": cp["client"],
                        "top_stage": cp["top_stage"],
                        "stages": cp["stages"]})
        out.sort(key=lambda t: -t["total_us"])
        return out[:max(n, 1)]

    def status(self) -> dict:
        return {"traces": len(self.traces),
                "sources": len(self.sources),
                "banked": self.banked_traces,
                "max_traces": self.max_traces}


class MgrModule:
    """Module contract: tick(mgr) runs every mgr interval."""

    NAME = "module"

    async def tick(self, mgr: "MgrDaemon") -> None:
        raise NotImplementedError

    def status(self) -> dict:
        return {}


class MgrDaemon(Dispatcher):

    TICK_INTERVAL = 1.0
    REPORT_PERIOD = 1.0         # handed to daemons via MMgrConfigure
    NEARFULL_RATIO = 0.85       # mon_osd_nearfull_ratio analog
    FULL_RATIO = 0.95           # mon_osd_full_ratio analog
    # an inter-OSD wait this old is suspect even without a visible
    # cycle (the other half may sit on a daemon that is not reporting)
    DEADLOCK_EDGE_AGE_S = 15.0

    def __init__(self, mon_addrs, modules: list[MgrModule] | None = None,
                 auth_key: bytes | None = None,
                 exporter_port: int | None = 0,
                 name: str = "x", config=None,
                 admin_socket_path: str | None = None):
        self.name = name
        from ceph_tpu_torch.utils.config import Config, ConfigError, Option
        # mgr-side knobs (hot: the exporter re-reads per scrape, the
        # history observer below reconfigures the live store)
        history_opts = [
            Option("mgr_history_slots", "int",
                   MetricsHistory.DEFAULT_SLOTS,
                   "samples retained per (daemon, metric) history "
                   "ring; with the interval this is the lookback "
                   "window, and it is the per-series memory bound",
                   minimum=2),
            Option("mgr_history_interval_s", "float",
                   MetricsHistory.DEFAULT_INTERVAL_S,
                   "minimum seconds between history samples of one "
                   "daemon's merged counter state"),
            Option("mgr_history_max_series", "int",
                   MetricsHistory.DEFAULT_MAX_SERIES,
                   "total (daemon, metric) history series cap — the "
                   "global memory bound; overflow series are counted "
                   "and skipped", minimum=1),
            Option("mgr_max_traces", "int", TraceIndex.MAX_TRACES,
                   "assembled traces retained in the TraceIndex "
                   "(LRU past the cap — the trace-assembly memory "
                   "bound)", minimum=4)]
        self.config = config if config is not None else Config([
            Option("mgr_max_client_series", "int", 64,
                   "cap on distinct ceph_client label values in "
                   "/metrics; overflow folds into ceph_client=\"_other\" "
                   "so a many-client swarm cannot explode the scrape",
                   minimum=2)])
        for opt in history_opts:
            try:
                self.config.declare(opt)
            except ConfigError:
                pass            # caller-supplied config already has it
        self.messenger = Messenger(f"mgr.{name}", auth_key=auth_key)
        self.messenger.add_dispatcher(self)
        self.monc = MonClient(self.messenger, mon_addrs)
        self.monc.on_osdmap = self._on_osdmap
        self.osdmap = OSDMap()
        self.modules = modules if modules is not None else \
            [BalancerModule(), PGAutoscalerModule()]
        self.health: dict = {}
        self.daemon_index = DaemonStateIndex()
        self.daemon_index.history.configure(
            slots=self.config.get("mgr_history_slots"),
            interval_s=self.config.get("mgr_history_interval_s"),
            max_series=self.config.get("mgr_history_max_series"))

        def _on_history_knob(name: str, value) -> None:
            key = name[len("mgr_history_"):]
            self.daemon_index.history.configure(**{
                {"slots": "slots", "interval_s": "interval_s",
                 "max_series": "max_series"}[key]: value})
        self.config.add_observer(
            ("mgr_history_slots", "mgr_history_interval_s",
             "mgr_history_max_series"), _on_history_knob)
        self.daemon_index.traces.configure(
            max_traces=self.config.get("mgr_max_traces"))
        self.config.add_observer(
            ("mgr_max_traces",),
            lambda _n, v: self.daemon_index.traces.configure(
                max_traces=v))
        self.asok = None
        if admin_socket_path:
            from ceph_tpu_torch.utils.admin_socket import AdminSocket
            self.asok = AdminSocket(admin_socket_path,
                                    config=self.config)
            self.asok.register_command(
                "perf history",
                lambda req: self.perf_history(
                    req.get("metric"), daemon=req.get("daemon"),
                    window_s=float(req.get("window", 60.0))),
                "windowed math over the metrics-history rings: "
                "metric=<name> [daemon=] [window=seconds]; omit "
                "metric to list recorded metric names")
            self.asok.register_command(
                "timeline dump",
                lambda req: self.timeline_dump(),
                "causally-ordered cluster timeline: every reporting "
                "process's flight ring merged with the mgr's own")
            self.asok.register_command(
                "history status",
                lambda req: self.daemon_index.history.status(),
                "metrics-history store: series/caps/resets")
            self.asok.register_command(
                "trace get",
                lambda req: self.trace_get(req.get("id", "")),
                "one assembled multi-process trace: id=<trace_id> -> "
                "waterfall + critical-path stage attribution")
            self.asok.register_command(
                "trace slowest",
                lambda req: self.trace_slowest(
                    int(req.get("n", 10)), req.get("class")),
                "slowest assembled traces: [n=10] [class=<op class>]")
            self.asok.register_command(
                "deadlock status",
                lambda req: self.deadlock_status(),
                "cross-daemon wait-for graph assembled from the "
                "per-OSD lockdep wait annotations: long-parked waits, "
                "inter-OSD edges, cycles, over-age edges — the "
                "DEADLOCK_SUSPECTED inputs")
        self.addr: tuple[str, int] | None = None
        # True while the mgrmap names us active; standbys keep their
        # (empty) digest to themselves so they can never overwrite the
        # active mgr's digest at the mon
        self.is_active = False
        self._tick_task: asyncio.Task | None = None
        self._beacon_task: asyncio.Task | None = None
        self.exporter: MetricsExporter | None = None
        self._exporter_port = exporter_port

    async def start(self) -> None:
        self.addr = await self.messenger.bind("127.0.0.1", 0)
        await self.monc.start()
        self.monc.subscribe("osdmap", 1)
        if self._exporter_port is not None:
            async def health_cb() -> dict:
                return self.health

            async def status_cb() -> dict:
                try:
                    status = await self.mon_command({"prefix": "status"})
                except Exception:
                    status = {}
                try:
                    status["modules"] = self.module_status()
                except Exception as e:
                    status["modules"] = {"error": str(e)}
                status["daemon_reports"] = self.daemon_index.summary()
                status["progress_events"] = \
                    self.daemon_index.progress_events()
                # top clients for the dashboard table (cross-OSD merge)
                agg = self.daemon_index.client_aggregate()
                status["client_table"] = dict(sorted(
                    agg.items(),
                    key=lambda kv: -kv[1].get("ops", 0))[:15])
                # per-pool integrity ledger for the dashboard scrub row
                status["scrub_table"] = \
                    self.daemon_index.scrub_aggregate()
                # dashboard sparkline feed: the most recently moving
                # history series (windowed p99 for histograms, rates
                # for counters), rendered as unicode microcharts
                status["history_sparklines"] = \
                    self.daemon_index.history.sparkline_data()
                # slowest assembled traces (tracing v2) with their
                # critical-path top stage for the dashboard table
                try:
                    self._ingest_local_traces()
                    status["slow_traces"] = \
                        self.daemon_index.traces.slowest(10)
                except Exception:
                    status["slow_traces"] = []
                return status
            self.exporter = MetricsExporter(
                port=self._exporter_port, health_cb=health_cb,
                status_cb=status_cb, index=self.daemon_index,
                max_client_series=lambda: self.config.get(
                    "mgr_max_client_series"))
            await self.exporter.start()
        self._tick_task = asyncio.get_running_loop().create_task(
            self._tick_loop())
        self._beacon_task = asyncio.get_running_loop().create_task(
            self._beacon_loop())
        if self.asok is not None:
            self.asok.start()
        dout("mgr", 1, "mgr up "
             + (f"(metrics on {self.exporter.addr})"
                if self.exporter else "(no exporter)"))

    async def stop(self) -> None:
        from ceph_tpu_torch.utils.async_util import reap
        for attr in ("_tick_task", "_beacon_task"):
            await reap(getattr(self, attr))
            setattr(self, attr, None)
        if self.asok is not None:
            self.asok.stop()
        if self.exporter is not None:
            await self.exporter.stop()
        await self.monc.close()
        await self.messenger.shutdown()

    # -- time-resolved observability (the flight/history query plane) --------

    def perf_history(self, metric: str | None, daemon: str | None = None,
                     window_s: float = 60.0) -> dict:
        """`perf history <metric> [--daemon] [--window]`: windowed math
        over the sample rings. Without a metric, lists what the store
        has recorded."""
        hist = self.daemon_index.history
        if not metric:
            return {"metrics": hist.metrics(daemon),
                    "daemons": hist.daemons(),
                    "status": hist.status()}
        return hist.query(metric, daemon=daemon, window_s=window_s)

    def timeline_dump(self, extra_rings: list[dict] | None = None,
                      window_s: float | None = None) -> dict:
        """The merged cluster timeline: every reporting process's
        shipped flight ring + the mgr's own process ring (+ any rings
        the caller fetched itself, e.g. over a ProcShardPool control
        channel), causally ordered by estimated time. A failure storm
        reads as one interleaved story across OS processes."""
        rings = self.daemon_index.flight_rings()
        rings.append(flight.dump())
        if extra_rings:
            rings.extend(extra_rings)
        events = flight.merge_timelines(rings)
        if window_s is not None and events:
            horizon = events[-1]["t_est"] - window_s
            events = [e for e in events if e["t_est"] >= horizon]
        return {"events": events,
                "processes": sorted({e["boot"] for e in events}),
                "sources": len(rings)}

    def _ingest_local_traces(self) -> None:
        """Fold the mgr's OWN process span collector into the index:
        a co-located client's rados_op root (or a mon/mgr span) has no
        MgrClient leg of its own, yet belongs in the assembly. The
        TraceIndex (pid, boot, seq) cursor makes the repeated full
        export idempotent."""
        try:
            self.daemon_index.traces.ingest(
                tracer.collector().export_since(0, limit=1 << 14))
        except Exception:
            pass

    def trace_get(self, trace_id: str) -> dict:
        """`trace get <id>`: one assembled multi-process waterfall."""
        self._ingest_local_traces()
        got = self.daemon_index.traces.get(str(trace_id))
        if got is None:
            return {"error": f"trace {trace_id!r} not assembled",
                    "index": self.daemon_index.traces.status()}
        return got

    def trace_slowest(self, n: int = 10,
                      op_class: str | None = None) -> dict:
        """`trace slowest [n] [--class]`: settled traces by duration."""
        self._ingest_local_traces()
        return {"traces": self.daemon_index.traces.slowest(n, op_class),
                "index": self.daemon_index.traces.status()}

    def _on_osdmap(self, payload: dict) -> None:
        from ceph_tpu_torch.crush.osdmap import apply_map_payload
        apply_map_payload(self.osdmap, payload)
        self.monc.sub_got("osdmap", self.osdmap.epoch)

    async def mon_command(self, cmd: dict) -> dict:
        return await self.monc.command(cmd, timeout=15.0)

    # -- report fan-in (DaemonServer.cc handle_open/handle_report) -----------

    async def ms_dispatch(self, conn: Connection, msg: Message) -> bool:
        if isinstance(msg, MMgrOpen):
            p = msg.payload
            self.daemon_index.open(p.get("daemon_name", "?"),
                                   p.get("service", "?"))
            conn.send_message(MMgrConfigure({"period": self.REPORT_PERIOD}))
            return True
        if isinstance(msg, MMgrReport):
            self.daemon_index.report(msg.payload)
            return True
        return False

    async def _beacon_loop(self) -> None:
        """Beacons ride their own task so the mgrmap liveness signal can
        never be starved by a slow health poll or module tick (the mon
        drops the active mgr after BEACON_GRACE without one). The reply
        names the active mgr — standby semantics key off it."""
        while True:
            try:
                out = await self.monc.command(
                    {"prefix": "mgr beacon", "name": self.name,
                     "addr": list(self.addr) if self.addr else None},
                    timeout=3.0)
                self.is_active = out.get("active_name") == self.name
            except Exception as e:
                dout("mgr", 4, f"mgr beacon failed: "
                               f"{type(e).__name__} {e}")
            await asyncio.sleep(self.TICK_INTERVAL)

    async def _tick_loop(self) -> None:
        while True:
            for name in self.daemon_index.cull():
                if not self.is_active:
                    continue
                dout("mgr", 2, f"mgr: daemon {name} stopped reporting; "
                               f"evicted")
                try:
                    await self.monc.send_log(
                        "WRN", f"mgr.{self.name}",
                        f"daemon {name} stopped reporting; evicted from "
                        f"the daemon index")
                except Exception:
                    pass
            if self.is_active:
                # standbys hold no daemon sessions: an empty digest from
                # one must never clobber the active mgr's at the mon
                try:
                    await self.monc.send_mgr_report(self._build_digest())
                except Exception as e:
                    dout("mgr", 4, f"mgr digest send failed: "
                                   f"{type(e).__name__} {e}")
            try:
                self.health = await self.mon_command({"prefix": "health"})
            except Exception as e:
                dout("mgr", 4, f"mgr health poll failed: "
                               f"{type(e).__name__} {e}")
            for mod in self.modules:
                try:
                    await mod.tick(self)
                except Exception as e:
                    dout("mgr", 2, f"mgr module {mod.NAME} failed: "
                                   f"{type(e).__name__} {e}")
                    from ceph_tpu_torch.utils import crash
                    crash.record(f"mgr.{self.name}", e)
            await asyncio.sleep(self.TICK_INTERVAL)

    def _build_digest(self) -> dict:
        """Aggregate daemon health metrics into the health-check digest
        the mon merges (MMonMgrReport; the reference mgr computes
        SLOW_OPS and fullness checks the same way in DaemonServer.cc
        send_report)."""
        checks: dict[str, dict] = {}
        slow_total, slow_oldest, slow_detail = 0, 0.0, []
        degraded, undersized = [], []
        nearfull, full = [], []
        offload_degraded = []
        crashed = []
        # scrub integrity surface: registry-backed, so the checks raise
        # at detection and clear after the next verified-clean round
        scrub_err = []          # (daemon, inconsistent, unrepaired)
        damaged_pgs = 0
        # long-parked lock/grant waits from every reporting daemon:
        # the cross-daemon wait-for graph's raw rows
        deadlock_rows: list[dict] = []
        # per-client SLO surface (OpTracker ClientTable health metrics)
        slo_total = 0
        slo_clients: dict[str, int] = {}
        slow_clients: dict[str, dict] = {}
        # the mgr's own crash records never travel a report session
        # (it does not report to itself): consult the local registry so
        # a crash-looping mgr module raises RECENT_CRASH too
        from ceph_tpu_torch.utils import crash as crash_mod
        own = len(crash_mod.recent(f"mgr.{self.name}"))
        if own:
            crashed.append((f"mgr.{self.name}", own))
        for name, st in sorted(self.daemon_index.daemons.items()):
            hm = st.health_metrics or {}
            if hm.get("recent_crashes"):
                crashed.append((name, int(hm["recent_crashes"])))
            n = int(hm.get("slow_ops") or 0)
            if n:
                slow_total += n
                slow_oldest = max(slow_oldest,
                                  float(hm.get("slow_ops_oldest_age_s")
                                        or 0.0))
                slow_detail.append(f"{name} has {n} slow ops")
            if hm.get("degraded_pgs"):
                degraded.append((name, int(hm["degraded_pgs"])))
            if hm.get("undersized_pgs"):
                undersized.append((name, int(hm["undersized_pgs"])))
            off = hm.get("offload") or {}
            if off.get("degraded"):
                offload_degraded.append(
                    (name, off.get("last_error") or "device error"))
            cl = hm.get("clients") or {}
            if cl.get("recent_violations"):
                slo_total += int(cl["recent_violations"])
                for v in cl.get("violating_clients") or []:
                    c = str(v.get("client", "?"))
                    slo_clients[c] = slo_clients.get(c, 0) \
                        + int(v.get("recent") or 0)
            for s in cl.get("slow_clients") or []:
                c = str(s.get("client", "?"))
                # a client slow on ANY osd is slow; keep its worst p99
                cur = slow_clients.get(c)
                if cur is None or float(s.get("p99_ms") or 0.0) \
                        > float(cur.get("p99_ms") or 0.0):
                    slow_clients[c] = dict(s, osd=name)
            for r in hm.get("deadlock") or []:
                deadlock_rows.append(dict(r, daemon=name))
            sc = hm.get("scrub") or {}
            if sc.get("inconsistent_objects"):
                scrub_err.append((name,
                                  int(sc["inconsistent_objects"]),
                                  int(sc.get("unrepaired_objects") or 0)))
            damaged_pgs += int(sc.get("inconsistent_pgs") or 0)
            store = hm.get("store") or {}
            util = float(store.get("utilization") or 0.0)
            if util >= self.FULL_RATIO:
                full.append((name, util))
            elif util >= self.NEARFULL_RATIO:
                nearfull.append((name, util))
        if slow_total:
            checks["SLOW_OPS"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{slow_total} slow ops, oldest one blocked "
                           f"for {slow_oldest:.1f} sec",
                "detail": slow_detail}
        if degraded:
            # primaries report their own PGs, so daemon counts sum
            # without double counting
            checks["PG_DEGRADED"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{sum(n for _, n in degraded)} pgs degraded",
                "detail": [f"{d}: {n} pgs degraded" for d, n in degraded]}
        if undersized:
            checks["PG_UNDERSIZED"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{sum(n for _, n in undersized)} pgs "
                           f"undersized",
                "detail": [f"{d}: {n} pgs undersized"
                           for d, n in undersized]}
        if nearfull:
            checks["OSD_NEARFULL"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(nearfull)} osds near full",
                "detail": [f"{d} is {u:.0%} full" for d, u in nearfull]}
        if full:
            checks["OSD_FULL"] = {
                "severity": "HEALTH_ERR",
                "summary": f"{len(full)} osds full",
                "detail": [f"{d} is {u:.0%} full" for d, u in full]}
        if crashed:
            # unarchived crash records (the reference crash module's
            # RECENT_CRASH): `crash archive` over the daemon's admin
            # socket acknowledges them and clears the check
            checks["RECENT_CRASH"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{sum(n for _, n in crashed)} recent "
                           f"crash records on {len(crashed)} daemons "
                           f"(crash ls / crash archive)",
                "detail": [f"{d}: {n} unarchived crash records"
                           for d, n in crashed]}
        if slo_total:
            # recent (windowed) violations only: the check clears by
            # itself once the overload that caused them ends
            worst = sorted(slo_clients.items(), key=lambda kv: -kv[1])
            checks["SLO_VIOLATIONS"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{slo_total} client SLO violations in the "
                           f"last 30s across {len(slo_clients)} "
                           f"clients (slo_read_ms/slo_write_ms)",
                "detail": [f"{c}: {n} recent violations"
                           for c, n in worst[:10]]}
        if slow_clients:
            # a client whose rolling p99 sits FAR beyond the SLO is a
            # tail-latency outlier even when total violations are few —
            # the starved-tenant signal a QoS scheduler must fix
            checks["SLOW_CLIENT"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(slow_clients)} clients with p99 far "
                           f"over SLO",
                "detail": [f"{c}: {s.get('kind')} p99 "
                           f"{s.get('p99_ms')}ms vs slo "
                           f"{s.get('slo_ms')}ms on {s.get('osd')}"
                           for c, s in sorted(slow_clients.items())]}
        if scrub_err:
            # scrub found copies/shards disagreeing with their peers:
            # data damage until a clean round retires the registry
            # entries (primaries report their own PGs — counts sum)
            total = sum(n for _, n, _ in scrub_err)
            unrep = sum(u for _, _, u in scrub_err)
            checks["OSD_SCRUB_ERRORS"] = {
                "severity": "HEALTH_ERR",
                "summary": f"{total} scrub errors"
                           + (f" ({unrep} unrepaired)" if unrep else ""),
                "detail": [f"{d}: {n} inconsistent objects"
                           + (f", {u} unrepaired" if u else "")
                           for d, n, u in scrub_err]}
            checks["PG_DAMAGED"] = {
                "severity": "HEALTH_ERR",
                "summary": f"Possible data damage: {damaged_pgs} pg"
                           f"{'s' if damaged_pgs != 1 else ''} "
                           f"inconsistent",
                "detail": [f"{d}: {n} objects in the inconsistent "
                           f"registry (list-inconsistent-obj)"
                           for d, n, _ in scrub_err]}
        # class-qualified: the digest must stay computable when driven
        # unbound against a bare daemon-state stub (no mgr methods)
        dl = MgrDaemon._assemble_deadlock(self, deadlock_rows)
        if dl["cycles"] or dl["over_age_edges"]:
            # suspicion, not proof: the check clears by itself once the
            # abort path (reservation timeout) drains the annotations
            detail = []
            for cyc in dl["cycles"]:
                detail.append("cycle: " + " -> ".join(cyc))
            for e in dl["over_age_edges"]:
                detail.append(f"{e['waiter']} waiting "
                              f"{e['age_s']:.1f}s on {e['resource']} "
                              f"held by {e['holder']} "
                              f"(task {e['task']}, tid {e['tid']})")
            checks["DEADLOCK_SUSPECTED"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(dl['cycles'])} wait-for cycles, "
                           f"{len(dl['over_age_edges'])} over-age "
                           f"inter-OSD waits (deadlock status)",
                "detail": detail}
        if offload_degraded:
            # the EC data path still serves (host-codec fallback is
            # bit-identical) but at host speed: warn, don't err
            checks["TPU_OFFLOAD_DEGRADED"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(offload_degraded)} daemons running EC "
                           f"on the host-codec fallback (device offload "
                           f"degraded)",
                "detail": [f"{d}: {err}" for d, err in offload_degraded]}
        return {"from": self.name,
                "checks": checks,
                "progress": self.daemon_index.progress_events(),
                "daemons": {name: {"service": st.service,
                                   "age_s": round(st.age, 2)}
                            for name, st in
                            sorted(self.daemon_index.daemons.items())}}

    def _assemble_deadlock(self, rows: list[dict]) -> dict:
        """Cross-daemon wait-for graph from the per-OSD lockdep wait
        annotations (the distributed half of asynclockdep). Nodes are
        daemon entities; a row whose `peer` names another OSD is a
        directed edge waiter -> holder — a remote scrub reservation
        parked on that peer's slot pool. A cycle is two (or more)
        primaries holding their own slot while waiting on each other's:
        the crossed-reservation deadlock the reservation timeout must
        break. Rows without a peer (local waits) are kept for
        attribution but contribute no inter-daemon edge."""
        edges = []
        for r in rows:
            if r.get("peer") is None:
                continue
            edges.append({"waiter": r.get("entity"),
                          "holder": f"osd.{r['peer']}",
                          "resource": r.get("resource"),
                          "kind": r.get("kind"),
                          "tid": r.get("tid"),
                          "age_s": float(r.get("age_s") or 0.0),
                          "task": r.get("task"),
                          "site": r.get("site")})
        succ: dict[str, set] = {}
        for e in edges:
            if e["waiter"]:
                succ.setdefault(e["waiter"], set()).add(e["holder"])
        cycles: list[list[str]] = []
        seen: set[frozenset] = set()
        visited: set[str] = set()

        def dfs(node: str, path: list, on_path: dict) -> None:
            on_path[node] = len(path)
            path.append(node)
            for nxt in sorted(succ.get(node, ())):
                if nxt in on_path:
                    ring = path[on_path[nxt]:]
                    key = frozenset(ring)
                    if key not in seen:
                        seen.add(key)
                        cycles.append(ring + [nxt])
                elif nxt not in visited:
                    dfs(nxt, path, on_path)
            path.pop()
            del on_path[node]
            visited.add(node)

        for start in sorted(succ):
            if start not in visited:
                dfs(start, [], {})
        over_age = [e for e in edges
                    if e["age_s"] >= getattr(
                        self, "DEADLOCK_EDGE_AGE_S",
                        MgrDaemon.DEADLOCK_EDGE_AGE_S)]
        return {"waits": rows, "edges": edges, "cycles": cycles,
                "over_age_edges": over_age}

    def deadlock_status(self) -> dict:
        """`deadlock status` admin-socket verb: assemble the graph
        fresh from the daemon index, so it answers even on a standby
        mgr and between digest ticks."""
        rows: list[dict] = []
        for name, st in sorted(self.daemon_index.daemons.items()):
            for r in (st.health_metrics or {}).get("deadlock") or []:
                rows.append(dict(r, daemon=name))
        out = self._assemble_deadlock(rows)
        out["suspected"] = bool(out["cycles"] or out["over_age_edges"])
        return out

    def module_status(self) -> dict:
        return {m.NAME: m.status() for m in self.modules}

    # -- shared cluster-state helpers for modules ----------------------------

    def pg_counts(self) -> dict[int, int]:
        """PGs hosted per up+in OSD across all pools (acting sets)."""
        counts = {o: 0 for o, st in self.osdmap.osds.items()
                  if st.up and st.in_cluster}
        for pool in self.osdmap.pools.values():
            for ps in range(pool.pg_num):
                _, acting = self.osdmap.pg_to_up_acting_osds(
                    PG(pool.id, ps))
                for o in acting:
                    if o in counts:
                        counts[o] += 1
        return counts


class BalancerModule(MgrModule):
    """upmap-lite: cap the spread between the most- and least-loaded
    OSDs by remapping one PG per tick."""

    NAME = "balancer"
    MAX_SPREAD = 2            # acceptable (max - min) PG count gap
    MAX_REMAPS = 16           # total overrides this module may own

    def __init__(self):
        self.remapped: dict = {}       # PG -> override list
        self.last: dict = {}

    async def tick(self, mgr: MgrDaemon) -> None:
        await self._gc_stale(mgr)
        counts = mgr.pg_counts()
        if len(counts) < 2:
            return
        self.last = dict(counts)
        hot = max(counts, key=lambda o: counts[o])
        cold = min(counts, key=lambda o: counts[o])
        if counts[hot] - counts[cold] <= self.MAX_SPREAD:
            return
        if len(self.remapped) >= self.MAX_REMAPS:
            return
        # find a PG on `hot` that does not already include `cold`
        for pool in mgr.osdmap.pools.values():
            for ps in range(pool.pg_num):
                pgid = PG(pool.id, ps)
                if pgid in self.remapped or \
                        pgid in mgr.osdmap.pg_temp:
                    continue
                _, acting = mgr.osdmap.pg_to_up_acting_osds(pgid)
                if hot not in acting or cold in acting:
                    continue
                new = [cold if o == hot else o for o in acting]
                await mgr.mon_command(
                    {"prefix": "osd pg-temp",
                     "pgid": [pgid.pool, pgid.ps], "osds": new})
                self.remapped[pgid] = new
                dout("mgr", 2, f"balancer: pg {pgid} {acting} -> {new} "
                               f"(osd.{hot}:{counts[hot]} -> "
                               f"osd.{cold}:{counts[cold]})")
                return

    async def _gc_stale(self, mgr: MgrDaemon) -> None:
        """Erase overrides that now pin a down/out OSD into an acting
        set: a stale pg-temp would hold a dead OSD there forever.
        Erasing also un-wedges the MAX_REMAPS budget."""
        for pgid, osds in list(self.remapped.items()):
            healthy = all(
                o in mgr.osdmap.osds and mgr.osdmap.osds[o].up
                and mgr.osdmap.osds[o].in_cluster for o in osds)
            if healthy:
                continue
            try:
                await mgr.mon_command(
                    {"prefix": "osd pg-temp",
                     "pgid": [pgid.pool, pgid.ps], "osds": []})
                del self.remapped[pgid]
                dout("mgr", 2, f"balancer: erased stale remap of {pgid}")
            except Exception as e:
                dout("mgr", 4, f"balancer gc failed: "
                               f"{type(e).__name__} {e}")

    def status(self) -> dict:
        return {"active_remaps": len(self.remapped),
                "pg_counts": dict(sorted(self.last.items()))}


class PGAutoscalerModule(MgrModule):
    """Report-only pg_num recommendations toward ~100 PGs per OSD."""

    NAME = "pg_autoscaler"
    TARGET_PER_OSD = 100

    def __init__(self):
        self.recommendations: dict[str, dict] = {}

    async def tick(self, mgr: MgrDaemon) -> None:
        n_osds = sum(1 for st in mgr.osdmap.osds.values()
                     if st.up and st.in_cluster)
        if not n_osds or not mgr.osdmap.pools:
            return
        budget = n_osds * self.TARGET_PER_OSD
        total_weight = len(mgr.osdmap.pools)
        out = {}
        for pool in mgr.osdmap.pools.values():
            ideal = max(1, budget // max(1, total_weight * pool.size))
            # round to the nearest power of two (pg_num convention)
            target = 1 << max(0, ideal.bit_length() - 1)
            if target * 2 - ideal < ideal - target:
                target *= 2
            out[pool.name] = {"pg_num": pool.pg_num,
                              "recommended": target,
                              "would_adjust": target != pool.pg_num}
        self.recommendations = out

    def status(self) -> dict:
        return {"pools": self.recommendations}
