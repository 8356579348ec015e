"""Prometheus-format metrics endpoint (mgr prometheus module analog).

Re-creation of the reference exporter's surface
(src/pybind/mgr/prometheus/module.py: GET /metrics, text format 0.0.4;
src/exporter/ for the per-daemon variant): every counter aggregated
from daemon MMgrReport sessions (mgr/daemon.py DaemonStateIndex) is
exported as `ceph_<counter>{ceph_daemon="osd.0"} value` — the labels
name the REPORTING daemon, so a multi-daemon cluster's osd/mon/mds/rgw
series all appear in one scrape. When no reports exist (standalone
exporter, or a mgr that daemons have not found yet) the in-process
PerfCountersCollection registry is the fallback source. avg counters
split into _sum/_count (prometheus summaries), histograms into
cumulative _bucket series; every family carries exactly one `# TYPE`
line. An optional health callback adds `ceph_health_status`
(0=OK 1=WARN 2=ERR) and per-check gauges; progress events become
`ceph_progress_*` gauges. GET /health returns the raw health JSON.

HTTP/1.0 server on asyncio — no external dependencies.
"""
from __future__ import annotations

import asyncio
import json
from typing import Awaitable, Callable

from ceph_tpu_torch.utils import tracer
from ceph_tpu_torch.utils.dout import dout
from ceph_tpu_torch.utils.perf_counters import PerfCountersCollection

_SEVERITY = {"HEALTH_OK": 0, "HEALTH_WARN": 1, "HEALTH_ERR": 2}

#: default bound on distinct `ceph_client` label values per scrape
#: (mgr_max_client_series): a 500-client swarm must not turn /metrics
#: into a cardinality bomb — overflow folds into ceph_client="_other"
MAX_CLIENT_SERIES = 64

#: (field, prometheus type, fold) — the ceph_client_* family table.
#: fold "sum" for ledgers, "max" for the percentile gauges (a folded
#: row's p99 is the worst of its members, never their meaningless sum)
_CLIENT_FAMILIES = (
    ("ops", "counter", "sum"),
    ("read_ops", "counter", "sum"),
    ("write_ops", "counter", "sum"),
    ("read_bytes", "counter", "sum"),
    ("written_bytes", "counter", "sum"),
    ("in_flight", "gauge", "sum"),
    ("slo_good", "counter", "sum"),
    ("slo_violations", "counter", "sum"),
    ("read_lat_p99_ms", "gauge", "max"),
    ("write_lat_p99_ms", "gauge", "max"),
)


def _cap_client_series(agg: dict[str, dict], cap: int) -> dict[str, dict]:
    """Bound the client set at `cap` distinct label values: the top
    (cap-1) clients by ops keep their own rows, everyone else (plus any
    OSD-side fold row) merges into one `_other`."""
    if len(agg) <= cap:
        return agg
    overflow = [c for c in agg if c != "_other"]
    ranked = sorted(overflow, key=lambda c: (-agg[c].get("ops", 0), c))
    keep = ranked[:max(1, cap - 1)]
    out = {c: agg[c] for c in keep}
    other = {"tenant": None,
             **{f: 0 for f, _t, fold in _CLIENT_FAMILIES if fold == "sum"},
             **{f: 0.0 for f, _t, fold in _CLIENT_FAMILIES
                if fold == "max"}}
    folded = 0
    for c, e in agg.items():
        if c in out:
            continue
        folded += 1
        for f, _t, fold in _CLIENT_FAMILIES:
            v = e.get(f)
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                continue
            other[f] = max(other[f], v) if fold == "max" else other[f] + v
    if folded:
        out["_other"] = other
    return out


def _sanitize(name: str) -> str:
    """Metric-NAME sanitizer: prometheus names are [a-z0-9_] here (the
    metrics-name lint enforces it). Label values keep their case — use
    _label_escape for those."""
    return "".join(ch.lower() if ch.isalnum() or ch == "_" else "_"
                   for ch in name)


def _label_escape(value: str) -> str:
    return value.replace("\\", r"\\").replace('"', r'\"') \
        .replace("\n", r"\n")


def _render_value(metric: str, label: str, ctype: str | None,
                  value) -> tuple[list[str], str]:
    """One counter's sample lines + its prometheus family type. The
    schema type wins; value shape is the fallback (a report may carry
    values whose schema line was lost to a truncated session)."""
    if ctype == "avg" or (isinstance(value, dict) and "avgcount" in value):
        value = value if isinstance(value, dict) else {}
        return ([f"{metric}_sum{{{label}}} {value.get('sum', 0.0)}",
                 f"{metric}_count{{{label}}} {value.get('avgcount', 0)}"],
                "summary")
    if ctype == "histogram" or isinstance(value, dict):
        # cumulative histogram series. Internal bucket i counts values
        # in [2^i, 2^(i+1)), so `le` is the numeric upper bound
        # 2^(i+1) in the counter's recorded unit (*_us = µs)
        value = value if isinstance(value, dict) else {}
        counts = {int(b[2:]): n
                  for b, n in value.get("buckets", {}).items()}
        rows, cum = [], 0
        for exp in sorted(counts):
            cum += counts[exp]
            rows.append(f'{metric}_bucket{{{label},'
                        f'le="{2 ** (exp + 1)}"}} {cum}')
        rows.append(f'{metric}_bucket{{{label},le="+Inf"}} '
                    f"{value.get('count', cum)}")
        rows.append(f"{metric}_sum{{{label}}} {value.get('sum', 0.0)}")
        rows.append(f"{metric}_count{{{label}}} "
                    f"{value.get('count', cum)}")
        return rows, "histogram"
    return ([f"{metric}{{{label}}} {value}"],
            "gauge" if ctype == "gauge" else "counter")


def render_metrics(health: dict | None = None, index=None,
                   max_client_series: int | None = None) -> str:
    """The /metrics payload: aggregated per-daemon counters (or the
    local registry when no daemon reports exist), text format."""
    if max_client_series is None:
        max_client_series = MAX_CLIENT_SERIES
    sources: list[tuple[str, dict, dict]] = \
        index.render_sources() if index is not None else []
    from_reports = bool(sources)
    if not from_reports:
        coll = PerfCountersCollection.instance()
        dump, schema = coll.dump(), coll.schema()
        sources = [(daemon, schema.get(daemon, {}), counters)
                   for daemon, counters in sorted(dump.items())]
    # group sample rows by family so each metric gets exactly ONE
    # `# TYPE` line however many daemons carry it
    families: dict[str, dict] = {}
    for daemon, schema, counters in sources:
        # daemon names arrive in remote MMgrOpen payloads: one bad name
        # must not break the whole scrape's text-format parse
        label = f'ceph_daemon="{_label_escape(daemon)}"'
        for key, value in sorted(counters.items()):
            metric = f"ceph_{_sanitize(key)}"
            ctype = (schema.get(key) or {}).get("type") \
                if schema else None
            rows, ftype = _render_value(metric, label, ctype, value)
            fam = families.setdefault(metric,
                                      {"type": ftype, "rows": []})
            fam["rows"].extend(rows)
    if from_reports:
        # per-device labeled counters (offload utilization): one family
        # per counter name, rows labeled by daemon AND device, so the
        # mesh fan-out's balance is graphable per accelerator
        # shapes arrive in remote MMgrReport payloads: like the daemon
        # names above, one malformed report must not break the scrape
        for daemon, devmap in index.device_sources():
            dlabel = _label_escape(daemon)
            if not isinstance(devmap, dict):
                continue
            for device, counters in sorted(devmap.items()):
                if not isinstance(counters, dict):
                    continue
                vlabel = _label_escape(str(device))
                for key, value in sorted(counters.items()):
                    if not isinstance(value, (int, float)) or \
                            isinstance(value, bool):
                        continue
                    metric = f"ceph_{_sanitize(key)}"
                    fam = families.setdefault(
                        metric, {"type": "counter", "rows": []})
                    fam["rows"].append(
                        f'{metric}{{ceph_daemon="{dlabel}",'
                        f'ceph_device="{vlabel}"}} {value}')
        # per-client labeled families (the multi-tenant lens): one row
        # per client per family, merged ACROSS OSDs by the index, label
        # cardinality bounded by mgr_max_client_series with overflow
        # folded into ceph_client="_other"
        agg = _cap_client_series(index.client_aggregate(),
                                 int(max_client_series))
        for client, e in sorted(agg.items()):
            clabel = (f'ceph_client="{_label_escape(str(client))}",'
                      f'tenant="{_label_escape(str(e.get("tenant") or ""))}"')
            for field, ftype, _fold in _CLIENT_FAMILIES:
                v = e.get(field)
                if not isinstance(v, (int, float)) or \
                        isinstance(v, bool):
                    continue
                metric = f"ceph_client_{_sanitize(field)}"
                fam = families.setdefault(
                    metric, {"type": ftype, "rows": []})
                fam["rows"].append(f"{metric}{{{clabel}}} {v}")
        # per-tenant QoS families (the dmclock scheduler's ledger):
        # shed/deferred/dequeue-phase splits merged ACROSS OSDs,
        # rendered with a `tenant` label. Cardinality is bounded by
        # the scheduler's own entity-table cap.
        for tenant, e in sorted(index.qos_aggregate().items()):
            tlabel = f'tenant="{_label_escape(str(tenant))}"'
            for field, v in sorted(e.items()):
                if not isinstance(v, (int, float)) or \
                        isinstance(v, bool):
                    continue
                metric = f"ceph_qos_{_sanitize(field)}"
                fam = families.setdefault(
                    metric, {"type": "gauge" if field == "queued"
                             else "counter", "rows": []})
                fam["rows"].append(f"{metric}{{{tlabel}}} {v}")
        # per-pool scrub families (the continuous-integrity ledger):
        # objects/bytes scanned and errors found/repaired merged ACROSS
        # the pool's primaries, registry counts and freshness ages as
        # gauges. Cardinality = pool count.
        for pool, e in sorted(index.scrub_aggregate().items()):
            plabel = f'pool="{_label_escape(str(pool))}"'
            for field, v in sorted(e.items()):
                if not isinstance(v, (int, float)) or \
                        isinstance(v, bool):
                    continue
                metric = f"ceph_scrub_{_sanitize(field)}"
                fam = families.setdefault(
                    metric, {"type": "gauge" if field in
                             ("inconsistent", "unrepaired",
                              "last_scrub_age_s",
                              "last_deep_scrub_age_s")
                             else "counter", "rows": []})
                fam["rows"].append(f"{metric}{{{plabel}}} {v}")
        fam = families.setdefault("ceph_daemon_report_age_seconds",
                                  {"type": "gauge", "rows": []})
        for daemon, age in index.report_ages().items():
            fam["rows"].append(
                f'ceph_daemon_report_age_seconds'
                f'{{ceph_daemon="{_label_escape(daemon)}"}} {age}')
        prog = families.setdefault("ceph_progress_fraction",
                                   {"type": "gauge", "rows": []})
        for ev in index.progress_events():
            prog["rows"].append(
                f'ceph_progress_fraction'
                f'{{id="{_label_escape(str(ev.get("id", "?")))}",'
                f'ceph_daemon="{_label_escape(str(ev.get("daemon", "?")))}"}} '
                f'{ev.get("progress", 0.0)}')
        if not prog["rows"]:
            del families["ceph_progress_fraction"]
    # critical-path attribution families (tracing v2): per-class and
    # per-client stage histograms banked by the TraceIndex as assembled
    # traces settle, plus exemplar series tying the existing latency
    # histograms to concrete slow trace_ids (separate series, not
    # OpenMetrics bucket suffixes — the text-format 0.0.4 parse of
    # bucket lines stays intact). Rendered whenever the index carries
    # traces, even before the first daemon report lands.
    tix = getattr(index, "traces", None)
    if tix is not None:
        tix.settle()
        for metric, hists, lname in (
                ("ceph_trace_critical_path_us", tix.class_hists,
                 "op_class"),
                ("ceph_trace_client_critical_path_us",
                 tix.client_hists, "ceph_client")):
            if not hists:
                continue
            fam = families.setdefault(
                metric, {"type": "histogram", "rows": []})
            for (key, stage), h in sorted(hists.items()):
                label = (f'{lname}="{_label_escape(str(key))}",'
                         f'stage="{_label_escape(str(stage))}"')
                cum = 0
                for exp, n in enumerate(h["buckets"]):
                    if not n:
                        continue
                    cum += n
                    fam["rows"].append(
                        f'{metric}_bucket{{{label},'
                        f'le="{2 ** (exp + 1)}"}} {cum}')
                fam["rows"].append(
                    f'{metric}_bucket{{{label},le="+Inf"}} '
                    f'{h["count"]}')
                fam["rows"].append(
                    f'{metric}_sum{{{label}}} {round(h["sum"], 1)}')
                fam["rows"].append(
                    f'{metric}_count{{{label}}} {h["count"]}')
        if tix.exemplars:
            fam = families.setdefault("ceph_op_total_us_exemplar",
                                      {"type": "gauge", "rows": []})
            for op_class, ex in sorted(tix.exemplars.items()):
                fam["rows"].append(
                    f'ceph_op_total_us_exemplar'
                    f'{{op_class="{_label_escape(str(op_class))}",'
                    f'trace_id="{_label_escape(str(ex["trace_id"]))}",'
                    f'top_stage="{_label_escape(str(ex["top_stage"]))}"'
                    f'}} {ex["total_us"]}')
    out: list[str] = []
    for metric in sorted(families):
        out.append(f"# TYPE {metric} {families[metric]['type']}")
        out.extend(families[metric]["rows"])
    if health is not None:
        out.append("# TYPE ceph_health_status gauge")
        out.append(f"ceph_health_status{{}} "
                   f"{_SEVERITY.get(health.get('status'), 2)}")
        checks = dict(health.get("checks", {}))
        for name in health.get("muted", {}):
            checks.setdefault(name, {"severity": "MUTED"})
        if checks:
            out.append("# TYPE ceph_health_detail gauge")
            for name, chk in sorted(checks.items()):
                out.append(
                    f'ceph_health_detail{{check="{_label_escape(name)}",'
                    f'severity="{chk.get("severity")}"}} 1')
    return "\n".join(out) + "\n"


_SPARK_BARS = "▁▂▃▄▅▆▇█"


def sparkline(points: list) -> str:
    """Values -> a unicode microchart, scaled to the series' own
    min..max (shape over time is the signal; the numbers ride the
    label). Non-numeric points render as gaps."""
    nums = [p for p in points
            if isinstance(p, (int, float)) and not isinstance(p, bool)]
    if not nums:
        return ""
    lo, hi = min(nums), max(nums)
    span = hi - lo
    out = []
    for p in points:
        if not isinstance(p, (int, float)) or isinstance(p, bool):
            out.append(" ")
            continue
        idx = int((p - lo) / span * (len(_SPARK_BARS) - 1)) if span \
            else 0
        out.append(_SPARK_BARS[idx])
    return "".join(out)


def render_dashboard(status: dict, health: dict | None) -> str:
    """Read-only cluster dashboard (one self-contained HTML page).
    Every cluster-supplied string is escaped: pool names and health
    summaries are attacker-influencable."""
    import html as _html
    esc = _html.escape
    h = health or status.get("health") or {}
    hstat = esc(str(h.get("status", "UNKNOWN")))
    color = {"HEALTH_OK": "#2a2", "HEALTH_WARN": "#d90",
             "HEALTH_ERR": "#c22"}.get(h.get("status"), "#888")
    rows = []
    for name, p in sorted((status.get("pools") or {}).items()):
        rows.append(f"<tr><td>{esc(str(name))}</td>"
                    f"<td>{esc(str(p.get('type', '')))}</td>"
                    f"<td>{esc(str(p.get('size', '')))}</td>"
                    f"<td>{esc(str(p.get('pg_num', '')))}</td></tr>")
    checks = []
    for cname, chk in (h.get("checks") or {}).items():
        checks.append(f"<li><b>{esc(str(cname))}</b> "
                      f"[{esc(str(chk.get('severity')))}]: "
                      f"{esc(str(chk.get('summary')))}</li>")
    om = status.get("osdmap") or {}
    mods = esc(json.dumps(status.get("modules", {}), indent=1))
    # per-daemon report table (the DaemonStateIndex view)
    daemon_rows = []
    for name, d in sorted((status.get("daemon_reports") or {}).items()):
        daemon_rows.append(
            f"<tr><td>{esc(str(name))}</td>"
            f"<td>{esc(str(d.get('service', '')))}</td>"
            f"<td>{esc(str(d.get('age_s', '')))}</td>"
            f"<td>{esc(str(d.get('num_counters', '')))}</td></tr>")
    daemons_html = ("<h2>daemons</h2><table><tr><th>daemon</th>"
                    "<th>service</th><th>report age (s)</th>"
                    "<th>counters</th></tr>"
                    + "".join(daemon_rows) + "</table>"
                    if daemon_rows else
                    "<h2>daemons</h2><p>no daemon reports yet</p>")
    # per-client table (the multi-tenant lens): top clients by ops with
    # their byte ledgers, tail latency, and SLO score
    client_rows = []
    for cname, ce in sorted((status.get("client_table") or {}).items(),
                            key=lambda kv: -kv[1].get("ops", 0)):
        client_rows.append(
            f"<tr><td>{esc(str(cname))}</td>"
            f"<td>{esc(str(ce.get('tenant') or ''))}</td>"
            f"<td>{esc(str(ce.get('ops', 0)))}</td>"
            f"<td>{ce.get('read_bytes', 0) / 1e6:.1f}</td>"
            f"<td>{ce.get('written_bytes', 0) / 1e6:.1f}</td>"
            f"<td>{esc(str(ce.get('read_lat_p99_ms', 0)))}</td>"
            f"<td>{esc(str(ce.get('write_lat_p99_ms', 0)))}</td>"
            f"<td>{esc(str(ce.get('slo_violations', 0)))}</td></tr>")
    clients_html = ("<h2>clients</h2><table><tr><th>client</th>"
                    "<th>tenant</th><th>ops</th><th>read MB</th>"
                    "<th>written MB</th><th>read p99 (ms)</th>"
                    "<th>write p99 (ms)</th><th>SLO viol</th></tr>"
                    + "".join(client_rows) + "</table>"
                    if client_rows else "")
    # per-pool scrub table (the continuous-integrity ledger): scan
    # volume, errors found/repaired, and the live inconsistent registry
    scrub_rows = []
    for pname, se in sorted((status.get("scrub_table") or {}).items()):
        scrub_rows.append(
            f"<tr><td>{esc(str(pname))}</td>"
            f"<td>{se.get('objects_scrubbed', 0)}</td>"
            f"<td>{se.get('bytes_hashed', 0) / 1e6:.1f}</td>"
            f"<td>{se.get('errors_found', 0)}</td>"
            f"<td>{se.get('errors_repaired', 0)}</td>"
            f"<td>{se.get('inconsistent', 0)}</td>"
            f"<td>{se.get('unrepaired', 0)}</td></tr>")
    scrub_html = ("<h2>scrub</h2><table><tr><th>pool</th>"
                  "<th>objects</th><th>MB hashed</th><th>found</th>"
                  "<th>repaired</th><th>inconsistent</th>"
                  "<th>unrepaired</th></tr>"
                  + "".join(scrub_rows) + "</table>"
                  if scrub_rows else "")
    progress_items = []
    for ev in (status.get("progress_events")
               or status.get("progress") or []):
        frac = float(ev.get("progress", 0.0))
        progress_items.append(
            f"<li>{esc(str(ev.get('message', ev.get('id', '?'))))} "
            f"[{esc(str(ev.get('daemon', '')))}]: {frac:.0%}</li>")
    progress_html = ("<h2>progress</h2><ul>"
                     + "".join(progress_items) + "</ul>"
                     if progress_items else "")
    # metrics-history sparklines (the mgr's time-resolved sample rings:
    # windowed p99 for histograms, per-interval rates for counters)
    spark_rows = []
    for row in (status.get("history_sparklines") or [])[:24]:
        if not isinstance(row, dict):
            continue
        points = row.get("points") or []
        last = row.get("last")
        last_s = f"{last:.3g}" if isinstance(last, (int, float)) \
            and not isinstance(last, bool) else ""
        spark_rows.append(
            f"<tr><td>{esc(str(row.get('daemon', '')))}</td>"
            f"<td>{esc(str(row.get('metric', '')))}</td>"
            f"<td>{esc(sparkline(points))}</td>"
            f"<td>{esc(last_s)}</td></tr>")
    sparks_html = ("<h2>metrics history</h2><table><tr><th>daemon</th>"
                   "<th>metric</th><th>trend</th><th>last</th></tr>"
                   + "".join(spark_rows) + "</table>"
                   if spark_rows else "")
    # slowest assembled traces (tracing v2: cluster-wide TraceIndex
    # with critical-path stage attribution per trace)
    slow_rows = []
    for t in (status.get("slow_traces") or [])[:10]:
        if not isinstance(t, dict):
            continue
        stages = t.get("stages") or {}
        breakdown = " ".join(
            f"{k}:{v / 1000:.1f}" for k, v in stages.items()
            if isinstance(v, (int, float)) and v > 0)
        slow_rows.append(
            f"<tr><td>{esc(str(t.get('trace_id', '')))}</td>"
            f"<td>{esc(str(t.get('op_class', '')))}</td>"
            f"<td>{esc(str(t.get('client', '')))}</td>"
            f"<td>{float(t.get('total_us', 0)) / 1000:.2f}</td>"
            f"<td>{esc(str(t.get('top_stage', '')))}</td>"
            f"<td>{esc(breakdown)}</td></tr>")
    slow_html = ("<h2>slowest traces</h2><table><tr><th>trace</th>"
                 "<th>class</th><th>client</th><th>ms</th>"
                 "<th>top stage</th><th>stage ms</th></tr>"
                 + "".join(slow_rows) + "</table>"
                 if slow_rows else "")
    # recent traces (process-wide span collector; empty when tracing off)
    trace_rows = []
    for t in tracer.recent_traces(limit=15):
        trace_rows.append(
            f"<tr><td>{esc(t['trace_id'])}</td>"
            f"<td>{esc(str(t['root']))}</td>"
            f"<td>{esc(', '.join(t['services']))}</td>"
            f"<td>{t['num_spans']}</td>"
            f"<td>{t['duration_us'] / 1000:.2f}</td></tr>")
    traces_html = ("<h2>recent traces</h2><table><tr><th>trace</th>"
                   "<th>root</th><th>services</th><th>spans</th>"
                   "<th>ms</th></tr>" + "".join(trace_rows) + "</table>"
                   if trace_rows else
                   "<h2>recent traces</h2><p>tracing off or no spans "
                   "collected (config set tracer_enabled true)</p>")
    return f"""<!doctype html><html><head><title>ceph-tpu dashboard</title>
<style>body{{font-family:monospace;margin:2em}}
table{{border-collapse:collapse}}td,th{{border:1px solid #ccc;
padding:4px 10px}}.pill{{color:#fff;background:{color};
padding:2px 10px;border-radius:9px}}</style></head><body>
<h1>ceph-tpu <span class="pill">{hstat}</span></h1>
<p>osdmap epoch {om.get('epoch', '?')} &middot;
{om.get('num_up_osds', '?')}/{om.get('num_osds', '?')} osds up &middot;
mons {', '.join(str(q) for q in
                (status.get('monmap') or {}).get('quorum', []))}</p>
<ul>{''.join(checks) or '<li>no active health checks</li>'}</ul>
<h2>pools</h2>
<table><tr><th>pool</th><th>type</th><th>size</th><th>pg_num</th></tr>
{''.join(rows)}</table>
{daemons_html}
{clients_html}
{scrub_html}
{sparks_html}
{progress_html}
{slow_html}
{traces_html}
<h2>mgr modules</h2><pre>{mods}</pre>
<p><a href="/metrics">metrics</a> &middot;
<a href="/status.json">status.json</a></p></body></html>"""


class MetricsExporter:
    """Serve /metrics (prometheus text), /health (JSON), and — when a
    status callback is wired — / as a dashboard-lite HTML page plus
    /status.json (the mgr dashboard module's role,
    src/pybind/mgr/dashboard, collapsed to a read-only status page)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 health_cb: Callable[[], Awaitable[dict]] | None = None,
                 status_cb: Callable[[], Awaitable[dict]] | None = None,
                 index=None, max_client_series=None):
        self.host, self.port = host, port
        self.health_cb = health_cb
        self.status_cb = status_cb
        # the mgr's DaemonStateIndex: aggregated per-daemon counters
        # from MMgrReport sessions (None -> local-registry fallback)
        self.index = index
        # int or zero-arg callable (hot mgr_max_client_series read)
        self.max_client_series = max_client_series
        self._server: asyncio.Server | None = None
        self.addr: tuple[str, int] | None = None

    def _client_series_cap(self) -> int:
        cap = self.max_client_series
        if callable(cap):
            try:
                cap = cap()
            except Exception:
                cap = None
        return int(cap) if cap else MAX_CLIENT_SERIES

    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.addr = self._server.sockets[0].getsockname()[:2]
        dout("mgr", 1, f"metrics exporter on {self.addr}")
        return self.addr

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _safe_status(self) -> dict:
        """status_cb degrades like health_cb: a failing module must
        produce an error page, not a reset connection."""
        try:
            return await self.status_cb()
        except Exception as e:
            dout("mgr", 2, f"status callback failed: {e}")
            return {"error": f"{type(e).__name__}: {e}"}

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            request = await asyncio.wait_for(reader.readline(), 10.0)
            parts = request.decode(errors="replace").split()
            path = parts[1] if len(parts) >= 2 else "/"
            while True:        # drain headers
                line = await asyncio.wait_for(reader.readline(), 10.0)
                if line in (b"\r\n", b"\n", b""):
                    break
            health = None
            if self.health_cb is not None:
                try:
                    health = await self.health_cb()
                except Exception as e:
                    dout("mgr", 2, f"health callback failed: {e}")
            if path.startswith("/metrics"):
                body = render_metrics(
                    health, index=self.index,
                    max_client_series=self._client_series_cap()).encode()
                ctype = "text/plain; version=0.0.4"
                code = "200 OK"
            elif path.startswith("/health"):
                body = json.dumps(health or {}).encode()
                ctype = "application/json"
                code = "200 OK"
            elif path.startswith("/status.json") and \
                    self.status_cb is not None:
                body = json.dumps(await self._safe_status()).encode()
                ctype = "application/json"
                code = "200 OK"
            elif path in ("/", "/index.html") and \
                    self.status_cb is not None:
                body = render_dashboard(await self._safe_status(),
                                        health).encode()
                ctype = "text/html; charset=utf-8"
                code = "200 OK"
            else:
                body = b"try /metrics, /health, /status.json or /\n"
                ctype = "text/plain"
                code = "404 Not Found"
            writer.write(
                f"HTTP/1.0 {code}\r\nContent-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
            await writer.drain()
        except (asyncio.TimeoutError, OSError):
            pass
        finally:
            writer.close()
