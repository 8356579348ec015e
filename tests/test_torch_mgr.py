"""The port's mgr (ceph_tpu_torch/mgr/: daemon, exporter, history)
against the JAX package's, on the CPU.

The reference's mgr cases run on the port: each reference test source is
exec'd with its imports renamed to the port (`load_reference_tests`), its
cluster harness replaced by tests/test_cluster.py's exec'd on the port
with `OSD(device="cpu")`, and its device plugin `tpu` replaced by `cuda`
on the CPU (the offload service over 8 CPU slots, the counterpart of the
reference tests' 8 virtual CPU devices). The cases:

  tests/test_mgr_daemon.py and tests/test_mgr_exporter.py, all of them;
  tests/test_mgr_history.py, all 21 functions (23 cases);
  tests/test_mgr_report.py :118, :193, :259, :320 and :355 (the one at
      :55 boots tools/vstart.py, which the port does not have yet);
  tests/test_offload.py :324, :478, :499 and :536;
  tests/test_attribution.py :192 and :279.

Then the same reports go into a DaemonStateIndex of each package: the
rendered /metrics text (with the `ceph_device`-labelled offload rows) and
the health digest (TPU_OFFLOAD_DEGRADED among its checks) must be equal.
"""
from __future__ import annotations

import asyncio
import inspect
import json
import signal

import pytest

from ceph_tpu.mgr import DaemonStateIndex as RefDaemonStateIndex
from ceph_tpu.mgr import MgrDaemon as RefMgrDaemon
from ceph_tpu.mgr.exporter import render_metrics as ref_render_metrics
from ceph_tpu_torch.mgr import DaemonStateIndex, MgrClient, MgrDaemon
from ceph_tpu_torch.mgr.exporter import render_metrics
from ceph_tpu_torch.mon.monitor import MgrMonitor
from ceph_tpu_torch.mon.paxos import Paxos
from ceph_tpu_torch.msg.messenger import Connection
from ceph_tpu_torch.osd.daemon import OSD

from tests.test_torch_kv_objectstore import load_reference_tests

HARD_TIMEOUT_S = 60

#: tests/test_cluster.py's harness on the port's daemons
_PORT_CLUSTER = load_reference_tests(
    "test_cluster", True, [], {},
    edits=(("osd = OSD(i, self.mon_addrs, store=store)",
            'osd = OSD(i, self.mon_addrs, store=store, device="cpu")'),))
ClusterHarness = _PORT_CLUSTER.ClusterHarness


def run(coro, timeout=30):
    return asyncio.run(asyncio.wait_for(coro, timeout))


_HARNESS_IMPORT = ("from tests.test_cluster import ClusterHarness, "
                   "fast_timers, run  # noqa: F401")
_PORT_HARNESS = "from tests.test_torch_mgr import ClusterHarness, run"
_TPU_IMPL = 'registry.factory("tpu", {"k": str(k), "m": str(m)})'
_CUDA_IMPL = ('registry.factory("cuda", {"k": str(k), "m": str(m), '
              '"device": "cpu"})')
_SERVICE = "offload.get_service()"
_CPU_SERVICE = 'offload.get_service(["cpu"] * 8)'

#: reference file -> the edits its source takes on the port
SOURCES = {
    "test_mgr_daemon": ((_HARNESS_IMPORT, _PORT_HARNESS),),
    "test_mgr_exporter": ((_HARNESS_IMPORT, _PORT_HARNESS),),
    "test_mgr_history": (),
    "test_mgr_report": ((_HARNESS_IMPORT, _PORT_HARNESS),),
    "test_offload": (
        ("from tests.test_cluster import ClusterHarness, run",
         _PORT_HARNESS),
        ("from ceph_tpu_torch.ec.plugin_tpu import ErasureCodeTpu",
         "from ceph_tpu_torch.ec.plugin_cuda import "
         "ErasureCodeCuda as ErasureCodeTpu"),
        (_TPU_IMPL, _CUDA_IMPL), (_SERVICE, _CPU_SERVICE),
        ("osd = OSD(7, harness.mon_addrs,",
         'osd = OSD(7, harness.mon_addrs, device="cpu",'),
        # the port stages a batch as a CPU tensor (a card's pinned page)
        ("return _host_apply(impl.coding_matrix, stacked)",
         "return _host_apply(impl.coding_matrix, stacked.numpy())")),
    "test_attribution": ((_TPU_IMPL, _CUDA_IMPL),
                         (_SERVICE, _CPU_SERVICE)),
}

CASES = [
    ("test_mgr_daemon", "test_mgr_modules_and_endpoint", None),
    ("test_mgr_daemon", "test_balancer_reduces_spread", None),
    ("test_mgr_exporter", "test_exporter_serves_daemon_metrics_and_health",
     None),
    *[("test_mgr_history", "test_bucket_quantile_matches_exact_oracle", q)
      for q in (0.5, 0.9, 0.99)],
    *[("test_mgr_history", name, None) for name in (
        "test_bucket_quantile_empty_and_tail",
        "test_bucket_counts_normalizes_key_styles",
        "test_history_ring_evicts_past_slots",
        "test_cadence_gate_skips_early_samples",
        "test_max_series_overflow_counted_not_stored",
        "test_counter_moving_backwards_drops_daemon_history",
        "test_gauge_never_counts_as_reset",
        "test_counter_rate_over_window",
        "test_histogram_window_p99_is_newest_minus_oldest",
        "test_avg_counter_window_math", "test_drop_and_reset",
        "test_sparkline_data_and_rendering",
        "test_report_feeds_history_and_flight_sources",
        "test_ingest_events_dedups_by_seq_per_source",
        "test_flight_source_bounds_events_and_rotates_sources",
        "test_ingest_rejects_malformed_rings",
        "test_cull_drops_history_but_keeps_flight_sources",
        "test_perf_history_query_and_listing",
        "test_mgr_history_knobs_reconfigure_live_store",
        "test_timeline_dump_merges_reported_local_and_extra_rings")],
    *[("test_mgr_report", name, None) for name in (
        "test_slow_ops_health_mute_ttl",
        "test_daemon_churn_eviction_and_rejoin", "test_metrics_name_lint",
        "test_digest_checks_and_progress", "test_perf_reset")],
    *[("test_offload", name, None) for name in (
        "test_device_stats_and_exporter_rows_for_every_mesh_device",
        "test_mgr_digest_raises_tpu_offload_degraded",
        "test_admin_socket_commands_and_hot_config",
        "test_offload_counters_ride_the_mgr_report")],
    ("test_attribution", "test_device_batches_and_fallback_attribution",
     None),
    ("test_attribution", "test_device_metrics_render_with_ceph_device_label",
     None),
]


@pytest.fixture(autouse=True)
def _guards(monkeypatch):
    """tests/test_cluster.py's fast timers on the port's classes, the
    offload service's defaults kept, a hard timeout that fires even in a
    loop that never yields, and the port's own leak gates
    (tests/conftest.py gates the reference's modules)."""
    from ceph_tpu_torch.offload import service
    # a daemon's `config set ec_offload_*` (test_offload's cases) rewrites
    # the module-wide defaults: a copy for the test, so no later test in
    # this process sees them changed
    monkeypatch.setattr(service, "_DEFAULTS", dict(service._DEFAULTS))
    monkeypatch.setattr(Paxos, "ELECTION_TIMEOUT", 0.15)
    monkeypatch.setattr(Paxos, "LEASE_INTERVAL", 0.2)
    monkeypatch.setattr(Paxos, "LEASE_TIMEOUT", 1.0)
    monkeypatch.setattr(Paxos, "ACCEPT_TIMEOUT", 0.8)
    monkeypatch.setattr(Connection, "KEEPALIVE_INTERVAL", 0.3)
    monkeypatch.setattr(Connection, "KEEPALIVE_TIMEOUT", 1.5)
    monkeypatch.setattr(Connection, "PARK_TIMEOUT", 2.0)
    monkeypatch.setattr(OSD, "HB_INTERVAL", 0.25)
    monkeypatch.setattr(OSD, "HB_GRACE", 1.2)

    def expire(signum, frame):
        raise TimeoutError(f"test ran past {HARD_TIMEOUT_S} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, HARD_TIMEOUT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
    from ceph_tpu_torch.utils import loopprof, sanitizer
    assert not loopprof.installed_loops(), "port loopprof left armed"
    strays = sanitizer.take_foreign_call_soon()
    assert not strays, f"port sanitizer saw foreign call_soon: {strays}"


def _file_fixtures(source: str, monkeypatch, tmp_path) -> dict:
    """The reference file's own autouse fixtures, on the port's modules,
    and the fixture arguments its cases take."""
    from ceph_tpu_torch.utils import copytrack, flight
    if source == "test_mgr_report":
        # fast_reporting: report/beacon periods that converge in test time
        monkeypatch.setattr(MgrClient, "REPORT_PERIOD", 0.2)
        monkeypatch.setattr(MgrDaemon, "TICK_INTERVAL", 0.2)
        monkeypatch.setattr(MgrDaemon, "REPORT_PERIOD", 0.2)
        monkeypatch.setattr(DaemonStateIndex, "STALE_AFTER", 2.0)
        monkeypatch.setattr(MgrMonitor, "BEACON_GRACE", 2.0)
    if source == "test_mgr_history":
        flight.reset()
    if source == "test_attribution":
        copytrack.reset()
    args = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    if source == "test_mgr_history":
        args["mgr"] = MgrDaemon([("127.0.0.1", 1)], modules=[],
                                exporter_port=None,
                                admin_socket_path=str(tmp_path / "mgr.asok"))
    return args


def test_every_listed_case_exists():
    import os
    import re

    from tests.test_torch_kv_objectstore import TESTS
    found = {name: set(re.findall(
        r"^def (test_\w+)\(", open(os.path.join(TESTS, name + ".py")).read(),
        re.M)) for name in SOURCES}
    for source, case, _ in CASES:
        assert case in found[source], (source, case)
    assert {c for s, c, _ in CASES if s == "test_mgr_history"} == \
        found["test_mgr_history"]
    assert len(found["test_mgr_history"]) == 21


@pytest.mark.parametrize("source,case,param", CASES,
                         ids=[f"{s}::{c}" + (f"[{p}]" if p else "")
                              for s, c, p in CASES])
def test_reference_mgr_case_on_the_port(source, case, param, tmp_path,
                                        monkeypatch):
    mod = load_reference_tests(source, True, [], {}, edits=SOURCES[source])
    args = _file_fixtures(source, monkeypatch, tmp_path)
    if param is not None:
        args["q"] = param
    fn = getattr(mod, case)
    try:
        fn(*[args[p] for p in inspect.signature(fn).parameters])
    finally:
        if source == "test_mgr_history":
            from ceph_tpu_torch.utils import flight
            flight.reset()
            flight.clear_snapshots()
        if source == "test_attribution":
            from ceph_tpu_torch.utils import copytrack
            copytrack.reset()


# -- the same reports into a DaemonStateIndex of each package ----------------

def _report(name, **extra):
    return dict({"daemon_name": name, "service": name.split(".")[0],
                 "schema": {}, "counters": {}, "daemon_status": {},
                 "health_metrics": {}, "progress": []}, **extra)


_SCHEMA = {"op": {"type": "u64"}, "Weird-Name.x": {"type": "u64"},
           "lat": {"type": "avg"}, "hist_us": {"type": "histogram"},
           "load": {"type": "gauge"},
           "copyflow_copied_bytes_h2d": {"type": "counter"}}
_COUNTERS = {"op": 7, "Weird-Name.x": 1,
             "lat": {"avgcount": 2, "sum": 0.5},
             "hist_us": {"count": 3, "sum": 99.0,
                         "buckets": {"2^3": 2, "2^5": 1}},
             "load": 4, "copyflow_copied_bytes_h2d": 4096}


def _device_rows(device: str, busy: float, fallback: int = 0) -> dict:
    return {device: {"offload_device_batches": 12,
                     "offload_device_ops": 30,
                     "offload_device_bytes": 12 << 20,
                     "offload_device_busy_seconds": busy,
                     "offload_device_fallback_ops": 0},
            "host": {"offload_device_batches": fallback,
                     "offload_device_ops": fallback,
                     "offload_device_bytes": 0,
                     "offload_device_busy_seconds": 0.0,
                     "offload_device_fallback_ops": fallback}}


#: three OSDs of a card (two co-hosted in one worker, so they report the
#: same service), one of them with its service's breaker tripped, and a
#: mon; one slow op, a degraded PG, recovery progress and a full store
REPORTS = [
    _report("osd.0", schema=_SCHEMA, counters=_COUNTERS,
            device_metrics=_device_rows("cuda:0", 0.25),
            health_metrics={"slow_ops": 1, "slow_ops_oldest_age_s": 3.0,
                            "offload": {"degraded": False},
                            "store": {"utilization": 0.5}}),
    _report("osd.1", schema=_SCHEMA, counters=dict(_COUNTERS, op=9),
            device_metrics=_device_rows("cuda:0", 0.5, fallback=3),
            health_metrics={"offload": {
                "degraded": True,
                "last_error": "RuntimeError: injected device failure"},
                "degraded_pgs": 2, "store": {"utilization": 0.91}},
            progress=[{"id": "recovery-1.3", "message": "recovery pg 1.3",
                       "progress": 0.5}]),
    _report("osd.2", schema=_SCHEMA, counters=_COUNTERS,
            device_metrics=_device_rows("cuda:0", 0.25),
            health_metrics={"offload": {"degraded": False},
                            "store": {"utilization": 0.97}}),
    _report("mon.a", schema={"elections": {"type": "u64"}},
            counters={"elections": 2}),
]
HEALTH = {"status": "HEALTH_WARN",
          "checks": {"OSD_DOWN": {"severity": "HEALTH_WARN",
                                  "summary": "1 osds down"}},
          "muted": {"SLOW_OPS": {"expires_in_s": 5}}}


@pytest.fixture
def frozen_clock(monkeypatch):
    """One monotonic instant for both packages' mgr modules, so report
    ages and history stamps render alike."""
    import types

    from ceph_tpu.mgr import daemon as ref_daemon
    from ceph_tpu.mgr import history as ref_history
    from ceph_tpu_torch.mgr import daemon, history
    clock = types.SimpleNamespace(monotonic=lambda: 1000.0)
    for mod in (ref_daemon, ref_history, daemon, history):
        monkeypatch.setattr(mod, "time", clock)


def _indexes():
    ref, port = RefDaemonStateIndex(), DaemonStateIndex()
    for r in REPORTS:
        ref.report(json.loads(json.dumps(r)))
        port.report(json.loads(json.dumps(r)))
    return ref, port


def test_rendered_metrics_equal_to_the_reference(frozen_clock):
    ref, port = _indexes()
    text = render_metrics(HEALTH, index=port)
    assert text == ref_render_metrics(HEALTH, index=ref)
    for osd in ("osd.0", "osd.1", "osd.2"):
        assert (f'ceph_offload_device_busy_seconds{{ceph_daemon="{osd}",'
                f'ceph_device="cuda:0"}}') in text
    assert text.count("# TYPE ceph_offload_device_batches ") == 1


def _digest(mgr_cls, index) -> dict:
    mgr = mgr_cls.__new__(mgr_cls)        # digest logic only, no I/O
    mgr.name = "x"
    mgr.daemon_index = index
    return mgr._build_digest()


def test_digest_equal_to_the_reference(frozen_clock):
    ref, port = _indexes()
    digest = _digest(MgrDaemon, port)
    assert json.dumps(digest, sort_keys=True) == \
        json.dumps(_digest(RefMgrDaemon, ref), sort_keys=True)
    check = digest["checks"]["TPU_OFFLOAD_DEGRADED"]
    assert [d.split(":")[0] for d in check["detail"]] == ["osd.1"]
    # the tripped service clears: the check goes, in both packages alike
    clear = _report("osd.1", health_metrics={"offload": {"degraded": False}})
    ref.report(dict(clear))
    port.report(dict(clear))
    digest = _digest(MgrDaemon, port)
    assert "TPU_OFFLOAD_DEGRADED" not in digest["checks"]
    assert json.dumps(digest, sort_keys=True) == \
        json.dumps(_digest(RefMgrDaemon, ref), sort_keys=True)
