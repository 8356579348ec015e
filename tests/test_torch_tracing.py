"""The port's observability modules against the JAX package's, on the CPU:
the pure cases of tests/test_tracing_v2.py (head sampling, the no-op when
every regime is off, tail promotion, the bounded reservoir, one-way
promotion, the config knobs, the critical path's exact sum and the
waterfall), tests/test_flight.py (the ring, filters, cursors, snapshots,
the cross-process merge, the anchors, the config knobs and the capacity
floor) and tests/test_attribution.py (the copy ledger's totals and perf
mirror, the attribution waterfall through each package's
`bench_driver.attribution_from_spans`).

Each case runs once through each package, with that package's
assertions, and returns what it observed; the two observations must be
equal."""
from __future__ import annotations

import time
import types

import pytest

from ceph_tpu.tools import bench_driver as ref_bench_driver
from ceph_tpu.utils import config as ref_config
from ceph_tpu.utils import copytrack as ref_copytrack
from ceph_tpu.utils import critpath as ref_critpath
from ceph_tpu.utils import flight as ref_flight
from ceph_tpu.utils import tracer as ref_tracer
from ceph_tpu.utils.perf_counters import (
    PerfCountersCollection as RefPerfCountersCollection)
from ceph_tpu_torch.tools import bench_driver
from ceph_tpu_torch.utils import config, copytrack, critpath, flight, tracer
from ceph_tpu_torch.utils.perf_counters import PerfCountersCollection

PKGS = {
    "ref": types.SimpleNamespace(
        tracer=ref_tracer, critpath=ref_critpath, flight=ref_flight,
        copytrack=ref_copytrack, Config=ref_config.Config,
        bench_driver=ref_bench_driver, perf=RefPerfCountersCollection),
    "port": types.SimpleNamespace(
        tracer=tracer, critpath=critpath, flight=flight,
        copytrack=copytrack, Config=config.Config,
        bench_driver=bench_driver, perf=PerfCountersCollection),
}


def _clean(m) -> None:
    m.tracer.disable()
    m.tracer.set_sampling(rate=0.0, tail_slow_ms=0.0)
    m.tracer.set_profile_dispatch(False)
    m.tracer.reset()
    m.flight.configure(enabled=True, capacity=m.flight.DEFAULT_CAPACITY)
    m.flight.reset()
    m.flight.clear_snapshots()
    m.copytrack.reset()


@pytest.fixture(autouse=True)
def clean_state():
    for m in PKGS.values():
        _clean(m)
    yield
    for m in PKGS.values():
        _clean(m)


def _collected(m) -> list[dict]:
    return [s for t in m.tracer.dump()["traces"] for s in t["spans"]]


def _names(m) -> list[str]:
    return sorted(s["name"] for s in _collected(m))


# -- tracing v2: sampling policy ----------------------------------------------

def case_head_sampling_decided_once_at_root(m):
    tr = m.tracer
    tr.set_sampling(rate=1.0)
    assert tr.active() and not tr.enabled()
    with tr.span("rados_op") as root:
        assert root.flags & tr.FLAG_SAMPLED
        assert tr.current_context()["f"] & tr.FLAG_SAMPLED
        tr.set_sampling(rate=0.0, tail_slow_ms=1000.0)     # hot flip
        with tr.span("osd_op") as child:
            assert child.flags & tr.FLAG_SAMPLED           # inherited
    first = _names(m)
    assert first == ["osd_op", "rados_op"]
    tr.reset()
    tr.set_sampling(rate=0.0, tail_slow_ms=10_000.0)
    with tr.span("rados_op") as root:
        assert not (root.flags & tr.FLAG_SAMPLED)
        tr.set_sampling(rate=1.0)
        with tr.span("osd_op") as child:
            assert not (child.flags & tr.FLAG_SAMPLED)
    assert _collected(m) == []          # skeleton only, never promoted
    return first


def case_noop_when_all_regimes_off(m):
    tr = m.tracer
    assert not tr.active()
    assert tr.span("x") is tr._NOOP
    assert tr.start_span("x") is None
    assert tr.current_context() is None
    return [tr.active(), tr.start_span("x"), tr.current_context()]


def case_tail_promotes_slow_and_errored_traces(m):
    tr = m.tracer
    tr.set_sampling(rate=0.0, tail_slow_ms=1.0)
    with tr.span("rados_op"):
        with tr.span("store_commit"):
            time.sleep(0.003)
    slow = _names(m)
    assert slow == ["rados_op", "store_commit"]
    tr.reset()
    tr.set_sampling(rate=0.0, tail_slow_ms=10_000.0)
    with pytest.raises(RuntimeError):
        with tr.span("rados_op"):
            raise RuntimeError("boom")
    spans = _collected(m)
    assert len(spans) == 1 and "error" in spans[0]["tags"]
    errored = spans[0]["tags"]["error"]
    tr.reset()
    with tr.span("rados_op"):
        pass
    assert _collected(m) == []
    assert tr.sampling()["reservoir"]["promoted"] == 0
    return [slow, errored]


def case_tail_reservoir_is_bounded_lru(m):
    tr = m.tracer
    tr.set_sampling(rate=0.0, tail_slow_ms=10_000.0)
    for _ in range(300):
        with tr.span("rados_op"):
            pass
    res = tr.sampling()["reservoir"]
    assert res["traces"] <= 256
    assert res["evicted"] > 0
    assert _collected(m) == []
    # ids are random, so the split between stripes is: every trace is
    # kept or evicted, none promoted
    return [res["traces"] + res["evicted"], res["promoted"]]


def case_promoted_trace_routes_later_spans_directly(m):
    tr = m.tracer
    tr.set_sampling(rate=0.0, tail_slow_ms=1.0)
    with tr.span("rados_op") as root:
        ctx = root.context()
        with tr.span("osd_op"):
            time.sleep(0.002)
    counts = [len(_collected(m))]
    late = tr.start_span("ms_dispatch", parent=ctx)
    late.finish()
    counts.append(len(_collected(m)))
    assert counts == [2, 3]
    return counts


def case_sampling_knobs_hot_toggle_via_config(m):
    tr = m.tracer
    cfg = m.Config()
    tr.register_config(cfg)
    seen = [tr.active()]
    cfg.set("tracer_sample_rate", 1.0)
    seen += [tr.active(), tr.sampling()["sample_rate"],
             tr.profile_dispatch()]
    cfg.set("tracer_tail_slow_ms", 25.0)
    seen += [tr.sampling()["tail_slow_ms"], tr.profile_dispatch()]
    cfg.set("tracer_sample_rate", 0.0)
    cfg.set("tracer_tail_slow_ms", 0.0)
    seen.append(tr.active())
    assert seen == [False, True, 1.0, False, 25.0, False, False]
    return [seen, sorted(cfg.show())]


# -- tracing v2: critical path and waterfall ----------------------------------

def _mkspan(tid, sid, parent, name, start, dur_us, tags=None):
    return {"trace_id": tid, "span_id": sid, "parent_id": parent,
            "name": name, "service": "", "start": start,
            "duration_us": float(dur_us), "tags": tags or {}, "seq": 0}


def case_critical_path_stages_sum_exactly_to_total(m):
    spans = [
        _mkspan("t1", "r", None, "rados_op", 0.0, 10_000,
                {"ops": "write", "client": "c9"}),
        _mkspan("t1", "o", "r", "osd_op", 0.001, 8_000,
                {"queue_wait_us": 1_500.0}),
        _mkspan("t1", "e", "o", "ec_encode", 0.002, 3_000),
        _mkspan("t1", "d", "e", "tpu_encode_dispatch", 0.003, 2_000,
                {"h2d_us": 400.0, "kernel_us": 1_000.0, "d2h_us": 300.0}),
        _mkspan("t1", "c", "o", "store_commit", 0.004, 2_500),
    ]
    cp = m.critpath.critical_path(spans)
    assert cp["total_us"] == 10_000
    assert cp["op_class"] == "write" and cp["client"] == "c9"
    st = cp["stages"]
    assert sum(st.values()) == pytest.approx(cp["total_us"], abs=0.01)
    assert st["queue_wait"] == 1_500
    assert st["h2d"] == 400 and st["kernel"] == 1_000 and st["d2h"] == 300
    assert st["encode"] == pytest.approx(3_000 - 1_700, abs=0.01)
    assert st["commit"] == 2_500
    assert cp["top_stage"] == "commit"
    spans2 = [
        _mkspan("t2", "r", None, "rados_op", 0.0, 1_000, {"ops": "read"}),
        _mkspan("t2", "d", "r", "tpu_decode_dispatch", 0.001, 900),
        _mkspan("t2", "c", "r", "store_commit", 0.002, 400),
    ]
    cp2 = m.critpath.critical_path(spans2)
    assert sum(cp2["stages"].values()) == pytest.approx(1_000, abs=0.01)
    assert cp2["stages"]["kernel"] > 0 and cp2["stages"]["other"] >= 0
    return [cp, cp2]


def case_waterfall_rows_and_depths(m):
    spans = [
        _mkspan("t1", "r", None, "rados_op", 100.0, 5_000),
        _mkspan("t1", "a", "r", "osd_op", 100.001, 3_000),
        _mkspan("t1", "b", "a", "store_commit", 100.002, 1_000),
    ]
    rows = m.critpath.waterfall(spans)
    assert [r["depth"] for r in rows] == [0, 1, 2]
    assert rows[0]["offset_us"] == 0.0
    assert rows[1]["offset_us"] == pytest.approx(1_000, rel=0.01)
    assert all(r["on_critical_path"] for r in rows)
    return rows


# -- flight recorder ----------------------------------------------------------

def _events(ring) -> list[tuple]:
    return [(e["type"], e["entity"], e["detail"]) for e in ring["events"]]


def case_ring_evicts_oldest_past_capacity(m):
    fl = m.flight
    fl.configure(capacity=8)
    seq0 = fl.last_seq()
    for i in range(20):
        fl.record("tick", f"e{i}", i=i)
    ring = fl.dump()
    assert len(ring["events"]) == 8
    assert [e["detail"]["i"] for e in ring["events"]] == list(range(12, 20))
    assert ring["dropped"] == 12
    st = fl.status()
    assert st["events"] == 8 and st["dropped"] == 12
    assert st["seq"] == seq0 + 20
    return [_events(ring), st["capacity"], st["dropped"]]


def case_shrinking_capacity_trims_live_ring(m):
    fl = m.flight
    fl.configure(capacity=64)
    for i in range(30):
        fl.record("tick", "e", i=i)
    fl.configure(capacity=10)
    ring = fl.dump()
    assert len(ring["events"]) == 10
    assert ring["events"][0]["detail"]["i"] == 20
    return _events(ring)


def case_disabled_recorder_records_nothing(m):
    fl = m.flight
    fl.configure(enabled=False)
    assert fl.record("tick", "e") is None
    assert fl.dump()["events"] == []
    fl.configure(enabled=True)
    ev = fl.record("tick", "e")
    assert ev is not None
    return [ev["type"], ev["entity"], ev["detail"]]


def case_dump_filters_by_type_and_entity(m):
    fl = m.flight
    fl.record("slow_op", "osd.0", duration_s=1.0)
    fl.record("slow_op", "osd.1", duration_s=2.0)
    fl.record("breaker_trip", "cuda:0")
    assert len(fl.dump("slow_op")["events"]) == 2
    assert len(fl.dump(None, "osd.1")["events"]) == 1
    only = fl.dump("slow_op", "osd.0")["events"]
    assert len(only) == 1 and only[0]["detail"]["duration_s"] == 1.0
    return [_events(fl.dump("slow_op")), _events(fl.dump(None, "osd.1")),
            _events(fl.dump("slow_op", "osd.0"))]


def case_events_since_cursor_ships_only_the_tail(m):
    fl = m.flight
    for i in range(5):
        fl.record("tick", "e", i=i)
    cursor = fl.last_seq()
    assert fl.events_since(cursor)["events"] == []
    fl.record("tick", "e", i=5)
    fl.record("tick", "e", i=6)
    tail = fl.events_since(cursor)["events"]
    assert [e["detail"]["i"] for e in tail] == [5, 6]
    ring = fl.events_since(0)
    assert "mono_now" in ring and "wall_now" in ring and "boot" in ring
    return [[e["detail"]["i"] for e in tail], sorted(ring)]


def case_reset_clears_ring_but_keeps_snapshots(m):
    fl = m.flight
    fl.record("tick", "e")
    fl.snapshot("incident")
    out = fl.reset()
    assert out["cleared"] == 1
    assert fl.dump()["events"] == []
    snaps = fl.snapshots()
    assert len(snaps) == 1 and snaps[0]["reason"] == "incident"
    assert len(snaps[0]["events"]) == 1
    return [out, [(s["reason"], _events(s)) for s in snaps]]


def case_snapshot_store_is_bounded(m):
    fl = m.flight
    for i in range(fl.MAX_SNAPSHOTS + 5):
        fl.snapshot(f"s{i}")
    snaps = fl.snapshots()
    assert len(snaps) == fl.MAX_SNAPSHOTS
    assert snaps[-1]["reason"] == f"s{fl.MAX_SNAPSHOTS + 4}"
    return [s["reason"] for s in snaps]


def _ring(boot, offset_wall, events):
    mono_now = 1000.0
    return {"pid": 1, "boot": boot, "mono_now": mono_now,
            "wall_now": mono_now + offset_wall, "dropped": 0,
            "enabled": True, "capacity": 512,
            "events": [dict(e) for e in events]}


def case_merge_orders_across_processes_by_estimated_wall(m):
    a = _ring("a", 5_000.0, [
        {"seq": 1, "mono": 10.0, "wall": 0.0, "type": "inject",
         "entity": "x", "detail": {}},
        {"seq": 2, "mono": 30.0, "wall": 0.0, "type": "recover",
         "entity": "x", "detail": {}}])
    b = _ring("b", 5_000.0, [
        {"seq": 1, "mono": 20.0, "wall": 0.0, "type": "trip",
         "entity": "y", "detail": {}}])
    merged = m.flight.merge_timelines([a, b])
    assert [e["type"] for e in merged] == ["inject", "trip", "recover"]
    assert all("t_est" in e for e in merged)
    return merged


def case_merge_survives_wall_clock_jump_mono_is_authoritative(m):
    events = [
        {"seq": 1, "mono": 10.0, "wall": 10_000.0, "type": "before",
         "entity": "", "detail": {}},
        {"seq": 2, "mono": 20.0, "wall": 6_400.0, "type": "after",
         "entity": "", "detail": {}},
    ]
    merged = m.flight.merge_timelines([_ring("a", 5_000.0, events)])
    assert [e["type"] for e in merged] == ["before", "after"]
    assert merged[0]["t_est"] < merged[1]["t_est"]
    assert merged[1]["t_est"] - merged[0]["t_est"] == pytest.approx(10.0)
    return merged


def case_merge_dedups_same_ring_seen_twice(m):
    ev = [{"seq": 1, "mono": 1.0, "wall": 0.0, "type": "t",
           "entity": "", "detail": {}}]
    merged = m.flight.merge_timelines(
        [_ring("a", 0.0, ev), _ring("a", 0.0, ev)])
    assert len(merged) == 1
    return merged


def case_merge_tolerates_malformed_rings(m):
    ok = _ring("a", 0.0, [{"seq": 1, "mono": 1.0, "wall": 0.0,
                           "type": "t", "entity": "", "detail": {}}])
    merged = m.flight.merge_timelines(
        [None, "junk", {}, {"mono_now": "x", "wall_now": 0},
         {"mono_now": 0.0, "wall_now": 0.0, "events": [None, {"a": 1}]},
         ok])
    assert len(merged) == 1
    return merged


def case_live_dump_anchor_matches_local_clocks(m):
    m.flight.record("tick", "e")
    ring = m.flight.dump()
    assert abs(ring["mono_now"] - time.monotonic()) < 5.0
    assert abs(ring["wall_now"] - time.time()) < 5.0
    return [sorted(ring), _events(ring)]


def case_flight_config_knobs_hot_apply_and_replay(m):
    fl = m.flight
    cfg = m.Config()
    fl.register_config(cfg)
    cfg.set("flight_ring_capacity", 16)
    assert fl.status()["capacity"] == 16
    cfg.set("flight_enabled", False)
    assert fl.record("tick", "e") is None
    cfg.set("flight_enabled", True)
    assert fl.record("tick", "e") is not None
    cfg2 = m.Config()
    fl.register_config(cfg2)
    cfg2.set("flight_ring_capacity", 32)
    fl.register_config(cfg2)
    assert fl.status()["capacity"] == 32
    changes = fl.dump("config_change")["events"]
    assert any(e["entity"] == "flight_ring_capacity"
               and e["detail"]["new"] == 32 for e in changes)
    return [fl.status()["capacity"], _events(fl.dump())]


def case_capacity_floor_is_enforced(m):
    m.flight.configure(capacity=1)
    assert m.flight.status()["capacity"] == 8
    return m.flight.status()["capacity"]


# -- the copy ledger and the attribution waterfall ----------------------------

def case_ledger_amplification_and_totals(m):
    ct = m.copytrack
    ct.copied("h2d", 300, 0.001)
    ct.referenced("buffer_to_staging", 1000)
    ct.copied("d2h", 100)
    assert ct.amplification(100) == 4.0
    assert ct.amplification(0) == 0.0
    snap = ct.snapshot()
    assert snap["copied_bytes_total"] == 400
    assert snap["referenced_bytes_total"] == 1000
    assert snap["copy_seconds_total"] == pytest.approx(0.001)
    return snap


def case_ledger_perf_counter_mirror_syncs_on_dump(m):
    pc = m.copytrack.perf()
    assert m.perf.instance().get("copyflow") is pc
    m.copytrack.copied("h2d", 128, 0.002)
    dump = pc.dump()
    assert dump["copied_bytes_h2d"] == 128
    assert dump["copy_micros_h2d"] == 2000
    m.copytrack.reset()
    after = pc.dump()
    assert after["copied_bytes_h2d"] == 0
    return [dump, after, pc.schema()]


def _span(trace, name, dur, **tags):
    return {"trace_id": trace, "name": name, "duration_us": dur,
            "tags": tags}


def case_attribution_buckets_sum_to_op_total(m):
    spans = [
        _span("t1", "osd_op", 1000.0, queue_wait_us=200.0),
        _span("t1", "offload_batch", 300.0, copy_us=50.0),
        _span("t1", "tpu_encode_dispatch", 400.0, h2d_us=100.0,
              kernel_us=250.0, d2h_us=50.0),
        _span("t1", "store_commit", 150.0),
        _span("t1", "store_commit", 120.0),
        _span("t2", "offload_batch", 10.0),
    ]
    bd = m.bench_driver
    att = bd.attribution_from_spans(spans)
    assert att["ops"] == 1
    assert att["op_total_us"] == 1200.0
    b = att["buckets_us"]
    assert b == {"queue_wait": 200.0, "copy": 50.0, "h2d": 100.0,
                 "kernel": 250.0, "d2h": 50.0, "commit": 150.0,
                 "other": 400.0}
    total = sum(b[k] for k in bd.ATTRIBUTION_BUCKETS)
    assert total == pytest.approx(att["op_total_us"], rel=0.10)
    assert att["attributed_fraction"] == pytest.approx(800.0 / 1200.0,
                                                       abs=1e-4)
    assert sum(att["bucket_pct"].values()) == pytest.approx(100.0, abs=0.5)
    return [att, bd.ATTRIBUTION_BUCKETS]


def case_attribution_empty_and_multi_op(m):
    bd = m.bench_driver
    assert bd.attribution_from_spans([])["ops"] == 0
    spans = [
        _span("t1", "osd_op", 500.0, queue_wait_us=100.0),
        _span("t2", "osd_op", 700.0),
        _span("t2", "store_commit", 200.0),
    ]
    att = bd.attribution_from_spans(spans)
    assert att["ops"] == 2
    assert att["op_total_us"] == pytest.approx((600.0 + 700.0) / 2)
    assert att["buckets_us"]["queue_wait"] == pytest.approx(50.0)
    assert att["buckets_us"]["commit"] == pytest.approx(100.0)
    return [bd.attribution_from_spans([]), att]


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_observes_what_the_reference_observes(case):
    ref = CASES[case](PKGS["ref"])
    _clean(PKGS["ref"])
    port = CASES[case](PKGS["port"])
    assert port == ref
