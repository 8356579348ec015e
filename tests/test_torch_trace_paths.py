"""The port's traced device path against the JAX package's, on the CPU:
the same ECUtil encode / decode / recover calls and one small offload
service pass (with an oversized write through the mesh) go through both
packages with tracing on, dispatch profiling off and then on. For both:
the span names, parent names and tag keys are equal, the non-timing tag
values are equal, the critical-path stages and op classes are equal,
and the copy ledger moves the same bytes through each stage. A break of
one slot's dispatch records the same flight events in both.

The reference's service runs on the conftest's 8 virtual JAX CPU
devices, the port's on `devices=["cpu"] * 8`. The port stacks a lone job
into its slot's staging page where the reference hands it through by
reference, so the ledger is compared per stage on copied plus
referenced bytes, and the copy split of `buffer_to_staging` is checked
on its own."""
import asyncio
import json

import numpy as np
import pytest
import torch

from ceph_tpu import offload as ref_offload
from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.osd import ec_util as ref_ec_util
from ceph_tpu.utils import copytrack as ref_copytrack
from ceph_tpu.utils import critpath as ref_critpath
from ceph_tpu.utils import flight as ref_flight
from ceph_tpu.utils import tracer as ref_tracer
from ceph_tpu.utils.checksummer import Checksummer as RefChecksummer
from ceph_tpu_torch import device, offload
from ceph_tpu_torch.ec.registry import factory
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.utils import copytrack, critpath, flight, tracer
from ceph_tpu_torch.utils.checksummer import Checksummer

K, M, CHUNK = 4, 2, 1024
CPU8 = ["cpu"] * 8
RNG = np.random.default_rng(61)
WRITES = [RNG.integers(0, 256, 2 * K * CHUNK, dtype=np.uint8).tobytes()
          for _ in range(3)]
BIG = RNG.integers(0, 256, 64 * K * CHUNK, dtype=np.uint8).tobytes()
BLOCKS = RNG.integers(0, 256, 3 * 4096, dtype=np.uint8).tobytes()
LOST = ((1,), (0, K + 1))
#: tags whose values do not depend on timing or on the package's device
#: naming; every other tag is compared by key only
VALUE_TAGS = ("bytes", "ops", "k", "m", "want", "batch_ops", "mode",
              "batch", "stripes", "missing", "need", "helpers", "chunks",
              "sub_chunks", "offload", "batched")
TIMED_TAGS = ("h2d_us", "kernel_us", "d2h_us")

PKGS = {
    "ref": {"tracer": ref_tracer, "critpath": ref_critpath,
            "copytrack": ref_copytrack, "flight": ref_flight,
            "ec_util": ref_ec_util},
    "port": {"tracer": tracer, "critpath": critpath,
             "copytrack": copytrack, "flight": flight,
             "ec_util": ec_util},
}


def run(coro, timeout=60.0):
    async def bounded():
        return await asyncio.wait_for(coro, timeout)
    return asyncio.run(bounded())


def _impl(pkg):
    if pkg == "ref":
        return ref_registry.factory("tpu", {"k": str(K), "m": str(M)})
    return factory("cuda", {"k": str(K), "m": str(M), "device": "cpu"})


def _reset(mods) -> None:
    mods["tracer"].disable()
    mods["tracer"].set_profile_dispatch(False)
    mods["tracer"].reset()
    mods["copytrack"].reset()
    mods["flight"].reset()


@pytest.fixture(autouse=True)
def clean_state():
    for mods in PKGS.values():
        _reset(mods)
    yield
    for mods in PKGS.values():
        _reset(mods)


def _spans(mods) -> list[dict]:
    return [s for t in mods["tracer"].dump()["traces"] for s in t["spans"]]


def _signature(spans: list[dict]) -> list[tuple]:
    """Per span: name, parent's name, tag keys, non-timing tag values and
    link count; sorted, since concurrent batches finish in any order."""
    by_id = {s["span_id"]: s for s in spans}
    sig = []
    for s in spans:
        parent = by_id.get(s["parent_id"])
        tags = s["tags"]
        values = {k: tags[k] for k in VALUE_TAGS if k in tags}
        sig.append((s["name"], parent["name"] if parent else "",
                    tuple(sorted(tags)),
                    json.dumps(values, sort_keys=True, default=int),
                    len(s.get("links") or ())))
    return sorted(sig)


def _critpaths(mods, spans: list[dict]) -> list[tuple]:
    by_trace: dict[str, list[dict]] = {}
    for s in spans:
        by_trace.setdefault(s["trace_id"], []).append(s)
    out = []
    for ss in by_trace.values():
        cp = mods["critpath"].critical_path(ss)
        assert sum(cp["stages"].values()) == pytest.approx(cp["total_us"],
                                                           abs=0.11)
        out.append((cp["op_class"], tuple(cp["stages"])))
    return sorted(out)


def _ledger(mods) -> dict:
    snap = mods["copytrack"].snapshot()["stages"]
    return {st: d["copied_bytes"] + d["referenced_bytes"]
            for st, d in snap.items()}


def _traced(pkg, profile: bool, body) -> dict:
    """body(pkg) with the package's tracer on; returns what it returned
    and the trace's and ledger's comparable forms."""
    mods = PKGS[pkg]
    mods["tracer"].enable()
    mods["tracer"].set_profile_dispatch(profile)
    try:
        out = body(pkg)
    finally:
        mods["tracer"].disable()
    spans = _spans(mods)
    return {"out": out, "spans": spans, "sig": _signature(spans),
            "critpath": _critpaths(mods, spans), "ledger": _ledger(mods),
            "snapshot": mods["copytrack"].snapshot()["stages"]}


def _assert_same_trace(ref: dict, port: dict, profile: bool) -> None:
    assert port["out"] == ref["out"]
    assert port["sig"] == ref["sig"]
    assert port["critpath"] == ref["critpath"]
    assert port["ledger"] == ref["ledger"]
    timed = [s for s in port["spans"]
             if any(t in s["tags"] for t in TIMED_TAGS)]
    if not profile:
        assert timed == []
        return
    assert timed
    for s in timed:
        legs = [s["tags"][t] for t in TIMED_TAGS]
        assert all(v >= 0.0 for v in legs)
        # the legs follow one another inside the span (each of the four
        # figures is rounded to 0.1 us)
        assert sum(legs) <= s["duration_us"] + 0.2, s


def _plain(shards) -> dict:
    return {i: bytes(b) for i, b in shards.items()}


def _ecutil_calls(pkg) -> dict:
    ecu = PKGS[pkg]["ec_util"]
    impl = _impl(pkg)
    sinfo = ecu.StripeInfo(K, K * CHUNK)
    out = {}
    # a one-stripe write: its planes go out by reference, zero-copy
    for w, data in enumerate((WRITES[0], WRITES[1][:K * CHUNK])):
        shards = _plain(ecu.encode(sinfo, impl, data))
        out[("encode", w)] = shards
        for lost in LOST:
            have = {i: b for i, b in shards.items() if i not in lost}
            out[("concat", w, lost)] = ecu.decode_concat(sinfo, impl, have)
            out[("shards", w, lost)] = _plain(ecu.decode_shards(
                sinfo, impl, have, lost))
    return out


@pytest.mark.parametrize("profile", [False, True], ids=["plain", "profiled"])
def test_ecutil_traces_match_reference(profile):
    """Inline ECUtil calls: ec_encode / ec_decode / ec_recover over the
    plugin's tpu_*_dispatch spans (host mode, legs timed when
    profiling)."""
    ref = _traced("ref", profile, _ecutil_calls)
    port = _traced("port", profile, _ecutil_calls)
    _assert_same_trace(ref, port, profile)
    names = {s[0] for s in port["sig"]}
    assert names == {"ec_encode", "ec_decode", "ec_recover",
                     "tpu_encode_dispatch", "tpu_decode_dispatch"}
    assert port["snapshot"] == {
        st: dict(d, copy_seconds=port["snapshot"][st]["copy_seconds"])
        for st, d in ref["snapshot"].items()}


async def _service_pass(svc, impl, ecu, checksummer) -> dict:
    """Concurrent encode_async / decode_concat_async /
    decode_shards_async / calculate_async, then one oversized write
    through the mesh."""
    sinfo = ecu.StripeInfo(K, K * CHUNK)
    enc = await asyncio.gather(*[ecu.encode_async(sinfo, impl, w,
                                                  service=svc)
                                 for w in WRITES])
    enc = [_plain(e) for e in enc]
    haves = [({i: b for i, b in sh.items() if i not in lost}, lost)
             for sh in enc for lost in LOST]
    concat, rebuilt, csums = await asyncio.gather(
        asyncio.gather(*[ecu.decode_concat_async(sinfo, impl, h,
                                                 service=svc)
                         for h, _ in haves]),
        asyncio.gather(*[ecu.decode_shards_async(sinfo, impl, h, lost,
                                                 service=svc)
                         for h, lost in haves]),
        asyncio.gather(checksummer.calculate_async(BLOCKS, service=svc),
                       checksummer.calculate_async(
                           [BLOCKS[:4096], BLOCKS[4096:]], service=svc)))
    big = _plain(await ecu.encode_async(sinfo, impl, BIG, service=svc))
    await asyncio.sleep(0)
    await svc.drain()
    return {"encode": enc, "concat": concat,
            "rebuilt": [_plain(r) for r in rebuilt],
            "csums": [c.tolist() for c in csums], "big": big,
            "stats": {k: svc.stats[k] for k in
                      ("jobs", "batches", "coalesced_ops", "fallback_ops",
                       "mesh_batches")}}


def _service_calls(pkg) -> dict:
    async def body():
        if pkg == "ref":
            svc = ref_offload.get_service()
            checksummer = RefChecksummer("crc32c", 4096)
        else:
            svc = offload.get_service(devices=CPU8)
            checksummer = Checksummer("crc32c", 4096)
        svc.linger_ms = 25.0
        svc.device_shard_bytes = 128 * 1024
        return await _service_pass(svc, _impl(pkg), PKGS[pkg]["ec_util"],
                                   checksummer)
    return run(body(), timeout=120)


@pytest.mark.parametrize("profile", [False, True], ids=["plain", "profiled"])
def test_service_pass_traces_match_reference(profile):
    """One service pass: offload_queue_wait (batch_ops) and offload_batch
    (ops, bytes, links; legs when profiling) under the callers' ec_*
    spans, the plugin's device-mode dispatch spans under offload_batch
    (the executor runs in the caller's context), the mesh batch's
    transfers in the ledger."""
    ref = _traced("ref", profile, _service_calls)
    port = _traced("port", profile, _service_calls)
    _assert_same_trace(ref, port, profile)
    stats = port["out"]["stats"]
    assert stats["mesh_batches"] == 1 and stats["fallback_ops"] == 0
    parents = {(s[0], s[1]) for s in port["sig"]}
    assert ("tpu_encode_dispatch", "offload_batch") in parents
    assert ("tpu_decode_dispatch", "offload_batch") in parents
    assert ("offload_queue_wait", "ec_encode") in parents
    assert ("offload_batch", "ec_encode") in parents
    batches = [s for s in port["spans"] if s["name"] == "offload_batch"]
    assert sum(s["tags"]["ops"] for s in batches) == stats["jobs"]
    assert len(batches) == stats["batches"]
    # the port stacks every device batch into its slot's page: copied
    staging = port["snapshot"]["buffer_to_staging"]
    assert staging["referenced_bytes"] == 0
    assert staging["copied_bytes"] == ref["ledger"]["buffer_to_staging"]
    # every byte sent to a slot went up, every result byte came down
    up = sum(s["tags"]["bytes"] for s in batches
             if s["tags"]["device"] != "host")
    assert port["ledger"]["h2d"] == up


def _break_one_slot(pkg) -> list[tuple]:
    """One slot's dispatch raises: the batch fails over, the slot's
    breaker trips. Returns the flight events (type, entity, detail)."""
    async def body():
        impl = _impl(pkg)
        if pkg == "ref":
            svc = ref_offload.get_service()
        else:
            svc = offload.get_service(devices=CPU8)
        slots = svc._topology()
        key = ("enc", impl.coding_matrix.tobytes(), CHUNK)
        victim = slots[hash(key) % len(slots)]
        orig = svc._device_call

        async def boom(slot, fn, stacked, *rest):
            if slot is victim:
                raise RuntimeError("card down")
            return await orig(slot, fn, stacked, *rest)
        svc._device_call = boom
        ecu = PKGS[pkg]["ec_util"]
        out = await ecu.encode_async(ecu.StripeInfo(K, K * CHUNK), impl,
                                     WRITES[0], service=svc)
        await asyncio.sleep(0)
        await svc.drain()
        assert svc.stats["fallback_ops"] == 0
        return _plain(out)
    out = run(body())
    events = [(e["type"], e["entity"], e["detail"])
              for e in PKGS[pkg]["flight"].dump()["events"]]
    return out, events


def test_slot_break_records_the_reference_flight_events():
    ref_out, ref_events = _break_one_slot("ref")
    out, events = _break_one_slot("port")
    assert out == ref_out
    assert events == ref_events
    assert [e[0] for e in events] == ["breaker_trip", "device_failover"]
    assert events[0][2]["error"] == "RuntimeError: card down"
    assert events[0][2]["all_degraded"] is False
    assert events[1][1] != events[1][2]["to"]


def test_legs_are_timed_on_the_stream_each_runs_on(monkeypatch):
    """On a card each leg is a pair of CUDA events recorded on the stream
    given for it (not the thread's current one), read after the
    synchronize; an unprofiled call creates no event."""
    recorded = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.at = None

        def record(self, stream=None):
            recorded.append(stream)
            self.at = len(recorded)

        def elapsed_time(self, end):         # ms
            return float(end.at - self.at)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    for which in (device.H2D, device.KERNEL, device.D2H):
        with device.leg(None, which, "copy"):
            pass
    assert recorded == []
    legs = device.Legs(torch.device("cuda", 1))
    for which, stream in ((device.H2D, "copy"), (device.KERNEL, "compute"),
                          (device.D2H, "copy"), (device.KERNEL, "compute")):
        with device.leg(legs, which, stream):
            pass
    assert recorded == ["copy", "copy", "compute", "compute", "copy", "copy",
                        "compute", "compute"]
    assert legs.read() == [0.001, 0.002, 0.001]
    assert legs.read() == [0.001, 0.002, 0.001]     # read once per event
