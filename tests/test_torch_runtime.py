"""The port's runtime substrate (ceph_tpu_torch/utils/{buffer,
admin_socket,throttle,crash}.py) and the offload service's config and
cross-loop seams, against the JAX package's, on the CPU: the BufferList
cases of tests/test_utils.py:24-60, the admin socket (:187), the
Throttle and HeartbeatMap (:217, :240), crash records, the
`ec_offload_*` schema and its hot-apply into a live service, `status`
and `flush` from a foreign thread, and sanitizer.unwrap at ECUtil's
three numpy boundaries (a stale guarded view raises; a live one decodes
equal to the reference)."""
import asyncio
import threading
import time

import numpy as np
import pytest
import torch

from ceph_tpu import offload as ref_offload
from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.native import ec_native as ref_ec_native
from ceph_tpu.osd import ec_util as ref_ec_util
from ceph_tpu.utils.buffer import BufferList as RefBufferList
from ceph_tpu_torch import offload
from ceph_tpu_torch.ec.registry import factory
from ceph_tpu_torch.native import ec_native
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.utils import crash, flight, sanitizer
from ceph_tpu_torch.utils.admin_socket import (VERSION, AdminSocket,
                                               admin_command)
from ceph_tpu_torch.utils.buffer import BufferList
from ceph_tpu_torch.utils.config import Config, Option
from ceph_tpu_torch.utils.perf_counters import PerfCountersCollection
from ceph_tpu_torch.utils.throttle import HeartbeatMap, Throttle

CPU8 = ["cpu"] * 8


def run(coro, timeout=30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@pytest.fixture(autouse=True)
def _port_gates():
    """The port's own leak gates (tests/conftest.py gates the
    reference's modules)."""
    yield
    from ceph_tpu_torch.utils import loopprof
    assert not loopprof.installed_loops(), "port loopprof left armed"
    strays = sanitizer.take_foreign_call_soon()
    assert not strays, f"port sanitizer saw foreign call_soon: {strays}"


# -- bufferlist ------------------------------------------------------------------

def test_bufferlist_append_and_substr():
    bl = BufferList(b"hello ")
    bl.append(b"world")
    assert len(bl) == 11
    assert bl.to_bytes() == b"hello world"
    sub = bl.substr(3, 5)
    assert sub.to_bytes() == b"lo wo"
    assert sub.num_segments == 2          # shares the source segments


def test_bufferlist_zero_copy_of_arrays():
    arr = np.arange(16, dtype=np.uint8)
    bl = BufferList(arr)
    arr[0] = 99
    assert bl.to_array()[0] == 99
    assert bl.is_contiguous()


def test_bufferlist_claim_append():
    a, b = BufferList(b"aa"), BufferList(b"bb")
    a.claim_append(b)
    assert a.to_bytes() == b"aabb"
    assert len(b) == 0


def test_bufferlist_rebuild_aligned():
    bl = BufferList(b"abc")
    bl.append(b"defg")
    padded = bl.rebuild_aligned(8)
    assert padded.size == 8
    assert bl.to_bytes() == b"abcdefg"
    assert bl.is_contiguous()


@pytest.mark.parametrize("seed", [0xFFFFFFFF, 0, 12345])
def test_bufferlist_crc_equals_the_reference(seed):
    data = np.random.default_rng(seed & 0xFF).integers(
        0, 256, 3000, dtype=np.uint8).tobytes()
    bl, ref = BufferList(data[:1000]), RefBufferList(data[:1000])
    bl.append(data[1000:])
    ref.append(data[1000:])
    crc = bl.crc32c(seed)
    assert crc == ref.crc32c(seed) == ec_native.crc32c(data, seed)
    assert bl.crc32c(seed) == crc                       # cached
    bl.append(b"x")
    assert bl.crc32c(seed) != crc                       # invalidated
    assert BufferList(b"xyz").contents_equal(BufferList(b"xyz"))
    assert not BufferList(b"xyz").contents_equal(BufferList(b"xyw"))


def test_bufferlist_unwraps_guarded_views():
    sanitizer.set_view_guards(True)
    try:
        page = bytearray(b"0123456789")
        view = sanitizer.guard_view(memoryview(page), label="rx")
        assert BufferList(view).to_bytes() == b"0123456789"
        sanitizer.recycle_buffer(page)
        with pytest.raises(sanitizer.UseAfterRecycleError):
            BufferList(view)
    finally:
        sanitizer.set_view_guards(False)


# -- admin socket ----------------------------------------------------------------

def _schema():
    return [Option("osd_pool_default_size", "int", 3, minimum=1, maximum=10),
            Option("debug_ms", "bool", False)]


def test_admin_socket_commands(tmp_path):
    cfg = Config(_schema())
    sock_path = str(tmp_path / "daemon.asok")
    asok = AdminSocket(sock_path, config=cfg)
    pc = PerfCountersCollection.instance()
    if pc.get("asok_port_test") is None:
        pc.create("asok_port_test").add("hits")
    pc.get("asok_port_test").inc("hits")
    asok.register_command("status", lambda req: {"state": "active"})
    asok.start()
    try:
        assert admin_command(sock_path, "version")["result"]["version"] \
            == VERSION
        assert admin_command(sock_path, "status")["result"]["state"] \
            == "active"
        perf = admin_command(sock_path, "perf dump")["result"]
        assert perf["asok_port_test"]["hits"] >= 1
        admin_command(sock_path, {"prefix": "config set",
                                  "key": "debug_ms", "value": "true"})
        assert admin_command(sock_path, {"prefix": "config get",
                                         "key": "debug_ms"})["result"][
            "debug_ms"] is True
        assert "error" in admin_command(sock_path, "bogus")
        for verb in ("crash ls", "profile dump", "deadlock dump",
                     "events dump", "trace dump"):
            assert "result" in admin_command(sock_path, verb), verb
    finally:
        asok.stop()
        pc.remove("asok_port_test")


# -- throttle / heartbeat --------------------------------------------------------

def test_throttle_blocking_and_fail():
    th = Throttle("bytes", 10)
    assert th.get_or_fail(6)
    assert not th.get_or_fail(5)
    assert th.get_or_fail(4)
    done = []

    def waiter():
        th.get(5, timeout=5)
        done.append(True)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    assert not done
    th.put(6)
    t.join(timeout=5)
    assert done and not t.is_alive()
    th.put(10)
    assert th.get(100, timeout=0.1)     # oversized: admitted on empty


def test_heartbeat_map():
    suicides = []
    hb = HeartbeatMap(on_suicide=suicides.append)
    hid = hb.add_worker("op_tp_0", grace=0.05, suicide_grace=0.1)
    assert hb.is_healthy()[0]
    time.sleep(0.12)
    healthy, bad = hb.is_healthy()
    assert not healthy and bad == ["op_tp_0"]
    assert suicides == ["op_tp_0"]
    hb.touch(hid)
    assert hb.is_healthy()[0]
    hb.remove_worker(hid)
    assert hb.is_healthy() == (True, [])


# -- crash records ---------------------------------------------------------------

def test_crash_records_coalesce_archive_and_freeze_the_ring():
    crash.reset()
    flight.reset()
    try:
        try:
            raise crash.SimulatedCrash("commit interrupted")
        except crash.SimulatedCrash as e:
            first = crash.record("osd.3", e)
            again = crash.record("osd.3", e)
        assert again["count"] == 2 and again["crash_id"] == \
            first["crash_id"]
        (row,) = crash.ls()
        assert row["exc_type"] == "SimulatedCrash" and row["count"] == 2
        assert row["backtrace_last"].endswith("commit interrupted")
        assert [e["type"] for e in flight.dump()["events"]] == ["crash"]
        assert any(s["reason"].startswith("crash:osd.3")
                   for s in flight.snapshots())
        assert crash.archive() == 1
        assert crash.ls() == [] and crash.recent() == []
        assert len(crash.ls(show_all=True)) == 1
    finally:
        crash.reset()


# -- the ec_offload_* schema and hot apply ---------------------------------------

def test_offload_options_equal_the_reference():
    def shape(opts):
        return [(o.name, o.type, o.default, o.minimum, o.maximum)
                for o in opts]
    assert shape(offload.OFFLOAD_OPTIONS()) == \
        shape(ref_offload.OFFLOAD_OPTIONS())


def test_register_config_hot_applies_to_a_live_service():
    from ceph_tpu_torch.offload import service as svc_mod
    saved = dict(svc_mod._DEFAULTS)
    cfg = Config()
    offload.register_config(cfg)
    offload.register_config(cfg)          # idempotent

    async def body():
        svc = offload.get_service(CPU8)
        cfg.set("ec_offload_linger_ms", 7)
        cfg.set("ec_offload_breaker_reset_s", 0.5)
        cfg.set("ec_offload_max_queue_bytes", "1m")
        cfg.set("ec_offload_device_count", 2)
        assert (svc.linger_ms, svc.breaker_reset_s) == (7.0, 0.5)
        assert svc.max_queue_bytes == 1 << 20
        assert len(svc._topology()) == 2
        cfg.rm("ec_offload_device_count")
        assert len(svc._topology()) == 8
        return svc.status()["settings"]
    try:
        settings = run(body())
        assert settings["linger_ms"] == 7.0
        assert svc_mod._DEFAULTS["linger_ms"] == 7.0
    finally:
        for name in ("ec_offload_linger_ms", "ec_offload_breaker_reset_s",
                     "ec_offload_max_queue_bytes"):
            cfg.rm(name)
    assert svc_mod._DEFAULTS == saved


# -- status / flush from a foreign thread ----------------------------------------

def test_status_and_flush_from_a_foreign_thread():
    """An admin thread reads status and force-flushes a pending bucket:
    both run on the service's loop, and the flushed job completes with
    the reference's crc."""
    blocks = np.random.default_rng(4).integers(0, 256, (4, 4096),
                                               dtype=np.uint8)
    ref_crc = ref_ec_native.crc32c_blocks(blocks.reshape(-1), 4096)

    async def body():
        svc = offload.get_service(CPU8)
        svc.linger_ms = 60_000.0          # only a flush ships the bucket
        job = asyncio.ensure_future(svc.crc32c_blocks(blocks, 4096))
        await asyncio.sleep(0)
        got = {}

        def admin():
            got["status"] = svc.status()
            got["flush"] = svc.flush()
        t = threading.Thread(target=admin)
        t.start()
        crcs = await asyncio.wait_for(job, 10)
        await asyncio.get_running_loop().run_in_executor(None, t.join, 10)
        assert not t.is_alive()
        await svc.drain()
        return crcs, got
    crcs, got = run(body())
    assert np.array_equal(crcs, ref_crc)
    assert len(got["status"]["pending_buckets"]) == 1
    assert got["flush"]["flushed_buckets"] == 1


def test_status_and_flush_after_the_loop_closed():
    async def make():
        return offload.get_service(CPU8)
    svc = asyncio.run(make())
    assert svc.status()["jobs"] == 0
    assert svc.flush()["error"] == "event loop closed"


# -- sanitizer.unwrap at ECUtil's numpy boundaries -------------------------------

K, M, CHUNK = 4, 2, 1024


@pytest.fixture(scope="module")
def ref_shards():
    impl = ref_registry.factory("tpu", {"k": str(K), "m": str(M)})
    data = np.random.default_rng(6).integers(0, 256, 3 * K * CHUNK,
                                             dtype=np.uint8).tobytes()
    sinfo = ref_ec_util.StripeInfo(K, K * CHUNK)
    shards = {i: bytes(b)
              for i, b in ref_ec_util.encode(sinfo, impl, data).items()}
    have = {i: b for i, b in shards.items() if i not in (1, K)}
    return {"data": data, "shards": shards,
            "concat": ref_ec_util.decode_concat(sinfo, impl, have),
            "rebuilt": {i: bytes(b) for i, b in ref_ec_util.decode_shards(
                sinfo, impl, have, [1, K]).items()}}


def _guarded(raw: bytes):
    page = bytearray(raw)
    return page, sanitizer.guard_view(memoryview(page), buf=page,
                                      label="frame_rx")


@pytest.mark.parametrize("boundary", ["encode", "decode_concat",
                                      "decode_shards"])
def test_ecutil_unwraps_guarded_views(ref_shards, boundary):
    impl = factory("cuda", {"k": str(K), "m": str(M), "device": "cpu"})
    sinfo = ec_util.StripeInfo(K, K * CHUNK)
    sanitizer.set_view_guards(True)
    try:
        if boundary == "encode":
            page, view = _guarded(ref_shards["data"])

            def call():
                return {i: bytes(b) for i, b in
                        ec_util.encode(sinfo, impl, view).items()}
            want = ref_shards["shards"]
        else:
            pages, have = {}, {}
            for i, b in ref_shards["shards"].items():
                if i not in (1, K):
                    pages[i], have[i] = _guarded(b)
            page = pages[0]
            if boundary == "decode_concat":
                def call():
                    return ec_util.decode_concat(sinfo, impl, have)
                want = ref_shards["concat"]
            else:
                def call():
                    return {i: bytes(b) for i, b in ec_util.decode_shards(
                        sinfo, impl, have, [1, K]).items()}
                want = ref_shards["rebuilt"]
        assert isinstance(page, bytearray)
        assert call() == want                    # live: unwrapped, equal
        sanitizer.recycle_buffer(page)
        with pytest.raises(sanitizer.UseAfterRecycleError):
            call()                               # stale: raises
    finally:
        sanitizer.set_view_guards(False)


def test_ecutil_passes_unguarded_inputs_through(ref_shards):
    impl = factory("cuda", {"k": str(K), "m": str(M), "device": "cpu"})
    sinfo = ec_util.StripeInfo(K, K * CHUNK)
    arr = torch.frombuffer(bytearray(ref_shards["data"]),
                           dtype=torch.uint8).numpy()
    assert {i: bytes(b) for i, b in ec_util.encode(sinfo, impl,
                                                   arr).items()} == \
        ref_shards["shards"]
