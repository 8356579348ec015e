"""The port's offload service (ceph_tpu_torch/offload) against the JAX
package's, on the CPU and without a cluster: the service-level cases of
tests/test_offload.py (coalescing, flush on bytes versus linger,
backpressure, breaker fallback then recovery, decode buckets, inline
bypass, affine routing with spill, an oversized batch through the mesh,
the per-device breaker), the async ECUtil functions and
Checksummer.calculate_async. The port's service runs over 8 x "cpu"
slots, the reference's over the conftest's 8 virtual CPU devices; every
output is compared with the reference service's for the same input
(tolerance 0: bytes and crc values)."""
import asyncio
import time

import numpy as np
import pytest
import torch

from ceph_tpu import offload as ref_offload
from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.osd import ec_util as ref_ec_util
from ceph_tpu.utils.checksummer import Checksummer as RefChecksummer
from ceph_tpu_torch import offload
from ceph_tpu_torch.device import DeviceUnavailable
from ceph_tpu_torch.ec.registry import factory
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.utils.checksummer import Checksummer

K, M, CHUNK = 4, 2, 1024
CPU8 = ["cpu"] * 8
DATA = bytes(range(256)) * 64                      # 4 stripes
BIG = bytes(range(256)) * 16 * 64                  # 256 KiB = 64 stripes
LOST = ((1,), (2,), (0, K + 1))
BLOCKS = np.random.default_rng(9).integers(0, 256, 5 * 4096,
                                           dtype=np.uint8).tobytes()


def run(coro, timeout=30.0):
    async def bounded():
        return await asyncio.wait_for(coro, timeout)
    return asyncio.run(bounded())


def _impl():
    return factory("cuda", {"k": str(K), "m": str(M), "device": "cpu"})


def _sinfo():
    return ec_util.StripeInfo(K, K * CHUNK)


def _plain(shards) -> dict:
    return {i: bytes(b) for i, b in shards.items()}


async def _drive(svc, impl, sinfo, ecu, checksummer) -> dict:
    """The same async calls through either package's service."""
    shards = _plain(await ecu.encode_async(sinfo, impl, DATA, service=svc))
    out = {"encode": shards,
           "big": _plain(await ecu.encode_async(sinfo, impl, BIG,
                                                service=svc))}
    for lost in LOST:
        have = {i: b for i, b in shards.items() if i not in lost}
        out[("concat", lost)] = await ecu.decode_concat_async(
            sinfo, impl, have, service=svc)
        out[("shards", lost)] = _plain(await ecu.decode_shards_async(
            sinfo, impl, have, lost, service=svc))
    out["csum"] = await checksummer.calculate_async(BLOCKS, service=svc)
    out["csum_scatter"] = await checksummer.calculate_async(
        [BLOCKS[:4096], b"", BLOCKS[4096:]], service=svc)
    # let the finished batch's done-callback run first: the reference's
    # drain spins on a finished task otherwise (Python 3.12's gather
    # completes eagerly and never yields)
    await asyncio.sleep(0)
    await svc.drain()
    return out


@pytest.fixture(scope="module")
def ref_out():
    """The JAX service's outputs: the oversized batch goes through its
    8-device mesh."""
    async def body():
        svc = ref_offload.get_service()
        prev = svc.device_shard_bytes
        svc.device_shard_bytes = 128 * 1024
        try:
            out = await _drive(
                svc, ref_registry.factory("tpu", {"k": str(K), "m": str(M)}),
                ref_ec_util.StripeInfo(K, K * CHUNK), ref_ec_util,
                RefChecksummer("crc32c", 4096))
            assert svc.stats["mesh_batches"] == 1
        finally:
            svc.device_shard_bytes = prev
        return out
    return run(body(), timeout=120)


def test_async_ecutil_and_checksums_match_reference(ref_out):
    """encode_async, decode_concat_async, decode_shards_async and
    calculate_async (one buffer and a scatter list) through the port's
    service, with the oversized write through its mesh, against the JAX
    service; and against the port's synchronous path."""
    async def body():
        svc = offload.get_service(devices=CPU8)
        svc.device_shard_bytes = 128 * 1024
        out = await _drive(svc, _impl(), _sinfo(), ec_util,
                           Checksummer("crc32c", 4096))
        assert svc.stats["mesh_batches"] == 1
        assert svc.stats["fallback_ops"] == 0
        return out
    out = run(body())
    assert out.keys() == ref_out.keys()
    for key in out:
        if key in ("csum", "csum_scatter"):
            np.testing.assert_array_equal(out[key], ref_out[key])
            assert out[key].dtype == np.uint32
        else:
            assert out[key] == ref_out[key], key
    assert out["encode"] == _plain(ec_util.encode(_sinfo(), _impl(), DATA))
    assert out[("concat", LOST[0])] == DATA
    np.testing.assert_array_equal(
        out["csum"], Checksummer("crc32c", 4096).calculate(BLOCKS))


def test_concurrent_submits_coalesce_into_one_batch(ref_out):
    async def body():
        svc = offload.get_service(devices=CPU8)
        svc.linger_ms = 25.0
        outs = await asyncio.gather(*[
            ec_util.encode_async(_sinfo(), _impl(), DATA, service=svc)
            for _ in range(6)])
        await svc.drain()
        return outs, svc.stats
    outs, stats = run(body())
    assert all(_plain(o) == ref_out["encode"] for o in outs)
    assert stats["jobs"] == 6
    assert stats["batches"] == 1                 # ONE device dispatch
    assert stats["coalesced_ops"] == 5


def test_flush_on_max_batch_bytes_beats_linger(ref_out):
    async def body():
        svc = offload.get_service(devices=CPU8)
        svc.linger_ms = 60_000.0                 # linger would hang
        svc.max_batch_bytes = 2 * len(DATA)      # two jobs fill a batch
        outs = await asyncio.gather(*[
            ec_util.encode_async(_sinfo(), _impl(), DATA, service=svc)
            for _ in range(2)])
        await svc.drain()
        return outs
    outs = run(body(), timeout=20)
    assert all(_plain(o) == ref_out["encode"] for o in outs)


def test_lone_op_ships_at_linger_deadline(ref_out):
    async def body():
        svc = offload.get_service(devices=CPU8)
        svc.linger_ms = 5.0
        out = await ec_util.encode_async(_sinfo(), _impl(), DATA,
                                         service=svc)
        await svc.drain()
        return out
    assert _plain(run(body(), timeout=20)) == ref_out["encode"]


def test_backpressure_bounds_admitted_bytes(ref_out):
    async def body():
        svc = offload.get_service(devices=CPU8)
        svc.linger_ms = 1.0
        # budget of about one job: admissions serialize, nothing is lost
        svc._throttle.reset_max(len(DATA) + 1)
        outs = await asyncio.gather(*[
            ec_util.encode_async(_sinfo(), _impl(), DATA, service=svc)
            for _ in range(5)])
        assert svc._throttle.current == 0        # fully released
        # a job BIGGER than the whole budget admits alone
        svc._throttle.reset_max(len(DATA) // 2)
        big = await ec_util.encode_async(_sinfo(), _impl(), DATA,
                                         service=svc)
        assert svc._throttle.current == 0
        await svc.drain()
        return outs + [big]
    assert all(_plain(o) == ref_out["encode"] for o in run(body()))


def test_device_failure_falls_back_identical_then_breaker_clears(ref_out):
    async def body():
        impl = _impl()
        svc = offload.get_service(devices=["cpu"])
        svc.breaker_reset_s = 0.05
        orig = impl.encode_stripes
        impl.encode_stripes = lambda s: (_ for _ in ()).throw(
            RuntimeError("injected device failure"))
        out = await ec_util.encode_async(_sinfo(), impl, DATA, service=svc)
        hm = svc.health_metrics()
        assert hm["degraded"] and hm["breaker_trips"] == 1
        assert "injected device failure" in hm["last_error"]
        before = svc.stats["fallback_ops"]
        out2 = await ec_util.encode_async(_sinfo(), impl, DATA, service=svc)
        assert svc.stats["fallback_ops"] > before
        impl.encode_stripes = orig
        await asyncio.sleep(0.06)                # cooldown -> probe
        out3 = await ec_util.encode_async(_sinfo(), impl, DATA, service=svc)
        assert not svc.degraded and not svc.health_metrics()["degraded"]
        assert svc.device_stats["host"]["fallback_ops"] == 2
        await svc.drain()
        return out, out2, out3
    # the host codec's output is bit-identical to the device kernel's
    assert all(_plain(o) == ref_out["encode"] for o in run(body()))


def test_decode_jobs_bucket_by_erasure_pattern(ref_out):
    shards = ref_out["encode"]

    async def body():
        svc = offload.get_service(devices=CPU8)
        svc.linger_ms = 25.0
        sub = {i: shards[i] for i in range(K + M) if i not in LOST[0]}
        sub2 = {i: shards[i] for i in range(K + M) if i not in LOST[1]}
        outs = await asyncio.gather(*[
            ec_util.decode_concat_async(_sinfo(), _impl(), s, service=svc)
            for s in (sub, sub, sub2)])
        await svc.drain()
        return outs, svc.stats
    outs, stats = run(body())
    assert outs == [ref_out[("concat", LOST[0])]] * 2 + \
        [ref_out[("concat", LOST[1])]]
    # the two same-pattern jobs share a batch; the third cannot
    assert stats["jobs"] == 3 and stats["batches"] == 2
    assert stats["coalesced_ops"] == 1


def test_inline_bypass_when_disabled(ref_out):
    async def body():
        svc = offload.get_service(devices=CPU8)
        offload.set_enabled(False)
        try:
            outs = await asyncio.gather(*[
                ec_util.encode_async(_sinfo(), _impl(), DATA, service=svc)
                for _ in range(3)])
            csum = await Checksummer("crc32c", 4096).calculate_async(
                [BLOCKS[:4096], BLOCKS[4096:]], service=svc)
        finally:
            offload.set_enabled(True)
        return outs, csum, svc.stats
    outs, csum, stats = run(body())
    assert all(_plain(o) == ref_out["encode"] for o in outs)
    np.testing.assert_array_equal(csum, ref_out["csum"])
    assert stats["batches"] == 4                 # one dispatch per op
    assert stats["coalesced_ops"] == 0


def test_device_affine_routing_with_least_busy_spillover():
    """Same bucket key -> same slot while it keeps up; a backed-up
    preferred slot spills to the least-busy one; with every slot out of
    rotation the router yields None (host)."""
    async def body():
        svc = offload.get_service(devices=CPU8)
        assert offload.service_for(asyncio.get_running_loop()) is svc
        assert offload.get_service_or_none() is svc
        slots = svc._topology()
        assert [s.label for s in slots] == [f"cpu:{i}" for i in range(8)]
        key = ("enc", b"matrix", 4096)
        pref = slots[hash(key) % len(slots)]
        for _ in range(4):
            assert svc._route(key) is pref
        pref.inflight = svc.device_spill_threshold
        spill = svc._route(key)
        assert spill is not pref and spill.inflight == 0
        assert svc.stats["device_spills"] == 1
        pref.inflight = 0
        for s in slots:
            s.degraded = True
            s.degraded_since = time.monotonic()
        assert svc._route(key) is None
        assert svc.degraded
        for s in slots:
            s.degraded = False
        assert not svc.degraded
    run(body())


def test_oversized_batch_stripe_shards_bit_identical(ref_out):
    """A batch at device_shard_bytes fans across the mesh of all slots
    through the sharded apply (K3's plain version here)."""
    async def body():
        svc = offload.get_service(devices=CPU8)
        svc.device_shard_bytes = 32 * 1024
        out = await ec_util.encode_async(_sinfo(), _impl(), BIG,
                                         service=svc)
        st = svc.status()
        await svc.drain()
        return out, svc.stats, st
    out, stats, st = run(body())
    assert _plain(out) == ref_out["big"]
    assert stats["mesh_batches"] == 1 and stats["fallback_ops"] == 0
    assert st["mesh"]["devices"] == 8
    assert st["mesh"]["shape"] == {"stripe": 8, "shard": 1}
    assert set(st["devices"]) == {f"cpu:{i}" for i in range(8)}


def test_per_device_breaker_isolates_one_slot(ref_out):
    """One slot failing fails its in-flight batch over to the next
    healthy slot: no host fallback, no service-wide degradation."""
    async def body():
        impl = _impl()
        svc = offload.get_service(devices=CPU8)
        slots = svc._topology()
        key = ("enc", impl.coding_matrix.tobytes(), CHUNK)
        victim = slots[hash(key) % len(slots)]
        orig = svc._device_call

        async def boom(slot, fn, stacked):
            if slot is victim:
                raise RuntimeError("card down")
            return await orig(slot, fn, stacked)
        svc._device_call = boom
        out = await ec_util.encode_async(_sinfo(), impl, DATA, service=svc)
        assert victim.degraded and not svc.degraded
        stats = dict(svc.stats)
        assert stats["breaker_trips"] == 1
        assert stats["device_failovers"] >= 1
        assert stats["fallback_ops"] == 0
        assert svc.health_metrics()["devices_out"] == 1
        out2 = await ec_util.encode_async(_sinfo(), impl, DATA, service=svc)
        assert svc.stats["breaker_trips"] == 1   # routed around the victim
        assert svc.stats["fallback_ops"] == 0
        await svc.drain()
        return out, out2
    assert all(_plain(o) == ref_out["encode"] for o in run(body()))


def test_crc_jobs_on_the_device_kernel_match_reference(ref_out):
    """crc_device on: the blocks go to a slot and K2 (its plain version
    here) computes them, in coalesced batches."""
    async def body():
        svc = offload.get_service(devices=CPU8)
        svc.crc_device = True
        svc.linger_ms = 25.0
        cs = Checksummer("crc32c", 4096)
        outs = await asyncio.gather(
            cs.calculate_async(BLOCKS, service=svc),
            cs.calculate_async([BLOCKS[:4096], b"", BLOCKS[4096:]],
                               service=svc))
        await svc.drain()
        return outs, svc.stats, svc.device_snapshot()
    (one, scatter), stats, devs = run(body())
    np.testing.assert_array_equal(one, ref_out["csum"])
    np.testing.assert_array_equal(scatter, ref_out["csum_scatter"])
    assert one.dtype == np.uint32
    assert stats["batches"] == 1 and stats["coalesced_ops"] == 1
    assert "host" not in devs


def test_service_and_mesh_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device list is valid")
    from ceph_tpu_torch.parallel import mesh

    async def make(devices=None):
        return offload.get_service(devices)
    with pytest.raises(DeviceUnavailable):
        run(make())
    with pytest.raises(DeviceUnavailable):
        mesh.make_mesh()
    with pytest.raises(DeviceUnavailable):
        mesh.mesh_storage_impl(mesh.make_mesh(), K, M)
    assert run(make(["cpu"])).devices == [torch.device("cpu")]
    assert offload.get_service_or_none() is None      # no running loop
    impl = mesh.mesh_storage_impl(mesh.make_mesh(devices=["cpu"] * 2), K, M)
    assert impl.device == torch.device("cpu")
