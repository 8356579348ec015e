"""The port's thread-sharded reactor (ceph_tpu_torch/utils/reactor.py)
and the offload service on it, on the CPU and without a cluster: the
cases of tests/test_reactor.py that need no cluster (placement and
registry, run_on, teardown, four shards' services over one shared
topology under an injected device failure, submit_threadsafe across
shards, the AdjustableSemaphore and Throttle cross-thread audits), held
against the JAX package's outputs where there are outputs. The port's
services run over 8 x "cpu" slots, the reference's plugin `tpu` on the
JAX CPU backend."""
import asyncio
import sys
import threading

import numpy as np
import pytest

from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.osd import ec_util as ref_ec_util
from ceph_tpu_torch import offload
from ceph_tpu_torch.ec.registry import factory
from ceph_tpu_torch.native import ec_native
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.qa import faultinject
from ceph_tpu_torch.utils import reactor
from ceph_tpu_torch.utils.reactor import ShardPool
from ceph_tpu_torch.utils.throttle import AdjustableSemaphore, Throttle

CPU8 = ["cpu"] * 8
DATA = bytes(range(256)) * 32


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@pytest.fixture(autouse=True)
def _port_gates():
    """The port's own leak gates (tests/conftest.py gates the
    reference's modules)."""
    yield
    from ceph_tpu_torch.utils import loopprof, sanitizer
    assert not loopprof.installed_loops(), "port loopprof left armed"
    strays = sanitizer.take_foreign_call_soon()
    assert not strays, f"port sanitizer saw foreign call_soon: {strays}"


# -- placement + registry + seams ----------------------------------------------

def test_shard_placement_and_registry():
    async def body():
        pool = ShardPool(3)
        try:
            assert pool.num_shards == 3
            assert [pool.place(i) for i in range(7)] == [0, 1, 2, 0, 1, 2, 0]
            assert pool.loop(0) is asyncio.get_running_loop()
            for i in range(3):
                assert reactor.pool_for(pool.loop(i)) is pool
                assert reactor.shard_index_of(pool.loop(i)) == i
            assert reactor.shard_label(pool.loop(2)) == "shard2"
            assert reactor.current_pool() is pool
            tids = await pool.run_on_each(threading.get_ident)
            assert len(set(tids)) == 3
            assert tids[0] == threading.get_ident()
        finally:
            await pool.shutdown()
        assert reactor.pool_for(asyncio.get_running_loop()) is None
    run(body())


def test_run_on_crosses_shards_and_returns_results():
    async def body():
        pool = ShardPool(2)
        try:
            async def where(x):
                return (threading.get_ident(),
                        asyncio.get_running_loop(), x * 2)
            tid0, loop0, r0 = await pool.run_on(0, where(21))
            tid1, loop1, r1 = await pool.run_on(1, where(4))
            assert (r0, r1) == (42, 8)
            assert tid0 == threading.get_ident()
            assert loop0 is pool.loop(0)
            assert tid1 != tid0 and loop1 is pool.loop(1)

            async def boom():
                raise RuntimeError("from shard 1")
            with pytest.raises(RuntimeError, match="from shard 1"):
                await pool.run_on(1, boom())
        finally:
            await pool.shutdown()
    run(body())


def test_shard_pool_teardown_reaps_stragglers():
    async def body():
        pool = ShardPool(2)

        async def linger():
            asyncio.get_running_loop().create_task(asyncio.sleep(60))
            return True
        assert await pool.run_on(1, linger())
        await pool.shutdown()
        assert pool.loop(1).is_closed()
    run(body())


def test_switch_interval_is_refcounted_across_pools():
    """Two overlapping multi-shard pools: the interval stays at the
    pool's bound until the LAST one shuts down, then comes back; a
    one-shard pool never touches it."""
    saved = sys.getswitchinterval()

    async def body():
        one = ShardPool(1)
        assert sys.getswitchinterval() == saved
        a, b = ShardPool(2), ShardPool(2)
        assert sys.getswitchinterval() == ShardPool.SWITCH_INTERVAL_S
        await a.shutdown()
        assert sys.getswitchinterval() == ShardPool.SWITCH_INTERVAL_S
        await b.shutdown()
        assert sys.getswitchinterval() == saved
        await one.shutdown()
    run(body())
    assert sys.getswitchinterval() == saved


# -- offload from four shards under an injected device failure -----------------

@pytest.fixture(scope="module")
def ref_encoded():
    impl = ref_registry.factory("tpu", {"k": "2", "m": "1"})
    return {i: bytes(b) for i, b in ref_ec_util.encode(
        ref_ec_util.StripeInfo(2, 8192), impl, DATA).items()}


def test_offload_from_four_shards_with_injected_device_failure(ref_encoded):
    """Every shard's front end feeds the ONE pool-shared topology: one
    armed device failure is one breaker trip and one fallback batch
    across the whole pool, every result equals the reference's, and
    every shard reads the same rotation state."""
    impl = factory("cuda", {"k": "2", "m": "1", "device": "cpu"})
    sinfo = ec_util.StripeInfo(2, 8192)

    async def body():
        pool = ShardPool(4)
        services = []

        async def submit_many(n=4):
            svc = offload.get_service(CPU8)
            if svc not in services:
                services.append(svc)
            svc.linger_ms = 1.0
            outs = await asyncio.gather(*[
                ec_util.encode_async(sinfo, impl, DATA, service=svc)
                for _ in range(n)])
            return [{i: bytes(b) for i, b in o.items()} == ref_encoded
                    for o in outs]
        try:
            warm = await asyncio.gather(*[pool.run_on(i, submit_many(1))
                                          for i in range(4)])
            assert all(ok for oks in warm for ok in oks)
            assert len({id(svc._topo) for svc in services}) == 1
            assert len({id(s) for s in services}) == 4
            base_fb = sum(s.stats["fallback_ops"] for s in services)
            base_tr = sum(s.stats["breaker_trips"] for s in services)
            faultinject.set_enabled(True)
            faultinject.arm_device_failures(1)
            results = await asyncio.gather(*[
                pool.run_on(i, submit_many(4)) for i in range(4)])
            assert all(ok for oks in results for ok in oks)
            trips = sum(s.stats["breaker_trips"] for s in services) \
                - base_tr
            fallbacks = sum(s.stats["fallback_ops"] for s in services) \
                - base_fb
            assert trips == 1
            assert 1 <= fallbacks <= 4
            # one shared rotation state (0 or 1 out: success evidence from
            # a batch already in flight may close the breaker again)
            outs = {s.health_metrics()["devices_out"] for s in services}
            assert len(outs) == 1 and outs <= {0, 1}
            assert not any(s.degraded for s in services)
        finally:
            faultinject.set_enabled(False)
            faultinject.reset(seed=0)
            await pool.shutdown()
    run(body(), timeout=120)


def test_later_shard_naming_another_device_list_raises():
    """The pool-shared topology serves one device list: a shard whose
    service names another raises instead of being served on the first
    shard's slots."""
    impl = factory("cuda", {"k": "2", "m": "1", "device": "cpu"})
    sinfo = ec_util.StripeInfo(2, 8192)

    async def encode_on(devices):
        svc = offload.get_service(devices)
        svc.linger_ms = 1.0
        return await ec_util.encode_async(sinfo, impl, DATA, service=svc)

    async def body():
        pool = ShardPool(2)
        try:
            await pool.run_on(0, encode_on(CPU8))
            with pytest.raises(ValueError, match="cannot join"):
                await pool.run_on(1, encode_on(["cpu"] * 2))
        finally:
            await pool.shutdown()
    run(body())


def test_service_rebinds_to_the_pool_topology():
    """A service made before its loop joined a pool re-binds to the
    pool's topology (and rebuilds its slots), and back to a private
    one after the pool is gone."""
    async def body():
        svc = offload.get_service(CPU8)
        private = svc._topo
        svc._topology()
        pool = ShardPool(2)
        try:
            assert svc._topo is pool.shared("offload_topology", object)
            assert svc._slots is None
            assert len(svc._topology()) == 8
        finally:
            await pool.shutdown()
        assert svc._topo is not private
        assert svc._topo is not pool.shared("offload_topology", object)
    run(body())


# -- cross-shard submission seam ------------------------------------------------

def test_offload_submit_threadsafe_crosses_shards():
    """Shard 0 hands jobs to shard 1's service through the
    call_soon_threadsafe seam; they run on shard 1's loop and the
    results equal the host's and the reference's."""
    blocks = np.frombuffer(bytes(range(256)) * 64,
                           dtype=np.uint8).reshape(4, 4096)
    ref_crc = ec_native.crc32c_blocks(blocks.reshape(-1), 4096)
    impl = factory("cuda", {"k": "2", "m": "1", "device": "cpu"})
    ref_impl = ref_registry.factory("tpu", {"k": "2", "m": "1"})
    stripes = np.random.default_rng(3).integers(0, 256, (3, 2, 4096),
                                                dtype=np.uint8)
    ref_parity = np.asarray(ref_impl.encode_stripes(stripes))

    async def body():
        pool = ShardPool(2)

        async def _get_service():
            svc = offload.get_service(CPU8)
            svc.linger_ms = 1.0
            return svc
        try:
            svc1 = await pool.run_on(1, _get_service())
            assert offload.service_for(pool.loop(1)) is svc1
            crcs = await asyncio.wrap_future(
                svc1.submit_threadsafe("crc32c_blocks", blocks, 4096))
            parity = await asyncio.wrap_future(
                svc1.submit_threadsafe("encode", impl, stripes))
            assert svc1.stats["jobs"] == 2
            return crcs, parity
        finally:
            await pool.shutdown()
    crcs, parity = run(body())
    assert np.array_equal(np.asarray(crcs), ref_crc)
    assert np.array_equal(parity, ref_parity)


def test_submit_threadsafe_on_a_closed_loop_raises():
    async def make():
        return offload.get_service(CPU8)
    svc = asyncio.run(make())
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit_threadsafe("crc32c_blocks",
                              np.zeros((1, 4096), np.uint8), 4096)


# -- AdjustableSemaphore / Throttle cross-shard audit ---------------------------

def test_adjustable_semaphore_cross_shard_release_and_resize():
    async def body():
        pool = ShardPool(2)
        sem = AdjustableSemaphore(1)
        try:
            await sem.acquire()              # binds to shard 0
            woke = asyncio.Event()

            async def waiter():
                await sem.acquire()
                woke.set()
            wt = asyncio.get_running_loop().create_task(waiter())
            await asyncio.sleep(0.05)
            assert not woke.is_set()

            async def foreign_release():
                sem.release()                # from shard 1's thread
            await pool.run_on(1, foreign_release())
            await asyncio.wait_for(woke.wait(), 5)
            await wt
            sem.release()
            assert sem._value == 1 and sem._debt == 0

            async def foreign_resize():
                sem.resize(3)
            await pool.run_on(1, foreign_resize())
            await asyncio.sleep(0.05)
            assert sem.limit == 3
            assert sem._value == 3
        finally:
            await pool.shutdown()
    run(body())


def test_throttle_cross_thread_budget_consistency():
    """get/put from 4 threads under a shortened switch interval: the
    count returns to exactly zero."""
    th = Throttle("xshard", 64)
    errs = []

    def worker():
        try:
            for _ in range(400):
                assert th.get(3, timeout=10)
                th.put(3)
        except Exception as e:   # pragma: no cover - failure reporting
            errs.append(e)
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert not errs
    assert th.current == 0
