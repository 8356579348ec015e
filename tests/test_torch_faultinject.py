"""The port's fault injector (ceph_tpu_torch/qa/faultinject.py) against
the JAX package's, on the CPU and without a cluster: the same seed and
consult schedule give the same injection log in both packages (the
cluster-free cases of tests/test_faultinject.py:63-106), an injected
device failure falls back bit-identical to the reference's plugin `tpu`
output on the service's staged and inline paths (:160), the
AdjustableSemaphore shrink contract (:185), and clay's whole-chunk
decode_shards through the service (:385). Tolerance 0: bytes and logs."""
import asyncio

import numpy as np
import pytest

from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.osd import ec_util as ref_ec_util
from ceph_tpu.qa import faultinject as ref_faultinject
from ceph_tpu_torch import offload
from ceph_tpu_torch.ec.registry import factory
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.qa import faultinject
from ceph_tpu_torch.utils import config, flight
from ceph_tpu_torch.utils.throttle import AdjustableSemaphore

CPU8 = ["cpu"] * 8
DATA = bytes(range(256)) * 64


def run(coro, timeout=30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@pytest.fixture(autouse=True)
def _port_gates():
    """Injection disarmed and empty around every test; and the port's
    own leak gates (tests/conftest.py gates the reference's modules)."""
    faultinject.set_enabled(False)
    faultinject.reset(seed=0)
    yield
    faultinject.set_enabled(False)
    faultinject.reset(seed=0)
    from ceph_tpu_torch.utils import loopprof, sanitizer
    assert not loopprof.installed_loops(), "port loopprof left armed"
    strays = sanitizer.take_foreign_call_soon()
    assert not strays, f"port sanitizer saw foreign call_soon: {strays}"


class _FakeMsg:
    pass


def _drive(mod, seed: int, n: int = 300) -> list:
    inj = mod.FaultInjector(seed=seed)
    inj.msg_drop, inj.msg_dup, inj.msg_delay = 0.2, 0.1, 0.1
    inj.bitrot = 0.3
    inj.device_fail = 0.2
    for i in range(n):
        inj.on_message(f"osd.{i % 3}", _FakeMsg())
        if i % 2 == 0:
            inj.maybe_bitrot(4096)
        if i % 3 == 0:
            inj.should_fail_device()
    return list(inj.log)


@pytest.mark.parametrize("seed", [0, 7, 8, 1234])
def test_same_seed_same_injection_log_in_both_packages(seed):
    port = _drive(faultinject, seed)
    assert port and port == _drive(faultinject, seed)
    assert port == _drive(ref_faultinject, seed)
    assert port != _drive(faultinject, seed + 1)


@pytest.mark.parametrize("mod", [faultinject, ref_faultinject],
                         ids=["port", "reference"])
def test_per_site_counters_are_interleaving_independent(mod):
    inj1, inj2 = mod.FaultInjector(seed=3), mod.FaultInjector(seed=3)
    inj1.msg_drop = inj2.msg_drop = 0.4
    inj1.device_fail = inj2.device_fail = 0.4
    for _ in range(50):
        inj1.on_message("osd.0", _FakeMsg())
    for _ in range(50):
        inj1.should_fail_device()
    for _ in range(50):
        inj2.should_fail_device()
    for _ in range(50):
        inj2.on_message("osd.0", _FakeMsg())
    assert sorted(inj1.log) == sorted(inj2.log)


def test_oneshot_rules_match_exactly_in_both_packages():
    class MOSDOpReply:
        pass

    class MPing:
        pass

    def verdicts(mod):
        inj = mod.FaultInjector(seed=0)
        inj.arm_oneshot(entity="client", msg_type="MOSDOpReply",
                        action="drop", count=1)
        return [inj.on_message("osd.1", MOSDOpReply())[0],
                inj.on_message("client", MPing())[0],
                inj.on_message("client", MOSDOpReply())[0],
                inj.on_message("client", MOSDOpReply())[0]]
    assert verdicts(faultinject) == verdicts(ref_faultinject) == \
        ["deliver", "deliver", "drop", "deliver"]


def test_fault_options_equal_the_reference():
    def shape(opts):
        return [(o.name, o.type, o.default, o.minimum, o.maximum)
                for o in opts]
    assert shape(faultinject.FAULT_OPTIONS()) == \
        shape(ref_faultinject.FAULT_OPTIONS())
    cfg = config.Config()
    faultinject.register_config(cfg)
    cfg.set("fault_inject_device_fail", 0.5)
    try:
        assert faultinject.get_injector().device_fail == 0.5
    finally:
        cfg.rm("fault_inject_device_fail")
    assert faultinject.get_injector().device_fail == 0.0


# -- injected device failure -> breaker fallback -------------------------------

@pytest.fixture(scope="module")
def ref_encoded():
    impl = ref_registry.factory("tpu", {"k": "4", "m": "2"})
    return {i: bytes(b) for i, b in ref_ec_util.encode(
        ref_ec_util.StripeInfo(4, 4 * 1024), impl, DATA).items()}


@pytest.mark.parametrize("inline", [False, True], ids=["staged", "inline"])
def test_injected_device_failure_falls_back_bit_identical(ref_encoded,
                                                          inline):
    """One armed failure: the batch (staged path) or the op (inline
    path, ec_offload_enabled off) goes to the host codec, equal to the
    reference's plugin `tpu`; the slot trips its breaker and the
    flight ring holds the fault and the trip."""
    async def body():
        impl = factory("cuda", {"k": "4", "m": "2", "device": "cpu"})
        sinfo = ec_util.StripeInfo(4, 4 * 1024)
        svc = offload.get_service(CPU8)
        svc.linger_ms = 1.0
        svc.enabled = not inline
        flight.reset()
        faultinject.set_enabled(True)
        faultinject.arm_device_failures(1)
        out = await ec_util.encode_async(sinfo, impl, DATA, service=svc)
        await asyncio.sleep(0)
        await svc.drain()
        return {i: bytes(b) for i, b in out.items()}, dict(svc.stats)
    out, stats = run(body())
    assert out == ref_encoded
    assert stats["fallback_ops"] >= 1 and stats["breaker_trips"] == 1
    assert faultinject.status()["device_fail_pending"] == 0
    types = [e["type"] for e in flight.dump()["events"]]
    assert types.count("fault_injected") == 1
    assert types.count("breaker_trip") == 1


# -- hot-resizable reservations ------------------------------------------------

def test_adjustable_semaphore_shrink_blocks_while_overheld():
    """A shrink never drives _value negative: it absorbs releases, and
    acquire() keeps blocking while more holders than the new limit are
    in flight."""
    async def body():
        sem = AdjustableSemaphore(8)
        for _ in range(8):
            await sem.acquire()
        sem.resize(2)
        assert sem.limit == 2
        assert sem.locked()
        with pytest.raises(asyncio.TimeoutError):
            await asyncio.wait_for(sem.acquire(), 0.05)
        for _ in range(7):               # 6 absorbed, 1 freed
            sem.release()
        await asyncio.wait_for(sem.acquire(), 1)
        assert sem.locked()
        sem.release()
        sem.resize(3)
        await asyncio.wait_for(sem.acquire(), 1)
    run(body())


# -- clay: whole chunks through decode_shards ----------------------------------

def test_decode_shards_whole_chunks_not_missliced_as_fragments():
    """Five whole surviving chunks on a clay pool satisfy the sub-chunk
    repair plan's preconditions but are not its strided runs:
    decode_shards treats them as whole chunks, sync and through the
    service, equal to the reference's shards."""
    code = factory("clay", {"k": "4", "m": "2", "d": "5", "device": "cpu"})
    ref_code = ref_registry.factory("clay", {"k": "4", "m": "2", "d": "5"})
    chunk = code.get_chunk_size(4 * 4096)
    assert chunk == ref_code.get_chunk_size(4 * 4096)
    si = ec_util.StripeInfo(4, 4 * chunk)
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, 3 * si.stripe_width,
                        dtype=np.uint8).tobytes()
    shards = {i: bytes(b) for i, b in ec_util.encode(si, code,
                                                     data).items()}
    ref_shards = {i: bytes(b) for i, b in ref_ec_util.encode(
        ref_ec_util.StripeInfo(4, 4 * chunk), ref_code, data).items()}
    assert shards == ref_shards
    lost = 2
    avail = {i: shards[i] for i in range(6) if i != lost}
    assert ec_util.decode_shards(si, code, avail, [lost])[lost] == \
        shards[lost]

    async def via_service():
        out = await ec_util.decode_shards_async(
            si, code, avail, [lost], service=offload.get_service(CPU8))
        return bytes(out[lost])
    assert run(via_service()) == ref_shards[lost]
