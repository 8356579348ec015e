"""The port's schedule explorer, buffer generation guards and lockset
recorder (ceph_tpu_torch/qa/interleave.py, utils/sanitizer.py) against
the JAX package's, on the CPU: the explorer mechanics of
tests/test_interleave.py:62-171 (the same seed gives the same digest and
ordering in the port and in the reference for one workload), the
staging-page guard on the port's `_DeviceSlot`, whose page on the CPU is
a plain CPU tensor (:171), the lockset recorder on the port's
`_Topology` (:233), the foreign call_soon recorder (:295), and the
guarded rx view of a DATA_VIEW message off the port's wire (:202), and
the explorer catching a reverted replica-splice bug in the port's PGLog
(:330), with the same failing seeds as the reference's."""
from __future__ import annotations

import asyncio
import threading

import pytest
import torch

from ceph_tpu.qa import interleave as ref_interleave
from ceph_tpu_torch.qa import interleave
from ceph_tpu_torch.utils import sanitizer


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


async def _pingpong_workload(mod):
    """Deterministic multi-task workload with schedule-sensitive
    output: the replay-contract probe, yielding through `mod`."""
    q: asyncio.Queue = asyncio.Queue()
    out = []

    async def producer(i):
        for j in range(5):
            await q.put((i, j))
            await asyncio.sleep(0)
            if mod.armed():
                await mod.yield_point("producer")

    async def consumer():
        for _ in range(15):
            out.append(await q.get())

    await asyncio.gather(producer(0), producer(1), producer(2), consumer())
    return tuple(out)


async def _explored(mod, seed):
    async with mod.explore(seed) as ex:
        order = await _pingpong_workload(mod)
        return ex.digest(), order, ex.decisions


@pytest.mark.parametrize("seed", [1, 7, 8, 11])
def test_same_seed_same_schedule_in_port_and_reference(seed):
    """One seed is one schedule: twice through the port, and once
    through the reference, give the same digest, ordering and number of
    decisions; the next seed explores another."""
    async def main():
        p1 = await _explored(interleave, seed)
        p2 = await _explored(interleave, seed)
        ref = await _explored(ref_interleave, seed)
        other = await _explored(interleave, seed + 100)
        return p1, p2, ref, other
    p1, p2, ref, other = run(main())
    assert p1 == p2 == ref
    assert p1[2] > 0
    assert p1[0] != other[0]


def test_explorer_perturbs_the_schedule():
    async def main():
        base = await _pingpong_workload(interleave)
        for s in range(16):
            _, order, _ = await _explored(interleave, s)
            if order != base:
                return True
        return False
    assert run(main())


def test_deferred_handle_cancel():
    async def main():
        async with interleave.explore(3, defer_p=1.0, max_defer=3):
            ran = []
            loop = asyncio.get_running_loop()
            h = loop.call_soon(ran.append, 1)
            h.cancel()
            for _ in range(8):
                await asyncio.sleep(0)
            assert ran == []
            h2 = loop.call_soon(ran.append, 2)
            for _ in range(8):
                await asyncio.sleep(0)
            assert ran == [2] and not h2.cancelled()
    run(main())


def test_wrapper_composition_survives_non_lifo_uninstall():
    """Explorer first, sanitizer on top, explorer uninstalled FIRST: the
    sanitizer's recorder stays live, and both disarm cleanly."""
    async def main():
        loop = asyncio.get_running_loop()
        interleave.install(loop, interleave.Explorer(1, defer_p=0.0))
        sanitizer.install(loop, view_guards=False)
        try:
            interleave.uninstall(loop)
            assert not interleave.armed()

            def foreign():
                try:
                    loop.call_soon(lambda: None)
                except RuntimeError:
                    pass
            t = threading.Thread(target=foreign)
            t.start()
            t.join(10)
            assert not t.is_alive()
            assert len(sanitizer.take_foreign_call_soon()) == 1
        finally:
            sanitizer.uninstall(loop)
            sanitizer.take_foreign_call_soon()
        ran = []
        loop.call_soon(ran.append, 1)
        await asyncio.sleep(0)
        assert ran == [1]
        async with interleave.explore(2) as ex:
            await _pingpong_workload(interleave)
            assert ex.decisions > 0
    run(main())


def test_uninstall_restores_call_soon():
    async def main():
        loop = asyncio.get_running_loop()
        before = loop.call_soon
        async with interleave.explore(1):
            assert loop.call_soon is not before
            assert interleave.armed()
        assert not interleave.armed()
        ran = []
        loop.call_soon(ran.append, 1)
        await asyncio.sleep(0)
        assert ran == [1]
    run(main())


# -- buffer generation guards on the port's staging pages ----------------------

def _guards() -> int:
    return sanitizer.perf().dump()["san_view_guard_trips"]


def test_generation_guard_catches_staging_reuse():
    """A view over a staging page (a CPU tensor here, pinned on a card)
    accessed after put_staging recycled the page raises at the access
    site; a fresh hand-out of the page reads cleanly."""
    from ceph_tpu_torch.offload.service import _DeviceSlot, _DeviceState
    sanitizer.set_view_guards(True)
    try:
        slot = _DeviceSlot(_DeviceState("cpu:0", torch.device("cpu")),
                           depth=2)
        page = slot.get_staging(4096)
        assert isinstance(page, torch.Tensor) and not page.is_pinned()
        view = sanitizer.guard_view(memoryview(page.numpy()), buf=page,
                                    label="staging")
        assert isinstance(view, sanitizer.GuardedView)
        assert len(view[0:16]) == 16
        trips0 = _guards()
        slot.put_staging(page)                  # the recycle point
        with pytest.raises(sanitizer.UseAfterRecycleError):
            bytes(view)
        with pytest.raises(sanitizer.UseAfterRecycleError):
            view[0:8].tobytes()
        assert _guards() >= trips0 + 2
        page2 = slot.get_staging(4096)
        assert page2 is page                    # the reused page
        v2 = sanitizer.guard_view(memoryview(page2.numpy()), buf=page2,
                                  label="staging")
        assert v2.nbytes == page2.numel()
    finally:
        sanitizer.set_view_guards(False)


def test_staging_page_untracked_while_guards_are_off():
    from ceph_tpu_torch.offload.service import _DeviceSlot, _DeviceState
    slot = _DeviceSlot(_DeviceState("cpu:0", torch.device("cpu")), depth=2)
    page = slot.get_staging(4096)
    view = memoryview(page.numpy())
    assert sanitizer.guard_view(view, buf=page) is view
    slot.put_staging(page)
    assert bytes(view[:4]) == bytes(page[:4].numpy())


def test_data_view_message_guarded_end_to_end():
    """The port's DATA_VIEW messages hand their rx window out guarded in
    sanitizer mode (tests/test_interleave.py:202): len, slices and bytes
    work, the guard unwraps at the tx boundary, and a recycle of the
    body buffer flips every outstanding view to raising. The frame is
    byte-equal to the reference's."""
    from ceph_tpu.msg import frames as ref_frames
    from ceph_tpu.msg.messages import MOSDOp as RefMOSDOp
    from ceph_tpu_torch.msg import frames
    from ceph_tpu_torch.msg.messages import Message, MOSDOp
    sanitizer.set_view_guards(True)
    try:
        m = MOSDOp({"op": "write"}, b"payload-bytes")
        m.seq = 1
        blob = bytes(frames.Frame(frames.Tag.MESSAGE,
                                  m.encode_segments()).encode())
        ref = RefMOSDOp({"op": "write"}, b"payload-bytes")
        ref.seq = 1
        assert blob == bytes(ref_frames.Frame(
            ref_frames.Tag.MESSAGE, ref.encode_segments()).encode())
        out = Message.decode_segments(frames.Frame.decode(blob).segments)
        assert isinstance(out.data, sanitizer.GuardedView)
        assert len(out.data) == len(b"payload-bytes")
        assert bytes(out.data) == b"payload-bytes"
        assert bytes(out.data[0:7]) == b"payload"
        # the guard unwraps cleanly at the tx boundary (resend path)
        assert out.encode_segments()[2] == b"payload-bytes"
        sanitizer.recycle_buffer(blob)          # simulated pooled-rx reuse
        with pytest.raises(sanitizer.UseAfterRecycleError):
            bytes(out.data)
        with pytest.raises(sanitizer.UseAfterRecycleError):
            out.encode_segments()
    finally:
        sanitizer.set_view_guards(False)


# -- lockset recorder on the port's topology -----------------------------------

def _in_thread(fn, *args, **kw):
    t = threading.Thread(target=fn, args=args, kwargs=kw)
    t.start()
    t.join(10)
    assert not t.is_alive()


def test_lockset_recorder_flags_unlocked_cross_thread_write():
    from ceph_tpu_torch.offload.service import _Topology
    sanitizer.set_lockset_recording(True)
    sanitizer.clear_lockset_conflicts()
    try:
        topo = _Topology()
        with topo.lock:
            topo.note("states", write=True)
        _in_thread(topo.note, "states", write=True)
        conflicts = sanitizer.lockset_conflicts()
        assert conflicts and conflicts[0]["field"] == "states"
        assert conflicts[0]["owner"] == "_Topology"
        # both sides under the topology lock: nothing to report
        sanitizer.clear_lockset_conflicts()

        def locked_write():
            with topo.lock:
                topo.note("mesh_fns", write=True)

        with topo.lock:
            topo.note("mesh_fns", write=True)
        _in_thread(locked_write)
        assert sanitizer.lockset_conflicts() == []
        topo.note("states", write=False)
        _in_thread(topo.note, "states", write=False)
        assert sanitizer.lockset_conflicts() == []
        # identity, not name: another topology's same-named lock does
        # not cover this one's fields
        sanitizer.clear_lockset_conflicts()
        other = _Topology()

        def wrong_lock_write():
            with other.lock:
                topo.note("states", write=True)

        with topo.lock:
            topo.note("states", write=True)
        _in_thread(wrong_lock_write)
        assert len(sanitizer.lockset_conflicts()) == 1
        _in_thread(wrong_lock_write)
        assert len(sanitizer.lockset_conflicts()) == 1
    finally:
        sanitizer.set_lockset_recording(False)
        sanitizer.clear_lockset_conflicts()


def test_topology_accesses_are_locked_in_device_states():
    """The port's device_states/reset/mesh_fn tap every field under the
    topology lock: two threads building and reading report nothing."""
    from ceph_tpu_torch.offload.service import _Topology
    sanitizer.set_lockset_recording(True)
    sanitizer.clear_lockset_conflicts()
    try:
        topo = _Topology()
        devs = [torch.device("cpu")] * 2
        _in_thread(topo.device_states, devs)
        assert len(topo.device_states(devs)) == 2
        _in_thread(topo.reset)
        assert len(topo.device_states(devs[:1])) == 1
        assert sanitizer.lockset_conflicts() == []
    finally:
        sanitizer.set_lockset_recording(False)
        sanitizer.clear_lockset_conflicts()


def test_foreign_call_soon_recorded_and_drained():
    async def main():
        loop = asyncio.get_running_loop()
        sanitizer.install(loop, view_guards=False)
        try:
            def foreign():
                try:
                    loop.call_soon(lambda: None)
                except RuntimeError:
                    pass            # debug mode raises; already recorded
            _in_thread(foreign)
        finally:
            sanitizer.uninstall(loop)
        events = sanitizer.take_foreign_call_soon()
        assert len(events) == 1
        assert "test_torch_interleave" in events[0]["callback"]
        assert sanitizer.take_foreign_call_soon() == []
    run(main())


# -- re-introduced-bug detection (tests/test_interleave.py:330) ----------------

SPLICE_SEEDS = 20


def _buggy_insert(log, entry):
    """The replica insert before the splice fix: the `version > head`
    guard drops out-of-order arrivals, leaving a log hole."""
    if entry.version > log.head:
        log.append(entry)


async def _splice_sweep(interleave_mod, pglog_mod):
    """(failing seeds, the first failing seed's two replays) of the
    reverted insert; the real insert must hold on every seed."""
    async def deliver(insert_fn, seed):
        async with interleave_mod.explore(seed, defer_p=0.5) as ex:
            log = pglog_mod.PGLog()

            async def arrive(v):
                if interleave_mod.armed():
                    await interleave_mod.yield_point("replica_rx")
                insert_fn(log, pglog_mod.LogEntry(
                    version=(1, v), op="modify", oid=f"o{v}", reqid=(9, v)))

            await asyncio.gather(arrive(5), arrive(6), arrive(7))
            return [e.version for e in log.entries], ex.digest()

    want = [(1, 5), (1, 6), (1, 7)]
    healthy_insert = pglog_mod.PGLog.insert
    failing = []
    for seed in range(SPLICE_SEEDS):
        got, _ = await deliver(lambda lg, e: healthy_insert(lg, e), seed)
        assert got == want, f"seed {seed}: real splice diverged"
        got_bad, _ = await deliver(_buggy_insert, seed)
        if got_bad != want:
            failing.append(seed)
    assert failing, "no schedule reordered the arrivals"
    r1 = await deliver(_buggy_insert, failing[0])
    r2 = await deliver(_buggy_insert, failing[0])
    assert r1 == r2 and r1[0] != want
    return failing, r1


def test_seeded_schedule_catches_reverted_splice_bug():
    """The explorer finds the reverted splice in the port's PGLog, the
    failing seed replays bit-identically, and the port fails on the same
    seeds with the same result and schedule digest as the reference."""
    from ceph_tpu.osd import pglog as ref_pglog
    from ceph_tpu_torch.osd import pglog
    port = run(_splice_sweep(interleave, pglog))
    ref = run(_splice_sweep(ref_interleave, ref_pglog))
    assert port == ref
