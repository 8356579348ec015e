"""The port's lockdep (ceph_tpu_torch/utils/sanitizer.py) against the JAX
package's, on the CPU: the cluster-free cases of
tests/test_lockdep.py:48-281 (an order inversion reported at acquire
time, the rotation-invariant cycle digest, the live wait-for-graph scan
and its watchdog, `deadlock dump`, wait annotations, the Throttle and
AdjustableSemaphore taps, and the seeded grant-versus-write schedule).
The same scenario under the same lock names gives the same inversion
report and cycle digest in both packages."""
from __future__ import annotations

import asyncio
import threading
import time

import pytest

from ceph_tpu.qa import interleave as ref_interleave
from ceph_tpu.utils import sanitizer as ref_sanitizer
from ceph_tpu.utils import throttle as ref_throttle
from ceph_tpu_torch.qa import interleave
from ceph_tpu_torch.utils import flight, sanitizer, throttle

PACKAGES = {"port": (sanitizer, throttle, interleave),
            "reference": (ref_sanitizer, ref_throttle, ref_interleave)}


@pytest.fixture(autouse=True)
def _port_gates():
    """The port's own leak gates (tests/conftest.py gates the
    reference's modules)."""
    yield
    from ceph_tpu_torch.utils import loopprof
    assert not loopprof.installed_loops(), "port loopprof left armed"
    strays = sanitizer.take_foreign_call_soon()
    assert not strays, f"port sanitizer saw foreign call_soon: {strays}"


@pytest.fixture()
def lockdep():
    """Arm both packages' lockdep for one test, fast watchdog tick."""
    for san in (sanitizer, ref_sanitizer):
        san.set_lockdep(True, stuck_wait_s=0.3)
    try:
        yield
    finally:
        for san in (sanitizer, ref_sanitizer):
            san.set_lockdep(False)


def _wait_until(pred, timeout=3.0, step=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(step)
    return pred()


def _in_thread(fn, *args):
    t = threading.Thread(target=fn, args=args)
    t.start()
    t.join(10)
    assert not t.is_alive()


def _inversion(san, names):
    a, b = san.make_lock(names[0]), san.make_lock(names[1])

    def fwd():
        with a:
            with b:
                pass

    def rev():
        with b:
            with a:             # the inversion fires here, at the attempt
                pass
    _in_thread(fwd)
    _in_thread(rev)
    _in_thread(rev)             # reported once, not per re-acquisition
    return san.lockdep_inversions(), san.lockdep_order_edges()


def test_order_inversion_detected_at_acquire(lockdep):
    port, port_edges = _inversion(sanitizer, ("t1:A", "t1:B"))
    ref, _ = _inversion(ref_sanitizer, ("t1:A", "t1:B"))
    assert len(port) == len(ref) == 1
    inv = port[0]
    assert inv["cycle"][0] == inv["cycle"][-1]
    assert set(inv["cycle"]) == {"t1:A", "t1:B"}
    assert len(inv["edges"]) == 2
    for e in inv["edges"]:
        assert "test_torch_lockdep" in e["site"]
    assert "t1:A -> t1:B" in port_edges
    assert inv["cycle"] == ref[0]["cycle"]
    assert inv["digest"] == ref[0]["digest"]
    assert [(e["before"], e["after"], e["site"]) for e in inv["edges"]] \
        == [(e["before"], e["after"], e["site"]) for e in ref[0]["edges"]]


@pytest.mark.parametrize("ring", [["X", "Y"], ["Y", "X"], ["X", "Z"],
                                  ["osd.1:slots", "osd.0:slots", "t:L"]])
def test_cycle_digest_equals_the_reference(ring):
    d = sanitizer._cycle_digest(ring)
    assert d == ref_sanitizer._cycle_digest(ring)
    assert len(d) == 16
    # rotation-invariant: the ring, not the discovery phase
    assert d == sanitizer._cycle_digest(ring[1:] + ring[:1])


def test_thread_deadlock_scan_and_watchdog(lockdep):
    """Two threads crossed on tracked locks: the scan names both parties,
    both resources and the reference's digest while the deadlock is
    live; the watchdog notices it within its tick and crumbs the flight
    ring."""
    a, b = sanitizer.make_lock("t2:A"), sanitizer.make_lock("t2:B")
    hold = threading.Barrier(2)

    def one(first, second):
        with first:
            hold.wait()
            if second.acquire(timeout=1.0):     # bounded: always unwinds
                second.release()

    t1 = threading.Thread(target=one, args=(a, b), name="t2-fwd")
    t2 = threading.Thread(target=one, args=(b, a), name="t2-rev")
    t1.start()
    t2.start()
    scan = _wait_until(
        lambda: (s := sanitizer.deadlock_scan(stuck_s=0.05))["cycles"]
        and s)
    assert scan, "deadlock never seen by the scan"
    cyc = scan["cycles"][0]
    assert set(cyc["resources"]) == {"t2:A", "t2:B"}
    assert {"thread:t2-fwd", "thread:t2-rev"} <= set(cyc["tasks"])
    assert cyc["digest"] == ref_sanitizer._cycle_digest(["t2:A", "t2:B"])
    for e in cyc["edges"]:
        assert e["waited_s"] >= 0.0 and "test_torch_lockdep" in e["site"]
    last = _wait_until(
        lambda: (sanitizer.deadlock_dump().get("last_detection")
                 or {}).get("cycles"))
    assert last and last[0]["digest"] == cyc["digest"]
    crumbs = [e for e in flight.dump("deadlock_cycle")["events"]
              if e["detail"].get("digest") == cyc["digest"]]
    assert crumbs, "watchdog never crumbed the cycle"
    t1.join(10)
    t2.join(10)
    assert not t1.is_alive() and not t2.is_alive()
    assert sanitizer.deadlock_scan()["cycles"] == []


def test_deadlock_dump_shape(lockdep):
    d = sanitizer.deadlock_dump()
    assert d["lockdep"] is True
    assert set(d) == set(ref_sanitizer.deadlock_dump())
    for key in ("order_edges", "inversions", "waits", "holders",
                "parked_tasks", "scan"):
        assert key in d
    lk = sanitizer.make_lock("t3:only")
    with lk:
        tok = sanitizer.lockdep_wait_start("t3:other", kind="lock",
                                           entity="osd.9", peer=1, tid=42)
        try:
            d = sanitizer.deadlock_dump()
            (w,) = [w for w in d["waits"] if w["resource"] == "t3:other"]
            assert w["kind"] == "lock" and w["held"] == ["t3:only"]
            assert w["detail"] == {"entity": "osd.9", "peer": 1, "tid": 42}
            assert "t3:only" in d["holders"]
        finally:
            sanitizer.lockdep_wait_end(tok)


def test_wait_annotations_entity_filter(lockdep):
    t1 = sanitizer.lockdep_wait_start("osd.1:slots", kind="remote_reserve",
                                      entity="osd.0", peer=1, tid=7)
    t2 = sanitizer.lockdep_wait_start("osd.0:slots", kind="remote_reserve",
                                      entity="osd.1", peer=0, tid=8)
    try:
        rows = sanitizer.wait_annotations(entity="osd.0", min_age_s=0.0)
        assert [r["resource"] for r in rows] == ["osd.1:slots"]
        assert rows[0]["peer"] == 1 and rows[0]["tid"] == 7
        assert sanitizer.wait_annotations(entity="osd.2",
                                          min_age_s=0.0) == []
        assert sanitizer.wait_annotations(entity="osd.0",
                                          min_age_s=60.0) == []
    finally:
        sanitizer.lockdep_wait_end(t1)
        sanitizer.lockdep_wait_end(t2)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_throttle_inversion_regression(lockdep, pkg):
    """A Throttle is a lock-order participant: holding a lock while
    filling it in one thread, and holding its budget while taking the
    lock in another, is the inversion a tracked lock gets flagged for
    (the same report in both packages)."""
    san, thr, _ = PACKAGES[pkg]
    th = thr.Throttle("budget", 1)
    lk = san.make_lock("t4:L")

    def fwd():
        with lk:
            th.get(1)
            th.put(1)

    def rev():
        th.get(1)
        with lk:
            pass
        th.put(1)
    _in_thread(fwd)
    _in_thread(rev)
    invs = [i for i in san.lockdep_inversions()
            if "throttle:budget" in i["cycle"]]
    assert len(invs) == 1
    assert set(invs[0]["cycle"]) == {"t4:L", "throttle:budget"}
    assert invs[0]["digest"] == ref_sanitizer._cycle_digest(
        ["t4:L", "throttle:budget"])


def test_adjustable_semaphore_waits_and_holders(lockdep):
    """A named semaphore registers its holder at acquire and its parked
    waiters in the wait-for graph; an anonymous one stays out."""
    async def main():
        sem = throttle.AdjustableSemaphore(1, name="t5:slots")
        sem.lockdep_detail = {"entity": "osd.5"}
        assert await sem.acquire()
        assert "t5:slots" in sanitizer.deadlock_dump()["holders"]

        async def second():
            assert await sem.acquire()
            sem.release()

        task = asyncio.create_task(second(), name="t5-waiter")
        await asyncio.sleep(0.05)
        rows = sanitizer.wait_annotations(entity="osd.5", min_age_s=0.0)
        assert [r["resource"] for r in rows] == ["t5:slots"]
        assert rows[0]["kind"] == "semaphore"
        assert rows[0]["task"] == "task:t5-waiter"
        sem.release()
        await task
        assert "t5:slots" not in sanitizer.deadlock_dump()["holders"]
        anon = throttle.AdjustableSemaphore(1)
        await anon.acquire()
        assert "t5:anon" not in sanitizer.deadlock_dump()["holders"]
        anon.release()
    asyncio.run(asyncio.wait_for(main(), 30))


async def _grant_vs_write(thr, ilv, inverted: bool) -> None:
    """Scrub-grant vs client-write miniature: legal order takes grant
    THEN gate on both sides; the inverted one crosses them."""
    grant = thr.AdjustableSemaphore(1, name="il:scrub_grant")
    gate = thr.AdjustableSemaphore(1, name="il:write_gate")

    async def scrubber():
        await grant.acquire()
        if ilv.armed():
            await ilv.yield_point("scrub:granted")
        await gate.acquire()
        gate.release()
        grant.release()

    async def writer():
        first, second = (gate, grant) if inverted else (grant, gate)
        await first.acquire()
        if ilv.armed():
            await ilv.yield_point("write:first")
        await second.acquire()
        second.release()
        first.release()

    await asyncio.gather(scrubber(), writer())


def test_interleave_grant_write_ordering(lockdep):
    """Legal ordering stays silent across seeds; the inverted ordering
    fires on every seed, the same seed reproduces the schedule and the
    witness, and both equal the reference's."""
    def one(pkg, seed, inverted):
        _, thr, ilv = PACKAGES[pkg]

        async def body():
            async with ilv.explore(seed) as ex:
                await _grant_vs_write(thr, ilv, inverted)
                return ex.digest()
        return asyncio.run(asyncio.wait_for(body(), 30))

    def digests(san):
        return sorted(i["digest"] for i in san.lockdep_inversions()
                      if "il:scrub_grant" in i["cycle"])

    for seed in range(3):
        one("port", seed, inverted=False)
    assert digests(sanitizer) == []
    sched1 = one("port", 11, inverted=True)
    wit1 = digests(sanitizer)
    assert len(wit1) == 1
    sanitizer.set_lockdep(False)
    sanitizer.set_lockdep(True, stuck_wait_s=0.3)   # reset state
    assert one("port", 11, inverted=True) == sched1
    assert digests(sanitizer) == wit1
    assert one("reference", 11, inverted=True) == sched1
    assert digests(ref_sanitizer) == wit1
