"""The reference's recovery and cluster cases on the port's daemons, on
the CPU: the paths the failure storm stands on (OSDs killed and revived,
log-driven recovery and backfill, EC recovery of lost shards, resent
ops answered from the PG log's dup index).

Each reference test source is exec'd with its imports renamed to the
port (`load_reference_tests`), its cluster harness replaced by
tests/test_cluster.py's exec'd on the port with `OSD(device="cpu")`, and
every EC profile a client sets carried through `convert.port_profile`
with `device=cpu` (tests/test_torch_access.py's guards, which also keep
the offload services' defaults per test). The cases:

  tests/test_cluster.py, all of them;
  tests/test_backfill.py, all of them;
  tests/test_dup_ops.py, all of them (its EC cluster from
      tests/test_ec_rmw.py's make_ec_cluster, exec'd on the port).

Then the faults the failure storm found, pinned: a revived OSD must stay
up (its peers dropped its liveness stamp while it was out of their
acting sets; the reference keeps it, and marks the OSD down again just
after its boot), and a failure report about its older incarnation,
landing after its re-boot, must not mark it down (the port's mon drops
it; the reference's counts it), nor leave its reporter deaf to the new
incarnation's death.

Every case runs under `asyncio.wait_for(..., 30)` and a hard SIGALRM
timeout, with the port's own leak gates.
"""
from __future__ import annotations

import asyncio
import inspect

import pytest

# _guards is autouse: the fast timers, the services' defaults kept, EC
# profiles in the port's names with device=cpu, the hard timeout
from tests.test_torch_access import _guards  # noqa: F401
from tests.test_torch_access import (_HARNESS, _PORT_HARNESS, ClusterHarness,
                                     _cases, load_reference_tests, run)

#: tests/test_ec_rmw.py's make_ec_cluster on the port's harness
make_ec_cluster = load_reference_tests(
    "test_ec_rmw", True, [], {},
    edits=((_HARNESS, _PORT_HARNESS),)).make_ec_cluster

#: reference file -> the edits its source takes on the port
SOURCES = {
    "test_cluster": (
        ("osd = OSD(i, self.mon_addrs, store=store)",
         'osd = OSD(i, self.mon_addrs, store=store, device="cpu")'),
        ("OSD(i, list(monmap.mons.values()), auth_key=key)",
         'OSD(i, list(monmap.mons.values()), auth_key=key, device="cpu")'),
        ("def run(coro, timeout=120)", "def run(coro, timeout=30)")),
    "test_backfill": ((_HARNESS, _PORT_HARNESS),),
    "test_dup_ops": ((_HARNESS, _PORT_HARNESS),
                     ("from tests.test_ec_rmw import make_ec_cluster",
                      "from tests.test_torch_recovery import "
                      "make_ec_cluster")),
}

CASES = [c for name in SOURCES for c in _cases(name)]


def test_every_reference_case_is_mirrored():
    """test_cluster's 9 cases with its restart case over 2 backends,
    test_backfill's 2, test_dup_ops' 4 with 2 over 2 pool types."""
    counts = {}
    for name, _, _ in CASES:
        counts[name] = counts.get(name, 0) + 1
    assert counts == {"test_cluster": 10, "test_backfill": 2,
                      "test_dup_ops": 6}


@pytest.mark.parametrize("source,case,param", CASES,
                         ids=[f"{s}::{c}" + (f"[{p}]" if p else "")
                              for s, c, p in CASES])
def test_reference_recovery_case_on_the_port(source, case, param, tmp_path,
                                             monkeypatch):
    mod = load_reference_tests(source, True, [], {}, edits=SOURCES[source])
    args = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    fn = getattr(mod, case)
    names = list(inspect.signature(fn).parameters)
    if param is not None:
        args[names[-1]] = param
    fn(*[args[p] for p in names])


def test_a_revived_osd_is_not_marked_down_again(tmp_path):
    """11 OSDs and a pool on all of them: osd.10 stopped and marked down
    leaves every peer's heartbeat table, and started again on its store
    2 s later it stays up. Its peers used to keep its last reply stamp
    while it was out of their acting sets, report it failed at their
    first heartbeat after its boot, and the mon marked it down again (the
    storm's revived OSDs); a sub-op reply it sent then was lost with the
    connection."""
    async def body():
        c = ClusterHarness(tmp_path, n_osds=11)
        try:
            await c.start()
            cl = await c.client()
            await cl.pool_create("rbd", pg_num=4, size=11)
            store = c.osds[10].store
            await c.kill_osd(10)
            await c.wait_osd_down(10)
            await asyncio.sleep(2.0)
            # out of every acting set for several heartbeats: no peer
            # keeps its stamp or its report
            stale = [o.whoami for o in c.osds.values()
                     if 10 in o._hb_last or 10 in o._hb_reported]
            await c.start_osd(10, store=store)
            mon = next(iter(c.mons.values()))
            loop = asyncio.get_running_loop()
            seen, end = [], loop.time() + 3.0
            while loop.time() < end:
                seen.append(mon.osdmon.osdmap.osds[10].up)
                await asyncio.sleep(0.02)
            return stale, seen
        finally:
            await c.stop()
    stale, seen = run(body())
    assert stale == [], f"peers keeping osd.10's liveness stamp: {stale}"
    downs = sum(1 for a, b in zip(seen, seen[1:]) if a and not b)
    assert downs == 0 and seen[-1], f"marked down {downs} time(s) after boot"


async def _until(pred, timeout: float = 10.0) -> None:
    loop = asyncio.get_running_loop()
    end = loop.time() + timeout
    while not pred():
        if loop.time() > end:
            raise TimeoutError("condition never held")
        await asyncio.sleep(0.02)


@pytest.mark.parametrize("package", ["reference", "port"])
def test_a_stale_failure_report_does_not_mark_a_revived_osd_down(
        package, tmp_path):
    """osd.3 re-boots at a new address; then two failure reports about
    its old incarnation land at the mon (sent from the reporters' maps
    before the re-boot, naming the address it had then), as a report
    sent before a mark-down can land after a quick re-boot. The
    reference's mon counts them and marks the revived OSD down; the
    port's drops them, as upstream's OSDMonitor::preprocess_failure does,
    and still marks it down on two reports about its new incarnation. No
    pool: no heartbeat peers, so no other report reaches the mon."""
    if package == "reference":
        from ceph_tpu.msg.messages import MOSDFailure
        from tests.test_cluster import ClusterHarness as Harness
    else:
        from ceph_tpu_torch.msg.messages import MOSDFailure
        Harness = ClusterHarness

    async def report(c, failed, epoch, addr):
        for r in (0, 1):
            conn = await c.osds[r].monc._ensure_conn()
            conn.send_message(MOSDFailure(
                {"failed": failed, "from": r, "epoch": epoch,
                 "addr": addr}))

    async def markdowns(mon, osd, seconds):
        """The mon's mark-downs of `osd` in the next `seconds` (a live
        OSD marked down re-boots at once: the map alone may never show
        it down between two samples)."""
        before = len(mon.cluster_log)
        await asyncio.sleep(seconds)
        return sum(1 for ln in list(mon.cluster_log)[before:]
                   if ln["message"].startswith(f"osd.{osd} marked down"))

    async def body():
        c = Harness(tmp_path, n_osds=4)
        try:
            await c.start()
            mon = next(iter(c.mons.values()))
            osdmap = mon.osdmon.osdmap
            await _until(lambda: all(
                i in osdmap.osds and osdmap.osds[i].up for i in range(4)))
            old_epoch, old_addr = osdmap.epoch, list(osdmap.osds[3].addr)
            store = c.osds[3].store
            await c.kill_osd(3)
            await c.start_osd(3, store=store)
            await _until(lambda: osdmap.osds[3].up
                         and list(osdmap.osds[3].addr) != old_addr)
            await report(c, 3, old_epoch, old_addr)
            stale = await markdowns(mon, 3, 2.0)
            fresh = None
            if package == "port":
                await report(c, 3, osdmap.epoch,
                             list(osdmap.osds[3].addr))
                fresh = await markdowns(mon, 3, 2.0)
            return stale, fresh
        finally:
            await c.stop()
    stale, fresh = run(body())
    if package == "reference":
        # the fault: the revived OSD marked down on stale reports
        assert stale == 1, f"the reference's mon marked it down {stale} times"
    else:
        assert stale == 0, f"stale reports marked it down {stale} times"
        assert fresh == 1, f"current reports marked it down {fresh} times"


def test_a_reporter_forgets_its_report_about_an_older_incarnation(tmp_path):
    """osd.0's and osd.1's heartbeats are held inside their reports of
    osd.3's death while osd.3 is marked down and re-booted at a new
    address, so their maps move from its old incarnation to its new one
    with no heartbeat between; the mon then drops both reports as stale.
    They must forget them and ping the new incarnation: when it dies too
    it is marked down within a few graces. Kept, the stale stamp and
    report stop their pings and any report of it, and osd.2's report
    alone is one of the two the mon needs."""
    grace = 1.2     # _guards' osd_heartbeat_grace

    async def body():
        c = ClusterHarness(tmp_path, n_osds=4)
        try:
            await c.start()
            cl = await c.client()
            await cl.pool_create("rbd", pg_num=4, size=4)
            osdmap = next(iter(c.mons.values())).osdmon.osdmap
            await _until(lambda: all(3 in c.osds[r]._hb_last
                                     for r in (0, 1, 2)))
            gate, held = asyncio.Event(), []
            for r in (0, 1):
                monc = c.osds[r].monc

                async def report(failed, reporter, epoch, addr,
                                 send=monc.report_failure):
                    if failed == 3:
                        held.append((reporter, epoch, list(addr)))
                        await gate.wait()
                    await send(failed, reporter, epoch=epoch, addr=addr)
                monc.report_failure = report
            old_addr = list(osdmap.osds[3].addr)
            store = c.osds[3].store
            await c.kill_osd(3)
            await _until(lambda: len(held) == 2)
            await cl.command({"prefix": "osd down", "ids": [3]})
            await c.wait_osd_down(3)
            await c.start_osd(3, store=store)
            await _until(lambda: all(
                o.osdmap.is_up(3) and list(o.osdmap.osds[3].addr) != old_addr
                for o in c.osds.values()))
            before = list(held)
            gate.set()
            await asyncio.sleep(4 * grace)
            stale = (osdmap.osds[3].up,
                     sorted(next(iter(c.mons.values()))
                            .osdmon.failure_reports.get(3, ())))
            await c.kill_osd(3)
            loop = asyncio.get_running_loop()
            t0 = loop.time()
            try:
                await c.wait_osd_down(3, timeout=4 * grace)
            except TimeoutError:
                return old_addr, before, stale, None
            return old_addr, before, stale, loop.time() - t0
        finally:
            await c.stop()
    old_addr, held, stale, down_s = run(body())
    assert sorted((r, a) for r, _, a in held) == [(0, old_addr), (1, old_addr)]
    assert stale == (True, []), f"stale reports counted: up, reporters {stale}"
    assert down_s is not None, \
        f"the new incarnation's death went unreported for {4 * grace} s"
