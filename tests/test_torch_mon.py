"""The port's control plane (ceph_tpu_torch/mon/) against the JAX
package's, on the CPU.

Every case of tests/test_mon.py runs on the port's monitors: the
reference test source is exec'd with its imports renamed to the port
(`load_reference_tests`), so a new reference case is mirrored by itself,
with its asyncio bound cut from 90 s to 30 s. Then one command sequence
goes into a reference monitor and into a port monitor, and their OSDMap
encodings must be equal bytes at every epoch (a profile with the device
plugin differs only by its name, `tpu` or `cuda`, and the port's
`device` key); and a MonStore written by either package opens in the
other, down to a monitor booted on the other package's store.
"""
from __future__ import annotations

import asyncio
import inspect
import os
import re
import signal

import pytest

from ceph_tpu.mon import MonMap as RefMonMap, Monitor as RefMonitor
from ceph_tpu.mon import MonStore as RefMonStore
from ceph_tpu.mon.paxos import Paxos as RefPaxos
from ceph_tpu.msg.messenger import Connection as RefConnection
from ceph_tpu_torch import convert
from ceph_tpu_torch.crush.osdmap import PG
from ceph_tpu_torch.mon import MonMap, Monitor, MonStore
from ceph_tpu_torch.mon.paxos import Paxos
from ceph_tpu_torch.msg.messenger import Connection

from tests.test_mon import free_ports
from tests.test_torch_kv_objectstore import TESTS, load_reference_tests

HARD_TIMEOUT_S = 60
_RUN_90 = "def run(coro, timeout=90):"
_RUN_30 = "def run(coro, timeout=30):"
# the port's host plugins take their device from the profile too
_JER = '"technique": "reed_sol_van"}'
_JER_CPU = '"technique": "reed_sol_van", "device": "cpu"}'


@pytest.fixture(autouse=True)
def _guards(monkeypatch):
    """tests/test_mon.py's fast timers on both packages' classes, a hard
    timeout that fires even in a loop that never yields, and the port's
    own leak gates (tests/conftest.py gates the reference's modules)."""
    for paxos, conn in ((Paxos, Connection), (RefPaxos, RefConnection)):
        monkeypatch.setattr(paxos, "ELECTION_TIMEOUT", 0.15)
        monkeypatch.setattr(paxos, "LEASE_INTERVAL", 0.2)
        monkeypatch.setattr(paxos, "LEASE_TIMEOUT", 1.0)
        monkeypatch.setattr(paxos, "ACCEPT_TIMEOUT", 0.8)
        monkeypatch.setattr(conn, "KEEPALIVE_INTERVAL", 0.3)
        monkeypatch.setattr(conn, "KEEPALIVE_TIMEOUT", 1.5)
        monkeypatch.setattr(conn, "PARK_TIMEOUT", 2.0)

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


def _reference_cases(name: str) -> list[str]:
    src = open(os.path.join(TESTS, name + ".py")).read()
    return re.findall(r"^def (test_\w+)\(", src, re.M)


MON_CASES = _reference_cases("test_mon")


def test_every_reference_mon_case_is_mirrored():
    assert len(MON_CASES) == 7, MON_CASES


@pytest.mark.parametrize("case", MON_CASES)
def test_reference_mon_case_on_the_port(case, tmp_path, monkeypatch):
    mod = load_reference_tests("test_mon", True, [], {},
                               edits=((_RUN_90, _RUN_30),
                                      (_JER, _JER_CPU)))
    assert mod.Monitor is Monitor and mod.Paxos is Paxos
    fn = getattr(mod, case)
    args = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    fn(*[args[p] for p in inspect.signature(fn).parameters])


# -- one command sequence into a monitor of each package ---------------------

JERASURE = {"plugin": "jerasure", "k": "2", "m": "1",
            "technique": "reed_sol_van", "device": "cpu"}
HOST_PROFILES = {
    "p_jer": JERASURE,
    "p_isa": {"plugin": "isa", "k": "4", "m": "2", "device": "cpu"},
    "p_clay": {"plugin": "clay", "k": "4", "m": "2", "d": "5",
               "device": "cpu"},
}


def _steps(dev_plugin: str, dev_extra: dict):
    """(label, fn(osdmonitor)) of the sequence; each step commits one
    epoch."""
    def boot(i, host):
        return lambda om: om.handle_boot(
            {"osd": i, "addr": ["127.0.0.1", 6800 + i], "weight": 1.0,
             "crush_location": {"host": host}})

    def pending(field, ids):
        return lambda om: getattr(om.get_pending(), field).extend(ids)

    def pg_temp(pool, ps, osds):
        def fn(om):
            pid = om.osdmap.get_pool(pool).id
            om.get_pending().new_pg_temp[PG(pid, ps)] = osds
        return fn

    steps = [(f"boot osd.{i}", boot(i, f"h{i // 2}")) for i in range(6)]
    steps += [(f"profile {n}", lambda om, n=n, p=p: om.cmd_profile_set(n, p))
              for n, p in HOST_PROFILES.items()]
    steps += [
        ("pool rbd", lambda om: om.cmd_pool_create("rbd", pg_num=8)),
        ("pool ec", lambda om: om.cmd_pool_create(
            "ecpool", pg_num=16, pool_type="erasure",
            erasure_code_profile="p_jer")),
        ("pool clay", lambda om: om.cmd_pool_create(
            "claypool", pg_num=4, pool_type="erasure",
            erasure_code_profile="p_clay", crush_failure_domain=0)),
        ("mksnap", lambda om: om.cmd_pool_snap("rbd", "mksnap",
                                               snap_name="s1")),
        ("selfmanaged", lambda om: om.cmd_pool_snap("ecpool",
                                                    "selfmanaged_create")),
        ("osd out 3", pending("new_out", [3])),
        ("osd down 4", pending("new_down", [4])),
        ("pg-temp", pg_temp("ecpool", 5, [0, 2, 5])),
        ("osd in 3", pending("new_in", [3])),
        ("profile dev", lambda om: om.cmd_profile_set(
            "p_dev", {"plugin": dev_plugin, "k": "4", "m": "2",
                      **dev_extra})),
        ("pool dev", lambda om: om.cmd_pool_create(
            "devpool", pg_num=8, pool_type="erasure",
            erasure_code_profile="p_dev")),
    ]
    return steps


async def _sequence(mon_cls, monmap_cls, path, dev_plugin, dev_extra):
    port = free_ports(1)[0]
    monmap = monmap_cls({"a": ("127.0.0.1", port)})
    mon = mon_cls("a", monmap, store_path=path)
    await mon.start()
    try:
        while not (mon.paxos.is_leader() and mon.paxos.is_active()):
            await asyncio.sleep(0.02)
        om = mon.osdmon
        maps = [(om.osdmap.epoch, om.osdmap.dumps())]
        for label, fn in _steps(dev_plugin, dev_extra):
            fn(om)
            await om.propose_pending()
            maps.append((om.osdmap.epoch, om.osdmap.dumps()))
        return maps, om.osdmap
    finally:
        await mon.stop()


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, 30))


def test_command_sequence_gives_equal_osdmaps(tmp_path):
    """The same commands into a reference monitor and a port monitor:
    equal OSDMap bytes at every epoch; the device profile's map equal
    after `convert.port_osdmap` and without the port's `device` key."""
    ref_maps, ref_map = _run(_sequence(
        RefMonitor, RefMonMap, str(tmp_path / "ref.json"), "tpu", {}))
    port_maps, port_map = _run(_sequence(
        Monitor, MonMap, str(tmp_path / "port.json"), "cuda",
        {"device": "cpu"}))
    n_host = len(_steps("cuda", {})) - 2
    assert len(ref_maps) == len(port_maps) == n_host + 3
    assert [e for e, _ in port_maps] == [e for e, _ in ref_maps]
    assert len({e for e, _ in port_maps}) == len(port_maps)
    for (e, ref), (_, port) in zip(ref_maps[:n_host + 1],
                                   port_maps[:n_host + 1]):
        assert port == ref, f"epoch {e}"
    ref_d, port_d = ref_map.to_dict(), port_map.to_dict()
    assert port_d["ec_profiles"]["p_dev"].pop("device") == "cpu"
    assert convert.port_osdmap(ref_d) == port_d
    pool = port_map.get_pool("devpool")
    assert (pool.size, pool.min_size, pool.stripe_width) == (6, 5, 4 * 4096)


def test_monstore_opens_in_either_package(tmp_path):
    """A MonStore written by either package opens in the other with the
    same contents, and writes the same file bytes back."""
    for writer, reader in ((RefMonStore, MonStore), (MonStore, RefMonStore)):
        path = str(tmp_path / f"{writer.__module__}.json")
        st = writer(path)
        st.put_one("osdmap", "1", {"epoch": 1, "blob": "x" * 40})
        st.put_one("paxos", "last_committed", 7)
        other = reader(path)
        assert other.dump() == st.dump()
        assert other.keys("osdmap") == ["1"]
        before = open(path, "rb").read()
        other.put_one("paxos", "last_committed", 7)
        assert open(path, "rb").read() == before


def test_monitor_boots_on_the_other_packages_store(tmp_path):
    """A monitor of each package that committed the host part of the
    sequence stops; a monitor of the other package boots on its store
    and serves the same OSDMap bytes."""
    ref_path, port_path = str(tmp_path / "r.json"), str(tmp_path / "p.json")
    _, ref_map = _run(_sequence(RefMonitor, RefMonMap, ref_path, "tpu", {}))
    _, port_map = _run(_sequence(Monitor, MonMap, port_path, "cuda",
                                 {"device": "cpu"}))

    async def reopen(mon_cls, monmap_cls, path):
        monmap = monmap_cls({"a": ("127.0.0.1", free_ports(1)[0])})
        mon = mon_cls("a", monmap, store_path=path)
        await mon.start()
        try:
            return mon.osdmon.osdmap.dumps()
        finally:
            await mon.stop()
    assert _run(reopen(Monitor, MonMap, ref_path)) == ref_map.dumps()
    assert _run(reopen(RefMonitor, RefMonMap, port_path)) == port_map.dumps()
