"""The port's cluster (ceph_tpu_torch/mon, osd, rados) against the JAX
package's, on the CPU: a monitor and OSDs of each package booted in this
process, an EC pool written, read degraded, recovered and deep-scrubbed.

The harness is tests/test_cluster.py:41-120's over either package: a
port cluster takes `OSD(device="cpu")` and EC profiles with plugin
`cuda` and `device=cpu`; a reference cluster takes plugin `tpu` on JAX's
CPU devices. The whole-workload case runs the same seeded traffic through
one cluster of each package (k=2 m=1 on 3 OSDs, pg_num 4) and holds every
read, every store's objects (shard bytes, attrs with the csum vectors,
the PG log and info omap), the acting sets and the deep scrub's counts
equal between them. Then the reference's named cluster cases run on the
port (tests/test_offload.py:391, :438, :499, tests/test_scrub.py:41, :74,
tests/test_ec_rmw.py:382), and an `OSD(device="cuda")` must raise
DeviceUnavailable at start() on a machine without a card.

Every cluster case runs under `asyncio.wait_for(..., 30)` and a hard
SIGALRM timeout, with the daemons stopped by bounded stops.
"""
from __future__ import annotations

import asyncio
import json
import random
import signal
import types

import pytest
import torch

from ceph_tpu import offload as ref_offload
from ceph_tpu.crush.osdmap import PG as RefPG
from ceph_tpu.mon import MonMap as RefMonMap, Monitor as RefMonitor
from ceph_tpu.mon.paxos import Paxos as RefPaxos
from ceph_tpu.msg.messenger import Connection as RefConnection
from ceph_tpu.objectstore.store import Transaction as RefTransaction
from ceph_tpu.osd.daemon import OSD as RefOSD
from ceph_tpu.rados import RadosClient as RefRadosClient
from ceph_tpu_torch import offload
from ceph_tpu_torch.crush.osdmap import PG
from ceph_tpu_torch.device import DeviceUnavailable
from ceph_tpu_torch.ec.plugin_cuda import ErasureCodeCuda
from ceph_tpu_torch.mon import MonMap, Monitor
from ceph_tpu_torch.mon.paxos import Paxos
from ceph_tpu_torch.msg.messenger import Connection
from ceph_tpu_torch.objectstore.store import Transaction
from ceph_tpu_torch.osd.daemon import OSD
from ceph_tpu_torch.qa import faultinject
from ceph_tpu_torch.rados import RadosClient

from tests.test_mon import free_ports

CASE_TIMEOUT_S = 30
HARD_TIMEOUT_S = 60
W = 2 * 4096        # stripe width of k=2 (4 KiB chunks)

PKGS = {
    "ref": types.SimpleNamespace(
        name="ref", Monitor=RefMonitor, MonMap=RefMonMap, OSD=RefOSD,
        RadosClient=RefRadosClient, PG=RefPG, Transaction=RefTransaction,
        offload=ref_offload, device_plugin="tpu", profile_extra={},
        osd_kwargs={}),
    "port": types.SimpleNamespace(
        name="port", Monitor=Monitor, MonMap=MonMap, OSD=OSD,
        RadosClient=RadosClient, PG=PG, Transaction=Transaction,
        offload=offload, device_plugin="cuda",
        profile_extra={"device": "cpu"}, osd_kwargs={"device": "cpu"}),
}


def run(coro, timeout=CASE_TIMEOUT_S):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@pytest.fixture(autouse=True)
def _guards(monkeypatch):
    """Both packages' fast timers (tests/test_cluster.py's), a hard
    timeout that fires even in a loop that never yields, and the port's
    own leak gates (tests/conftest.py gates the reference's modules)."""
    for paxos, conn, osd in ((Paxos, Connection, OSD),
                             (RefPaxos, RefConnection, RefOSD)):
        monkeypatch.setattr(paxos, "ELECTION_TIMEOUT", 0.15)
        monkeypatch.setattr(paxos, "LEASE_INTERVAL", 0.2)
        monkeypatch.setattr(paxos, "LEASE_TIMEOUT", 1.0)
        monkeypatch.setattr(paxos, "ACCEPT_TIMEOUT", 0.8)
        monkeypatch.setattr(conn, "KEEPALIVE_INTERVAL", 0.3)
        monkeypatch.setattr(conn, "KEEPALIVE_TIMEOUT", 1.5)
        monkeypatch.setattr(conn, "PARK_TIMEOUT", 2.0)
        monkeypatch.setattr(osd, "HB_INTERVAL", 0.25)
        monkeypatch.setattr(osd, "HB_GRACE", 1.2)

    def expire(signum, frame):
        raise TimeoutError(f"test ran past {HARD_TIMEOUT_S} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, HARD_TIMEOUT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
        faultinject.set_enabled(False)
        faultinject.reset(seed=0)
    from ceph_tpu_torch.utils import loopprof, sanitizer
    assert not loopprof.installed_loops(), "port loopprof left armed"
    strays = sanitizer.take_foreign_call_soon()
    assert not strays, f"port sanitizer saw foreign call_soon: {strays}"


class ClusterHarness:
    """tests/test_cluster.py:41-120's harness over the package `pkg`."""

    def __init__(self, pkg, tmp_path, n_osds: int = 3):
        self.pkg = pkg
        tmp_path.mkdir(parents=True, exist_ok=True)
        port = free_ports(1)[0]
        self.monmap = pkg.MonMap({"m0": ("127.0.0.1", port)})
        self.tmp_path = tmp_path
        self.mons: dict = {}
        self.osds: dict = {}
        self.n_osds = n_osds
        self.clients: list = []

    @property
    def mon_addrs(self):
        return list(self.monmap.mons.values())

    async def start(self) -> None:
        for name in self.monmap.mons:
            mon = self.pkg.Monitor(
                name, self.monmap,
                store_path=str(self.tmp_path / f"mon.{name}"))
            self.mons[name] = mon
            await mon.start()
        deadline = asyncio.get_running_loop().time() + 10
        while not any(m.paxos.is_leader() and m.paxos.is_active()
                      for m in self.mons.values()):
            if asyncio.get_running_loop().time() > deadline:
                raise TimeoutError("no mon leader")
            await asyncio.sleep(0.05)
        for i in range(self.n_osds):
            await self.start_osd(i)

    async def start_osd(self, i: int, **kwargs):
        osd = self.pkg.OSD(i, self.mon_addrs,
                           **{**self.pkg.osd_kwargs, **kwargs})
        self.osds[i] = osd
        await osd.start()
        return osd

    async def kill_osd(self, i: int) -> None:
        await self.osds.pop(i).stop()

    async def client(self):
        c = self.pkg.RadosClient(self.mon_addrs)
        await c.connect()
        self.clients.append(c)
        return c

    async def wait_osd_down(self, i: int, timeout: float = 10.0) -> None:
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            maps = [o.osdmap for o in self.osds.values()]
            if maps and all(i in m.osds and not m.osds[i].up for m in maps):
                return
            if asyncio.get_running_loop().time() > deadline:
                raise TimeoutError(f"osd.{i} never marked down")
            await asyncio.sleep(0.05)

    async def wait_clean(self, pool: str, pg_num: int, size: int,
                         timeout: float = 15.0) -> None:
        """Every PG of `pool` active on a full acting set with nothing
        left to recover."""
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            prim = [pg for o in self.osds.values() for pg in o.pgs.values()
                    if pg.pool.name == pool and pg.is_primary()]
            if len(prim) == pg_num and all(
                    pg.state == "active" and not pg._pending_recovery
                    and not pg._deferred_activate
                    and sorted(pg.acting) == sorted(self.osds)[:size]
                    for pg in prim):
                return
            if asyncio.get_running_loop().time() > deadline:
                raise TimeoutError(f"pool {pool} never clean")
            await asyncio.sleep(0.05)

    async def stop(self) -> None:
        for c in self.clients:
            try:
                await asyncio.wait_for(c.shutdown(), 5)
            except Exception:
                pass
        for osd in list(self.osds.values()):
            try:
                await asyncio.wait_for(osd.stop(), 5)
            except Exception:
                pass
        for mon in self.mons.values():
            try:
                await asyncio.wait_for(mon.stop(), 5)
            except Exception:
                pass


async def ec_cluster(pkg, tmp_path, k: int, m: int, n_osds: int,
                     pg_num: int = 1, plugin: str | None = None,
                     profile: dict | None = None):
    """tests/test_ec_rmw.py:24's make_ec_cluster over `pkg`; the plugin
    defaults to the package's device plugin."""
    c = ClusterHarness(pkg, tmp_path, n_osds=n_osds)
    await c.start()
    cl = await c.client()
    prof = {"plugin": plugin or pkg.device_plugin, "k": str(k), "m": str(m),
            **(profile or {}), **pkg.profile_extra}
    await cl.command({"prefix": "osd erasure-code-profile set",
                      "name": "prof", "profile": prof})
    await cl.pool_create("ecpool", pg_num=pg_num, pool_type="erasure",
                         erasure_code_profile="prof")
    return c, cl, cl.ioctx("ecpool")


def corrupt_in_store(pkg, osd, pg, oid, flip_at=10):
    """tests/test_scrub.py:30-38: flip a byte by a raw store write, so
    only the EC per-chunk csum can catch it."""
    cid, gh = pg.backend.coll(), pg.backend.ghobject(oid)
    blob = bytearray(osd.store.read(cid, gh))
    blob[flip_at] ^= 0xFF
    osd.store.queue_transaction(
        pkg.Transaction().write(cid, gh, 0, bytes(blob)))


def primary_pg(c, oid):
    for osd in c.osds.values():
        for pg in osd.pgs.values():
            if pg.is_primary() and oid in pg.list_objects():
                return pg
    raise AssertionError(f"no primary holds {oid}")


def store_dump(osd) -> dict:
    """Every object of an OSD's store: bytes, attrs and omap (the shards
    with their csum vectors, the PG log and info keys)."""
    st = osd.store
    out = {}
    for cid in sorted(st.list_collections(), key=str):
        for gh in st.collection_list(cid):
            out[f"{cid}/{gh}"] = (st.read(cid, gh), st.getattrs(cid, gh),
                                  st.omap_get(cid, gh))
    return out


# -- one workload through both packages ---------------------------------------

async def _workload(pkg, tmp_path) -> dict:
    """The seeded workload of the parity case; what it saw, for the
    comparison."""
    rng = random.Random(20)
    seen: dict = {"reads": []}
    c, cl, io = await ec_cluster(pkg, tmp_path, 2, 1, 3, pg_num=4)
    try:
        model: dict[str, bytearray] = {}

        async def read_all(tag):
            for oid in sorted(model):
                got = await io.read(oid)
                assert got == bytes(model[oid]), (pkg.name, tag, oid)
                seen["reads"].append((tag, oid, got))

        # write_full, append, ranged overwrites, truncate and a hole:
        # tests/test_ec_rmw.py:44-86's verbs
        for i in range(6):
            data = rng.randbytes(rng.choice([100, W, 3 * W - 7, 2 * W + 5]))
            await io.write_full(f"o{i}", data)
            model[f"o{i}"] = bytearray(data)
        for i, size in enumerate([100, W, W - 100, 3 * W + 17]):
            piece = rng.randbytes(size)
            await io.append("o0", piece)
            model["o0"] += piece
        for off, size in [(10, 50), (W - 30, 60), (W, W), (2 * W + 1, 2)]:
            piece = rng.randbytes(size)
            await io.write("o1", piece, offset=off)
            obj = model["o1"]
            if len(obj) < off + size:
                obj += b"\0" * (off + size - len(obj))
            obj[off:off + size] = piece
        await io.truncate("o2", 40)
        del model["o2"][40:]
        await io.write("h", b"tail", offset=3 * W + 5)
        model["h"] = bytearray(b"\0" * (3 * W + 5) + b"tail")
        await read_all("healthy")
        omap = c.osds[0].osdmap
        pool = omap.get_pool("ecpool")
        seen["acting"] = [list(omap.pg_to_up_acting_osds(
            pkg.PG(pool.id, ps))[1]) for ps in range(pool.pg_num)]

        # one OSD down: degraded reads
        await c.kill_osd(2)
        await c.wait_osd_down(2)
        await read_all("degraded")
        omap = c.osds[0].osdmap
        seen["acting_down"] = [list(omap.pg_to_up_acting_osds(
            pkg.PG(pool.id, ps))[1]) for ps in range(pool.pg_num)]

        # back on an empty store (a replaced disk): recovery rebuilds
        # its shard of every object
        await c.start_osd(2)
        await c.wait_clean("ecpool", pool.pg_num, 3)
        await read_all("recovered")
        seen["stores_recovered"] = {i: store_dump(o)
                                    for i, o in sorted(c.osds.items())}

        # a flipped shard byte: deep scrub finds and repairs it
        prim = primary_pg(c, "o0")
        holder = min(i for i in c.osds if i != prim.host.whoami)
        vpg = next(pg for pg in c.osds[holder].pgs.values()
                   if "o0" in pg.list_objects())
        corrupt_in_store(pkg, c.osds[holder], vpg, "o0")
        scrubs = []
        for i in sorted(c.osds):
            for pgid in sorted(c.osds[i].pgs, key=lambda p: p.ps):
                pg = c.osds[i].pgs[pgid]
                if pg.is_primary():
                    res = await pg.scrub(deep=True)
                    scrubs.append((pgid.ps, res["errors"], res["repaired"],
                                   sorted(res["inconsistent"])))
        seen["scrubs"] = scrubs
        await read_all("scrubbed")
        seen["stores"] = {i: store_dump(o) for i, o in sorted(c.osds.items())}
        svc = pkg.offload.get_service()
        seen["fallback_ops"] = svc.stats["fallback_ops"]
        seen["batches"] = svc.stats["batches"]
    finally:
        await c.stop()
    return seen


def test_workload_equal_between_packages(tmp_path, monkeypatch):
    """The same seeded writes, degraded reads, recovery and deep scrub
    through a reference cluster (plugin tpu) and a port cluster (plugin
    cuda on the CPU): equal reads, store contents, acting sets and scrub
    counts; the scrub repairs exactly the flipped shard. Both clients
    take one instance nonce, so the reqids in the PG logs agree."""
    import secrets
    monkeypatch.setattr(secrets, "randbits", lambda bits: 0xC0FFEE)
    ref = run(_workload(PKGS["ref"], tmp_path / "ref"))
    port = run(_workload(PKGS["port"], tmp_path / "port"))
    assert port["reads"] == ref["reads"]
    assert port["acting"] == ref["acting"]
    assert port["acting_down"] == ref["acting_down"]
    assert 2 not in sum(port["acting_down"], [])
    assert port["scrubs"] == ref["scrubs"]
    assert sum(s[1] for s in port["scrubs"]) == 1
    assert sum(s[2] for s in port["scrubs"]) == 1
    assert [s[3] for s in port["scrubs"] if s[3]] == [["o0"]]
    for key in ("stores_recovered", "stores"):
        assert sorted(port[key]) == sorted(ref[key])
        for i in ref[key]:
            assert port[key][i].keys() == ref[key][i].keys(), (key, i)
            for name in ref[key][i]:
                assert port[key][i][name] == ref[key][i][name], \
                    (key, i, name)
    shards = [v for v in port["stores"][0].values() if "csum" in v[1]]
    assert shards and all(json.loads(v[1]["csum"]) for v in shards)
    assert port["fallback_ops"] == 0 and port["batches"] > 0


# -- the reference's named cluster cases, on the port ------------------------

PORT = PKGS["port"]


def test_cross_pg_writes_share_one_device_batch(tmp_path, monkeypatch):
    """tests/test_offload.py:391 on the port: two concurrent writes to
    objects in different PGs coalesce into one encode_stripes dispatch."""
    shapes: list[int] = []
    orig = ErasureCodeCuda.encode_stripes

    def spy(self, data):
        shapes.append(int(data.shape[0]))
        return orig(self, data)
    monkeypatch.setattr(ErasureCodeCuda, "encode_stripes", spy)

    async def body():
        c, cl, io = await ec_cluster(PORT, tmp_path, 2, 1, 3, pg_num=4)
        svc = offload.get_service()
        try:
            svc.linger_ms = 300.0
            osd = next(iter(c.osds.values()))
            names, seen = [], set()
            for i in range(64):
                pg = osd.osdmap.object_to_pg("ecpool", f"x{i}")
                if pg not in seen:
                    seen.add(pg)
                    names.append(f"x{i}")
                if len(names) == 2:
                    break
            payloads = {n: bytes([i]) * W for i, n in enumerate(names)}
            base = dict(svc.stats)
            await asyncio.gather(*[io.write_full(n, payloads[n])
                                   for n in names])
            svc.linger_ms = 2.0
            assert max(shapes) >= 2, shapes
            assert svc.stats["coalesced_ops"] - base["coalesced_ops"] >= 1
            for n in names:
                assert await io.read(n) == payloads[n]
        finally:
            svc.linger_ms = 2.0
            await c.stop()
    run(body())


def test_armed_device_failure_falls_back_no_lost_ops(tmp_path):
    """tests/test_offload.py:438 on the port, through qa/faultinject: an
    armed device failure sends its batch to the host fallback with no
    lost op, the OSD's health metric trips (one dispatch slot, breaker
    threshold 1), and it clears after the breaker cooldown."""
    async def body():
        c, cl, io = await ec_cluster(PORT, tmp_path, 2, 1, 3)
        try:
            svc = offload.get_service()
            svc.apply_setting("ec_offload_device_count", 1)
            svc.breaker_threshold = 1
            svc.breaker_reset_s = 60.0
            osd = next(iter(c.osds.values()))
            faultinject.set_enabled(True)
            faultinject.arm_device_failures(1)
            payloads = {f"f{i}": bytes([i]) * (2 * W) for i in range(8)}
            await asyncio.gather(*[io.write_full(n, p)
                                   for n, p in payloads.items()])
            assert svc.degraded
            hm = osd._mgr_health_metrics()["offload"]
            assert hm["degraded"] and hm["fallback_ops"] >= 1
            assert hm["breaker_trips"] == 1
            for n, p in payloads.items():
                assert await io.read(n) == p
            faultinject.set_enabled(False)
            svc.breaker_reset_s = 0.05
            await asyncio.sleep(0.06)
            fallback = svc.stats["fallback_ops"]
            await io.write_full("recovered", b"r" * W)
            assert not svc.degraded
            assert not osd._mgr_health_metrics()["offload"]["degraded"]
            assert svc.stats["fallback_ops"] == fallback
            assert await io.read("recovered") == b"r" * W
        finally:
            await c.stop()
    run(body())


def test_admin_socket_commands_and_hot_config(tmp_path):
    """tests/test_offload.py:499 on the port: `ec offload status` /
    `ec offload flush` on a real OSD's admin socket, and the ec_offload_*
    options reach the live service."""
    async def body():
        c = ClusterHarness(PORT, tmp_path, n_osds=2)
        await c.start()
        osd = await c.start_osd(7, admin_socket_path=str(tmp_path /
                                                         "osd7.asok"))
        svc = offload.get_service()
        try:
            st = osd.asok.execute({"prefix": "ec offload status"})
            assert "error" not in st
            res = st["result"]
            assert res["enabled"] is True
            assert {"max_batch_bytes", "linger_ms",
                    "max_queue_bytes"} <= set(res["settings"])
            fl = osd.asok.execute({"prefix": "ec offload flush"})
            assert fl["result"]["flushed_buckets"] == 0
            osd.config.set("ec_offload_linger_ms", 7.5)
            assert svc.linger_ms == 7.5
            osd.config.set("ec_offload_max_batch_bytes", 1 << 20)
            assert svc.max_batch_bytes == 1 << 20
            osd.config.set("ec_offload_enabled", False)
            assert svc.enabled is False
            osd.config.set("ec_offload_enabled", True)
            assert svc.enabled is True
            assert set(osd._mgr_device_metrics()) <= {
                f"cpu:{i}" for i in range(8)} | {"host"}
        finally:
            offload.set_enabled(True)
            svc.apply_setting("ec_offload_linger_ms", 2.0)
            svc.apply_setting("ec_offload_max_batch_bytes", 8 << 20)
            await c.stop()
    run(body())


@pytest.mark.parametrize("own_shard", [False, True],
                         ids=["replica_shard", "primary_shard"])
def test_deep_scrub_repairs_ec_shard(tmp_path, own_shard):
    """tests/test_scrub.py:41 (a non-primary shard) and :74 (the
    primary's own shard) on the port: a light scrub reads no data and
    finds nothing; a deep scrub finds and repairs the flipped shard, and
    a second deep scrub comes back clean."""
    async def body():
        c, cl, io = await ec_cluster(PORT, tmp_path, 2, 1, 3)
        try:
            payload = random.Random(3).randbytes(
                2 * 8192 if own_shard else 3 * 8192 + 100)
            await io.write_full("obj", payload)
            prim = primary_pg(c, "obj")
            if own_shard:
                corrupt_in_store(PORT, prim.host, prim, "obj")
            else:
                victim = next(o for i, o in c.osds.items()
                              if i != prim.host.whoami)
                vpg = next(pg for pg in victim.pgs.values()
                           if "obj" in pg.list_objects())
                corrupt_in_store(PORT, victim, vpg, "obj")
                res = await prim.scrub(deep=False)
                assert res["errors"] == 0
            res = await prim.scrub(deep=True)
            assert res["errors"] == 1 and res["repaired"] == 1
            assert res["inconsistent"] == ["obj"]
            res = await prim.scrub(deep=True)
            assert res["errors"] == 0, res
            assert await io.read("obj") == payload
        finally:
            await c.stop()
    run(body())


@pytest.mark.parametrize("plugin,profile,n_osds", [
    ("isa", {"k": "2", "m": "2"}, 4),
    ("clay", {"k": "2", "m": "2"}, 4),
    ("shec", {"k": "2", "m": "2", "c": "1"}, 4),
    ("lrc", {"k": "2", "m": "2", "l": "2"}, 6),
    ("cuda", {"k": "2", "m": "2"}, 4),
])
def test_ec_cluster_path_is_plugin_agnostic(tmp_path, plugin, profile,
                                            n_osds):
    """tests/test_ec_rmw.py:382 on the port's plugins (each with
    device=cpu): full writes, an append, an interior overwrite, a
    truncate and a degraded read with one shard holder down."""
    async def body():
        c = ClusterHarness(PORT, tmp_path, n_osds=n_osds)
        try:
            await c.start()
            cl = await c.client()
            await cl.command({"prefix": "osd erasure-code-profile set",
                              "name": "prof",
                              "profile": {"plugin": plugin, **profile,
                                          "device": "cpu"}})
            await cl.pool_create("ecpool", pg_num=2, pool_type="erasure",
                                 erasure_code_profile="prof")
            io = cl.ioctx("ecpool")
            rng = random.Random(5)
            model: dict[str, bytearray] = {}
            for i in range(4):
                data = rng.randbytes(rng.choice([100, W, 3 * W - 7]))
                await io.write_full(f"o{i}", data)
                model[f"o{i}"] = bytearray(data)
            piece = rng.randbytes(W + 33)
            await io.append("o0", piece)
            model["o0"] += piece
            await io.write("o1", b"ZZZZ", offset=W - 2)
            if len(model["o1"]) < W + 2:
                model["o1"] += b"\0" * (W + 2 - len(model["o1"]))
            model["o1"][W - 2:W + 2] = b"ZZZZ"
            await io.truncate("o2", 40)
            del model["o2"][40:]
            for oid, want in model.items():
                assert await io.read(oid) == bytes(want), (plugin, oid)
            victim = max(c.osds)
            await c.kill_osd(victim)
            await c.wait_osd_down(victim)
            for oid, want in model.items():
                assert await io.read(oid) == bytes(want), \
                    (plugin, oid, "degraded")
        finally:
            await c.stop()
    run(body())


def test_clay_subchunk_repair_goes_through_the_service(tmp_path,
                                                      monkeypatch):
    """tests/test_faultinject.py:417 on the port: a CLAY pool's
    single-shard recovery fetches d partial helper fragments, not k whole
    chunks, and hands them to the OSD's offload service
    (`decode_shards_async(..., fragments=True)`); the rebuilt shards read
    back equal."""
    from ceph_tpu_torch.osd import ec_util
    calls = []
    orig = ec_util.decode_shards_async

    async def spy(*args, **kwargs):
        calls.append((kwargs.get("service"), kwargs.get("fragments")))
        return await orig(*args, **kwargs)
    monkeypatch.setattr(ec_util, "decode_shards_async", spy)

    def repair_totals(c):
        return (sum(pg.backend.repair_bytes_fetched for o in c.osds.values()
                    for pg in o.pgs.values()),
                sum(pg.backend.repair_bytes_full for o in c.osds.values()
                    for pg in o.pgs.values()))

    async def body():
        c, cl, io = await ec_cluster(PORT, tmp_path, 4, 2, 6, plugin="clay",
                                     profile={"d": "5"})
        try:
            obj = cl.osdmap.get_pool("ecpool").stripe_width
            rng = random.Random(3)
            model = {f"o{i}": rng.randbytes(obj) for i in range(3)}
            for oid, data in model.items():
                await io.write_full(oid, data)
            store = c.osds[5].store
            await c.kill_osd(5)
            await c.wait_osd_down(5)
            fresh = {f"d{i}": rng.randbytes(obj) for i in range(4)}
            for oid, data in fresh.items():
                await io.write_full(oid, data)
            f0, full0 = repair_totals(c)
            await c.start_osd(5, store=store)
            await c.wait_clean("ecpool", 1, 6)
            f1, full1 = repair_totals(c)
            assert full1 - full0 > 0
            assert (f1 - f0) / (full1 - full0) < 0.9
            svc = offload.get_service()
            assert (svc, True) in calls
            for oid, data in {**model, **fresh}.items():
                assert await io.read(oid) == data, oid
        finally:
            await c.stop()
    run(body())


# -- the device seam -----------------------------------------------------------

@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a card is present: device='cuda' is valid here")
def test_osd_on_cuda_without_a_card_raises_at_start():
    """No silent fallback: an OSD asked for the card raises at start()
    on a machine without one, before it mounts its store, and no service
    is built for its loop."""
    async def body():
        osd = OSD(0, [("127.0.0.1", free_ports(1)[0])])
        assert osd.device == "cuda"
        with pytest.raises(DeviceUnavailable):
            await osd.start()
        assert offload.service_for(asyncio.get_running_loop()) is None
        assert not osd.store.list_collections()
    run(body())


def test_second_device_list_on_one_loop_raises():
    """One loop's service has one device list: an OSD naming another
    raises ValueError at start()."""
    async def body():
        svc = offload.get_service(["cpu"] * 4)
        osd = OSD(0, [("127.0.0.1", free_ports(1)[0])], device="cpu")
        with pytest.raises(ValueError, match="offload service"):
            await osd.start()
        assert len(svc.devices) == 4
        osd.store.umount()
    run(body())
