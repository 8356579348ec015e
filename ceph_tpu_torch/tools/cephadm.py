"""cephadm-lite: spec-driven cluster deployment + daemon management.

Re-creation of the reference's deployment plane at framework scope
(src/cephadm/cephadm.py bootstrap/daemon management + the mgr cephadm
orchestrator module's service specs, src/pybind/mgr/cephadm/): a
CLUSTER SPEC declares the service counts; `apply` converges the running
cluster toward it — booting missing daemons, stopping surplus ones —
and daemons restart from their persistent stores (the rolling-upgrade
primitive `orch daemon restart`).

Spec shape (JSON):
    {"mon": {"count": 3},
     "osd": {"count": 4, "backend": "bluestore", "device": "cuda"},
     "mgr": {"count": 1}, "mds": {"count": 1},
     "pools": [{"name": "rbd", "pg_num": 32, "size": 3}]}

Idiomatic divergences: daemons are asyncio objects in this process, not
containers — "deploy" is construction, "host" is this host; stores
persist under the cluster base dir, so stop/start round-trips state the
way a container restart over a bind-mounted /var/lib/ceph does.

The OSD spec's `device` (default "cuda") is the OSDs' device: without a
card an OSD raises DeviceUnavailable in its start(), before it joins the
map; "cpu" runs every OSD's kernels as their plain versions.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys

from ceph_tpu_torch.mon.monitor import MonMap, Monitor
from ceph_tpu_torch.osd.daemon import OSD
from ceph_tpu_torch.rados.client import RadosClient
from ceph_tpu_torch.utils.dout import dout


def _free_ports(n: int) -> list[int]:
    import socket
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        ports = [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()
    return ports


def _make_store(backend: str, path: str):
    if backend == "memstore":
        return None
    if backend == "filestore":
        from ceph_tpu_torch.objectstore import FileStore
        return FileStore(path)
    from ceph_tpu_torch.objectstore import BlueStore
    return BlueStore(path)


class CephadmCluster:
    """One managed cluster: daemons keyed `type.id` (orch ps names)."""

    def __init__(self, base_dir: str, auth_key: bytes | None = None):
        self.base_dir = base_dir
        self.auth_key = auth_key
        self.monmap: MonMap | None = None
        self.mons: dict[str, Monitor] = {}
        self.osds: dict[int, OSD] = {}
        self.mgrs: dict[int, object] = {}
        self.mdss: dict[int, object] = {}
        self.spec: dict = {}
        self._admin: RadosClient | None = None

    @property
    def mon_addrs(self):
        return list(self.monmap.mons.values())

    # -- orchestration -------------------------------------------------------

    async def apply(self, spec: dict) -> dict:
        """Converge toward `spec` (mgr/cephadm `orch apply`)."""
        os.makedirs(self.base_dir, exist_ok=True)
        self.spec = spec
        actions: list[str] = []
        await self._apply_mons(spec.get("mon", {}).get("count", 1),
                               actions)
        await self._apply_osds(spec.get("osd", {}), actions)
        await self._apply_mgrs(spec.get("mgr", {}).get("count", 0),
                               actions)
        await self._apply_mdss(spec.get("mds", {}).get("count", 0),
                               actions)
        for pool in spec.get("pools", []):
            admin = await self._admin_client()
            if pool["name"] not in admin.osdmap.pool_names:
                kw = {k: v for k, v in pool.items() if k != "name"}
                await admin.pool_create(pool["name"], **kw)
                actions.append(f"pool.create {pool['name']}")
        return {"applied": actions, "inventory": self.inventory()}

    async def _apply_mons(self, count: int, actions: list[str]) -> None:
        if self.monmap is None:
            ports = _free_ports(count)
            self.monmap = MonMap({f"m{i}": ("127.0.0.1", ports[i])
                                  for i in range(count)})
        elif count != len(self.monmap.mons):
            raise ValueError("mon count changes require remonmapping "
                             "(not supported; redeploy)")
        for name in self.monmap.mons:
            if name in self.mons:
                continue
            mon = Monitor(name, self.monmap,
                          store_path=os.path.join(self.base_dir,
                                                  f"mon.{name}"),
                          auth_key=self.auth_key)
            await mon.start()
            self.mons[name] = mon
            actions.append(f"mon.{name} deployed")
        deadline = asyncio.get_running_loop().time() + 30
        while not any(m.paxos.is_leader() and m.paxos.is_active()
                      for m in self.mons.values()):
            if asyncio.get_running_loop().time() > deadline:
                raise TimeoutError("monitor quorum never formed")
            await asyncio.sleep(0.05)

    async def _apply_osds(self, osd_spec: dict,
                          actions: list[str]) -> None:
        count = osd_spec.get("count", 0)
        backend = osd_spec.get("backend", "bluestore")
        for i in range(count):
            if i in self.osds:
                continue
            await self.daemon_start("osd", i, backend=backend)
            actions.append(f"osd.{i} deployed ({backend})")
        for i in sorted(self.osds):
            if i >= count:
                await self.daemon_stop("osd", i)
                actions.append(f"osd.{i} removed")

    async def _apply_mgrs(self, count: int, actions: list[str]) -> None:
        from ceph_tpu_torch.mgr import MgrDaemon
        for i in range(count):
            if i in self.mgrs:
                continue
            mgr = MgrDaemon(self.mon_addrs, auth_key=self.auth_key,
                            name=str(i))
            await mgr.start()
            self.mgrs[i] = mgr
            actions.append(f"mgr.{i} deployed")
        for i in sorted(self.mgrs):
            if i >= count:
                await self.mgrs.pop(i).stop()
                actions.append(f"mgr.{i} removed")

    async def _apply_mdss(self, count: int, actions: list[str]) -> None:
        from ceph_tpu_torch.mds import MDSDaemon
        if count:
            # each pool converges independently: a crash between the
            # two creates must heal on re-apply
            admin = await self._admin_client()
            for pool in ("cephfs_metadata", "cephfs_data"):
                if pool not in admin.osdmap.pool_names:
                    await admin.pool_create(pool, pg_num=8)
        for i in range(count):
            if i in self.mdss:
                continue
            mds = MDSDaemon(self.mon_addrs, auth_key=self.auth_key,
                            name=f"mds.{i}")
            await mds.start()
            self.mdss[i] = mds
            actions.append(f"mds.{i} deployed")
        for i in sorted(self.mdss):
            if i >= count:
                await self.mdss.pop(i).stop()
                actions.append(f"mds.{i} removed")

    # -- daemon management (orch daemon start/stop/restart) ------------------

    async def daemon_start(self, kind: str, did: int,
                           backend: str | None = None) -> None:
        if kind != "osd":
            raise ValueError("per-daemon start supports osds")
        backend = backend or self.spec.get("osd", {}).get("backend",
                                                          "bluestore")
        device = self.spec.get("osd", {}).get("device", "cuda")
        store = _make_store(backend,
                            os.path.join(self.base_dir, f"osd.{did}"))
        osd = OSD(did, self.mon_addrs, store=store,
                  auth_key=self.auth_key, device=device)
        await osd.start()
        self.osds[did] = osd

    async def daemon_stop(self, kind: str, did: int) -> None:
        if kind == "osd":
            await self.osds.pop(did).stop()
        elif kind == "mgr":
            await self.mgrs.pop(did).stop()
        elif kind == "mds":
            await self.mdss.pop(did).stop()
        else:
            raise ValueError(f"unknown daemon {kind}.{did}")

    async def daemon_restart(self, kind: str, did: int) -> None:
        """Stop + start from the same store dir — the rolling-upgrade
        primitive: state survives because stores persist on disk."""
        await self.daemon_stop(kind, did)
        await asyncio.sleep(0.1)
        if kind == "osd":
            await self.daemon_start("osd", did)
        elif kind == "mgr":
            from ceph_tpu_torch.mgr import MgrDaemon
            mgr = MgrDaemon(self.mon_addrs, auth_key=self.auth_key,
                            name=str(did))
            await mgr.start()
            self.mgrs[did] = mgr
        elif kind == "mds":
            from ceph_tpu_torch.mds import MDSDaemon
            mds = MDSDaemon(self.mon_addrs, auth_key=self.auth_key,
                            name=f"mds.{did}")
            await mds.start()
            self.mdss[did] = mds

    def inventory(self) -> dict:
        """`orch ps` — every managed daemon and where its state lives."""
        out = {}
        for name in self.mons:
            out[f"mon.{name}"] = {"status": "running",
                                  "store": f"mon.{name}"}
        for i, osd in self.osds.items():
            out[f"osd.{i}"] = {"status": "running",
                               "store": type(osd.store).__name__}
        for i in self.mgrs:
            out[f"mgr.{i}"] = {"status": "running"}
        for i in self.mdss:
            out[f"mds.{i}"] = {"status": "running"}
        return out

    async def _admin_client(self) -> RadosClient:
        if self._admin is None:
            self._admin = RadosClient(self.mon_addrs,
                                      auth_key=self.auth_key)
            await self._admin.connect()
        return self._admin

    async def stop(self) -> None:
        if self._admin is not None:
            try:
                await asyncio.wait_for(self._admin.shutdown(), 20)
            except Exception:
                pass
            self._admin = None
        for d in [*self.mdss.values(), *self.mgrs.values()]:
            try:
                await asyncio.wait_for(d.stop(), 20)
            except Exception:
                pass
        for osd in list(self.osds.values()):
            try:
                await asyncio.wait_for(osd.stop(), 20)
            except Exception:
                pass
        for mon in self.mons.values():
            try:
                await asyncio.wait_for(mon.stop(), 20)
            except Exception:
                pass
        self.mons.clear()
        self.osds.clear()
        self.mgrs.clear()
        self.mdss.clear()


async def _bootstrap_and_smoke(spec: dict, base_dir: str) -> dict:
    cluster = CephadmCluster(base_dir)
    try:
        report = await cluster.apply(spec)
        admin = await cluster._admin_client()
        status = await admin.command({"prefix": "status"})
        report["status"] = status
        if spec.get("pools"):
            io = admin.ioctx(spec["pools"][0]["name"])
            await io.write_full("cephadm-smoke", b"deployed")
            assert await io.read("cephadm-smoke") == b"deployed"
            report["smoke"] = "ok"
        return report
    finally:
        await cluster.stop()


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--apply", required=True,
                   help="cluster spec JSON file (or inline JSON)")
    p.add_argument("--base-dir", default=None)
    args = p.parse_args()
    if os.path.exists(args.apply):
        with open(args.apply) as f:
            spec = json.load(f)
    else:
        spec = json.loads(args.apply)
    import tempfile
    base = args.base_dir or tempfile.mkdtemp(prefix="cephadm-")
    report = asyncio.run(
        asyncio.wait_for(_bootstrap_and_smoke(spec, base), 180))
    print(json.dumps(report, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
