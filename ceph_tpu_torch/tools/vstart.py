"""vstart: boot a dev cluster (mons + osds) in one process.

Re-creation of the reference's src/vstart.sh developer cluster: spin up
a monitor quorum and a set of OSDs on localhost sockets, then hand out
librados-subset clients. Used by tests, the verify workflow, and the
CLI smoke mode (`python -m ceph_tpu_torch.tools.vstart --smoke`).

Idiomatic divergences: daemons are asyncio objects in one process (the
reference forks real processes); `--smoke` runs a writeback workload
the way qa/standalone/ceph-helpers.sh tests do, instead of leaving an
interactive cluster behind.

`device` (default "cuda") is the OSDs' device, handed to every
in-process OSD and to every worker's `boot_osd`; without a card an OSD
raises DeviceUnavailable in its start(), before it joins the map.
`device="cpu"` runs every OSD's kernels as their plain versions. The
smoke's EC profile names the same device.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import socket
import sys
import tempfile

from ceph_tpu_torch.mon.monitor import MonMap, Monitor
from ceph_tpu_torch.osd.daemon import OSD
from ceph_tpu_torch.rados.client import RadosClient

MDS_POOLS = ("cephfs_metadata", "cephfs_data")
RGW_POOL = "rgw_index"


def free_ports(n: int) -> list[int]:
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


class VCluster:
    """A running dev cluster: n mons + m osds, all in-process."""

    def __init__(self, base_dir: str, n_mons: int = 1, n_osds: int = 3,
                 with_mgr: bool = False, with_mds: bool = False,
                 with_rgw: bool = False, reactor_shards: int = 1,
                 reactor_procs: int = 0, device: str = "cuda"):
        ports = free_ports(n_mons)
        self.monmap = MonMap({f"m{i}": ("127.0.0.1", ports[i])
                              for i in range(n_mons)})
        self.base_dir = base_dir
        self.n_osds = n_osds
        self.with_mgr = with_mgr
        self.with_mds = with_mds
        self.with_rgw = with_rgw
        self.device = device
        # sharded reactor: OSDs round-robin across N event-loop shards;
        # mons, mgr, mds, rgw, and clients stay on shard 0 (the calling
        # loop). 1 = the classic single-loop cluster, no pool at all.
        # reactor_procs > 0 forks the shards into worker PROCESSES
        # instead (`--procs`): OSDs boot over the admin-socket control
        # channel and self.osds holds WorkerOSDRef handles, not OSDs.
        self.reactor_shards = max(1, int(reactor_shards))
        self.reactor_procs = max(0, int(reactor_procs))
        if self.reactor_procs and self.reactor_shards > 1:
            raise ValueError("--shards and --procs are mutually "
                             "exclusive")
        self.pool = None
        self.proc_pool = None
        self._shard_of: dict[int, int] = {}
        self.mons: dict[str, Monitor] = {}
        self.osds: dict[int, OSD] = {}
        self.mgr = None
        self.mds = None
        self.rgw = None
        self.clients: list[RadosClient] = []

    @property
    def mon_addrs(self) -> list[tuple[str, int]]:
        return list(self.monmap.mons.values())

    async def start(self) -> None:
        if self.reactor_procs:
            from ceph_tpu_torch.utils.reactor import ProcShardPool
            self.proc_pool = ProcShardPool(self.reactor_procs,
                                           name="vstart",
                                           base_dir=self.base_dir)
            await self.proc_pool.start()
        elif self.reactor_shards > 1:
            from ceph_tpu_torch.utils.reactor import ShardPool
            self.pool = ShardPool(self.reactor_shards, name="vstart")
        for name in self.monmap.mons:
            mon = Monitor(name, self.monmap,
                          store_path=f"{self.base_dir}/mon.{name}")
            self.mons[name] = mon
            await mon.start()
        deadline = asyncio.get_running_loop().time() + 30
        while not any(m.paxos.is_leader() and m.paxos.is_active()
                      for m in self.mons.values()):
            if asyncio.get_running_loop().time() > deadline:
                raise TimeoutError("monitor quorum never formed")
            await asyncio.sleep(0.05)
        for i in range(self.n_osds):
            await self.start_osd(i)
        if self.with_mgr:
            from ceph_tpu_torch.mgr import MgrDaemon
            self.mgr = MgrDaemon(self.mon_addrs)
            await self.mgr.start()
        if self.with_mds:
            from ceph_tpu_torch.mds.daemon import MDSDaemon
            cl = await self.client()
            for pool in MDS_POOLS:
                await cl.pool_create(pool, pg_num=8,
                                     size=min(3, self.n_osds))
            self.mds = MDSDaemon(self.mon_addrs,
                                 metadata_pool=MDS_POOLS[0],
                                 data_pool=MDS_POOLS[1])
            await self.mds.start()
        if self.with_rgw:
            from ceph_tpu_torch.rgw.gateway import RGWGateway
            cl = await self.client()
            await cl.pool_create(RGW_POOL, pg_num=8,
                                 size=min(3, self.n_osds))
            self.rgw = RGWGateway(cl.ioctx(RGW_POOL))
            await self.rgw.start()

    async def start_osd(self, i: int, store=None):
        if self.proc_pool is not None:
            if store is not None:
                raise ValueError("a store object cannot cross the "
                                 "process boundary")
            import torch

            from ceph_tpu_torch.ops import _build
            from ceph_tpu_torch.tools.cluster_boot import (WorkerOSDRef,
                                                           boot_worker_osd)
            # the parent builds stale kernels (a no-op once they are
            # fresh) before a worker would run nvcc on its loop at its
            # first dispatch
            if self.device != "cpu" and torch.cuda.is_available():
                _build.build()
            res = await boot_worker_osd(self.proc_pool, i, self.mon_addrs,
                                        self.device)
            ref = WorkerOSDRef(self.proc_pool, i, res["shard"],
                               tuple(res["addr"]))
            self.osds[i] = ref
            return ref
        osd = OSD(i, self.mon_addrs, store=store, device=self.device)
        self.osds[i] = osd
        if self.pool is not None:
            shard = self._shard_of.setdefault(i, self.pool.place(i))
            await self.pool.run_on(shard, osd.start())
        else:
            await osd.start()
        return osd

    async def kill_osd(self, i: int) -> None:
        osd = self.osds.pop(i)
        if self.proc_pool is not None:
            await self.proc_pool.stop_osd(i)
            return
        shard = self._shard_of.get(i)
        if self.pool is not None and shard is not None:
            await self.pool.run_on(shard, osd.stop())
        else:
            await osd.stop()

    async def client(self) -> RadosClient:
        c = RadosClient(self.mon_addrs)
        await c.connect()
        self.clients.append(c)
        return c

    async def stop(self) -> None:
        # bounded_stop, not bare wait_for: a timeout must REAP the
        # half-finished daemon stop (cancel + await) instead of
        # abandoning it, or its connection/dispatch tasks are destroyed
        # pending at loop close (the "Task was destroyed" teardown spam)
        from ceph_tpu_torch.utils.async_util import bounded_stop
        for daemon in (self.rgw, self.mds, self.mgr):
            if daemon is not None:
                await bounded_stop(daemon.stop(), 20)
        for c in self.clients:
            await bounded_stop(c.shutdown(), 20)
        if self.proc_pool is not None:
            # workers stop their own OSDs inside the shutdown verb
            await self.proc_pool.shutdown()
            self.proc_pool = None
            self.osds.clear()
        for i, osd in list(self.osds.items()):
            shard = self._shard_of.get(i)
            if self.pool is not None and shard is not None:
                # stop on the owning shard: the daemon's tasks belong
                # to that loop (loop-affinity rule)
                await self.pool.run_on(shard,
                                       bounded_stop(osd.stop(), 20))
            else:
                await bounded_stop(osd.stop(), 20)
        for mon in self.mons.values():
            await bounded_stop(mon.stop(), 20)
        if self.pool is not None:
            await self.pool.shutdown()
            self.pool = None

    def status(self) -> dict:
        leader = next((m for m in self.mons.values()
                       if m.paxos.is_leader()), None)
        osdmap = leader.osdmon.osdmap if leader else None
        return {
            "mons": {name: {"rank": m.rank,
                            "leader": m.paxos.is_leader(),
                            "quorum": sorted(m.paxos.quorum)}
                     for name, m in self.mons.items()},
            "osdmap_epoch": osdmap.epoch if osdmap else 0,
            "osds": {i: {"up": bool(osdmap and osdmap.is_up(i)),
                         # WorkerOSDRef: PG state lives in the worker
                         # process — fetch via `worker status` instead
                         "pgs": len(getattr(o, "pgs", ()))}
                     for i, o in self.osds.items()},
            "pools": ({p.name: {"type": p.type, "size": p.size,
                                "pg_num": p.pg_num}
                       for p in osdmap.pools.values()} if osdmap else {}),
        }


async def smoke(n_mons: int, n_osds: int, shards: int = 1,
                procs: int = 0, device: str = "cuda") -> dict:
    """Boot, write/read through a replicated pool, report. Exit-code
    contract: raises on any failure, returns the status dict on success."""
    with tempfile.TemporaryDirectory(prefix="vstart-") as base:
        c = VCluster(base, n_mons=n_mons, n_osds=n_osds,
                     reactor_shards=shards, reactor_procs=procs,
                     device=device)
        try:
            await c.start()
            cl = await c.client()
            await cl.pool_create("smoke", pg_num=8, size=min(3, n_osds))
            io = cl.ioctx("smoke")
            for i in range(10):
                await io.write_full(f"o{i}", f"payload-{i}".encode() * 10)
            for i in range(10):
                got = await io.read(f"o{i}")
                want = f"payload-{i}".encode() * 10
                if got != want:
                    raise AssertionError(f"o{i}: read {got[:20]!r}...")
            listed = await io.list_objects()
            if listed != [f"o{i}" for i in range(10)]:
                raise AssertionError(f"bad listing: {listed}")
            ec_note = "skipped (needs >= 3 osds)"
            if n_osds >= 3:
                await cl.command({
                    "prefix": "osd erasure-code-profile set",
                    "name": "smokeprof",
                    "profile": {"plugin": "jerasure", "k": "2", "m": "1",
                                "technique": "reed_sol_van",
                                "device": device}})
                await cl.pool_create("smoke-ec", pg_num=4,
                                     pool_type="erasure",
                                     erasure_code_profile="smokeprof")
                ecio = cl.ioctx("smoke-ec")
                for i in range(5):
                    await ecio.write_full(f"e{i}", bytes([i + 1]) * 9000)
                for i in range(5):
                    if await ecio.read(f"e{i}") != bytes([i + 1]) * 9000:
                        raise AssertionError(f"ec readback e{i}")
                ec_note = "ok: 5 striped objects wrote+read"
            status = c.status()
            status["smoke"] = "ok: 10 objects wrote+read+listed"
            status["smoke_ec"] = ec_note
            return status
        finally:
            await c.stop()


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mons", type=int, default=1)
    p.add_argument("--osds", type=int, default=3)
    p.add_argument("--smoke", action="store_true",
                   help="run a write/read workload and exit")
    p.add_argument("--shards", type=int, default=1,
                   help="reactor shards: OSDs round-robin across N "
                        "event-loop threads (1 = single loop)")
    p.add_argument("--procs", type=int, default=0,
                   help="process-backed reactor: OSDs round-robin "
                        "across N spawned worker processes (true GIL "
                        "escape; 0 = in-process runtime)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the OSDs' and the EC profile's device")
    args = p.parse_args()
    if not args.smoke:
        p.error("only --smoke mode is supported (in-process daemons "
                "cannot outlive the interpreter)")
    status = asyncio.run(asyncio.wait_for(
        smoke(args.mons, args.osds, args.shards, args.procs,
              args.device), 120))
    print(json.dumps(status, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
