"""Ephemeral mini-cluster boot/teardown shared by the bench stages and
CLI drivers.

Three call sites used to hand-roll the same sequence — ephemeral port,
tmpdir, MonMap/Monitor boot, leader wait, OSD loop, client connect,
and the reaping teardown — and the "Task was destroyed but it is
pending" fix had to be applied to each copy separately. This is
the one copy: teardown always runs (even when an OSD fails to start
mid-loop), always through `bounded_stop`, so a wedged daemon stop is
cancelled-and-awaited rather than abandoned. Pool/profile creation
stays with the caller — that is what the call sites actually differ in.

`reactor_shards` dials the sharded reactor runtime (utils/reactor.py):
with N > 1 the OSDs are placed round-robin across N event-loop shards
(shard 0 = the calling loop, which keeps the mon and the client — the
control plane), each OSD's whole lifecycle (start, dispatch, stop)
running on its owning shard. N = 1 is byte-for-byte the old single-loop
boot: no pool, no threads.

`reactor_procs` dials the PROCESS-backed runtime instead: N spawned
worker processes (shards 1..N), OSDs placed round-robin into them and
booted over the admin-socket control channel, while the mon and client
stay in this process on shard 0. The yielded `osds` are
`WorkerOSDRef` handles — daemon state lives in the workers, so the
refs marshal everything (config, admin verbs, status) as JSON; there
is no in-process OSD object to poke.

`device` (default "cuda") is the OSDs' device, handed to the in-process
OSDs and to every worker's `boot_osd`. With workers on a card the
parent builds every stale kernel before it spawns them (a worker would
otherwise run nvcc on its loop at its first dispatch); a worker that
cannot open the card fails its boot and this raises DeviceUnavailable.
`device="cpu"` runs every OSD's kernels as their plain versions.
"""
from __future__ import annotations

import asyncio
import contextlib
import socket
import tempfile
from typing import AsyncIterator, Callable

from ceph_tpu_torch.device import DeviceUnavailable
from ceph_tpu_torch.utils.async_util import bounded_stop
from ceph_tpu_torch.utils.reactor import ProcShardPool, ShardPool


class WorkerOSDRef:
    """Parent-side handle onto an OSD hosted by a shard worker process:
    identity plus the JSON control-channel seams. Deliberately NOT an
    OSD: cross-process state must be marshalled, never reached into."""

    def __init__(self, pool: ProcShardPool, whoami: int, shard: int,
                 addr: tuple[str, int]):
        self.pool = pool
        self.whoami = whoami
        self.shard = shard
        self.addr = addr

    async def admin(self, request: dict | str, timeout: float = 30.0):
        """One control-channel verb to this OSD's worker."""
        return await self.pool.call(self.shard, request, timeout=timeout)

    async def config_set(self, key: str, value) -> None:
        """Set one option on THIS OSD only (whoami-routed — co-hosted
        OSDs in the same worker keep their values, matching the
        thread-mode `osd.config.set` semantics). Pool-wide broadcasts
        go through `pool.config_set` instead. Recorded so a respawned
        worker replays it onto this daemon's fresh boot."""
        await self.admin({"prefix": "config set", "key": key,
                          "value": value, "whoami": self.whoami})
        self.pool.record_osd_override(self.whoami, key, value)

    async def config_get(self, key: str):
        res = await self.admin({"prefix": "config get", "key": key,
                                "whoami": self.whoami})
        return res[key]

    async def status(self) -> dict:
        st = await self.admin("worker status")
        return st["osds"][str(self.whoami)]


async def boot_worker_osd(proc_pool, whoami: int, mon_addrs,
                          device: str) -> dict:
    """`proc_pool.boot_osd` on `device`; DeviceUnavailable when the
    worker cannot open it (the worker's error crosses as a
    RuntimeError naming it)."""
    try:
        return await proc_pool.boot_osd(whoami, mon_addrs, device=device)
    except RuntimeError as e:
        if DeviceUnavailable.__name__ in str(e):
            raise DeviceUnavailable(str(e)) from e
        raise


@contextlib.asynccontextmanager
async def ephemeral_cluster(
        n_osds: int, prefix: str = "ceph-tpu-",
        store_factory: Callable[[str, int], object] | None = None,
        stop_timeout: float = 20.0,
        reactor_shards: int = 1,
        reactor_procs: int = 0,
        device: str = "cuda") -> AsyncIterator[tuple]:
    """Boot mon + `n_osds` OSDs on localhost and a connected client;
    yield `(client, osds, mon)`; reap everything on exit.

    `store_factory(tmpdir, osd_id)` supplies a per-OSD ObjectStore
    (None -> MemStore default). `reactor_shards` > 1 spreads the OSDs
    over that many reactor shards; `reactor_procs` > 0 spreads them
    over that many worker PROCESSES instead (see module doc) — the two
    modes are mutually exclusive, and a store_factory cannot cross a
    process boundary."""
    import torch

    from ceph_tpu_torch.mon import MonMap, Monitor
    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.osd.daemon import OSD
    from ceph_tpu_torch.rados import RadosClient

    if reactor_procs > 0:
        if reactor_shards > 1:
            raise ValueError("reactor_shards and reactor_procs are "
                             "mutually exclusive")
        if store_factory is not None:
            raise ValueError("store_factory closures cannot cross the "
                             "process boundary: process-backed OSDs "
                             "build their own (MemStore) stores")

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    tmp = tempfile.mkdtemp(prefix=prefix)
    monmap = MonMap({"m0": ("127.0.0.1", port)})
    mon = Monitor("m0", monmap, store_path=f"{tmp}/mon")
    await mon.start()
    pool = None
    osds: list = []
    shard_of: dict[int, int] = {}
    client = None

    async def _on_shard(i: int, coro):
        """Run `coro` on OSD i's shard (inline in the 1-shard world)."""
        if pool is None:
            return await coro
        return await pool.run_on(shard_of[i], coro)

    try:
        # inside the try: a pool that fails to come up must still tear
        # the already-running mon down
        proc_pool = None
        if reactor_procs > 0:
            if device != "cpu" and torch.cuda.is_available():
                _build.build()
            proc_pool = ProcShardPool(reactor_procs, base_dir=tmp)
            await proc_pool.start()
        elif reactor_shards > 1:
            pool = ShardPool(reactor_shards)
        while not (mon.paxos.is_leader() and mon.paxos.is_active()):
            await asyncio.sleep(0.05)
        mon_addrs = list(monmap.mons.values())
        for i in range(n_osds):
            if proc_pool is not None:
                res = await boot_worker_osd(proc_pool, i, mon_addrs, device)
                osds.append(WorkerOSDRef(proc_pool, i, res["shard"],
                                         tuple(res["addr"])))
                continue
            store = store_factory(tmp, i) if store_factory else None
            osd = OSD(i, mon_addrs, store=store, device=device)
            shard_of[i] = pool.place(i) if pool is not None else 0
            await _on_shard(i, osd.start())
            osds.append(osd)
        client = RadosClient(mon_addrs)
        await client.connect()
        yield client, osds, mon
    finally:
        if client is not None:
            await bounded_stop(client.shutdown(), stop_timeout)
        if proc_pool is not None:
            # the workers stop their own OSDs inside the shutdown verb
            # (bounded, straggler-reaped), then the pool reaps the
            # processes themselves
            await proc_pool.shutdown(stop_timeout)
        for i, osd in enumerate(osds):
            if isinstance(osd, WorkerOSDRef):
                continue
            # stop each OSD ON its owning shard: its tasks, queues, and
            # connections are that loop's objects (loop-affinity rule)
            await _on_shard(i, bounded_stop(osd.stop(), stop_timeout))
        await bounded_stop(mon.stop(), stop_timeout)
        if pool is not None:
            await pool.shutdown()
