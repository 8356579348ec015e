"""Shard worker process: one reactor shard of a ProcShardPool.

Spawned by `utils/reactor.py` (`python -m ceph_tpu_torch.utils.reactor_worker
--index N --socket PATH`), this process owns ONE event loop hosting the
OSD daemons the parent places here, plus an AdminSocket bound at PATH —
the parent→worker control channel. Everything that crosses the process
boundary is either JSON over that socket (boot/stop/config/inject/
status verbs) or the cluster's own wire protocol (the messenger speaks
TCP between daemons, so client I/O, sub-op fan-out, heartbeats, and
MgrReports all flow exactly as they do in-process).

Identity: the loop registers as POOL-WIDE shard `--index` via
`reactor.adopt_worker_shard`, so loopprof gauges export as
`loop_busy_fraction_shard<N>` (not a pid-local label), `OSD.shard`
reports the pool-wide index in daemon status, and the parent's
cross-process `shard_busy_skew` merge lines up.

Device topology: the parent sets CEPH_TPU_OFFLOAD_DEVICE_PARTITION
("j/W") before spawn; this process's OSDs resolve only its round-robin
slice of the cards (`device.partition`: with fewer cards than workers,
every worker takes the first, so on one card all W workers share
cuda:0, each with its own CUDA context, pinned staging pages and copy
streams). Each OSD opens the card in `OSD.start()`, before it joins the
map; a worker that cannot open it fails `boot_osd` with
DeviceUnavailable. Three verbs are the port's own: `ec offload status`
(the loop's offload service, as an OSD's admin socket answers it),
`device status` (kernel launch counts in this process, pinned staging
bytes, the card memory this context holds; `reset` zeroes the launch
counts) and `scrub` (every hosted OSD's scrub_all, awaited).

Teardown: the `shutdown` verb (or SIGTERM) bounded-stops every hosted
OSD on the loop, then reaps the loop's leftover tasks before exiting —
a worker exit is as tail-clean as a daemon stop.
"""
from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import os
import signal
import sys
import threading
import time

from ceph_tpu_torch.utils import reactor
from ceph_tpu_torch.utils.admin_socket import AdminSocket
from ceph_tpu_torch.utils.async_util import bounded_stop, reap_all
from ceph_tpu_torch.utils.config import ConfigError
from ceph_tpu_torch.utils.dout import dout


class _Worker:
    """The worker runtime: hosted OSDs + control-channel verbs."""

    def __init__(self, index: int, socket_path: str, pool_name: str):
        self.index = index
        self.pool_name = pool_name
        self.started_at = time.monotonic()
        self.loop: asyncio.AbstractEventLoop | None = None
        self.stop_ev: asyncio.Event | None = None
        self.osds: dict[int, object] = {}
        self.asok = AdminSocket(socket_path)
        self.asok.register_command(
            "worker status", self._status,
            "worker identity, uptime, and hosted-OSD status")
        self.asok.register_command(
            "boot_osd", self._boot_osd,
            "boot one OSD in this worker: whoami, mon_addrs, "
            "[crush_location]")
        self.asok.register_command(
            "stop_osd", self._stop_osd,
            "stop one hosted OSD: whoami")
        self.asok.register_command(
            "config set", self._config_set,
            "apply one option to every hosted OSD's config — or ONE "
            "with whoami=N (observers fire in this process): key, value")
        self.asok.register_command(
            "config get", self._config_get,
            "effective value of one option (whoami=N for a specific "
            "OSD, else the first hosted one): key")
        self.asok.register_command(
            "inject", self._inject,
            "fault injection: what=crash SIGKILLs this worker process "
            "(supervisor reap + heartbeat-loss mark-down drill); "
            "what=status reports the injector; whoami=N routes any "
            "verb to that hosted OSD's injector")
        self.asok.register_command(
            "shutdown", self._shutdown,
            "stop every hosted OSD, drain the loop, and exit")
        self.asok.register_command(
            "ec offload status", self._offload_status,
            "this worker loop's offload service status (the hosted "
            "OSDs share it)")
        self.asok.register_command(
            "device status", self._device_status,
            "kernel launches in this process, pinned staging bytes and "
            "card memory of this CUDA context: [reset]")
        self.asok.register_command(
            "scrub", self._scrub,
            "scrub every primary PG of the hosted OSDs now and wait for "
            "the results: [deep]")

    # -- control-channel hooks (run on admin-socket threads) -----------------

    def _on_loop(self, coro, timeout: float = 60.0):
        """Run `coro` on the worker loop from an admin thread and wait
        out the result (the hooks are synchronous by contract)."""
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        try:
            return fut.result(timeout)
        except concurrent.futures.TimeoutError:
            fut.cancel()
            raise TimeoutError(f"worker shard{self.index}: loop call "
                               f"timed out after {timeout}s") from None

    def _status(self, req: dict) -> dict:
        return {
            "pid": os.getpid(),
            "shard": self.index,
            "pool": self.pool_name,
            "uptime_s": round(time.monotonic() - self.started_at, 1),
            # snapshot: this runs on an admin-socket thread while
            # _boot_osd inserts on the loop thread
            "osds": {str(i): o._daemon_status()
                     for i, o in list(self.osds.items())},
        }

    def _boot_osd(self, req: dict) -> dict:
        whoami = int(req["whoami"])
        if whoami in self.osds:
            raise ValueError(f"osd.{whoami} already hosted here")
        mon_addrs = [(a[0], int(a[1])) for a in req["mon_addrs"]]

        async def boot():
            from ceph_tpu_torch.osd.daemon import OSD
            osd = OSD(whoami, mon_addrs,
                      crush_location=req.get("crush_location"),
                      device=req.get("device", "cuda"))
            addr = await osd.start()
            self.osds[whoami] = osd
            return list(addr)
        addr = self._on_loop(boot())
        return {"whoami": whoami, "addr": addr, "pid": os.getpid()}

    def _stop_osd(self, req: dict) -> dict:
        whoami = int(req["whoami"])
        osd = self.osds.get(whoami)
        if osd is None:
            raise ValueError(f"osd.{whoami} not hosted here")
        # stop FIRST, untrack after: a stop that times out must leave
        # the daemon tracked (shutdown retries it; a re-boot of the
        # same id keeps hitting the already-hosted guard) rather than
        # orphaning a still-running OSD
        self._on_loop(bounded_stop(osd.stop(), 20.0))
        self.osds.pop(whoami, None)
        return {"stopped": whoami}

    def _config_set(self, req: dict) -> dict:
        """The knob-propagation seam: the parent's `config set` lands on
        every hosted OSD's Config, so hot-togglable observers (offload
        batcher, pipeline window, profiler, SLO table, faultinject)
        fire in THIS process."""
        key, value = req["key"], req["value"]
        if "whoami" in req:
            # per-OSD routing: the WorkerOSDRef handle targets ONE
            # daemon, matching thread-mode `osd.config.set` semantics
            # even when several OSDs share this worker
            osd = self.osds.get(int(req["whoami"]))
            if osd is None:
                raise ValueError(f"osd.{req['whoami']} not hosted here")
            osd.config.set(key, value)
            return {"applied": [int(req["whoami"])], "errors": []}
        applied, errors = [], []
        for whoami, osd in list(self.osds.items()):
            try:
                osd.config.set(key, value)
                applied.append(whoami)
            except ConfigError as e:
                errors.append(f"osd.{whoami}: {e}")
        # an OSD-less worker is a no-op, not an error: a pool-wide
        # broadcast must not abort half-propagated because one worker
        # happens to be (momentarily) empty. A bad key DOES error —
        # every hosted OSD rejected it.
        if self.osds and not applied:
            raise ConfigError("; ".join(errors))
        return {"applied": applied, "errors": errors}

    def _config_get(self, req: dict) -> dict:
        if "whoami" in req:
            osd = self.osds.get(int(req["whoami"]))
            if osd is None:
                raise ValueError(f"osd.{req['whoami']} not hosted here")
            return {req["key"]: osd.config.get(req["key"])}
        for osd in list(self.osds.values()):
            return {req["key"]: osd.config.get(req["key"])}
        raise ConfigError("no OSDs hosted here yet")

    def _inject(self, req: dict) -> dict:
        from ceph_tpu_torch.qa import faultinject
        if "whoami" in req:
            osd = self.osds.get(int(req["whoami"]))
            if osd is None:
                raise ValueError(f"osd.{req['whoami']} not hosted here")
            return osd._inject_admin(req)
        what = req.get("what", "status")
        if what == "status":
            return faultinject.status()
        if what == "crash":
            # SIGKILL this worker after the response flushes: the drill
            # for a dead shard host — no teardown, no goodbyes; peers
            # see heartbeat silence, the reporter quorum marks the
            # hosted OSDs down, the parent supervisor reaps the corpse
            dout("reactor", 1, f"worker shard{self.index}: injected "
                               f"crash — SIGKILL pid {os.getpid()}")
            threading.Timer(
                0.05, os.kill, (os.getpid(), signal.SIGKILL)).start()
            return {"injected": "crash", "pid": os.getpid(),
                    "shard": self.index}
        raise ValueError(f"unknown worker inject target {what!r} "
                         f"(route OSD verbs with whoami=N)")

    def _service(self):
        """The offload service of this worker's loop (built by the first
        hosted OSD's start)."""
        from ceph_tpu_torch import offload
        svc = offload.service_for(self.loop)
        if svc is None:
            raise ValueError("no OSD has started an offload service here")
        return svc

    def _offload_status(self, req: dict) -> dict:
        return self._service().status()

    def _device_status(self, req: dict) -> dict:
        import torch

        from ceph_tpu_torch.ops import crc32c, rs_codec
        out = {"pid": os.getpid(), "shard": self.index,
               "launches": {"gf_bitmatrix": rs_codec.launches,
                            "crc32c_blocks": crc32c.launches,
                            "gf_bitmatrix_csum":
                                rs_codec.encode_local_launches}}
        if req.get("reset"):
            rs_codec.launches = crc32c.launches = 0
            rs_codec.encode_local_launches = 0
        svc = self._service()
        out["devices"] = [str(d) for d in svc.devices]
        out["pinned_bytes"] = self._on_loop(self._pinned_bytes(svc))
        cards = sorted({d.index for d in svc.devices if d.type == "cuda"})
        out["cuda"] = {f"cuda:{i}": {
            "memory_allocated": torch.cuda.memory_allocated(i),
            "memory_reserved": torch.cuda.memory_reserved(i)}
            for i in cards}
        return out

    def _scrub(self, req: dict) -> dict:
        """Every hosted OSD's `scrub_all` (the awaited form of an OSD's
        `scrub` admin verb): {pg: {errors, repaired, inconsistent}}."""
        deep = bool(req.get("deep", False))

        async def scrub_all() -> dict:
            out = {}
            for osd in list(self.osds.values()):
                for pg, res in (await osd.scrub_all(deep=deep)).items():
                    if res is None:
                        raise RuntimeError(f"scrub of pg {pg} failed")
                    out[pg] = {"errors": res["errors"],
                               "repaired": res["repaired"],
                               "inconsistent": sorted(res["inconsistent"])}
            return out
        return self._on_loop(scrub_all(), timeout=float(
            req.get("timeout", 120.0)))

    @staticmethod
    async def _pinned_bytes(svc) -> int:
        """Bytes of the staging pages the service's slots hold (pinned
        on a card), read on the loop that owns them."""
        return sum(t.numel() for sl in svc._slots or ()
                   for t in sl.staging)

    def _shutdown(self, req: dict) -> dict:
        self.loop.call_soon_threadsafe(self.stop_ev.set)
        return {"stopping": True, "shard": self.index}

    # -- lifecycle ------------------------------------------------------------

    async def run(self) -> None:
        self.loop = asyncio.get_running_loop()
        self.stop_ev = asyncio.Event()
        reactor.adopt_worker_shard(self.index, self.pool_name)
        try:
            self.loop.add_signal_handler(signal.SIGTERM,
                                         self.stop_ev.set)
        except (NotImplementedError, RuntimeError):
            pass
        self.asok.start()
        dout("reactor", 1, f"worker shard{self.index} up "
                           f"(pid {os.getpid()})")
        try:
            await self.stop_ev.wait()
        finally:
            for whoami, osd in list(self.osds.items()):
                await bounded_stop(osd.stop(), 20.0)
                self.osds.pop(whoami, None)
            self.asok.stop()
            # straggler reap: anything a daemon stop left behind must
            # not be destroyed pending at loop close (the same
            # discipline as ShardPool._shard_main)
            cur = asyncio.current_task()
            await reap_all([t for t in asyncio.all_tasks()
                            if t is not cur])
            try:
                from ceph_tpu_torch.utils import loopprof
                loopprof.uninstall(self.loop)
            except Exception:
                pass
            dout("reactor", 1, f"worker shard{self.index} down")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--index", type=int, required=True,
                   help="pool-wide shard index of this worker")
    p.add_argument("--socket", required=True,
                   help="admin-socket path for the control channel")
    p.add_argument("--pool-name", default="reactor")
    args = p.parse_args(argv)
    worker = _Worker(args.index, args.socket, args.pool_name)
    asyncio.run(worker.run())
    return 0


if __name__ == "__main__":
    sys.exit(main())
