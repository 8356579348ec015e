"""MonClient: the daemon/client side of the monitor plane.

Re-creation of src/mon/MonClient.{h,cc} essentials: hunt for a live
monitor, bootstrap the monmap, subscribe to map updates, and run
commands with retry — commands bounce off peons with a leader hint
(rc=-11) and the client re-targets, like the reference's command retry
on EAGAIN/leader change. Auth is the `none` method (matching the
messenger this round).

The MonClient shares its daemon's Messenger (the reference wires
MonClient into the daemon's client messenger the same way) and speaks
over a lossy client connection: a transport fault drops the session and
the hunt loop picks another monitor.

The port's copy of ceph_tpu/mon/mon_client.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import asyncio
import time

from ceph_tpu_torch.msg.messages import (MLog, Message, MMgrMap, MMonCommand,
                                         MMonCommandAck, MMonGetMap, MMonMap,
                                         MMonMgrReport, MMonSubscribe, MOSDBoot,
                                         MOSDFailure, MOSDMapMsg)
from ceph_tpu_torch.msg.messenger import Connection, Dispatcher, Messenger, Policy
from ceph_tpu_torch.utils.dout import dout


class MonClient(Dispatcher):
    COMMAND_TIMEOUT = 10.0      # per-attempt ack wait
    HUNT_BACKOFF = 0.1

    def __init__(self, messenger: Messenger,
                 mon_addrs: list[tuple[str, int]]):
        self.messenger = messenger
        self.messenger.add_dispatcher(self)
        self.mon_addrs = [tuple(a) for a in mon_addrs]
        self.monmap: dict | None = None
        # latest pushed mgrmap (subscribe "mgrmap"): daemons resolve the
        # active mgr from this cache, never by polling commands
        self.mgrmap: dict | None = None
        self._conn: Connection | None = None
        self._cur_addr: tuple[str, int] | None = None
        self._tid = 0
        self._waiters: dict[int, asyncio.Future] = {}
        # subscriptions: what -> start epoch; re-sent after re-hunt
        self._sub_want: dict[str, int] = {}
        self.on_osdmap = None       # callback(payload dict)
        self._closed = False

    # -- connection hunt -----------------------------------------------------

    async def _ensure_conn(self) -> Connection:
        if self._conn is not None and not self._conn._closed \
                and self._conn.connected:
            return self._conn
        last_err: Exception | None = None
        for _ in range(3):
            for addr in self.mon_addrs:
                if self._closed:
                    raise ConnectionError("monclient closed")
                try:
                    conn = await self.messenger.connect(
                        addr, Policy.lossy_client())
                    self._conn = conn
                    self._cur_addr = addr
                    self._resubscribe()
                    return conn
                except Exception as e:
                    last_err = e
            await asyncio.sleep(self.HUNT_BACKOFF)
        raise ConnectionError(f"no monitor reachable: {last_err}")

    async def _retarget(self, addr: tuple[str, int] | None) -> None:
        """Drop the current session; optionally pin the next hunt to the
        leader address a peon handed us."""
        self._conn = None
        if addr is not None:
            addr = tuple(addr)
            if addr in self.mon_addrs:
                # rotate so the hunt tries the leader first
                i = self.mon_addrs.index(addr)
                self.mon_addrs = self.mon_addrs[i:] + self.mon_addrs[:i]
            else:
                self.mon_addrs.insert(0, addr)

    def _resubscribe(self) -> None:
        if self._sub_want and self._conn is not None:
            self._conn.send_message(MMonSubscribe(
                {"what": dict(self._sub_want)}))

    # -- public API ----------------------------------------------------------

    async def start(self) -> None:
        """Bootstrap: fetch the monmap from whichever mon answers."""
        conn = await self._ensure_conn()
        conn.send_message(MMonGetMap({"what": "monmap"}))

    async def command(self, cmd: dict, timeout: float = 30.0) -> dict:
        """Run a command against the leader; retries through leader hints
        and transport faults until it lands or the deadline passes."""
        deadline = time.monotonic() + timeout
        last = "no attempt"
        while time.monotonic() < deadline:
            try:
                conn = await self._ensure_conn()
            except ConnectionError as e:
                last = str(e)
                await asyncio.sleep(self.HUNT_BACKOFF)
                continue
            self._tid += 1
            tid = self._tid
            fut = asyncio.get_running_loop().create_future()
            self._waiters[tid] = fut
            conn.send_message(MMonCommand({"tid": tid, "cmd": cmd}))
            try:
                ack = await asyncio.wait_for(
                    fut, min(self.COMMAND_TIMEOUT,
                             max(0.1, deadline - time.monotonic())))
            except asyncio.TimeoutError:
                last = f"ack timeout from {self._cur_addr}"
                await self._retarget(None)
                continue
            finally:
                self._waiters.pop(tid, None)
            rc = ack.get("rc", 0)
            if rc == 0:
                return ack.get("out", {})
            if rc == -11:          # not leader: follow the hint
                last = ack.get("error", "not leader")
                await self._retarget(ack.get("leader_addr"))
                await asyncio.sleep(self.HUNT_BACKOFF)
                continue
            raise RuntimeError(ack.get("error", f"command failed rc={rc}"))
        raise TimeoutError(f"mon command {cmd.get('prefix')!r} timed out "
                           f"({last})")

    def subscribe(self, what: str, start: int) -> None:
        """Subscribe to map updates (MMonSubscribe); push survives
        re-hunts. osdmap payloads land on self.on_osdmap."""
        self._sub_want[what] = start
        if self._conn is not None and self._conn.connected:
            self._resubscribe()

    def sub_got(self, what: str, epoch: int) -> None:
        """Advance the subscription cursor after consuming an epoch."""
        if what in self._sub_want:
            self._sub_want[what] = max(self._sub_want[what], epoch + 1)

    async def request_osdmap(self, have: int = 0) -> None:
        """Ask for the current osdmap (reply lands on on_osdmap)."""
        conn = await self._ensure_conn()
        conn.send_message(MMonGetMap({"what": "osdmap", "have": have}))

    async def send_boot(self, osd: int, addr: tuple[str, int],
                        crush_location: dict | None = None,
                        weight: float = 1.0) -> None:
        conn = await self._ensure_conn()
        conn.send_message(MOSDBoot(
            {"osd": osd, "addr": list(addr),
             "crush_location": crush_location or {}, "weight": weight}))

    async def report_failure(self, failed: int, reporter: int, epoch: int,
                             addr) -> None:
        """Report osd `failed` down; `epoch` is the reporter's map epoch
        and `addr` the address that map gives `failed`, so that the mon
        can drop a report about an older incarnation."""
        conn = await self._ensure_conn()
        conn.send_message(MOSDFailure({"failed": failed, "from": reporter,
                                       "epoch": epoch, "addr": list(addr)}))

    _LOG_LEVELS = ("WRN", "ERR")

    async def send_log(self, level: str, who: str, message: str) -> None:
        """Ship one cluster-log line to the mon (LogClient-lite). Only
        WARN+ levels travel — the channel is for health events, not
        debug chatter (mon_cluster_log_level analog)."""
        if level not in self._LOG_LEVELS:
            return
        conn = await self._ensure_conn()
        conn.send_message(MLog({"level": level, "who": who,
                                "message": message, "stamp": time.time()}))

    async def send_mgr_report(self, payload: dict) -> None:
        """Ship the mgr's aggregated health digest to the mon
        (MMonMgrReport; fire-and-forget like the osd plane — the next
        tick re-sends a fresher digest anyway)."""
        conn = await self._ensure_conn()
        conn.send_message(MMonMgrReport(payload))

    async def close(self) -> None:
        self._closed = True
        for fut in self._waiters.values():
            if not fut.done():
                fut.cancelled() or fut.cancel()
        self._waiters.clear()

    # -- dispatch ------------------------------------------------------------

    async def ms_dispatch(self, conn: Connection, msg: Message) -> bool:
        if isinstance(msg, MMonCommandAck):
            fut = self._waiters.get(msg.payload.get("tid", 0))
            if fut is not None and not fut.done():
                fut.set_result(msg.payload)
            return True
        if isinstance(msg, MMonMap):
            self.monmap = msg.payload.get("monmap")
            return True
        if isinstance(msg, MOSDMapMsg):
            if self.on_osdmap is not None:
                res = self.on_osdmap(msg.payload)
                if asyncio.iscoroutine(res):
                    await res
            return True
        if isinstance(msg, MMgrMap):
            m = msg.payload.get("mgrmap")
            if m and (self.mgrmap is None or m.get("epoch", 0)
                      >= self.mgrmap.get("epoch", 0)):
                self.mgrmap = m
                self.sub_got("mgrmap", m.get("epoch", 0))
            return True
        return False

    def ms_handle_reset(self, conn: Connection) -> None:
        if conn is self._conn:
            dout("monc", 10, "mon session reset; will re-hunt")
            self._conn = None
