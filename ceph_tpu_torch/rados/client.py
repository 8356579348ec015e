"""librados-subset client: RadosClient + IoCtx over an Objecter-lite.

Re-creation of the reference client stack's essentials:
  * Objecter placement + retry (src/osdc/Objecter.cc:2783 _calc_target
    computes pg + primary from the osdmap; ops are resent on map epoch
    change rather than failed — :2286 _op_submit);
  * librados surface (src/librados/librados_c.cc:1308 rados_write ->
    IoCtxImpl::write -> operate): connect, pool I/O contexts, synchronous
    object ops, pool/profile admin via mon commands.

Idiomatic divergences: JSON command plane instead of the CLI encoding;
one lossy connection per OSD re-established on fault; a -11 reply or a
sub-op timeout triggers a map refresh + recompute instead of the
reference's epoch broadcast machinery.

The port's copy of ceph_tpu/rados/client.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import asyncio
import time

from ceph_tpu_torch.crush.crush import CRUSH_NONE
from ceph_tpu_torch.crush.osdmap import Incremental, OSDMap
from ceph_tpu_torch.msg.messages import (Message, MOSDOp, MOSDOpReply,
                                         MOSDOpThrottle, MWatchNotify,
                                         MWatchNotifyAck)
from ceph_tpu_torch.msg.messenger import Connection, Dispatcher, Messenger, Policy
from ceph_tpu_torch.mon.mon_client import MonClient
from ceph_tpu_torch.utils import tracer
from ceph_tpu_torch.utils.dout import dout

import json


class RadosError(Exception):
    def __init__(self, rc: int, message: str):
        super().__init__(f"rc={rc}: {message}")
        self.rc = rc


class ObjectNotFound(RadosError):
    pass


class RadosClient(Dispatcher):
    """rados_connect + Objecter-lite (placement, resend on epoch change)."""

    OP_TIMEOUT = 15.0
    ATTEMPT_TIMEOUT = 5.0
    # capped exponential backoff between resends (Objecter backoff
    # semantics): the first retry is immediate — it usually lands on a
    # freshly-elected primary after the map refresh — later ones slow
    # down so a storm of failed ops cannot hammer a recovering cluster
    BACKOFF_BASE = 0.05
    BACKOFF_MAX = 2.0

    def __init__(self, mon_addrs: list[tuple[str, int]],
                 auth_key: bytes | None = None,
                 name: str | None = None,
                 tenant: str | None = None):
        # client instance nonce: makes (nonce, seq) reqids globally
        # unique so OSDs can dedup retried non-idempotent ops
        # (osd_reqid_t semantics)
        import secrets
        self._nonce = secrets.randbits(48)
        # client identity (EntityName client.<id>): negotiated once per
        # msgr2 session at the HELLO handshake and stamped on every
        # MOSDOp, so the OSD's per-client accountant can attribute ops,
        # bytes, and tail latency to THIS client. Anonymous callers get
        # a nonce-derived id — still stable for the client's lifetime.
        if name:
            self.name = name if name.startswith("client.") \
                else f"client.{name}"
        else:
            self.name = f"client.{self._nonce:012x}"
        self.tenant = tenant
        self.messenger = Messenger(self.name, auth_key=auth_key,
                                   tenant=tenant)
        self.messenger.add_dispatcher(self)
        self.monc = MonClient(self.messenger, mon_addrs)
        self.monc.on_osdmap = self._on_osdmap
        self.osdmap = OSDMap()
        self._map_changed = asyncio.Event()
        self._tid = 0
        self._reqseq = 0
        # ops bounced by QoS shed admission control (MOSDOpThrottle
        # replies absorbed by the backoff-and-resend path)
        self.throttled_ops = 0
        self._waiters: dict[int, asyncio.Future] = {}
        self._osd_conns: dict[int, Connection] = {}
        # linger watches (Objecter linger ops): cookie -> registration;
        # re-sent on map change / connection reset so a watch survives
        # primary failover
        self._watches: dict[int, dict] = {}
        self._next_cookie = 1
        self._relinger_task: asyncio.Task | None = None
        self._relinger_pending = False
        # strong refs: the loop keeps only weak refs to tasks, and a
        # collected delivery task would silently swallow a notify
        self._notify_tasks: set[asyncio.Task] = set()

    # -- lifecycle -----------------------------------------------------------

    async def connect(self) -> None:
        await self.messenger.bind("127.0.0.1", 0)
        await self.monc.start()
        self.monc.subscribe("osdmap", 1)
        await self.wait_for_map()

    async def shutdown(self) -> None:
        await self.monc.close()
        await self.messenger.shutdown()

    # -- map handling --------------------------------------------------------

    def _on_osdmap(self, payload: dict) -> None:
        from ceph_tpu_torch.crush.osdmap import apply_map_payload
        apply_map_payload(self.osdmap, payload)
        self.monc.sub_got("osdmap", self.osdmap.epoch)
        self._map_changed.set()
        self._schedule_relinger()

    async def wait_for_map(self, min_epoch: int = 1,
                           timeout: float = 15.0) -> None:
        deadline = time.monotonic() + timeout
        while self.osdmap.epoch < min_epoch:
            self._map_changed.clear()
            await self.monc.request_osdmap(self.osdmap.epoch)
            try:
                await asyncio.wait_for(
                    self._map_changed.wait(),
                    max(0.1, min(2.0, deadline - time.monotonic())))
            except asyncio.TimeoutError:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"no osdmap epoch >= {min_epoch}") from None

    # -- admin plane ---------------------------------------------------------

    async def command(self, cmd: dict, timeout: float = 30.0) -> dict:
        return await self.monc.command(cmd, timeout=timeout)

    async def pool_create(self, name: str, **kwargs) -> dict:
        out = await self.command({"prefix": "osd pool create", "pool": name,
                                  **{k: v for k, v in kwargs.items()}})
        # wait until our map shows the pool so I/O can target it
        deadline = time.monotonic() + 15.0
        while name not in self.osdmap.pool_names:
            if time.monotonic() > deadline:
                raise TimeoutError(f"pool {name!r} never appeared in map")
            await self.wait_for_map(self.osdmap.epoch + 1)
        return out

    def ioctx(self, pool_name: str) -> "IoCtx":
        return IoCtx(self, pool_name)

    # -- objecter ------------------------------------------------------------

    async def _osd_conn(self, osd: int) -> Connection:
        conn = self._osd_conns.get(osd)
        if conn is not None and not conn._closed and conn.connected:
            return conn
        a = self.osdmap.get_addr(osd)
        conn = await self.messenger.connect((a[0], int(a[1])),
                                            Policy.lossy_client())
        self._osd_conns[osd] = conn
        return conn

    async def submit(self, pool_name: str, oid: str, ops: list[dict],
                     data: bytes = b"", timeout: float | None = None,
                     pgid=None,
                     attempt_timeout: float | None = None
                     ) -> tuple[dict, bytes]:
        """Objecter::op_submit-lite: compute the target, send, resend on
        epoch change / wrong-primary / transport fault. `pgid` pins the
        target PG (PG-scoped ops like `list`). When tracing is on, this
        opens the ROOT span of the op's trace (where the head-sampling
        decision is drawn); every messenger hop and OSD-side stage
        nests under it."""
        if not tracer.active():
            return await self._submit_inner(pool_name, oid, ops, data,
                                            timeout, pgid, attempt_timeout)
        with tracer.span("rados_op", "client") as sp:
            if sp is not None:      # hot-toggle race: may disable mid-call
                sp.set_tag("pool", pool_name)
                sp.set_tag("oid", oid)
                sp.set_tag("ops", "+".join(o.get("op", "?") for o in ops))
                sp.set_tag("bytes", len(data))
                sp.set_tag("client", self.name)
            return await self._submit_inner(pool_name, oid, ops, data,
                                            timeout, pgid, attempt_timeout)

    async def _submit_inner(self, pool_name: str, oid: str,
                            ops: list[dict], data: bytes = b"",
                            timeout: float | None = None, pgid=None,
                            attempt_timeout: float | None = None
                            ) -> tuple[dict, bytes]:
        deadline = time.monotonic() + (timeout or self.OP_TIMEOUT)
        last = "no attempt"
        # one reqid per LOGICAL op, stable across retries: the PG's
        # dup-op index keys on it, so a retry whose first attempt
        # committed is answered from the log instead of re-executing
        self._reqseq += 1
        reqid = [self._nonce, self._reqseq]
        attempt = 0
        while time.monotonic() < deadline:
            if attempt:
                await self._op_backoff(attempt, deadline)
            attempt += 1
            if pool_name not in self.osdmap.pool_names:
                raise RadosError(-2, f"pool {pool_name!r} does not exist")
            pg = pgid if pgid is not None \
                else self.osdmap.object_to_pg(pool_name, oid)
            primary = self.osdmap.primary(pg)
            if primary == CRUSH_NONE:
                last = f"pg {pg} has no primary"
                await self._refresh_map(deadline)
                continue
            try:
                conn = await self._osd_conn(primary)
            except Exception as e:
                last = f"osd.{primary} unreachable: {e}"
                await self._refresh_map(deadline)
                continue
            self._tid += 1
            tid = self._tid
            fut = asyncio.get_running_loop().create_future()
            self._waiters[tid] = fut
            # the op is stamped with the session's negotiated identity:
            # the OSD accountant keys on the handshake entity and uses
            # this stamp only as the cross-check / requeue-path carrier
            payload = {"tid": tid, "pgid": [pg.pool, pg.ps], "oid": oid,
                       "ops": ops, "reqid": reqid,
                       "epoch": self.osdmap.epoch,
                       "client": self.name}
            if self.tenant:
                payload["tenant"] = self.tenant
            conn.send_message(MOSDOp(payload, data))
            try:
                reply = await asyncio.wait_for(
                    fut, min(attempt_timeout or self.ATTEMPT_TIMEOUT,
                             max(0.1, deadline - time.monotonic())))
            except asyncio.TimeoutError:
                last = f"op timeout against osd.{primary}"
                self._osd_conns.pop(primary, None)
                await self._refresh_map(deadline)
                continue
            finally:
                self._waiters.pop(tid, None)
            p, outdata = reply
            rc = p.get("rc", 0)
            if "retry_after_ms" in p:
                # QoS shed (MOSDOpThrottle): the map is fine — the
                # tenant is over its share. Honor the OSD's pacing
                # hint (scaled up on consecutive bounces, bounded by
                # the op deadline) and resend the same tid; no map
                # refresh, no connection teardown.
                self.throttled_ops += 1
                last = "throttled (qos shed)"
                delay = (float(p.get("retry_after_ms") or 50) / 1e3
                         * min(attempt, 8))
                delay = min(delay, max(0.0,
                                       deadline - time.monotonic()))
                if delay > 0:
                    await asyncio.sleep(delay)
                continue
            if rc == -11:            # wrong primary / stale map: recompute
                last = p.get("error", "wrong target")
                await self._refresh_map(deadline)
                continue
            if rc == -110:           # primary lost a replica mid-op: the op
                last = "sub-op timeout"   # is retried on the new interval
                await self._refresh_map(deadline)
                continue
            if rc == -2:
                raise ObjectNotFound(rc, p.get("error", oid))
            if rc < 0:
                raise RadosError(rc, p.get("error", "op failed"))
            return p, outdata
        raise TimeoutError(f"op on {oid!r} timed out ({last})")

    async def _op_backoff(self, attempt: int, deadline: float) -> None:
        """Sleep the capped exponential backoff before resend `attempt`
        (per-op: every logical op starts back at the base). Bounded by
        the op's own deadline so backoff can never extend it."""
        if attempt < 2:
            return          # first retry is immediate (stale-map case)
        delay = min(self.BACKOFF_MAX,
                    self.BACKOFF_BASE * (2 ** (attempt - 2)))
        delay = min(delay, max(0.0, deadline - time.monotonic()))
        if delay > 0:
            await asyncio.sleep(delay)

    async def _refresh_map(self, deadline: float) -> None:
        self._map_changed.clear()
        try:
            await self.monc.request_osdmap(self.osdmap.epoch)
            await asyncio.wait_for(
                self._map_changed.wait(),
                max(0.1, min(1.0, deadline - time.monotonic())))
        except (asyncio.TimeoutError, ConnectionError):
            pass

    # -- watch/notify linger plumbing ----------------------------------------

    def register_watch(self, pool: str, oid: str, callback) -> int:
        # the OSD keys watchers by cookie alone (the reference keys by
        # (entity, cookie)): embed the client nonce so two clients'
        # cookies can never collide; a wide shift so the sequence can
        # never carry into the nonce bits
        cookie = self._nonce * 2 ** 32 + self._next_cookie
        self._next_cookie += 1
        self._watches[cookie] = {"pool": pool, "oid": oid,
                                 "callback": callback}
        return cookie

    def unregister_watch(self, cookie: int) -> None:
        self._watches.pop(cookie, None)

    def _schedule_relinger(self) -> None:
        if not self._watches:
            return
        # a reset arriving while a relinger pass is mid-flight must
        # trigger ANOTHER pass: the running one may already be past the
        # watch the new reset just killed
        self._relinger_pending = True
        if self._relinger_task is not None and \
                not self._relinger_task.done():
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        self._relinger_task = loop.create_task(self._relinger())

    async def _relinger(self) -> None:
        """Re-send every registered watch (idempotent on the OSD): runs
        after a map change or transport reset, so a watch follows the
        PG's primary (Objecter::_linger_submit semantics)."""
        while self._relinger_pending:
            self._relinger_pending = False
            await asyncio.sleep(0.05)
            for cookie, w in list(self._watches.items()):
                try:
                    await self.submit(w["pool"], w["oid"],
                                      [{"op": "watch", "oid": w["oid"],
                                        "cookie": cookie}])
                except Exception as e:
                    dout("rados", 3, f"relinger watch {cookie} on "
                                     f"{w['oid']!r}: {type(e).__name__} {e}")

    async def _deliver_notify(self, conn: Connection,
                              msg: Message) -> None:
        p = msg.payload
        w = self._watches.get(int(p.get("cookie", 0)))
        ack = b""
        if w is not None:
            try:
                res = w["callback"](p["notify_id"], msg.data)
                if asyncio.iscoroutine(res):
                    res = await res
                if isinstance(res, bytes):
                    ack = res
            except Exception as e:
                dout("rados", 2, f"watch callback failed: "
                                 f"{type(e).__name__} {e}")
        # ack on the SAME connection the notify came in on: it reaches
        # the waiting primary without re-entering the op queue
        conn.send_message(MWatchNotifyAck(
            {"pgid": p["pgid"], "notify_id": p["notify_id"],
             "cookie": p["cookie"]}, ack))

    # -- dispatch ------------------------------------------------------------

    async def ms_dispatch(self, conn: Connection, msg: Message) -> bool:
        if isinstance(msg, (MOSDOpReply, MOSDOpThrottle)):
            # a throttle is delivered through the same waiter: the
            # submit loop recognizes the retry_after_ms marker and
            # backs off WITHOUT a map refresh (QoS shed, not topology)
            fut = self._waiters.get(msg.payload.get("tid", 0))
            if fut is not None and not fut.done():
                fut.set_result((msg.payload, msg.data))
            return True
        if isinstance(msg, MWatchNotify):
            t = asyncio.get_running_loop().create_task(
                self._deliver_notify(conn, msg))
            self._notify_tasks.add(t)
            t.add_done_callback(self._notify_tasks.discard)
            return True
        return False

    def ms_handle_reset(self, conn: Connection) -> None:
        for osd, c in list(self._osd_conns.items()):
            if c is conn:
                del self._osd_conns[osd]
        # the primary holding our watches died with that conn
        self._schedule_relinger()


class IoCtx:
    """Synchronous-ish per-pool I/O context (librados IoCtx)."""

    #: op kinds that mutate state and therefore carry a SnapContext
    #: ("call" may stage writes server-side, so it carries one too)
    MOD_KINDS = frozenset({"write_full", "write", "append", "truncate",
                           "zero", "create", "delete", "setxattr",
                           "rmxattr", "omap_set", "omap_rm", "rollback",
                           "call"})

    def __init__(self, client: RadosClient, pool_name: str):
        self.client = client
        self.pool_name = pool_name
        # self-managed SnapContext (seq + snap ids, newest first); when
        # unset, writes use the pool-snap context from the osdmap
        self._snapc: dict | None = None

    # -- snapshots (librados snap API subset) --------------------------------

    def set_snap_context(self, seq: int, snaps: list[int]) -> None:
        """rados_ioctx_selfmanaged_snap_set_write_ctx: snaps newest
        first. (0, []) reverts to the pool-snap context — the reference
        forbids mixing pool and self-managed snaps in one pool; keep
        them in separate pools."""
        if seq == 0 and not snaps:
            self._snapc = None
            return
        self._snapc = {"seq": seq, "snaps": sorted(snaps, reverse=True)}

    def _snap_context(self) -> dict | None:
        if self._snapc is not None:
            return self._snapc
        pool = self.client.osdmap.get_pool(self.pool_name)
        if pool is None or not pool.pool_snaps:
            return None
        snaps = sorted((int(s) for s in pool.pool_snaps), reverse=True)
        return {"seq": pool.snap_seq, "snaps": snaps}

    async def selfmanaged_snap_create(self) -> int:
        out = await self.client.command(
            {"prefix": "osd pool selfmanaged snap create",
             "pool": self.pool_name})
        return out["snapid"]

    async def selfmanaged_snap_rm(self, snapid: int) -> None:
        out = await self.client.command(
            {"prefix": "osd pool selfmanaged snap rm",
             "pool": self.pool_name, "snapid": snapid})
        # wait for the COMMITTED epoch from the reply (a concurrent
        # unrelated proposal could satisfy "my epoch + 1" early)
        await self.client.wait_for_map(out["epoch"])

    async def snap_create(self, name: str) -> int:
        out = await self.client.command(
            {"prefix": "osd pool mksnap", "pool": self.pool_name,
             "snap": name})
        # writes must see the new pool record or they won't clone: wait
        # for the committed epoch the mon reported
        await self.client.wait_for_map(out["epoch"])
        return out["snapid"]

    async def snap_rm(self, name: str) -> None:
        out = await self.client.command(
            {"prefix": "osd pool rmsnap", "pool": self.pool_name,
             "snap": name})
        await self.client.wait_for_map(out["epoch"])

    def snap_list(self) -> dict[str, int]:
        pool = self.client.osdmap.get_pool(self.pool_name)
        return {v: int(k) for k, v in (pool.pool_snaps or {}).items()}

    def snap_lookup(self, name: str) -> int:
        sid = self.snap_list().get(name)
        if sid is None:
            raise RadosError(-2, f"snap {name!r} not found")
        return sid

    async def rollback(self, oid: str, snapid: int) -> dict:
        p, _ = await self._submit(
            oid, [{"op": "rollback", "oid": oid, "snapid": snapid}])
        return p

    async def snap_rollback(self, oid: str, snap_name: str) -> dict:
        return await self.rollback(oid, self.snap_lookup(snap_name))

    async def list_snaps(self, oid: str) -> dict:
        p, _ = await self.client.submit(
            self.pool_name, oid, [{"op": "list_snaps", "oid": oid}])
        return p["results"][0]["out"]

    async def _submit(self, oid: str, ops: list[dict],
                      data: bytes = b"") -> tuple[dict, bytes]:
        """Mutation submit: stamps each modifying op with the current
        SnapContext (IoCtxImpl::operate attaching the io ctx snapc)."""
        snapc = self._snap_context()
        if snapc is not None:
            for op in ops:
                if op["op"] in self.MOD_KINDS:
                    op.setdefault("snapc", snapc)
        return await self.client.submit(self.pool_name, oid, ops, data)

    async def write_full(self, oid: str, data: bytes) -> dict:
        p, _ = await self._submit(
            oid, [{"op": "write_full", "oid": oid}], data)
        return p

    async def write(self, oid: str, data: bytes, offset: int = 0) -> dict:
        """Ranged write (rados_write): extends the object as needed; on
        EC pools this drives the RMW partial-stripe pipeline."""
        p, _ = await self._submit(
            oid, [{"op": "write", "oid": oid, "off": offset}], data)
        return p

    async def append(self, oid: str, data: bytes) -> dict:
        p, _ = await self._submit(
            oid, [{"op": "append", "oid": oid}], data)
        return p

    async def create(self, oid: str, exclusive: bool = True) -> dict:
        p, _ = await self._submit(
            oid, [{"op": "create", "oid": oid, "exclusive": exclusive}])
        return p

    async def truncate(self, oid: str, size: int) -> dict:
        p, _ = await self._submit(
            oid, [{"op": "truncate", "oid": oid, "size": size}])
        return p

    async def zero(self, oid: str, offset: int, length: int) -> dict:
        p, _ = await self._submit(
            oid, [{"op": "zero", "oid": oid, "off": offset, "len": length}])
        return p

    async def read(self, oid: str, offset: int = 0, length: int = 0,
                   snapid: int | None = None) -> bytes:
        op = {"op": "read", "oid": oid, "off": offset, "len": length}
        if snapid is not None:
            op["snapid"] = snapid
        _, data = await self.client.submit(self.pool_name, oid, [op])
        return data

    async def remove(self, oid: str) -> dict:
        p, _ = await self._submit(oid, [{"op": "delete", "oid": oid}])
        return p

    async def stat(self, oid: str, snapid: int | None = None) -> dict:
        op = {"op": "stat", "oid": oid}
        if snapid is not None:
            op["snapid"] = snapid
        p, _ = await self.client.submit(self.pool_name, oid, [op])
        return p["results"][0]["out"]

    # -- xattrs / omap (replicated pools; EC pools return EOPNOTSUPP) ---------

    async def setxattr(self, oid: str, name: str, value: bytes) -> dict:
        p, _ = await self._submit(
            oid, [{"op": "setxattr", "oid": oid, "name": name}], value)
        return p

    async def getxattr(self, oid: str, name: str) -> bytes:
        _, data = await self.client.submit(
            self.pool_name, oid,
            [{"op": "getxattr", "oid": oid, "name": name}])
        return data

    async def getxattrs(self, oid: str) -> dict[str, bytes]:
        p, _ = await self.client.submit(
            self.pool_name, oid, [{"op": "getxattrs", "oid": oid}])
        return {k: v.encode("latin1")
                for k, v in p["results"][0]["out"]["xattrs"].items()}

    async def rmxattr(self, oid: str, name: str) -> dict:
        p, _ = await self._submit(
            oid, [{"op": "rmxattr", "oid": oid, "name": name}])
        return p

    async def omap_set(self, oid: str, kv: dict[str, bytes]) -> dict:
        p, _ = await self._submit(
            oid, [{"op": "omap_set", "oid": oid,
                   "kv": {k: v.decode("latin1") for k, v in kv.items()}}])
        return p

    async def omap_get(self, oid: str) -> dict[str, bytes]:
        p, _ = await self.client.submit(
            self.pool_name, oid, [{"op": "omap_get", "oid": oid}])
        return {k: v.encode("latin1")
                for k, v in p["results"][0]["out"]["omap"].items()}

    async def omap_rm(self, oid: str, keys: list[str]) -> dict:
        p, _ = await self._submit(
            oid, [{"op": "omap_rm", "oid": oid, "keys": keys}])
        return p

    # -- aio (librados AioCompletion / neorados role) ------------------------

    @property
    def _aio(self):
        from ceph_tpu_torch.rados.aio import AioDispatcher
        d = getattr(self.client, "_aio_dispatcher", None)
        if d is None:
            d = self.client._aio_dispatcher = AioDispatcher()
        return d

    def aio_write_full(self, oid: str, data: bytes):
        return self._aio.submit(self.write_full(oid, data))

    def aio_write(self, oid: str, data: bytes, offset: int = 0):
        return self._aio.submit(self.write(oid, data, offset))

    def aio_append(self, oid: str, data: bytes):
        return self._aio.submit(self.append(oid, data))

    def aio_read(self, oid: str, offset: int = 0, length: int = 0):
        return self._aio.submit(self.read(oid, offset, length))

    def aio_remove(self, oid: str):
        return self._aio.submit(self.remove(oid))

    def aio_stat(self, oid: str):
        return self._aio.submit(self.stat(oid))

    def aio_operate(self, oid: str, ops: list[dict], data: bytes = b""):
        return self._aio.submit(self._submit(oid, ops, data))

    async def aio_flush(self) -> None:
        await self._aio.flush()

    # -- watch/notify (rados_watch3 / rados_notify2 subset) ------------------

    async def watch(self, oid: str, callback) -> int:
        """Register a watch; `callback(notify_id, data)` runs on every
        notify (may be sync or async; bytes it returns ride the ack).
        Returns the watch cookie. The client lingers the watch across
        primary failover and reconnects."""
        cookie = self.client.register_watch(self.pool_name, oid, callback)
        try:
            await self.client.submit(
                self.pool_name, oid,
                [{"op": "watch", "oid": oid, "cookie": cookie}])
        except Exception:
            self.client.unregister_watch(cookie)
            raise
        return cookie

    async def unwatch(self, cookie: int) -> None:
        w = self.client._watches.get(cookie)
        self.client.unregister_watch(cookie)
        if w is not None:
            await self.client.submit(
                self.pool_name, w["oid"],
                [{"op": "unwatch", "oid": w["oid"], "cookie": cookie}])

    async def notify(self, oid: str, payload: bytes = b"",
                     timeout: float = 3.0) -> dict:
        """Fan a notification out to every watcher of `oid`; returns
        {"acks": [[cookie, data], ...], "timeouts": [cookie, ...]}.
        The attempt window extends past the server-side gather so a slow
        watcher can't make the Objecter resend (and double-notify)."""
        p, _ = await self.client.submit(
            self.pool_name, oid,
            [{"op": "notify", "oid": oid, "timeout": timeout}], payload,
            timeout=timeout + 10.0, attempt_timeout=timeout + 5.0)
        out = p["results"][0]["out"]
        return {"notify_id": out["notify_id"],
                "acks": [[c, d.encode("latin1")] for c, d in out["acks"]],
                "timeouts": list(out["timeouts"])}

    async def list_watchers(self, oid: str) -> list[dict]:
        p, _ = await self.client.submit(
            self.pool_name, oid, [{"op": "list_watchers", "oid": oid}])
        return p["results"][0]["out"]["watchers"]

    async def call(self, oid: str, cls: str, method: str,
                   indata: bytes = b"") -> bytes:
        """Execute an object-class method server-side
        (rados_exec / CEPH_OSD_OP_CALL)."""
        _, out = await self._submit(
            oid, [{"op": "call", "oid": oid, "cls": cls,
                   "method": method}], indata)
        return out

    async def list_objects(self) -> list[str]:
        """Union of object listings across this pool's PG primaries."""
        from ceph_tpu_torch.crush.osdmap import PG as PGId
        seen: set[str] = set()
        pool = self.client.osdmap.get_pool(self.pool_name)
        for ps in range(pool.pg_num):
            pg = PGId(pool.id, ps)
            if self.client.osdmap.primary(pg) == CRUSH_NONE:
                continue
            try:
                p, _ = await self.client.submit(
                    self.pool_name, f"pg{ps}", [{"op": "list", "oid": ""}],
                    pgid=pg)
            except (RadosError, TimeoutError):
                continue
            seen.update(p["results"][0]["out"].get("objects", []))
        return sorted(seen)
