"""MgrClient: the daemon side of the mgr report fan-in.

Re-creation of src/mgr/MgrClient.{h,cc}: every daemon (osd, mon, mds,
rgw) holds a session to the active mgr and periodically ships an
MMgrReport — its perf-counter schema once per session, then changed
values only, plus a daemon_status blob, daemon health metrics (slow
ops, pg states, store utilization), and in-flight progress events. The
mgr aggregates these into its DaemonStateIndex (mgr/daemon.py), which
the prometheus exporter renders with per-daemon labels.

Discovery: the active mgr's address lives in the paxos-replicated
mgrmap (mon/monitor.py MgrMonitor), pushed to "mgrmap" subscribers over
the MonClient session (MMgrMap) — the caller-supplied `resolve` hook
just reads that cache (never a command: polling the command plane from
every daemon would load, and on ack timeouts churn, the shared mon
session). Resolution only runs while the report session is down: an
open connection is the liveness signal, and a dead mgr drops it,
triggering a re-resolve against the latest pushed map.

The session rides the daemon's existing messenger as a lossy client:
reports are periodic and idempotent-by-merge, so a lost report costs
one period of staleness, never correctness.

The port's copy of ceph_tpu/mgr/mgr_client.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import asyncio
import time
from typing import Awaitable, Callable

from ceph_tpu_torch.msg.messages import Message, MMgrConfigure, MMgrOpen, MMgrReport
from ceph_tpu_torch.msg.messenger import Connection, Dispatcher, Messenger, Policy
from ceph_tpu_torch.utils import flight, tracer
from ceph_tpu_torch.utils.dout import dout
from ceph_tpu_torch.utils.perf_counters import PerfCountersCollection


class MgrClient(Dispatcher):
    """One daemon's reporting session to the active mgr."""

    REPORT_PERIOD = 1.0         # mgr_tick_period analog; MMgrConfigure
                                # from the mgr overrides it per session

    def __init__(self, messenger: Messenger, daemon_name: str, service: str,
                 resolve: Callable[[], "Awaitable | tuple | None"],
                 status_cb: Callable[[], dict] | None = None,
                 health_cb: Callable[[], dict] | None = None,
                 progress_cb: Callable[[], list] | None = None,
                 device_cb: Callable[[], dict] | None = None,
                 client_cb: Callable[[], dict] | None = None,
                 qos_cb: Callable[[], dict] | None = None,
                 perf_name: str | None = None,
                 extra_loggers: tuple[str, ...] = ()):
        self.messenger = messenger
        self.messenger.add_dispatcher(self)
        self.daemon_name = daemon_name
        self.service = service
        self.resolve = resolve
        self.status_cb = status_cb
        self.health_cb = health_cb
        self.progress_cb = progress_cb
        # per-device labeled metrics (e.g. the offload service's
        # per-accelerator utilization): {device: {counter: value}},
        # exported with a `ceph_device` label alongside `ceph_daemon`
        self.device_cb = device_cb
        # per-client labeled metrics (the OSD OpTracker's ClientTable):
        # {client: {counter/buckets}}, merged ACROSS daemons in the mgr
        # and exported as ceph_client_* with a `ceph_client` label
        self.client_cb = client_cb
        # per-tenant QoS ledger (the dmclock scheduler's shed/deferred/
        # dequeue-phase splits): {tenant: {counter: value}}, exported
        # as ceph_qos_* with a `tenant` label
        self.qos_cb = qos_cb
        self.perf_name = perf_name or daemon_name
        # process-shared perf loggers this daemon also reports (e.g. the
        # EC offload service's "offload" counters), merged into the
        # report with a "<logger>_" key prefix so the mgr/exporter sees
        # them per reporting daemon
        self.extra_loggers = tuple(extra_loggers)
        self.period = self.REPORT_PERIOD
        self.reports_sent = 0
        self._conn: Connection | None = None
        self._addr: tuple | None = None
        self._schema_keys_sent: frozenset | None = None
        self._last_sent: dict = {}
        # flight-recorder shipping cursor: only ring events with
        # seq > cursor travel per report (the ring is process-wide, so
        # co-located daemons each ship it — the mgr dedups by
        # (boot, seq))
        self._flight_cursor = 0
        # tracer span-collector shipping cursor (tracing v2): completed
        # sampled/promoted spans travel incrementally the same way, and
        # the mgr's TraceIndex dedups by (pid, boot, seq)
        self._trace_cursor = 0
        self._task: asyncio.Task | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._report_loop())

    async def stop(self) -> None:
        if self._task is not None:
            from ceph_tpu_torch.utils.async_util import reap
            await reap(self._task)
            self._task = None
        if self._conn is not None:
            await self._conn.close()
            self._conn = None

    # -- report loop ---------------------------------------------------------

    async def _report_loop(self) -> None:
        while True:
            await asyncio.sleep(self.period)
            try:
                await self.send_report()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # a dead mgr must not wedge the daemon: drop the session
                # and re-resolve next period
                dout("mgrc", 5, f"{self.daemon_name}: report failed: "
                               f"{type(e).__name__} {e}")
                self._conn = None

    async def _ensure_session(self) -> Connection | None:
        if self._conn is not None and not self._conn._closed \
                and self._conn.connected:
            return self._conn
        self._conn = None
        addr = self.resolve()
        if asyncio.iscoroutine(addr):
            addr = await addr
        if not addr:
            return None
        conn = await self.messenger.connect(
            (addr[0], int(addr[1])), Policy.lossy_client())
        conn.send_message(MMgrOpen(
            {"daemon_name": self.daemon_name, "service": self.service}))
        self._conn = conn
        self._addr = tuple(addr)
        # fresh session: the mgr's state for us may be gone — resend the
        # schema, the full counter values, and the whole flight ring
        self._schema_keys_sent = None
        self._last_sent = {}
        self._flight_cursor = 0
        self._trace_cursor = 0
        return conn

    def _safe(self, cb, default):
        if cb is None:
            return default
        try:
            return cb()
        except Exception as e:
            dout("mgrc", 5, f"{self.daemon_name}: report callback failed: "
                           f"{type(e).__name__} {e}")
            return default

    async def send_report(self) -> bool:
        """Build and ship one MMgrReport; False when no mgr is active."""
        conn = await self._ensure_session()
        if conn is None:
            return False
        payload: dict = {"daemon_name": self.daemon_name,
                         "service": self.service, "stamp": time.time()}
        coll = PerfCountersCollection.instance()
        schema: dict = {}
        dump: dict = {}
        for logger, prefix in [(self.perf_name, "")] + [
                (ln, f"{ln}_") for ln in self.extra_loggers]:
            pc = coll.get(logger)
            if pc is None:
                continue
            schema.update({prefix + k: v for k, v in pc.schema().items()})
            dump.update({prefix + k: v for k, v in pc.dump().items()})
        if schema:
            keys = frozenset(schema)
            if keys != self._schema_keys_sent:
                # once per session — and again if the key set changed
                # (daemon restart re-registered its counters)
                payload["schema"] = schema
                self._schema_keys_sent = keys
                self._last_sent = {}
            # deltas: only counters whose value moved since the last
            # report travel; the mgr merges into its stored copy
            payload["counters"] = {k: v for k, v in dump.items()
                                   if self._last_sent.get(k) != v}
            self._last_sent = dump
        payload["daemon_status"] = self._safe(self.status_cb, {})
        payload["health_metrics"] = self._safe(self.health_cb, {})
        payload["progress"] = self._safe(self.progress_cb, [])
        payload["device_metrics"] = self._safe(self.device_cb, {})
        payload["client_metrics"] = self._safe(self.client_cb, {})
        payload["qos_metrics"] = self._safe(self.qos_cb, {})
        # flight-recorder leg: the ring tail since the last report,
        # plus the anchor pair the mgr's timeline merge needs. Shipped
        # every report (an empty tail still refreshes the anchors);
        # cursor advances only after the send below cannot fail
        ring = flight.events_since(self._flight_cursor)
        payload["events"] = ring
        # trace assembly leg: completed sampled/tail-promoted spans
        # since the last report (bounded batch; the cursor advances
        # only past what actually travelled, so the rest follows next
        # period). Process-wide like the flight ring — co-located
        # daemons each ship it, the mgr dedups by (pid, boot, seq).
        spans = tracer.export_since(self._trace_cursor)
        if spans["spans"]:
            payload["trace_spans"] = spans
        conn.send_message(MMgrReport(payload))
        if ring["events"]:
            self._flight_cursor = max(e["seq"] for e in ring["events"])
        if spans["spans"]:
            self._trace_cursor = spans["next"]
        self.reports_sent += 1
        return True

    # -- dispatch ------------------------------------------------------------

    async def ms_dispatch(self, conn: Connection, msg: Message) -> bool:
        if isinstance(msg, MMgrConfigure):
            period = msg.payload.get("period")
            if period:
                self.period = max(0.05, float(period))
            return True
        return False

    def ms_handle_reset(self, conn: Connection) -> None:
        if conn is self._conn:
            self._conn = None
