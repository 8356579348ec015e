"""The OSD daemon: boots against the monitor quorum, subscribes to
osdmaps, hosts PGs, and serves client I/O.

Re-creation of the reference OSD's lifecycle and dispatch
(src/osd/OSD.cc): init + MOSDBoot through a MonClient (:3704 init,
_preboot), osdmap subscription and PG advance on every epoch
(handle_osd_map/activate_map), op ingest ms_fast_dispatch (:7550) ->
per-PG execution, OSD<->OSD heartbeats with failure reports to the mon
(heartbeat :6187, send_failures :7224).

Idiomatic divergences: one asyncio event loop stands in for the sharded
op threadpool (the concurrency axis the reference gets from
osd_op_tp); heartbeats ride the cluster connections instead of separate
hb_front/hb_back messengers; PG discovery scans pool pg ranges on each
epoch instead of tracking creation deltas.

The port's copy of ceph_tpu/osd/daemon.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import asyncio
import json
import time

from ceph_tpu_torch import device as _device
from ceph_tpu_torch.crush.osdmap import PG, Incremental, OSDMap
from ceph_tpu_torch.mgr.mgr_client import MgrClient
from ceph_tpu_torch.msg.messages import (Message, MOSDOp, MOSDOpReply,
                                         MOSDOpThrottle, MOSDPGInfo,
                                         MOSDPGLog, MOSDPGPush, MOSDPGPushReply,
                                         MOSDPGQuery, MOSDRepOp, MOSDRepOpReply,
                                         MOSDRepScrub, MOSDRepScrubMap,
                                         MOSDScrubReserve, MPing, MPingReply)
from ceph_tpu_torch.msg.messenger import Connection, Dispatcher, Messenger, Policy
from ceph_tpu_torch.mon.mon_client import MonClient
from ceph_tpu_torch.objectstore.memstore import MemStore
from ceph_tpu_torch.objectstore.store import StoreError
from ceph_tpu_torch.osd import scrub as scrub_mod
from ceph_tpu_torch.osd.backend import IntervalChange
from ceph_tpu_torch.osd.pg import PGInstance
from ceph_tpu_torch.qa import faultinject
from ceph_tpu_torch.utils import (copytrack, crash, flight, loopprof, sanitizer,
                                  tracer)
from ceph_tpu_torch.utils.admin_socket import AdminSocket
from ceph_tpu_torch.utils.async_util import drain_all, reap_all
from ceph_tpu_torch.utils.config import Config, Option
from ceph_tpu_torch.utils.dout import dout
from ceph_tpu_torch.utils.perf_counters import (TYPE_AVG, TYPE_GAUGE,
                                                TYPE_HISTOGRAM,
                                                PerfCountersCollection)
from ceph_tpu_torch.utils.throttle import AdjustableSemaphore, HeartbeatMap
from ceph_tpu_torch.utils.work_queue import (ClientTable, Finisher, OpTracker,
                                             ShardedOpQueue, WRITE_OP_KINDS,
                                             classify_ops, current_op,
                                             reset_current_op, set_current_op)


class OSD(Dispatcher):
    """One object-storage daemon.

    `device` is where its EC and crc work runs: "cuda" (default) builds
    the loop's offload service over every visible card and raises
    DeviceUnavailable at start() without one; "cpu" builds it over
    ["cpu"] * 8, the plain PyTorch versions; "cuda:N" over that card.
    The service is per loop and its device list is read only when it is
    created, so every OSD of one in-process cluster shares it and must
    name the same device: a second device list raises ValueError at
    start(). The shard checksums of its EC pools use the same device."""

    HB_INTERVAL = 1.0
    HB_GRACE = 3.0              # osd_heartbeat_grace analog

    NUM_OP_SHARDS = 5           # osd_op_num_shards analog

    SCRUB_INTERVAL = 60.0       # osd_scrub_min_interval analog
    DEEP_SCRUB_EVERY = 4        # every Nth scrub round goes deep

    MAX_RECOVERY_IN_FLIGHT = 4  # osd_max_backfills / AsyncReserver slots

    PG_PIPELINE_DEPTH = 4       # per-PG execution window (1 = serial)

    def __init__(self, whoami: int, mon_addrs: list[tuple[str, int]],
                 store=None, crush_location: dict | None = None,
                 admin_socket_path: str | None = None,
                 config: Config | None = None,
                 auth_key: bytes | None = None,
                 device: str = "cuda"):
        self.whoami = whoami
        self.device = device
        self.store = store if store is not None else MemStore(f"osd{whoami}")
        self.crush_location = crush_location or {"host": f"host{whoami}"}
        # tunables live in the Config (defaults seeded from the class
        # attrs so test monkeypatching still works); timer loops re-read
        # every iteration, so `config set` via the admin socket takes
        # effect immediately (observer-free hot reload)
        self.config = config if config is not None else Config([
            Option("osd_heartbeat_interval", "float", self.HB_INTERVAL,
                   "seconds between peer pings", minimum=0.01),
            Option("osd_heartbeat_grace", "float", self.HB_GRACE,
                   "silence before reporting a peer failed",
                   minimum=0.05),
            Option("osd_scrub_interval", "float", self.SCRUB_INTERVAL,
                   "seconds between background scrub rounds",
                   minimum=0.05),
            Option("osd_deep_scrub_every", "int", self.DEEP_SCRUB_EVERY,
                   "every Nth scrub round re-reads data", minimum=1),
            Option("osd_scrub_chunk_max", "int", 32,
                   "objects scanned per scrub chunk; each chunk costs "
                   "one QoS grant under the scrub class, so smaller "
                   "chunks yield to client I/O more often (hot: the "
                   "next chunk re-reads it)", minimum=1),
            Option("osd_scrub_sleep", "float", 0.0,
                   "seconds slept between scrub scan chunks (throttle "
                   "on top of the QoS pacing; hot)", minimum=0.0),
            Option("osd_scrub_reserve", "bool", True,
                   "reserve one scrub slot on every acting-set member "
                   "before a round may gate client writes (the "
                   "reference's scrub reserver; hot)"),
            Option("osd_scrub_reserve_timeout", "float", 10.0,
                   "seconds a primary waits for a local or remote "
                   "scrub reservation before aborting the round — the "
                   "path that breaks crossed-reservation deadlocks "
                   "(hot)", minimum=0.1),
            Option("osd_max_scrubs", "int", 1,
                   "concurrent scrub rounds this daemon will take part "
                   "in, as primary or replica (hot: resizes the live "
                   "reservation pool)", minimum=1),
            Option("osd_op_num_shards", "int", self.NUM_OP_SHARDS,
                   "op queue shards (startup only)", minimum=1),
            Option("osd_max_recovery_in_flight", "int",
                   self.MAX_RECOVERY_IN_FLIGHT,
                   "host-wide recovery reservation slots (hot: resizes "
                   "the live pool, so recovery pressure can be tuned "
                   "mid-storm)", minimum=1),
            Option("osd_pg_pipeline_depth", "int",
                   self.PG_PIPELINE_DEPTH,
                   "max concurrent client ops in the execution slice "
                   "per PG (distinct objects only; the pg-log ordered "
                   "slice stays strictly FIFO). 1 = the legacy serial "
                   "pipeline, bit-identical. Hot: resizes the live "
                   "admission window", minimum=1),
            Option("osd_ec_repair_subchunks", "bool", True,
                   "use regenerating-code sub-chunk repair plans for "
                   "single-shard recovery (fetch repair fragments from "
                   "d helpers instead of k whole chunks)"),
            # per-client SLO engine (hot: the observer pushes changes
            # into the live ClientTable, so an operator can tighten or
            # relax the SLO mid-overload). 0 = class unguarded.
            Option("slo_read_ms", "float", 0.0,
                   "read-op SLO in ms; ops slower than this count as "
                   "per-client violations (0 disables)", minimum=0.0),
            Option("slo_write_ms", "float", 0.0,
                   "write-op SLO in ms; ops slower than this count as "
                   "per-client violations (0 disables)", minimum=0.0),
            Option("osd_max_client_entries", "int", 256,
                   "bound of the per-client accounting table; the "
                   "least-recently-active overflow folds into _other "
                   "(hot: resizes the live table)", minimum=2),
            # dmclock QoS arbiter (osd/scheduler/): every knob is hot
            # — the observer pushes changes into the live scheduler,
            # so an operator can impose a limit or flip the overload
            # policy mid-storm
            Option("osd_mclock_enabled", "bool", False,
                   "arbitrate op dequeue by per-tenant reservation/"
                   "limit/weight tag clocks instead of the legacy "
                   "class WRR (hot: queued work migrates)"),
            Option("osd_mclock_cost_per_io_bytes", "size", 65536,
                   "payload bytes worth one extra IO of scheduling "
                   "cost (byte-normalization of the tag clocks)",
                   minimum=1),
            Option("osd_mclock_client_reservation", "float", 0.0,
                   "guaranteed cost-units/sec per client tenant "
                   "(0 = no floor)", minimum=0.0),
            Option("osd_mclock_client_limit", "float", 0.0,
                   "cost-units/sec cap per client tenant (0 = "
                   "uncapped)", minimum=0.0),
            Option("osd_mclock_client_weight", "float", 1.0,
                   "proportional share of excess capacity per client "
                   "tenant", minimum=0.0),
            Option("osd_mclock_recovery_reservation", "float", 4.0,
                   "guaranteed cost-units/sec for the recovery class "
                   "pseudo-entity (nonzero keeps recovery progressing "
                   "under client floods)", minimum=0.0),
            Option("osd_mclock_recovery_limit", "float", 0.0,
                   "cost-units/sec cap for recovery (0 = uncapped)",
                   minimum=0.0),
            Option("osd_mclock_recovery_weight", "float", 0.5,
                   "recovery's proportional share of excess capacity",
                   minimum=0.0),
            Option("osd_mclock_scrub_reservation", "float", 2.0,
                   "guaranteed cost-units/sec for the scrub class "
                   "pseudo-entity (nonzero keeps integrity scanning "
                   "progressing under client floods)", minimum=0.0),
            Option("osd_mclock_scrub_limit", "float", 0.0,
                   "cost-units/sec cap for scrub (0 = uncapped)",
                   minimum=0.0),
            Option("osd_mclock_scrub_weight", "float", 0.25,
                   "scrub's proportional share of excess capacity",
                   minimum=0.0),
            Option("osd_mclock_snaptrim_reservation", "float", 1.0,
                   "guaranteed cost-units/sec for the snaptrim class "
                   "pseudo-entity", minimum=0.0),
            Option("osd_mclock_snaptrim_limit", "float", 0.0,
                   "cost-units/sec cap for snaptrim (0 = uncapped)",
                   minimum=0.0),
            Option("osd_mclock_snaptrim_weight", "float", 0.25,
                   "snaptrim's proportional share of excess capacity",
                   minimum=0.0),
            Option("osd_mclock_overload_policy", "str", "backpressure",
                   "past-saturation admission control: backpressure "
                   "defers dequeue until limit tags mature; shed "
                   "refuses enqueue with an EAGAIN-style throttle "
                   "reply once a tenant's backlog passes "
                   "osd_mclock_shed_queue_depth",
                   enum=("backpressure", "shed")),
            Option("osd_mclock_shed_queue_depth", "int", 256,
                   "per-tenant queued-op depth that triggers shedding "
                   "(shed policy only)", minimum=1),
            Option("osd_mclock_tenant_profiles", "str", "",
                   "JSON {tenant: {reservation, limit, weight}} "
                   "per-tenant overrides of the osd_mclock_client_* "
                   "defaults"),
        ])
        # op tracing rides the same config (hot-togglable: `config set
        # tracer_enabled true` over the admin socket starts collecting)
        tracer.register_config(self.config)
        # the process-wide EC offload service's knobs (ec_offload_*)
        # ride this daemon's config too: `config set
        # ec_offload_linger_ms 5` over the admin socket retunes the
        # batcher live via the config observer
        from ceph_tpu_torch import offload
        offload.register_config(self.config)
        # per-peer message batching knobs (msgr_batch_*): hot-togglable
        # through the same observer path — `config set
        # msgr_batch_linger_us 1000` retunes the wire batcher live
        from ceph_tpu_torch.msg import messenger as msgr_mod
        msgr_mod.register_config(self.config)
        # the msgr frame/batch counters must exist before the first
        # MgrReport so their families export from round one
        msgr_mod.msgr_perf()
        # runtime asyncio sanitizer (debug mode + slow-callback log +
        # task spawn-site tracking): `config set sanitizer_enabled
        # true` arms the running loop live
        sanitizer.register_config(self.config)
        # event-loop sampling profiler (`profile dump` over the admin
        # socket): loop-busy-fraction + top stall sites, hot-togglable
        # via `config set profiler_enabled true`
        loopprof.register_config(self.config)
        # deterministic fault injection (fault_inject_*): `config set
        # fault_inject_enabled true` over the admin socket arms the
        # process-wide injector; the `inject` command fires one-shots
        faultinject.register_config(self.config)
        # flight-recorder knobs (flight_*): `config set
        # flight_ring_capacity 2048` resizes the process-wide event
        # ring live; `config set flight_enabled false` silences it
        flight.register_config(self.config)
        # the profiler/copy-ledger/tracer counter mirrors must exist
        # before the first MgrClient report so their families export
        # from round one
        loopprof.perf()
        copytrack.perf()
        tracer.perf()
        scrub_mod.scrub_perf()
        # per-daemon perf counters, served by `perf dump` (the admin
        # socket reads the process-wide collection)
        coll = PerfCountersCollection.instance()
        coll.remove(f"osd.{whoami}")    # a restarted id re-registers
        self.perf = coll.create(f"osd.{whoami}")
        self.perf.add("op", description="client ops executed")
        self.perf.add("op_latency", type=TYPE_AVG,
                      description="client op latency (seconds)")
        self.perf.add("subop", description="replication sub-ops applied")
        self.perf.add("recovery_push",
                      description="objects pushed by recovery/backfill")
        self.perf.add("recovery_bytes_pushed",
                      description="shard bytes pushed to recovering "
                                  "peers")
        self.perf.add("recovery_bytes_fetched",
                      description="shard bytes fetched by recovery "
                                  "reconstruction gathers")
        self.perf.add("recovery_bytes_full_equiv",
                      description="bytes a full-stripe gather would "
                                  "have fetched for the same repairs "
                                  "(repair-bandwidth baseline)")
        self.perf.add("heartbeat_failures",
                      description="peers reported failed to the mon")
        # per-stage latency histograms (power-of-two µs buckets; the
        # exporter renders them as cumulative prometheus histograms)
        # per-PG pipelined execution (the PrimaryLogPG concurrency
        # window): live occupancy + admissions parked on a full window
        self.perf.add("pg_pipeline_inflight", type=TYPE_GAUGE,
                      description="ops currently in pipelined "
                                  "execution across this OSD's PGs")
        self.perf.add("pg_pipeline_window_stalls",
                      description="shard-worker waits with queued work "
                                  "blocked behind a full per-PG "
                                  "pipeline window")
        # dmclock QoS ledger (per-tenant splits ride the MgrReport
        # qos_metrics leg; these are the daemon-wide aggregates)
        self.perf.add("qos_shed",
                      description="client ops refused by shed "
                                  "admission control (throttle reply)")
        self.perf.add("qos_deferred_waits",
                      description="shard-worker sleeps with every "
                                  "queued tenant limit-blocked "
                                  "(backpressure)")
        self.perf.add("qos_dequeue_reservation",
                      description="ops dequeued by the reservation "
                                  "phase (tenant behind its floor)")
        self.perf.add("qos_dequeue_weight",
                      description="ops dequeued by the weight phase "
                                  "(proportional share)")
        self.perf.add("op_total_us", type=TYPE_HISTOGRAM,
                      description="client op total latency (µs)")
        self.perf.add("op_queue_wait_us", type=TYPE_HISTOGRAM,
                      description="op queue wait before dequeue (µs)")
        self.perf.add("ec_encode_us", type=TYPE_HISTOGRAM,
                      description="EC encode dispatch latency (µs)")
        self.perf.add("store_commit_us", type=TYPE_HISTOGRAM,
                      description="objectstore queue_transaction "
                                  "latency (µs)")
        # the store feeds its commit latency into this daemon's histogram
        self.store.commit_perf = self.perf
        # op execution substrate: sharded queue (per-PG order, cross-PG
        # concurrency) + finisher for completions + per-op tracking
        self.hb_map = HeartbeatMap()
        # the per-client accountant registers in the process collection
        # so admin-socket `perf dump`/`perf reset` cover it (reset
        # zeroes the client tables, not just the aggregate counters)
        clients = ClientTable(
            f"osd.{whoami}.clients",
            max_entries=self.config.get("osd_max_client_entries"))
        clients.set_slo(read_ms=self.config.get("slo_read_ms"),
                        write_ms=self.config.get("slo_write_ms"))
        coll.remove(clients.name)       # a restarted id re-registers
        coll.register(clients)
        self.config.add_observer(
            ("slo_read_ms", "slo_write_ms", "osd_max_client_entries"),
            self._on_client_knobs)
        self.optracker = OpTracker(clients=clients)
        self.op_queue = ShardedOpQueue(
            f"osd.{whoami}.op_tp",
            num_shards=self.config.get("osd_op_num_shards"),
            hb_map=self.hb_map,
            pipeline_depth=self.config.get("osd_pg_pipeline_depth"),
            perf=self.perf)
        self.config.add_observer(("osd_pg_pipeline_depth",),
                                 self._on_pipeline_depth)
        # dmclock arbiter wiring: seed the scheduler from the knobs,
        # then keep it live via the observer (every osd_mclock_* knob
        # is hot, including the enable toggle — queued work migrates)
        self._apply_qos_knobs()
        self.op_queue.set_mclock_enabled(
            self.config.get("osd_mclock_enabled"))
        self.config.add_observer(
            ("osd_mclock_enabled", "osd_mclock_cost_per_io_bytes",
             "osd_mclock_client_reservation",
             "osd_mclock_client_limit", "osd_mclock_client_weight",
             "osd_mclock_recovery_reservation",
             "osd_mclock_recovery_limit", "osd_mclock_recovery_weight",
             "osd_mclock_scrub_reservation",
             "osd_mclock_scrub_limit", "osd_mclock_scrub_weight",
             "osd_mclock_snaptrim_reservation",
             "osd_mclock_snaptrim_limit", "osd_mclock_snaptrim_weight",
             "osd_mclock_overload_policy",
             "osd_mclock_shed_queue_depth",
             "osd_mclock_tenant_profiles"),
            self._on_qos_knobs)
        self.finisher = Finisher(f"osd.{whoami}.finisher",
                                 hb_map=self.hb_map)
        self.asok: AdminSocket | None = None
        if admin_socket_path:
            self.asok = AdminSocket(admin_socket_path, config=self.config)
            self.asok.register_command(
                "dump_ops_in_flight",
                lambda req: self.optracker.dump_ops_in_flight(),
                "ops currently being processed")
            self.asok.register_command(
                "dump_historic_ops",
                lambda req: self.optracker.dump_historic_ops(),
                "recently completed ops with event timelines")
            self.asok.register_command(
                "dump_historic_slow_ops",
                lambda req: self.optracker.dump_historic_slow_ops(),
                "recently completed slow ops")
            self.asok.register_command(
                "dump_clients",
                lambda req: self._dump_clients(req.get("limit")),
                "per-client accounting: ops/bytes/in-flight, rolling "
                "p50/p99 per class, SLO good-vs-violating counters, "
                "live QoS tag clocks")
            self.asok.register_command(
                "qos status",
                lambda req: self.op_queue.qos_status(),
                "dmclock scheduler: per-tenant tag clocks, "
                "reservation/limit/weight in force, shed/deferred "
                "ledger")
            self.asok.register_command(
                "scrub",
                lambda req: self._trigger_scrub(req.get("deep", False)),
                "scrub all primary PGs now (deep=true for deep scrub)")
            self.asok.register_command(
                "last_scrub",
                lambda req: {f"{pgid.pool}.{pgid.ps}": pg.last_scrub
                             for pgid, pg in self.pgs.items()
                             if pg.last_scrub is not None},
                "last scrub result per PG")
            self.asok.register_command(
                "list-inconsistent-obj",
                lambda req: self._list_inconsistent(req.get("pool")),
                "per-PG inconsistent-object registry from the last "
                "scrub rounds (optionally filtered by pool id)")
            self.asok.register_command(
                "status", lambda req: self._daemon_status(),
                "daemon status")
            self.asok.register_command(
                "ec offload status",
                lambda req: self._offload_admin("status"),
                "offload service: queue/batch/fallback stats + settings")
            self.asok.register_command(
                "ec offload flush",
                lambda req: self._offload_admin("flush"),
                "force-flush every pending offload batch bucket")
            self.asok.register_command(
                "inject",
                lambda req: self._inject_admin(req),
                "fault injection: what=crash|hang|bitrot|msg|device|"
                "status (hang: seconds; bitrot: oid [offset]; msg: "
                "action/type/entity/count; device: count)")
        self.messenger = Messenger(f"osd.{whoami}", auth_key=auth_key)
        self.messenger.add_dispatcher(self)
        self.monc = MonClient(self.messenger, mon_addrs)
        self.monc.on_osdmap = self._on_osdmap
        # mgr report session: perf-counter deltas + daemon status +
        # health metrics (slow ops, pg states, store utilization) +
        # recovery progress, shipped as MMgrReport over the messenger
        self.mgr_client = MgrClient(
            self.messenger, f"osd.{whoami}", "osd",
            resolve=lambda: (self.monc.mgrmap or {}).get("active_addr"),
            status_cb=self._daemon_status,
            health_cb=self._mgr_health_metrics,
            progress_cb=self._mgr_progress,
            device_cb=self._mgr_device_metrics,
            client_cb=self._mgr_client_metrics,
            qos_cb=self._mgr_qos_metrics,
            extra_loggers=("offload", "sanitizer", "loopprof",
                           "copyflow", "msgr", "tracer", "scrub"))
        # the per-loop offload service handle (set at start(): the
        # admin-socket thread cannot resolve the running loop itself)
        self._offload_svc = None
        self.osdmap = OSDMap()
        self.pgs: dict[PG, PGInstance] = {}
        self.addr: tuple[str, int] | None = None
        self._conns: dict[int, Connection] = {}
        # ops parked until their PG finishes peering (waiting_for_active,
        # src/osd/PG.cc): preserves arrival order without wedging a
        # queue shard on a peering PG. Entries are (ingest_seq, conn,
        # msg, trk) kept sorted by ingest_seq: an op re-parked from the
        # shard queue must land BEFORE later arrivals that parked
        # directly, or a client's ops reorder across an interval change
        # (the reference requeues at the front for the same reason)
        self._waiting_for_active: dict[PG, list] = {}
        self._op_seq = 0
        # strong refs to detached notify tasks (the loop keeps only
        # weak refs; a collected task would drop the notify silently)
        self._notify_tasks: set[asyncio.Task] = set()
        # host-wide recovery throttle: background pushes across ALL PGs
        # share these slots so backfill cannot monopolize the daemon
        # (AsyncReserver, src/common/AsyncReserver.h). Resizable live
        # via the osd_max_recovery_in_flight config observer so
        # recovery pressure can be tuned mid-storm.
        self.recovery_reservations = AdjustableSemaphore(
            self.config.get("osd_max_recovery_in_flight"))
        self.config.add_observer(("osd_max_recovery_in_flight",),
                                 self._on_recovery_slots)
        # host-wide scrub slots (osd_max_scrubs): a round — primary- or
        # replica-side — holds one for its whole duration. Named, so
        # when lockdep is armed every park on the pool is a tracked
        # wait and every holder a tracked task; the entity detail rides
        # into the mgr deadlock annotations.
        self.scrub_reservations = AdjustableSemaphore(
            self.config.get("osd_max_scrubs"),
            name=f"osd.{self.whoami}:scrub_reservations")
        self.scrub_reservations.lockdep_detail = {
            "entity": f"osd.{self.whoami}"}
        # remote grants held for other primaries: (pool, ps, tid, from)
        self._scrub_remote_grants: set[tuple] = set()
        self.config.add_observer(("osd_max_scrubs",),
                                 self._on_scrub_slots)
        # fault injection: a hang deadline makes dispatch swallow
        # everything (peers see heartbeat silence -> mark-down); the
        # crash task is deliberately NOT in _bg_tasks (it runs stop(),
        # which reaps _bg_tasks — tracking it there would self-deadlock)
        self._hang_until = 0.0
        self._crash_task: asyncio.Task | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        # reactor shard index (set at start(); None = unpooled loop)
        self.shard: int | None = None
        self._booted = asyncio.Event()
        self._hb_task: asyncio.Task | None = None
        self._scrub_task: asyncio.Task | None = None
        self._bg_tasks: set[asyncio.Task] = set()
        self._reboot_task: asyncio.Task | None = None
        self._hb_last: dict[int, float] = {}      # peer -> last reply stamp
        self._hb_reported: set[int] = set()
        self._stopping = False
        # completion latch for concurrent stops (injected crash racing
        # harness teardown): the second caller WAITS for the first
        # stop to finish rather than returning mid-teardown
        self._stop_event: asyncio.Event | None = None

    # -- lifecycle -----------------------------------------------------------

    async def start(self, timeout: float = 30.0) -> tuple[str, int]:
        # the offload service's device list (DeviceUnavailable without
        # the card it names), sliced to this process's partition when a
        # process-backed reactor spawned it
        devices = _device.service_devices(self.device)
        # this process's CUDA context and kernels, before the daemon
        # joins the map: done at the first dispatch instead, they would
        # stall the loop past its peers' heartbeat grace
        _device.open_devices(devices)
        try:
            self.store.mount()
        except StoreError as e:
            # ONLY an uninitialized store may be formatted — any other
            # mount failure (corrupt meta, IO error) must not silently
            # wipe a durable store
            if e.code != "ENOENT":
                raise
            self.store.mkfs()
            self.store.mount()
        from ceph_tpu_torch import offload
        self._offload_svc = offload.get_service(devices)
        if self._offload_svc.devices != devices:
            raise ValueError(
                f"osd.{self.whoami} asks for devices {devices}, but this "
                f"loop's offload service runs on {self._offload_svc.devices}")
        self._loop = asyncio.get_running_loop()
        # reactor placement: under the sharded runtime start() runs ON
        # the owning shard's loop, so every loop-bound resource this
        # daemon creates (messenger server, connections, op queue,
        # offload front end) lands on that shard by construction
        from ceph_tpu_torch.utils import reactor
        self.shard = reactor.shard_index_of(self._loop)
        sanitizer.maybe_install(self.config)
        loopprof.maybe_install(self.config)
        self.op_queue.start()
        self.finisher.start()
        if self.asok is not None:
            self.asok.start()
        self.addr = await self.messenger.bind("127.0.0.1", 0)
        await self.monc.start()
        self.monc.subscribe("osdmap", 1)
        self.monc.subscribe("mgrmap", 1)
        await self.monc.send_boot(self.whoami, self.addr,
                                  crush_location=self.crush_location)
        deadline = time.monotonic() + timeout
        while not self._booted.is_set():
            if time.monotonic() > deadline:
                raise TimeoutError(f"osd.{self.whoami} never marked up")
            # boots can race leadership churn: re-send until the map shows us
            try:
                await asyncio.wait_for(self._booted.wait(), 2.0)
            except asyncio.TimeoutError:
                await self.monc.send_boot(self.whoami, self.addr,
                                          crush_location=self.crush_location)
        self._hb_task = asyncio.get_running_loop().create_task(
            self._heartbeat())
        self._scrub_task = asyncio.get_running_loop().create_task(
            self._scrub_loop())
        self.mgr_client.start()
        dout("osd", 1, f"osd.{self.whoami} up at {self.addr}")
        return self.addr

    # -- mgr reporting -------------------------------------------------------

    def _daemon_status(self) -> dict:
        return {"whoami": self.whoami,
                "osdmap_epoch": self.osdmap.epoch,
                "num_pgs": len(self.pgs),
                "hb_healthy": self.hb_map.is_healthy()[0],
                "reactor_shard": self.shard,
                "ops_processed": self.op_queue.processed,
                "pipeline": {
                    "depth": self.op_queue.pipeline_depth,
                    "in_flight": self.op_queue.total_in_flight(),
                    "window_stalls": self.op_queue.window_stalls}}

    def _mgr_health_metrics(self) -> dict:
        """Daemon health metrics for the report path: slow ops from the
        OpTracker, pending PG states, store utilization — the inputs of
        the mon's SLOW_OPS / PG_* / OSD_NEARFULL checks."""
        slow = self.optracker.get_health_metrics()
        states: dict[str, int] = {}
        degraded = undersized = 0
        for pg in self.pgs.values():
            states[pg.state] = states.get(pg.state, 0) + 1
            if not pg.is_primary():
                continue
            if len(pg.acting) < pg.pool.size:
                undersized += 1
                degraded += 1
            elif pg._pending_recovery:
                degraded += 1
        return {"slow_ops": slow["slow_ops"],
                "slow_ops_oldest_age_s": slow["oldest_age_s"],
                "pg_states": states,
                "degraded_pgs": degraded,
                "undersized_pgs": undersized,
                # unarchived crash records for this daemon: the mgr
                # digests any non-zero count into RECENT_CRASH
                "recent_crashes": len(crash.recent(f"osd.{self.whoami}")),
                # device-offload circuit-breaker state: the mgr digests
                # a degraded service into its offload health check
                "offload": (self._offload_svc.health_metrics()
                            if self._offload_svc is not None else {}),
                # per-client SLO surface: recent violations + slow
                # clients, digested into SLO_VIOLATIONS / SLOW_CLIENT
                "clients": self.optracker.clients.health_metrics(),
                # integrity surface: registry counts digested into
                # PG_DAMAGED / OSD_SCRUB_ERRORS, per-pool table
                # aggregated into the ceph_scrub_* exporter families
                "scrub": self._scrub_health_metrics(),
                # long-parked lock/grant waits annotated with (entity,
                # resource, peer, tid): the rows the mgr assembles into
                # its cross-daemon wait-for graph (DEADLOCK_SUSPECTED)
                "deadlock": sanitizer.wait_annotations(
                    entity=f"osd.{self.whoami}"),
                "store": self.store.statfs()}

    def _mgr_device_metrics(self) -> dict:
        """Per-device offload utilization for the report path: the mgr
        stores these per daemon; the exporter renders them with a
        `ceph_device` label."""
        return (self._offload_svc.device_metrics()
                if self._offload_svc is not None else {})

    def _mgr_client_metrics(self) -> dict:
        """Per-client accounting for the report path: the mgr merges a
        client's tallies ACROSS OSDs and the exporter renders them as
        `ceph_client_*` families with a `ceph_client` label."""
        return self.optracker.clients.mgr_metrics()

    def _mgr_qos_metrics(self) -> dict:
        """Per-tenant QoS ledger (shed/deferred/dequeue-phase splits)
        for the report path: the exporter renders them as `ceph_qos_*`
        families with a `tenant` label."""
        return self.op_queue.sched.tenant_metrics()

    def _dump_clients(self, limit=None) -> dict:
        """dump_clients + the live QoS tag columns of each client's
        scheduling entity (its tenant, or itself when untenanted)."""
        dump = self.optracker.clients.dump_clients(limit)
        sched = self.op_queue.sched
        for row in dump.get("clients", []):
            row.update(sched.tag_columns(
                row.get("tenant") or row.get("client")))
        return dump

    def _on_client_knobs(self, name: str, value) -> None:
        """slo_read_ms / slo_write_ms / osd_max_client_entries observer:
        pushed straight into the live ClientTable (its own lock makes
        this safe from the admin-socket thread)."""
        clients = self.optracker.clients
        if name == "slo_read_ms":
            clients.set_slo(read_ms=float(value))
        elif name == "slo_write_ms":
            clients.set_slo(write_ms=float(value))
        elif name == "osd_max_client_entries":
            clients.resize(int(value))

    def _offload_admin(self, cmd: str) -> dict:
        if self._offload_svc is None:
            return {"error": "offload service not started"}
        if cmd == "flush":
            return self._offload_svc.flush()
        return self._offload_svc.status()

    # -- fault injection (admin `inject` + injector-driven hooks) ------------

    def _run_on_loop(self, fn, *args) -> None:
        """Run `fn(*args)` on this daemon's loop: config observers fire
        from admin-socket threads, and the targets (wake events,
        semaphores) are loop-bound — hop via call_soon_threadsafe when
        off the loop, run inline when already on it (or when the
        daemon's loop is gone)."""
        loop = self._loop
        if loop is not None and not loop.is_closed():
            try:
                on_loop = asyncio.get_running_loop() is loop
            except RuntimeError:
                on_loop = False
            if not on_loop:
                loop.call_soon_threadsafe(fn, *args)
                return
        fn(*args)

    def _on_pipeline_depth(self, name: str, value) -> None:
        """osd_pg_pipeline_depth observer: hot-resize the live per-PG
        admission window."""
        self._run_on_loop(self.op_queue.set_pipeline_depth, int(value))

    def _apply_qos_knobs(self) -> None:
        """Push every osd_mclock_* value into the live scheduler."""
        cfg = self.config
        profiles: dict = {}
        raw = cfg.get("osd_mclock_tenant_profiles")
        if raw:
            try:
                parsed = json.loads(raw)
                if isinstance(parsed, dict):
                    profiles = {str(k): v for k, v in parsed.items()
                                if isinstance(v, dict)}
            except (ValueError, TypeError):
                dout("osd", 1, f"osd.{self.whoami}: bad "
                               f"osd_mclock_tenant_profiles JSON ignored")
        self.op_queue.configure_qos(
            cost_per_io_bytes=cfg.get("osd_mclock_cost_per_io_bytes"),
            client_reservation=cfg.get("osd_mclock_client_reservation"),
            client_limit=cfg.get("osd_mclock_client_limit"),
            client_weight=cfg.get("osd_mclock_client_weight"),
            tenant_profiles=profiles,
            overload_policy=cfg.get("osd_mclock_overload_policy"),
            shed_queue_depth=cfg.get("osd_mclock_shed_queue_depth"),
            class_params={"recovery": {
                "reservation": cfg.get("osd_mclock_recovery_reservation"),
                "limit": cfg.get("osd_mclock_recovery_limit"),
                "weight": cfg.get("osd_mclock_recovery_weight")},
                "scrub": {
                "reservation": cfg.get("osd_mclock_scrub_reservation"),
                "limit": cfg.get("osd_mclock_scrub_limit"),
                "weight": cfg.get("osd_mclock_scrub_weight")},
                "snaptrim": {
                "reservation": cfg.get("osd_mclock_snaptrim_reservation"),
                "limit": cfg.get("osd_mclock_snaptrim_limit"),
                "weight": cfg.get("osd_mclock_snaptrim_weight")}})

    def _on_qos_knobs(self, name: str, value) -> None:
        """osd_mclock_* observer: the enable toggle migrates queued
        work (loop-bound); parameter knobs re-resolve every live
        entity's tags."""
        if name == "osd_mclock_enabled":
            self._run_on_loop(self.op_queue.set_mclock_enabled,
                              bool(value))
        else:
            self._run_on_loop(self._apply_qos_knobs)

    def _on_recovery_slots(self, name: str, value) -> None:
        """osd_max_recovery_in_flight observer: resize the live slot
        pool."""
        self._run_on_loop(self.recovery_reservations.resize, int(value))

    def _on_scrub_slots(self, name: str, value) -> None:
        """osd_max_scrubs observer: resize the live scrub slot pool."""
        self._run_on_loop(self.scrub_reservations.resize, int(value))

    def _inject_admin(self, req: dict) -> dict:
        """`inject` admin-socket verbs — the same injector the config
        knobs and the failure-storm bench drive."""
        what = req.get("what", "status")
        if what == "status":
            return faultinject.status()
        if what in ("msg", "device"):
            # one-shot rules are consulted behind the armed() gate:
            # arming them with the injector disabled would be a silent
            # no-op (crash/hang/bitrot fire unconditionally) — auto-arm
            # and say so, `config set fault_inject_enabled false`
            # disarms as usual
            armed_now = not faultinject.armed()
            if armed_now:
                faultinject.set_enabled(True)
            if what == "msg":
                rule = faultinject.arm_oneshot(
                    entity=req.get("entity"), msg_type=req.get("type"),
                    action=req.get("action", "drop"),
                    count=int(req.get("count", 1)),
                    delay_ms=req.get("delay_ms"))
                return {"injected": "msg", "rule": rule,
                        "armed": armed_now}
            pending = faultinject.arm_device_failures(
                int(req.get("count", 1)))
            return {"injected": "device", "pending": pending,
                    "armed": armed_now}
        loop = self._loop
        if loop is None or loop.is_closed():
            return {"error": "daemon not running"}
        if what == "crash":
            loop.call_soon_threadsafe(self._start_crash_task)
            return {"injected": "crash"}
        if what == "hang":
            seconds = float(req.get("seconds", 5.0))
            loop.call_soon_threadsafe(self._set_hang, seconds)
            return {"injected": "hang", "seconds": seconds}
        if what == "bitrot":
            import concurrent.futures
            fut = asyncio.run_coroutine_threadsafe(
                self._inject_bitrot(req["oid"], req.get("offset")), loop)
            try:
                return fut.result(timeout=5.0)
            except concurrent.futures.TimeoutError:
                fut.cancel()
                return {"error": "bitrot injection timed out"}
        return {"error": f"unknown inject target {what!r}"}

    def _start_crash_task(self) -> None:
        if self._crash_task is None or self._crash_task.done():
            self._crash_task = asyncio.get_running_loop().create_task(
                self.fault_crash())

    def _set_hang(self, seconds: float) -> None:
        self._hang_until = time.monotonic() + max(0.0, seconds)
        dout("osd", 1, f"osd.{self.whoami} injected hang for "
                       f"{seconds:.1f}s (dispatch + heartbeats muted)")

    async def fault_crash(self, reason: str = "injected crash") -> None:
        """Injected daemon death: record the crash, then tear down —
        peers find out through heartbeat silence, exactly like a kill."""
        crash.record(f"osd.{self.whoami}", RuntimeError(reason),
                     backtrace="(injected)")
        await self.stop()

    async def _inject_bitrot(self, oid: str,
                             offset=None) -> dict:
        """Flip one byte of the local shard blob of `oid` (any PG),
        bypassing csum maintenance — on the loop, so it cannot race a
        concurrent apply."""
        for pg in self.pgs.values():
            if not pg.backend.local_exists(oid):
                continue
            cid = pg.backend.coll()
            gh = pg.backend.ghobject(oid)
            size = len(self.store.read(cid, gh))
            if size == 0:
                return {"error": f"{oid!r} is empty on osd.{self.whoami}"}
            off = int(offset) if offset is not None else size // 2
            if self.store.corrupt(cid, gh, off):
                dout("osd", 1, f"osd.{self.whoami} injected bitrot in "
                               f"{oid!r} at offset {off}")
                return {"injected": "bitrot", "oid": oid, "offset": off,
                        "size": size}
        return {"error": f"no local shard of {oid!r} on "
                         f"osd.{self.whoami}"}

    def _mgr_progress(self) -> list:
        """Completion fractions for in-flight recovery/backfill (the
        reference progress module's events, fed through MMgrReport)."""
        out = []
        for pg in self.pgs.values():
            total = getattr(pg, "recovery_total", 0)
            remaining = len(pg._pending_recovery)
            if total and remaining:
                out.append({
                    "id": f"recovery-{pg.pgid.pool}.{pg.pgid.ps}",
                    "message": f"recovery of pg "
                               f"{pg.pgid.pool}.{pg.pgid.ps}",
                    "progress": round(
                        max(0.0, (total - remaining)) / total, 4)})
            prog = getattr(pg, "scrub_progress", None)
            if prog is not None and prog.state == "scrubbing" \
                    and prog.objects_total:
                out.append({
                    "id": f"scrub-{pg.pgid.pool}.{pg.pgid.ps}",
                    "message": f"{'deep-' if prog.deep else ''}scrub of "
                               f"pg {pg.pgid.pool}.{pg.pgid.ps}",
                    "progress": round(
                        min(prog.objects_scrubbed, prog.objects_total)
                        / prog.objects_total, 4)})
        return out

    def _spawn_scrubs(self, deep: bool) -> dict[str, asyncio.Task]:
        """One scrub task per primary active PG, each held in _bg_tasks
        (reaped at stop(), failures crash-recorded) AND returned by
        handle so callers can await real per-PG results."""
        tasks: dict[str, asyncio.Task] = {}
        for pgid, pg in list(self.pgs.items()):
            if pg.is_primary() and pg.state == "active":
                task = asyncio.get_running_loop().create_task(
                    pg.scrub(deep=deep))
                # hold a strong ref (the loop keeps only a weak one) and
                # surface repair failures in the log
                self._bg_tasks.add(task)
                task.add_done_callback(self._bg_task_done)
                tasks[f"{pgid.pool}.{pgid.ps}"] = task
        return tasks

    def _trigger_scrub(self, deep: bool) -> dict:
        """Kick a scrub of every primary PG. From the loop the tasks
        are spawned inline; from an admin-socket thread the spawn hops
        to the daemon's loop (tasks can only be created there) and the
        reply lists the PGs that will be scheduled."""
        try:
            on_loop = asyncio.get_running_loop() is self._loop
        except RuntimeError:
            on_loop = False
        if on_loop:
            pgs = sorted(self._spawn_scrubs(deep))
        else:
            pgs = sorted(f"{pgid.pool}.{pgid.ps}"
                         for pgid, pg in list(self.pgs.items())
                         if pg.is_primary() and pg.state == "active")
            self._run_on_loop(self._spawn_scrubs, deep)
        return {"scheduled": len(pgs), "deep": deep, "pgs": pgs}

    async def scrub_all(self, deep: bool = False) -> dict[str, dict]:
        """Scrub every primary PG and return {pg: result} — the awaited
        form of the fire-and-forget `scrub` admin verb. Waits without
        cancelling; a failed PG's slot is None (the failure is already
        crash-recorded by _bg_task_done)."""
        tasks = self._spawn_scrubs(deep)
        await drain_all(tasks.values())
        out: dict[str, dict] = {}
        for key, task in tasks.items():
            out[key] = (task.result()
                        if not task.cancelled()
                        and task.exception() is None else None)
        return out

    def _list_inconsistent(self, pool=None) -> dict:
        """Admin `list-inconsistent-obj`: the per-PG registries of every
        primary PG, newest scrub knowledge (the `rados
        list-inconsistent-obj` analog)."""
        out: dict = {}
        for pgid, pg in self.pgs.items():
            if not pg.is_primary():
                continue
            if pool is not None and pgid.pool != int(pool):
                continue
            if pg.inconsistent_objects:
                out[f"{pgid.pool}.{pgid.ps}"] = [
                    dict(e) for _, e in
                    sorted(pg.inconsistent_objects.items())]
        return {"inconsistent": out,
                "objects": sum(len(v) for v in out.values())}

    def _scrub_health_metrics(self) -> dict:
        """The scrub slice of the mgr health report: cluster health
        checks (PG_DAMAGED / OSD_SCRUB_ERRORS) key off the registry
        counts; the per-pool table feeds DaemonStateIndex
        .scrub_aggregate() -> the ceph_scrub_*{pool=} exporter
        families."""
        inconsistent = unrepaired = damaged_pgs = 0
        pools: dict[str, dict] = {}
        now = time.time()
        for pgid, pg in self.pgs.items():
            if not pg.is_primary():
                continue
            name = getattr(pg.pool, "name", None) or str(pgid.pool)
            p = pools.setdefault(name, {
                "objects_scrubbed": 0, "bytes_hashed": 0,
                "errors_found": 0, "errors_repaired": 0,
                "inconsistent": 0, "unrepaired": 0,
                "last_scrub_age_s": -1.0, "last_deep_scrub_age_s": -1.0})
            st = pg.scrub_stats
            p["objects_scrubbed"] += st["objects_scrubbed"]
            p["bytes_hashed"] += st["bytes_hashed"]
            p["errors_found"] += st["errors_found"]
            p["errors_repaired"] += st["errors_repaired"]
            reg = pg.inconsistent_objects
            n_unrep = sum(1 for e in reg.values() if not e["repaired"])
            p["inconsistent"] += len(reg)
            p["unrepaired"] += n_unrep
            inconsistent += len(reg)
            unrepaired += n_unrep
            if reg:
                damaged_pgs += 1
            for stamp, key in ((pg.last_scrub_stamp, "last_scrub_age_s"),
                               (pg.last_deep_scrub_stamp,
                                "last_deep_scrub_age_s")):
                if stamp:
                    age = round(now - stamp, 1)
                    if p[key] < 0 or age > p[key]:
                        p[key] = age
        return {"inconsistent_objects": inconsistent,
                "unrepaired_objects": unrepaired,
                "inconsistent_pgs": damaged_pgs,
                "pools": pools}

    def _bg_task_done(self, task: asyncio.Task) -> None:
        self._bg_tasks.discard(task)
        if not task.cancelled() and task.exception() is not None:
            e = task.exception()
            dout("osd", 1, f"osd.{self.whoami} background task failed: "
                           f"{type(e).__name__} {e}")
            # a swallowed fatal exception leaves a crash record behind:
            # surfaced as RECENT_CRASH through the mgr report path and
            # listable via `crash ls`
            crash.record(f"osd.{self.whoami}", e)

    async def _scrub_loop(self) -> None:
        """Background scrub scheduler: every SCRUB_INTERVAL, scrub each
        PG this OSD is primary of (the reference's OSD::sched_scrub);
        every DEEP_SCRUB_EVERY-th round re-reads data (deep)."""
        rounds = 0
        last = time.monotonic()
        while True:
            # sleep in short slices so a runtime `config set
            # osd_scrub_interval` takes effect without waiting out the
            # previous interval
            interval = self.config.get("osd_scrub_interval")
            await asyncio.sleep(min(1.0, interval / 4))
            if time.monotonic() - last < interval:
                continue
            last = time.monotonic()
            rounds += 1
            deep = rounds % self.config.get("osd_deep_scrub_every") == 0
            # per-PG tasks with real handles: failures are crash-
            # recorded by _bg_task_done, stragglers are reaped at
            # stop() via _bg_tasks — nothing fire-and-forget
            await self.scrub_all(deep=deep)

    async def _reboot_until_up(self) -> None:
        """Resend MOSDBoot until the map shows us up again (mirrors the
        resend loop in start(); survives mon churn mid-send)."""
        while not self._stopping:
            if self._hang_until and time.monotonic() < self._hang_until:
                # injected hang: a wedged daemon cannot re-boot either —
                # the mark-down must stick until the hang lifts
                await asyncio.sleep(0.2)
                continue
            me = self.osdmap.osds.get(self.whoami)
            if me is not None and me.up and self._same_addr(me.addr):
                return
            try:
                await self.monc.send_boot(self.whoami, self.addr,
                                          crush_location=self.crush_location)
            except Exception as e:
                dout("osd", 5, f"osd.{self.whoami} re-boot send failed: "
                               f"{type(e).__name__} {e}")
            await asyncio.sleep(2.0)

    async def stop(self) -> None:
        if self._stop_event is not None:
            # a stop is already running (or done): wait it out so the
            # caller never proceeds while teardown is mid-flight
            await self._stop_event.wait()
            return
        self._stop_event = asyncio.Event()
        self._stopping = True
        try:
            bg = [t for t in (self._hb_task, self._scrub_task,
                              self._reboot_task) if t is not None]
            # background + detached-notify tasks too: anything left
            # pending when the loop closes is destroyed (messenger
            # leak's sibling)
            bg += list(self._bg_tasks) + list(self._notify_tasks)
            await reap_all(bg)
            self._bg_tasks.clear()
            self._notify_tasks.clear()
            for pg in self.pgs.values():
                pg._cancel_peering()
                pg.backend.fail_inflight("osd stopping")
            for waiting in self._waiting_for_active.values():
                for _, _, _, trk in waiting:
                    trk.finish()
            self._waiting_for_active.clear()
            await self.op_queue.stop()
            await self.finisher.stop()
            if self.asok is not None:
                self.asok.stop()
            await self.mgr_client.stop()
            await self.monc.close()
            await self.messenger.shutdown()
            # coalesced persist flush LAST, after the messenger is down:
            # a sub-op dispatched mid-teardown re-arms the call_soon
            # flush, and an earlier flush would leave that dirty delta
            # to fire after umount (applied data without its log entry)
            for pg in self.pgs.values():
                pg.flush_persist()
            self.store.umount()
        finally:
            self._stop_event.set()

    # -- osdmap plane --------------------------------------------------------

    async def _on_osdmap(self, payload: dict) -> None:
        changed = False
        if payload.get("full") is not None:
            full = payload["full"]
            if full["epoch"] > self.osdmap.epoch:
                self.osdmap.load_dict(full)
                changed = True
        for raw in payload.get("incrementals", []):
            inc_dict = json.loads(raw) if isinstance(raw, str) else raw
            inc = Incremental.from_dict(inc_dict)
            if inc.epoch <= self.osdmap.epoch:
                continue
            if inc.epoch != self.osdmap.epoch + 1:
                # gap: ask the mon for the full map instead
                self.monc.subscribe("osdmap", self.osdmap.epoch + 1)
                break
            self.osdmap.apply_incremental(inc)
            changed = True
        if not changed:
            return
        self.monc.sub_got("osdmap", self.osdmap.epoch)
        me = self.osdmap.osds.get(self.whoami)
        if me is not None and me.up and self._same_addr(me.addr):
            self._booted.set()
        elif self._booted.is_set() and me is not None and not me.up \
                and not self._stopping:
            # we are alive but the map says down (wrongly marked):
            # re-boot, as the reference OSD does on a spurious mark-down
            if self._reboot_task is None or self._reboot_task.done():
                dout("osd", 1, f"osd.{self.whoami} wrongly marked down; "
                               f"re-booting")
                self._reboot_task = asyncio.get_running_loop().create_task(
                    self._reboot_until_up())
                t = asyncio.get_running_loop().create_task(
                    self.monc.send_log(
                        "WRN", f"osd.{self.whoami}",
                        "map wrongly marked me down; re-booting"))
                self._bg_tasks.add(t)
                t.add_done_callback(self._bg_task_done)
        for peer in list(self._conns):
            if not self.osdmap.is_up(peer):
                self._drop_conn(peer)
        self._advance_pgs()

    def _same_addr(self, addr) -> bool:
        if self.addr is None:
            return False
        return tuple(addr) == tuple(self.addr) if addr else False

    def _advance_pgs(self) -> None:
        """Scan every pool's PGs; host the ones whose acting set includes
        us, advance intervals on the rest (OSD::activate_map)."""
        for pool in self.osdmap.pools.values():
            for ps in range(pool.pg_num):
                pgid = PG(pool.id, ps)
                up, acting = self.osdmap.pg_to_up_acting_osds(pgid)
                mine = self.whoami in acting
                inst = self.pgs.get(pgid)
                if inst is None:
                    if not mine:
                        continue
                    inst = PGInstance(self, pgid, pool)
                    self.pgs[pgid] = inst
                # pool records mutate across epochs (snap create/rm):
                # the PG must see the current one, then react to newly
                # removed snaps
                inst.pool = pool
                inst.advance_map(up, acting)
                inst.maybe_snaptrim()
        # parked ops whose PG lost primacy (or went straight to active)
        # must not wait forever
        for pgid in list(self._waiting_for_active):
            pg = self.pgs.get(pgid)
            if pg is not None:
                if pg.state == "active" or not pg.is_primary():
                    self.requeue_waiting(pg)
            else:
                for seq, conn, msg, trk in self._waiting_for_active.pop(
                        pgid, []):
                    trk.finish()
                    try:
                        conn.send_message(MOSDOpReply(
                            {"tid": msg.payload.get("tid", 0), "rc": -11,
                             "epoch": self.osdmap.epoch,
                             "error": "pg gone"}))
                    except Exception:
                        pass

    # -- cluster connections -------------------------------------------------

    def _osd_addr(self, osd: int) -> tuple[str, int]:
        a = self.osdmap.get_addr(osd)
        return (a[0], int(a[1]))

    async def send_osd(self, peer: int, msg: Message) -> None:
        addr = self._osd_addr(peer)
        conn = self._conns.get(peer)
        if conn is not None and (conn._closed
                                 or tuple(conn.peer_addr or ()) != addr):
            # the peer re-bound (restart => new port): a cached lossless
            # conn would replay into the void forever
            self._drop_conn(peer)
            conn = None
        if conn is None:
            conn = await self.messenger.connect(addr, Policy.lossless_peer())
            self._conns[peer] = conn
        conn.send_message(msg)

    def _drop_conn(self, peer: int) -> None:
        conn = self._conns.pop(peer, None)
        if conn is not None:
            # tracked: stop() reaps these, so a close racing daemon
            # teardown can't be destroyed while pending
            t = asyncio.get_running_loop().create_task(conn.close())
            self._bg_tasks.add(t)
            t.add_done_callback(self._bg_task_done)

    # -- heartbeats / failure reporting (OSD::heartbeat) ---------------------

    def _hb_peers(self) -> set[int]:
        peers: set[int] = set()
        for pg in self.pgs.values():
            if pg.state != "stray":
                peers |= pg.acting_peers()
        return peers

    async def _heartbeat(self) -> None:
        # peer -> the address its stamp and report are about: a peer
        # that re-booted at a new address is another incarnation
        incarnation: dict[int, tuple] = {}
        while True:
            await asyncio.sleep(self.config.get("osd_heartbeat_interval"))
            now = time.monotonic()
            if self._hang_until:
                if now < self._hang_until:
                    continue    # injected hang: no pings, no reports
                # hang lifted: the map pushes announcing our mark-down
                # were swallowed (the mon thinks it delivered them) —
                # re-request the map so the wrongly-marked-down re-boot
                # path sees the mark-down and recovers. The liveness
                # stamps also froze (ping replies were swallowed): left
                # stale, the very next tick would report EVERY healthy
                # peer failed — re-seed them instead
                self._hang_until = 0.0
                self._hb_last.clear()
                self._hb_reported.clear()
                dout("osd", 1, f"osd.{self.whoami} injected hang "
                               f"lifted; re-requesting osdmap")
                try:
                    await self.monc.request_osdmap(0)
                except Exception as e:
                    dout("osd", 3, f"osd.{self.whoami} post-hang map "
                                   f"request failed: "
                                   f"{type(e).__name__} {e}")
            peers = self._hb_peers()
            # a peer that left every acting set (marked down, its PGs
            # remapped) is pinged no more: forget its liveness stamp and
            # report, as OSD::_remove_heartbeat_peer drops its
            # HeartbeatInfo. Kept, the stamp dates its next incarnation
            # from before it died, and it is reported failed at its
            # first tick back (the mon marks it down again just after
            # its boot; the reference does so)
            for gone in set(self._hb_last) - peers:
                del self._hb_last[gone]
            self._hb_reported &= peers
            for gone in set(incarnation) - peers:
                del incarnation[gone]
            for peer in peers:
                if not self.osdmap.is_up(peer):
                    self._hb_last.pop(peer, None)
                    self._hb_reported.discard(peer)
                    incarnation.pop(peer, None)
                    continue
                # this map may have moved from the peer's old
                # incarnation to a new one between two ticks (its
                # mark-down never seen here): the stamp and the report
                # were about the old one, which the mon drops, and kept
                # they would stop the pings and any report of the new
                # one's death (OSD::_add_heartbeat_peer replaces a peer
                # whose address changed)
                addr = tuple(self.osdmap.osds[peer].addr)
                if incarnation.setdefault(peer, addr) != addr:
                    self._hb_last.pop(peer, None)
                    self._hb_reported.discard(peer)
                    incarnation[peer] = addr
                last = self._hb_last.setdefault(peer, now)
                if now - last > self.config.get("osd_heartbeat_grace"):
                    if peer not in self._hb_reported:
                        self._hb_reported.add(peer)
                        try:
                            # the incarnation this map knows: the mon
                            # drops a report about an older one
                            await self.monc.report_failure(
                                peer, self.whoami, epoch=self.osdmap.epoch,
                                addr=self.osdmap.osds[peer].addr)
                            self.perf.inc("heartbeat_failures")
                            dout("osd", 1, f"osd.{self.whoami} reported "
                                           f"osd.{peer} down")
                            flight.record(
                                "heartbeat_failure", f"osd.{peer}",
                                reporter=self.whoami,
                                silent_s=round(now - last, 2))
                        except Exception:
                            self._hb_reported.discard(peer)
                        else:
                            # best-effort: a failed clog line must not
                            # un-record the (delivered) failure report
                            try:
                                await self.monc.send_log(
                                    "WRN", f"osd.{self.whoami}",
                                    f"no heartbeat reply from osd.{peer} "
                                    f"for {now - last:.1f}s; reported "
                                    f"failed")
                            except Exception:
                                pass
                    continue
                try:
                    await self.send_osd(peer, MPing(
                        {"stamp": now, "from": self.whoami}))
                except Exception:
                    self._drop_conn(peer)

    # -- dispatch ------------------------------------------------------------

    def ms_handle_reset(self, conn: Connection) -> None:
        """A client connection died: its watches die with it (watchers
        linger-re-register over a fresh connection)."""
        for pg in self.pgs.values():
            pg.drop_watchers_for_conn(conn)

    async def ms_dispatch(self, conn: Connection, msg: Message) -> bool:
        if self._hang_until and time.monotonic() < self._hang_until:
            # injected hang: swallow everything (pings AND the map
            # pushes the MonClient would otherwise consume after us in
            # the chain) so peers see heartbeat silence, report us
            # failed, and the mon marks us down
            return True
        if isinstance(msg, MPing):
            # the reply must name the RESPONDER: the pinger keys its
            # liveness table by who answered, not by who asked
            conn.send_message(MPingReply(
                {"stamp": msg.payload.get("stamp"), "from": self.whoami}))
            return True
        if isinstance(msg, MPingReply):
            peer = msg.payload.get("from")
            if peer is not None:
                self._hb_last[peer] = time.monotonic()
                self._hb_reported.discard(peer)
            return True
        if isinstance(msg, MOSDOp):
            self._ingest_op(conn, msg)
            return True
        if isinstance(msg, MOSDRepOp):
            pg = self._pg_of(msg)
            if pg is not None:
                await pg.backend.handle_rep_op(conn, msg)
                self.perf.inc("subop")
            return True
        if isinstance(msg, MOSDRepOpReply):
            pg = self._pg_of(msg)
            if pg is not None:
                pg.backend.sub_op_ack(msg.payload["tid"],
                                      msg.payload["from"])
            return True
        if isinstance(msg, MOSDPGQuery):
            pg = self._pg_of(msg)
            if pg is not None:
                await pg.handle_query(conn, msg)
            return True
        if isinstance(msg, MOSDPGLog):
            pg = self._pg_of(msg)
            if pg is not None:
                pg.handle_log(msg)
            return True
        if isinstance(msg, MOSDPGPush):
            pg = self._pg_of(msg, create=True)
            if pg is not None:
                await pg.handle_push(conn, msg)
            return True
        if isinstance(msg, MOSDPGPushReply):
            return True
        if isinstance(msg, MOSDPGInfo):
            pg = self._pg_of(msg, create=True)
            if pg is not None:
                if msg.payload.get("op") == "activate":
                    pg.handle_activate(msg)
                elif msg.payload.get("op") == "recovering":
                    pg.handle_recovering(msg)
            return True
        if isinstance(msg, MOSDRepScrub):
            pg = self._pg_of(msg)
            if pg is not None:
                await pg.handle_scrub_request(conn, msg)
            return True
        if isinstance(msg, MOSDRepScrubMap):
            pg = self._pg_of(msg)
            if pg is not None:
                pg.handle_scrub_map(msg)
            return True
        if isinstance(msg, MOSDScrubReserve):
            pg = self._pg_of(msg, create=True)
            if pg is not None:
                if msg.payload.get("op") == "reserve":
                    # a reserve can park on the slot pool for seconds:
                    # never on the dispatch loop, or every other
                    # message from this peer (replication sub-ops,
                    # heartbeats on shared conns) stalls behind it
                    t = asyncio.get_running_loop().create_task(
                        scrub_mod.handle_scrub_reserve(self, pg, msg))
                    self._notify_tasks.add(t)
                    t.add_done_callback(self._notify_tasks.discard)
                else:
                    await scrub_mod.handle_scrub_reserve(self, pg, msg)
            return True
        from ceph_tpu_torch.msg.messages import MWatchNotifyAck
        if isinstance(msg, MWatchNotifyAck):
            pg = self._pg_of(msg)
            if pg is not None:
                pg.handle_notify_ack(msg)
            return True
        return await self._dispatch_backend(conn, msg)

    async def _dispatch_backend(self, conn: Connection,
                                msg: Message) -> bool:
        """EC sub-op messages are routed to the PG's ECBackend."""
        from ceph_tpu_torch.msg.messages import (MOSDECSubOpRead,
                                                 MOSDECSubOpReadReply,
                                                 MOSDECSubOpWrite,
                                                 MOSDECSubOpWriteReply)
        if isinstance(msg, (MOSDECSubOpWrite, MOSDECSubOpRead)):
            pg = self._pg_of(msg, create=True)
            if pg is not None:
                await pg.backend.handle_sub_op(conn, msg)
                if isinstance(msg, MOSDECSubOpWrite):
                    self.perf.inc("subop")
            return True
        if isinstance(msg, (MOSDECSubOpWriteReply, MOSDECSubOpReadReply)):
            pg = self._pg_of(msg)
            if pg is not None:
                pg.backend.handle_sub_op_reply(msg)
            return True
        return False

    def _pg_of(self, msg: Message, create: bool = False) -> PGInstance | None:
        pool_id, ps = msg.payload["pgid"]
        pgid = PG(pool_id, ps)
        inst = self.pgs.get(pgid)
        if inst is None and create:
            pool = self.osdmap.pools.get(pool_id)
            if pool is None:
                return None
            inst = PGInstance(self, pgid, pool)
            up, acting = self.osdmap.pg_to_up_acting_osds(pgid)
            self.pgs[pgid] = inst
            inst.advance_map(up, acting)
        return inst

    # -- op ingest: enqueue_op -> sharded queue -> dequeue_op ---------------
    # (src/osd/OSD.cc:9683 enqueue_op, :9742 dequeue_op; per-PG hashing
    # keeps same-PG ops FIFO while shards run concurrently)

    @staticmethod
    def _op_identity(conn: Connection,
                     p: dict) -> tuple[str | None, str | None]:
        """Client identity of an op: the session's handshake entity is
        authoritative (it was negotiated before any op flowed); the
        MOSDOp stamp is the fallback for paths where the originating
        session is gone (requeues after a reset). Non-client peers
        (OSD-to-OSD MOSDOp never happens, but belt-and-braces) are not
        accounted."""
        name = conn.peer_name if conn.peer_name.startswith("client") \
            else p.get("client")
        if not name or not str(name).startswith("client"):
            return None, None
        tenant = getattr(conn, "peer_tenant", None) or p.get("tenant")
        return str(name), (str(tenant) if tenant else None)

    def _ingest_op(self, conn: Connection, msg: MOSDOp) -> None:
        p = msg.payload
        pool_id, ps = p["pgid"]
        pgid = PG(pool_id, ps)
        pg = self.pgs.get(pgid)
        if pg is None or not pg.is_primary():
            conn.send_message(MOSDOpReply(
                {"tid": p.get("tid", 0), "rc": -11,
                 "epoch": self.osdmap.epoch, "error": "not primary"}))
            return
        ops = p.get("ops", [])
        client, tenant = self._op_identity(conn, p)
        desc = (f"osd_op({'+'.join(o.get('op', '?') for o in ops)} "
                f"{ops[0].get('oid', '') if ops else ''} "
                f"pg={pgid.pool}.{pgid.ps} tid={p.get('tid', 0)})")
        if any(o.get("op") == "notify" for o in ops):
            # notify gathers watcher acks for seconds: it must NOT hold
            # an op-queue shard, or a watcher callback touching the same
            # PG (the RBD header-watch pattern) deadlocks behind it —
            # the reference routes notifies outside the write pipeline.
            # Still tracked + counted like any other op.
            trk = self.optracker.create(desc, client=client,
                                        tenant=tenant)
            trk.trace = tracer.current_context()
            trk.mark_event("detached_notify")
            t = asyncio.get_running_loop().create_task(
                self._execute_op(conn, msg, trk))
            self._notify_tasks.add(t)
            t.add_done_callback(self._notify_tasks.discard)
            return
        trk = self.optracker.create(desc, client=client, tenant=tenant)
        # the trace context (the connection's ms_dispatch span) rides the
        # TrackedOp: the queued closure runs in a shard worker task where
        # the dispatch context is gone
        trk.trace = tracer.current_context()
        trk.mark_event("queued")
        self._op_seq += 1
        seq = self._op_seq
        if pg.state != "active" or self._waiting_for_active.get(pgid):
            self._park_op(pgid, seq, conn, msg, trk)
            return
        self._enqueue_op(pgid, seq, conn, msg, trk)

    def _park_op(self, pgid: PG, seq: int, conn, msg, trk) -> None:
        import bisect
        trk.mark_event("waiting_for_active")
        waiting = self._waiting_for_active.setdefault(pgid, [])
        bisect.insort(waiting, (seq, conn, msg, trk), key=lambda e: e[0])

    async def _execute_op(self, conn: Connection, msg: MOSDOp, trk,
                          queue_wait_us: float | None = None) -> None:
        """Run one tracked client op with its span + perf accounting —
        the single site for op latency bookkeeping (detached notifies
        and queued ops both land here)."""
        token = set_current_op(trk)
        t0 = time.monotonic()
        try:
            with tracer.span("osd_op", f"osd.{self.whoami}",
                             parent=trk.trace) as sp:
                if sp is not None:
                    sp.set_tag("desc", trk.description)
                    if queue_wait_us is not None:
                        sp.set_tag("queue_wait_us", queue_wait_us)
                await self._handle_op(conn, msg)
        finally:
            reset_current_op(token)
            trk.finish()
            self.perf.inc("op")
            lat = time.monotonic() - t0
            self.perf.avg_add("op_latency", lat)
            self.perf.hist_add("op_total_us", lat * 1e6)

    @staticmethod
    def _op_object(msg: MOSDOp) -> str | None:
        """The object stream a client op belongs to, for the pipelined
        window's per-object FIFO. None (an exclusive whole-PG barrier)
        when the op vector names no single object — multi-object
        messages and listings keep the legacy serial semantics."""
        oids = {o.get("oid") for o in msg.payload.get("ops", [])}
        if len(oids) == 1:
            oid = oids.pop()
            if oid is not None:
                return oid
        return None

    def _enqueue_op(self, pgid: PG, seq: int, conn: Connection,
                    msg: MOSDOp, trk) -> None:
        t_enq = time.monotonic()

        async def work():
            # the PG may have left 'active' while this op sat in the
            # queue: re-park instead of wedging the shard worker on a
            # peering PG (the reference requeues into waiting_for_active)
            pg = self.pgs.get(pgid)
            if pg is not None and pg.is_primary() and pg.state != "active":
                self._park_op(pgid, seq, conn, msg, trk)
                return
            trk.mark_event("dequeued")
            wait_us = (time.monotonic() - t_enq) * 1e6
            self.perf.hist_add("op_queue_wait_us", wait_us)
            await self._execute_op(conn, msg, trk,
                                   queue_wait_us=round(wait_us, 1))
        p = msg.payload
        nbytes = len(msg.data) or sum(int(o.get("len") or 0)
                                      for o in p.get("ops", []))
        admitted = self.op_queue.enqueue(
            (pgid.pool, pgid.ps), work, obj=self._op_object(msg),
            entity=trk.tenant or trk.client, nbytes=nbytes)
        if not admitted:
            # shed admission control: the tenant's backlog is past the
            # depth cap — refuse with a pacing hint instead of letting
            # queue depth and p99 run away. The client resends the
            # same tid after the backoff; no map refresh (the map is
            # fine, the tenant is over its share).
            trk.mark_event("qos_shed")
            trk.finish()
            try:
                conn.send_message(MOSDOpThrottle(
                    {"tid": p.get("tid", 0), "rc": -11,
                     "retry_after_ms": 50,
                     "epoch": self.osdmap.epoch}))
            except Exception:
                pass

    def requeue_waiting(self, pg: PGInstance) -> None:
        """PG activation (or loss of primacy) drains its parked ops in
        ingest order (the reference requeues waiting_for_active)."""
        waiting = self._waiting_for_active.pop(pg.pgid, None)
        if not waiting:
            return
        for seq, conn, msg, trk in waiting:
            if pg.is_primary() and pg.state == "active":
                trk.mark_event("requeued_after_activation")
                self._enqueue_op(pg.pgid, seq, conn, msg, trk)
            else:
                trk.mark_event("dropped_not_primary")
                trk.finish()
                try:
                    conn.send_message(MOSDOpReply(
                        {"tid": msg.payload.get("tid", 0), "rc": -11,
                         "epoch": self.osdmap.epoch,
                         "error": "not primary"}))
                except Exception:
                    pass

    async def _handle_op(self, conn: Connection, msg: MOSDOp) -> None:
        p = msg.payload
        tid = p.get("tid", 0)
        pool_id, ps = p["pgid"]
        pgid = PG(pool_id, ps)
        pg = self.pgs.get(pgid)
        if pg is None or not pg.is_primary():
            # wrong (or stale) target: tell the client to refresh its map
            conn.send_message(MOSDOpReply(
                {"tid": tid, "rc": -11, "epoch": self.osdmap.epoch,
                 "error": "not primary"}))
            return
        trk = current_op()
        if trk is not None and trk.client:
            # kind is known before execution so even an errored op's
            # latency lands in the right per-client histogram
            trk.kind = classify_ops(p.get("ops", []))
        try:
            results = []
            outdata = b""
            for i, op in enumerate(p.get("ops", [])):
                if p.get("reqid"):
                    # one dedup key per op within the message: multi-op
                    # messages must not collide in the dup index
                    op = dict(op, reqid=[*p["reqid"], i])
                rc, out, opdata = await pg.do_op(op, msg.data, conn=conn)
                results.append({"rc": rc, "out": out})
                outdata += opdata
                if rc < 0:
                    break
            final_rc = results[-1]["rc"] if results else 0
            if trk is not None and trk.client:
                # byte attribution: reads are charged what they
                # returned; writes what they shipped — but a dup-op
                # replay (answered from the pg log, never re-executed)
                # charges NOTHING, so a client's resends can't inflate
                # its written-bytes ledger
                if trk.kind == "read":
                    trk.rd_bytes = len(outdata)
                elif trk.kind == "write" and any(
                        o.get("op") in WRITE_OP_KINDS
                        and r["rc"] == 0
                        and not (r.get("out") or {}).get("dup")
                        for o, r in zip(p.get("ops", []), results)):
                    trk.wr_bytes = len(msg.data)
            conn.send_message(MOSDOpReply(
                {"tid": tid, "rc": final_rc, "results": results,
                 "epoch": self.osdmap.epoch}, outdata))
        except asyncio.TimeoutError:
            conn.send_message(MOSDOpReply(
                {"tid": tid, "rc": -110, "epoch": self.osdmap.epoch,
                 "error": "sub-op timeout"}))
        except IntervalChange as e:
            # don't fail the client: it refreshes the map and resends,
            # landing on whoever is primary in the new interval
            conn.send_message(MOSDOpReply(
                {"tid": tid, "rc": -11, "epoch": self.osdmap.epoch,
                 "error": f"interval change: {e}"}))
        except Exception as e:
            conn.send_message(MOSDOpReply(
                {"tid": tid, "rc": -5, "epoch": self.osdmap.epoch,
                 "error": f"{type(e).__name__}: {e}"}))
