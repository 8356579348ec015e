"""Monitor daemon: quorum member + OSDMonitor service + client plane.

Reference shape (src/mon/Monitor.cc, OSDMonitor.cc, PaxosService.cc):
the monitor owns a Paxos instance; services express state changes as
pending transactions proposed through it; every quorum member applies
committed transactions in order, so service state is identical across
monitors. The OSDMonitor's state is the OSDMap:

  * EC profiles and pools are validated in-monitor by instantiating the
    erasure-code plugin from the profile (OSDMonitor.cc:7506
    get_erasure_code; :11260 profile set) — a bad profile never reaches
    the map;
  * pool create derives size=k+m / min_size=k+1 from the plugin and
    builds the CRUSH rule via the EC default (indep, ErasureCode.cc:70);
  * osd boots (MOSDBoot) add the osd under its crush_location and mark
    it up; failure reports (MOSDFailure) mark it down once enough
    distinct reporters agree (OSDMonitor.cc:2868 reporter quorum); a
    leader tick marks long-down osds out (down_out_interval);
  * committed epochs are pushed to osdmap subscribers as incrementals.

Peons forward osd-plane messages to the leader and bounce commands with
a leader hint (the reference forwards those too; the client retry keeps
this simpler without changing observable behavior).

The port's copy of ceph_tpu/mon/monitor.py (jax-free; the port imports
nothing of the JAX package). Profiles are checked through the port's
plugin registry, on the device that the profile's `device` key names
(default cuda): a `cuda` profile instantiates the plugin on the card
while the leader validates it, inside a Paxos proposal, and again at
pool create. Build the kernels before a monitor sees such a profile
(`ops._build.build()`): a first-use `nvcc` build there would stall the
leader past the Paxos timeouts.
"""
from __future__ import annotations

import asyncio
import collections
import json
import time

from ceph_tpu_torch.crush import CrushMap, Incremental, OSDMap, Pool, Rule, Step
from ceph_tpu_torch.mon.paxos import NotLeader, Paxos
from ceph_tpu_torch.mon.store import MonStore, MonStoreTxn
from ceph_tpu_torch.msg.messages import (MLog, Message, MMgrMap, MMonCommand,
                                         MMonCommandAck, MMonElection,
                                         MMonGetMap, MMonMap, MMonMgrReport,
                                         MMonPaxos, MMonSubscribe, MOSDBoot,
                                         MOSDFailure, MOSDMapMsg, MPing,
                                         MPingReply)
from ceph_tpu_torch.msg.messenger import Connection, Dispatcher, Messenger
from ceph_tpu_torch.utils import flight
from ceph_tpu_torch.utils.async_util import reap, reap_all
from ceph_tpu_torch.utils.dout import dout
from ceph_tpu_torch.utils.perf_counters import PerfCountersCollection


class MonMap:
    """Names -> addrs; rank = index in sorted names (src/mon/MonMap.h)."""

    def __init__(self, mons: dict[str, tuple[str, int]], epoch: int = 1):
        self.epoch = epoch
        self.mons = {name: tuple(addr) for name, addr in mons.items()}

    @property
    def ranks(self) -> list[str]:
        return sorted(self.mons)

    def rank_of(self, name: str) -> int:
        return self.ranks.index(name)

    def addr_of_rank(self, rank: int) -> tuple[str, int]:
        return self.mons[self.ranks[rank]]

    def to_dict(self) -> dict:
        return {"epoch": self.epoch,
                "mons": {n: list(a) for n, a in self.mons.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "MonMap":
        return cls({n: tuple(a) for n, a in d["mons"].items()}, d["epoch"])


class OSDMonitor:
    """The OSDMap service (src/mon/OSDMonitor.cc essentials)."""

    MIN_DOWN_REPORTERS = 2      # mon_osd_min_down_reporters (OSDMonitor.cc:2868)
    DOWN_OUT_INTERVAL = 30.0
    KEEP_EPOCHS = 64            # bounded full-map/inc history window

    def __init__(self, mon: "Monitor"):
        self.mon = mon
        self.osdmap = OSDMap(CrushMap())
        self.pending: Incremental | None = None
        self.down_at: dict[int, float] = {}
        # failed osd -> set of reporter osds (reporter quorum)
        self.failure_reports: dict[int, set[int]] = {}
        # osd -> the epoch that last marked it up (OSDMap's up_from),
        # kept here and out of the map's bytes: a failure report from
        # a map before that epoch is about an older incarnation
        self.up_from: dict[int, int] = {}
        # one proposal in flight at a time (PaxosService serializes);
        # the pending epoch is assigned at encode time under this lock,
        # after the previous commit has applied — two racing callers can
        # never build two incrementals with the same epoch
        self._propose_lock = asyncio.Lock()

    # -- state recovery ------------------------------------------------------

    def load(self) -> None:
        store = self.mon.store
        epochs = [int(e) for e in store.keys("osdmap_full")]
        if epochs:
            latest = max(epochs)
            self.osdmap.load_dict(store.get("osdmap_full", str(latest)))
        # seed the down->out clock for osds already down in the loaded map
        # so a later leadership here still marks them out eventually
        now = time.monotonic()
        for osd, state in self.osdmap.osds.items():
            if not state.up and state.in_cluster:
                self.down_at.setdefault(osd, now)

    # -- pending / propose ---------------------------------------------------

    def get_pending(self) -> Incremental:
        if self.pending is None:
            # epoch 0 is a placeholder: the real epoch is stamped in
            # encode_pending, under the propose lock
            self.pending = Incremental(epoch=0)
        return self.pending

    def encode_pending(self) -> bytes:
        inc = self.pending
        self.pending = None
        inc.epoch = self.osdmap.epoch + 1
        return json.dumps({"service": "osdmap",
                           "inc": inc.to_dict()}).encode()

    async def propose_pending(self) -> int | None:
        """Propose the pending incremental; resolves at commit. Proposals
        are serialized: while one is in flight, later mutations pile into
        a fresh pending that is proposed (with a rebased epoch) after the
        first commit applies."""
        async with self._propose_lock:
            if self.pending is None or self.pending.empty():
                self.pending = None
                return None
            value = self.encode_pending()
            fut = self.mon.paxos.propose(value)
            return await asyncio.wait_for(fut, 30)

    def apply_commit(self, inc_dict: dict, txn: MonStoreTxn) -> None:
        inc = Incremental.from_dict(inc_dict)
        if inc.epoch != self.osdmap.epoch + 1:
            dout("mon", 10, f"{self.mon.name}: skip stale inc "
                            f"{inc.epoch} at {self.osdmap.epoch}")
            return
        self.osdmap.apply_incremental(inc)
        for osd in inc.new_down:
            self.down_at[osd] = time.monotonic()
            self.failure_reports.pop(osd, None)
        for osd in inc.new_up:
            self.down_at.pop(osd, None)
            self.failure_reports.pop(osd, None)
            self.up_from[osd] = inc.epoch
        txn.put("osdmap_full", str(self.osdmap.epoch), self.osdmap.to_dict())
        txn.put("osdmap_inc", str(inc.epoch), inc_dict)
        # bounded map history (the reference trims to
        # [first_committed, last]): old epochs can never be needed again —
        # subscribers older than the window get the full map
        floor = self.osdmap.epoch - self.KEEP_EPOCHS
        for prefix in ("osdmap_full", "osdmap_inc"):
            for e in self.mon.store.keys(prefix):
                if int(e) <= floor:
                    txn.erase(prefix, e)
        self.mon.kick_subscribers()

    # -- control-plane verbs -------------------------------------------------

    def _get_erasure_code(self, profile_name: str):
        """Instantiate the plugin from a stored profile — in-monitor
        validation (OSDMonitor.cc:7506)."""
        from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
        profile = self.osdmap.ec_profiles.get(profile_name)
        if profile is None:
            raise ValueError(f"erasure-code profile {profile_name!r} "
                             "does not exist")
        plugin = profile.get("plugin", "jerasure")
        return ErasureCodePluginRegistry.instance().factory(
            plugin, dict(profile))

    def cmd_profile_set(self, name: str, profile: dict) -> dict:
        from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
        plugin = profile.get("plugin", "jerasure")
        # validate by instantiation before it can enter the map
        ErasureCodePluginRegistry.instance().factory(plugin, dict(profile))
        self.get_pending().new_ec_profiles[name] = dict(profile)
        return {"profile": name}

    def _ensure_root(self, crush: CrushMap) -> None:
        if "default" not in crush._names:
            crush.add_bucket(10, "default")

    def _next_rule_id(self, crush: CrushMap) -> int:
        return max(crush._rules, default=-1) + 1

    def cmd_pool_create(self, name: str, pg_num: int = 32,
                        pool_type: str = "replicated", size: int = 3,
                        erasure_code_profile: str = "",
                        crush_failure_domain: int = 1) -> dict:
        if name in self.osdmap.pool_names:
            # idempotent: commands are at-least-once (client retries after
            # ack timeouts may follow a commit that actually landed), so a
            # re-create of an existing pool reports the existing pool
            # (divergence from the reference's EEXIST, which relies on the
            # CLI user to interpret it)
            pool = self.osdmap.get_pool(name)
            return {"pool": name, "pool_id": pool.id, "size": pool.size,
                    "min_size": pool.min_size, "crush_rule": pool.crush_rule,
                    "existed": True}
        crush = CrushMap.from_dict(self.osdmap.crush.to_dict())
        self._ensure_root(crush)
        rule_id = self._next_rule_id(crush)
        if pool_type == "erasure":
            ec = self._get_erasure_code(erasure_code_profile)
            k = ec.get_data_chunk_count()
            m = ec.get_chunk_count() - k
            size = k + m
            min_size = k + 1
            # EC rule: indep with holes (ErasureCode::create_rule, mode
            # "indep"; OSDMonitor crush_rule_create_erasure :7470)
            crush.make_simple_rule(rule_id, f"{name}_rule", "default",
                                   crush_failure_domain, mode="indep")
            # chunk size through the plugin's own get_chunk_size (the
            # reference derives stripe_width the same way, OSDMonitor
            # prepare_new_pool): bitmatrix techniques need chunks
            # divisible by w, and sub-chunk codes (clay) need chunks
            # divisible by sub_chunk_no — alignment-only math broke
            # clay at k=8,m=3,d=10 (sub_chunk_no=81 does not divide a
            # 128-aligned 4096 chunk)
            chunk = ec.get_chunk_size(k * 4096)
            stripe_width = k * chunk
        else:
            min_size = max(1, size - 1)
            crush.make_simple_rule(rule_id, f"{name}_rule", "default",
                                   crush_failure_domain, mode="firstn")
            stripe_width = 0
        pid = max(self.osdmap.pools, default=0) + 1
        pending = self.get_pending()
        for other in pending.new_pools.values():
            if other.name == name:
                raise ValueError(f"pool {name!r} pending")
            pid = max(pid, other.id + 1)
        pending.new_pools[pid] = Pool(
            id=pid, name=name, type=pool_type, size=size, min_size=min_size,
            pg_num=pg_num, crush_rule=rule_id,
            ec_profile=erasure_code_profile, stripe_width=stripe_width)
        pending.new_crush = crush.to_dict()
        return {"pool": name, "pool_id": pid, "size": size,
                "min_size": min_size, "crush_rule": rule_id}

    def cmd_pool_snap(self, pool_name: str, action: str,
                      snap_name: str | None = None,
                      snapid: int | None = None) -> dict:
        """Pool + self-managed snapshot id allocation/removal
        (OSDMonitor prepare_pool_op SNAP_CREATE/SNAP_DELETE and
        IoCtxImpl::selfmanaged_snap_create's mon round-trip): snap ids
        are monotonically allocated from the pool's snap_seq; removals
        land in removed_snaps for the OSDs' snaptrim to consume."""
        import dataclasses as _dc
        pid = self.osdmap.pool_names.get(pool_name)
        if pid is None:
            raise ValueError(f"pool {pool_name!r} does not exist")
        # snapshots work on both pool types: EC pools clone per-shard
        # chunk blobs via clone sub-ops (see osd/ec_backend.py)
        pending = self.get_pending()
        base = pending.new_pools.get(pid, self.osdmap.pools[pid])
        p = _dc.replace(base, pool_snaps=dict(base.pool_snaps),
                        removed_snaps=list(base.removed_snaps))
        if action == "mksnap":
            if snap_name in p.pool_snaps.values():
                raise ValueError(f"snap {snap_name!r} exists")
            sid = p.snap_seq + 1
            p.snap_seq = sid
            p.pool_snaps[str(sid)] = snap_name
        elif action == "rmsnap":
            sid = next((int(k) for k, v in p.pool_snaps.items()
                        if v == snap_name), None)
            if sid is None:
                raise ValueError(f"snap {snap_name!r} does not exist")
            del p.pool_snaps[str(sid)]
            p.removed_snaps.append(sid)
        elif action == "selfmanaged_create":
            sid = p.snap_seq + 1
            p.snap_seq = sid
        elif action == "selfmanaged_rm":
            sid = int(snapid)
            if sid not in p.removed_snaps:
                p.removed_snaps.append(sid)
            p.snap_seq = max(p.snap_seq, sid)
        else:
            raise ValueError(f"unknown snap action {action!r}")
        pending.new_pools[pid] = p
        return {"snapid": sid, "pool": pool_name}

    def handle_boot(self, payload: dict) -> bool:
        """MOSDBoot: add under crush_location, mark up. True if changed."""
        osd = payload["osd"]
        addr = payload["addr"]
        loc = payload.get("crush_location", {})
        weight = payload.get("weight", 1.0)
        state = self.osdmap.osds.get(osd)
        pending = self.get_pending()
        in_crush = any(osd in b.items
                       for b in self.osdmap.crush._buckets.values())
        if state is None or not in_crush or state.addr != addr:
            crush = CrushMap.from_dict(self.osdmap.crush.to_dict())
            self._ensure_root(crush)
            host = loc.get("host", f"host{osd}")
            if host not in crush._names:
                crush.add_bucket(1, host)
                crush.add_item("default", crush._names[host], 0.0)
            bid = crush._names[host]
            bucket = crush._buckets[bid]
            if osd not in bucket.items:
                crush.add_item(bid, osd, weight, name=f"osd.{osd}")
            else:
                crush.reweight_item(bid, osd, weight)
            # recompute (never increment) the host's weight in the root so
            # a re-boot can't inflate it
            root = crush._buckets[crush._names["default"]]
            root.weights[root.items.index(bid)] = bucket.weight()
            pending.new_crush = crush.to_dict()
        if state is None:
            pending.new_osds[osd] = addr
        if state is None or not state.up or state.addr != addr:
            pending.new_up[osd] = addr
            if state is not None and not state.in_cluster:
                pending.new_in.append(osd)
            return True
        return not pending.empty()

    def handle_failure(self, payload: dict) -> bool:
        failed = payload["failed"]
        reporter = payload.get("from", -1)
        state = self.osdmap.osds.get(failed)
        # every report and what became of it is logged, as upstream's
        # preprocess_failure logs "dne/dup/old": a mark-down that never
        # came tells whether its reports arrived
        what = (f"failure report of osd.{failed} from osd.{reporter} "
                f"(epoch {payload.get('epoch')}, addr {payload.get('addr')})")
        if state is None or not state.up:
            dout("mon", 1, f"{what} dropped: not up")
            return False
        # a report about an older incarnation of the OSD, sent from a
        # map before its last boot or naming the address it had then, is
        # stale (OSDMonitor::preprocess_failure): landing after a quick
        # re-boot it would mark the revived OSD down again. A report
        # without them (the JAX package's daemons send none) is counted
        epoch = payload.get("epoch")
        addr = payload.get("addr")
        if (epoch is not None and epoch < self.up_from.get(failed, 0)) \
                or (addr is not None and list(addr) != list(state.addr)):
            dout("mon", 1, f"{what} dropped: about an older incarnation "
                           f"(up from epoch {self.up_from.get(failed)} at "
                           f"{state.addr})")
            return False
        reporters = self.failure_reports.setdefault(failed, set())
        reporters.add(reporter)
        dout("mon", 1, f"{what} counted: reporters {sorted(reporters)} of "
                       f"{self.MIN_DOWN_REPORTERS}")
        if len(reporters) >= self.MIN_DOWN_REPORTERS:
            pending = self.get_pending()
            if failed not in pending.new_down:
                pending.new_down.append(failed)
                self.mon.clog(
                    "WRN", f"mon.{self.mon.name}",
                    f"osd.{failed} marked down "
                    f"({len(reporters)} reporters: {sorted(reporters)})")
                flight.record("osd_markdown", f"osd.{failed}",
                              reporters=sorted(reporters),
                              mon=self.mon.name)
            return True
        return False

    def tick(self) -> bool:
        """Leader periodic work: down -> out after the interval."""
        changed = False
        now = time.monotonic()
        for osd, when in list(self.down_at.items()):
            state = self.osdmap.osds.get(osd)
            if state is None or state.up:
                continue
            if state.in_cluster and now - when > self.DOWN_OUT_INTERVAL:
                pending = self.get_pending()
                if osd not in pending.new_out:
                    pending.new_out.append(osd)
                    changed = True
        return changed


class MgrMonitor:
    """MgrMap service (src/mon/MgrMonitor.cc essentials): the active
    mgr's identity + report address, replicated through paxos so every
    quorum member — and any daemon asking `mgr dump` — agrees on where
    reports go. Beacons keep it fresh; the leader drops an active mgr
    whose beacons stop, which raises MGR_DOWN cluster-wide."""

    BEACON_GRACE = 8.0          # mon_mgr_beacon_grace analog

    def __init__(self, mon: "Monitor"):
        self.mon = mon
        self.map: dict = {"epoch": 0, "active_name": None,
                          "active_addr": None}
        self.last_beacon = 0.0      # monotonic; leader-local liveness

    def load(self) -> None:
        m = self.mon.store.get("mgrmap", "latest")
        if m:
            self.map = m

    def beacon(self, name: str, addr) -> dict | None:
        """Record a beacon; returns a new map to propose when the
        active identity changed (first mgr, restart on a new port).
        While an active mgr holds the slot, other mgrs' beacons are
        STANDBY (ignored) — they take over only after the active is
        dropped for beacon loss, like the reference's standby pool."""
        addr = list(addr) if addr else None
        active = self.map.get("active_name")
        if active is not None and active != name:
            return None
        self.last_beacon = time.monotonic()
        if active == name and self.map.get("active_addr") == addr:
            return None
        return {"epoch": self.map.get("epoch", 0) + 1,
                "active_name": name, "active_addr": addr}

    def tick(self) -> dict | None:
        """Leader periodic work: drop an active mgr whose beacons
        stopped (returns the map to propose)."""
        if not self.map.get("active_name"):
            return None
        if not self.last_beacon:
            # fresh leadership: grant a full grace window before
            # declaring the recorded active mgr dead
            self.last_beacon = time.monotonic()
            return None
        if time.monotonic() - self.last_beacon > self.BEACON_GRACE:
            return {"epoch": self.map.get("epoch", 0) + 1,
                    "active_name": None, "active_addr": None}
        return None

    def apply_commit(self, m: dict, txn: MonStoreTxn) -> None:
        if m.get("epoch", 0) <= self.map.get("epoch", 0):
            return
        self.map = m
        txn.put("mgrmap", "latest", m)
        self.mon.push_mgrmap()


class Monitor(Dispatcher):
    """One monitor daemon: messenger + paxos + services + client plane."""

    def __init__(self, name: str, monmap: MonMap,
                 store_path: str | None = None,
                 auth_key: bytes | None = None):
        self.name = name
        self.monmap = monmap
        self.rank = monmap.rank_of(name)
        self.store = MonStore(store_path)
        self.messenger = Messenger(f"mon.{name}", auth_key=auth_key)
        self.messenger.add_dispatcher(self)
        peers = {monmap.rank_of(n): addr for n, addr in monmap.mons.items()
                 if n != name}
        self.paxos = Paxos(self.messenger, self.rank, peers, self.store,
                           on_commit=self._on_paxos_commit,
                           on_role_change=self._on_role_change)
        self.paxos.on_sync = self._on_store_sync
        self.osdmon = OSDMonitor(self)
        self.mgrmon = MgrMonitor(self)
        # mgr-fed health digest (MMonMgrReport): checks + progress +
        # per-daemon report ages, merged into the health engine while
        # fresh
        self.mgr_digest: dict | None = None
        self._mgr_digest_mono = 0.0
        # health mutes: code -> {"expires": wall|None, "stamp": wall};
        # persisted through the mon store so a restart keeps them
        self.health_mutes: dict[str, dict] = {}
        self._prev_checks: dict[str, str] = {}   # code -> severity
        # osdmap subscribers: conn -> next epoch wanted
        self.subs: dict[Connection, int] = {}
        # mgrmap subscribers: conn -> next epoch wanted (daemons learn
        # the active mgr by push, never by polling commands)
        self.mgr_subs: dict[Connection, int] = {}
        self._tick_task: asyncio.Task | None = None
        # in-flight background proposals (_spawn_proposal): tracked so
        # stop() can reap them — a detached proposal task left pending
        # at loop close is the monitor's own _dispatch_loop leak
        self._proposal_tasks: set[asyncio.Task] = set()
        self._applied = 0      # last paxos version applied to services
        # cluster log (LogMonitor-lite, src/mon/LogMonitor.cc): WARN+
        # events from daemons (MLog) and this mon's own map-change
        # events, in a bounded ring queryable via `log last`
        self.cluster_log: collections.deque[dict] = \
            collections.deque(maxlen=1000)
        # per-daemon perf counters: quorum/paxos activity, shipped to
        # the mgr like every other daemon's
        coll = PerfCountersCollection.instance()
        coll.remove(f"mon.{name}")      # a restarted mon re-registers
        self.perf = coll.create(f"mon.{name}")
        self.perf.add("paxos_commit", description="paxos values committed")
        self.perf.add("election", description="elections called")
        self.perf.add("command", description="mon commands served")
        self.perf.add("cluster_log_lines",
                      description="cluster-log lines recorded")
        self.paxos.perf = self.perf
        # report session to the active mgr (resolved from the replicated
        # mgrmap — every mon, leader or peon, knows it). Lazy import:
        # ceph_tpu_torch.mgr pulls in mon_client, which would cycle here.
        from ceph_tpu_torch.mgr.mgr_client import MgrClient
        self.mgr_client = MgrClient(
            self.messenger, f"mon.{name}", "mon",
            resolve=lambda: self.mgrmon.map.get("active_addr"),
            status_cb=lambda: {
                "rank": self.rank, "leader": self.paxos.is_leader(),
                "quorum": sorted(self.paxos.quorum),
                "osdmap_epoch": self.osdmon.osdmap.epoch,
                "applied_version": self._applied},
            perf_name=f"mon.{name}",
            extra_loggers=("sanitizer",))

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> tuple[str, int]:
        addr = await self.messenger.bind(*self.monmap.mons[self.name])
        self.osdmon.load()
        self.mgrmon.load()
        self.health_mutes = self.store.get("health", "mutes", {}) or {}
        self._applied = self.store.get("mon", "applied_version", 0)
        self.paxos.recover_from_store()
        self._replay_missing()
        await self.paxos.start()
        self.mgr_client.start()
        self._tick_task = asyncio.get_running_loop().create_task(self._tick())
        dout("mon", 1, f"mon.{self.name} up at {addr} rank {self.rank}")
        return addr

    async def stop(self) -> None:
        await reap(self._tick_task)
        await reap_all(list(self._proposal_tasks))
        self._proposal_tasks.clear()
        await self.mgr_client.stop()
        await self.paxos.stop()
        await self.messenger.shutdown()

    def _replay_missing(self) -> None:
        """Apply any paxos values committed but not yet service-applied
        (crash between paxos txn and service txn)."""
        for v in range(self._applied + 1, self.paxos.last_committed + 1):
            raw = self.store.get("paxos_values", str(v))
            if raw is not None:
                self._apply_value(v, raw.encode("latin1"))

    async def _tick(self) -> None:
        while True:
            await asyncio.sleep(1.0)
            try:
                if self.paxos.is_leader() and self.paxos.is_active():
                    if self.osdmon.tick():
                        await self.osdmon.propose_pending()
                    m = self.mgrmon.tick()
                    if m is not None:
                        await self._propose_mgrmap(m)
                    self._log_health_transitions()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # a proposal timeout/leadership loss must not kill the
                # periodic task — the work retries
                # on the next tick
                dout("mon", 5, f"mon.{self.name}: tick proposal failed: "
                               f"{type(e).__name__} {e}")

    async def _propose_mgrmap(self, m: dict) -> None:
        value = json.dumps({"service": "mgrmap", "map": m}).encode()
        await asyncio.wait_for(self.paxos.propose(value), 30)

    async def _propose_health_mutes(self, mutes: dict) -> None:
        """Mute set/clear rides paxos so every quorum member answers
        `health` identically and mutes survive leadership changes."""
        value = json.dumps({"service": "health",
                            "mutes": mutes}).encode()
        await asyncio.wait_for(self.paxos.propose(value), 30)

    # -- paxos plumbing ------------------------------------------------------

    def _on_paxos_commit(self, version: int, value: bytes) -> None:
        self._apply_value(version, value)

    def _apply_value(self, version: int, value: bytes) -> None:
        txn = MonStoreTxn()
        try:
            decoded = json.loads(value)
            if decoded.get("service") == "osdmap":
                self.osdmon.apply_commit(decoded["inc"], txn)
            elif decoded.get("service") == "mgrmap":
                self.mgrmon.apply_commit(decoded["map"], txn)
            elif decoded.get("service") == "health":
                self.health_mutes = decoded.get("mutes", {}) or {}
                txn.put("health", "mutes", self.health_mutes)
        except Exception as e:
            dout("mon", 0, f"mon.{self.name}: apply v{version} failed: "
                           f"{type(e).__name__} {e}")
        self._applied = version
        txn.put("mon", "applied_version", version)
        self.store.apply_transaction(txn)

    def _on_store_sync(self) -> None:
        """Paxos replaced our whole store (we were behind the leader's
        trim horizon): reload service state from it."""
        self.osdmon.osdmap = OSDMap(CrushMap())
        self.osdmon.down_at.clear()
        self.osdmon.failure_reports.clear()
        self.osdmon.load()
        self.mgrmon.load()
        self.health_mutes = self.store.get("health", "mutes", {}) or {}
        self._applied = self.store.get("mon", "applied_version", 0)
        dout("mon", 1, f"mon.{self.name}: full sync -> osdmap epoch "
                       f"{self.osdmon.osdmap.epoch}")

    def _on_role_change(self) -> None:
        if self.paxos.is_leader():
            # beacons landed on the previous leader while we were a
            # peon: re-arm the grace window instead of dropping a live
            # active mgr on our stale clock
            self.mgrmon.last_beacon = 0.0
        if self.paxos.is_leader() and self.osdmon.osdmap.epoch == 0:
            # first leader seeds the initial map (epoch 1: empty crush root)
            crush = CrushMap()
            crush.add_bucket(10, "default")
            inc = self.osdmon.get_pending()
            inc.new_crush = crush.to_dict()
            self._spawn_proposal()

    def _spawn_proposal(self) -> None:
        """Background propose_pending with failures logged, never
        raised into the event loop; the handle is tracked so stop()
        reaps any proposal still in flight."""
        async def run():
            try:
                await self.osdmon.propose_pending()
            except Exception as e:
                dout("mon", 5, f"mon.{self.name}: background proposal "
                               f"failed: {type(e).__name__} {e}")
        task = asyncio.get_running_loop().create_task(run())
        self._proposal_tasks.add(task)
        task.add_done_callback(self._proposal_tasks.discard)

    # -- dispatch ------------------------------------------------------------

    async def ms_dispatch(self, conn: Connection, msg: Message) -> bool:
        if isinstance(msg, MMonElection):
            await self.paxos.handle_election(conn, msg)
        elif isinstance(msg, MMonPaxos):
            await self.paxos.handle_paxos(conn, msg)
        elif isinstance(msg, MPing):
            conn.send_message(MPingReply(dict(msg.payload)))
        elif isinstance(msg, MMonGetMap):
            self._handle_get_map(conn, msg)
        elif isinstance(msg, MMonSubscribe):
            self._handle_subscribe(conn, msg)
        elif isinstance(msg, MMonCommand):
            await self._handle_command(conn, msg)
        elif isinstance(msg, MOSDBoot):
            await self._osd_plane(msg, self.osdmon.handle_boot)
        elif isinstance(msg, MOSDFailure):
            await self._osd_plane(msg, self.osdmon.handle_failure)
        elif isinstance(msg, MLog):
            p = msg.payload
            self.clog(p.get("level", "WRN"), p.get("who", "?"),
                      p.get("message", ""), stamp=p.get("stamp"))
        elif isinstance(msg, MMonMgrReport):
            # only the ACTIVE mgr's digest counts: a just-demoted mgr
            # whose fire-and-forget sends are still in flight must not
            # clobber its successor's fresher digest
            sender = msg.payload.get("from")
            if sender is not None and \
                    sender != self.mgrmon.map.get("active_name"):
                return True
            self.mgr_digest = msg.payload
            self._mgr_digest_mono = time.monotonic()
            # the health engine runs wherever `health` is asked: forward
            # so the leader (and through it, transitions -> clog) always
            # has the freshest digest even when the mgr's session landed
            # on a peon
            if not self.paxos.is_leader():
                leader = self.paxos.leader
                if leader is not None and leader != self.rank:
                    await self.paxos._send(
                        leader, MMonMgrReport(dict(msg.payload)))
        else:
            return False
        return True

    # -- cluster log ---------------------------------------------------------

    def clog(self, level: str, who: str, message: str,
             stamp: float | None = None) -> None:
        """Append one cluster-log line (whichever mon a daemon's session
        lands on records it; `log last` reads that mon's ring)."""
        self.cluster_log.append(
            {"stamp": stamp if stamp is not None else time.time(),
             "level": level, "who": who, "message": message})
        self.perf.inc("cluster_log_lines")
        dout("mon", 2, f"mon.{self.name} clog [{level}] {who}: {message}")

    def ms_handle_reset(self, conn: Connection) -> None:
        self.subs.pop(conn, None)
        self.mgr_subs.pop(conn, None)

    # -- client plane --------------------------------------------------------

    def _handle_get_map(self, conn: Connection, msg: MMonGetMap) -> None:
        what = msg.payload.get("what", "monmap")
        if what == "monmap":
            conn.send_message(MMonMap({"monmap": self.monmap.to_dict()}))
        else:
            osdmap = self.osdmon.osdmap
            conn.send_message(MOSDMapMsg(
                {"full": osdmap.to_dict() if osdmap.epoch else None,
                 "incrementals": []}))

    def _handle_subscribe(self, conn: Connection, msg: MMonSubscribe) -> None:
        want = msg.payload.get("what", {})
        if "osdmap" in want:
            start = int(want["osdmap"])
            self.subs[conn] = start
            self._push_maps(conn)
        if "mgrmap" in want:
            self.mgr_subs[conn] = int(want["mgrmap"])
            self._push_mgrmap(conn)

    def kick_subscribers(self) -> None:
        for conn in list(self.subs):
            self._push_maps(conn)

    def push_mgrmap(self) -> None:
        for conn in list(self.mgr_subs):
            self._push_mgrmap(conn)

    def _push_mgrmap(self, conn: Connection) -> None:
        epoch = self.mgrmon.map.get("epoch", 0)
        if epoch < self.mgr_subs.get(conn, 0):
            return
        try:
            conn.send_message(MMgrMap({"mgrmap": dict(self.mgrmon.map)}))
        except Exception:
            self.mgr_subs.pop(conn, None)
            return
        self.mgr_subs[conn] = epoch + 1

    def _push_maps(self, conn: Connection) -> None:
        start = self.subs.get(conn, 0)
        cur = self.osdmon.osdmap.epoch
        if start > cur:
            return
        incs = []
        for e in range(max(start, 1), cur + 1):
            inc = self.store.get("osdmap_inc", str(e))
            if inc is None:
                incs = None
                break
            incs.append(inc)
        if incs is not None and incs and start >= 1:
            conn.send_message(MOSDMapMsg({"full": None,
                                          "incrementals": incs}))
        else:
            conn.send_message(MOSDMapMsg(
                {"full": self.osdmon.osdmap.to_dict(), "incrementals": []}))
        self.subs[conn] = cur + 1

    async def _osd_plane(self, msg: Message, handler) -> None:
        if not self.paxos.is_leader():
            leader = self.paxos.leader
            if leader is not None and leader != self.rank:
                await self.paxos._send(leader, type(msg)(dict(msg.payload),
                                                         msg.data))
            return
        try:
            if handler(msg.payload):
                await self.osdmon.propose_pending()
        except Exception as e:
            # osd-plane messages are fire-and-forget: a failed proposal
            # (leadership churn) must not look like a transport fault to
            # the messenger; the osd re-sends on the next map/boot retry
            dout("mon", 5, f"mon.{self.name}: osd-plane proposal failed: "
                           f"{type(e).__name__} {e}")

    async def _handle_command(self, conn: Connection, msg: MMonCommand) -> None:
        tid = msg.payload.get("tid", 0)
        cmd = msg.payload.get("cmd", {})
        prefix = cmd.get("prefix", "")
        self.perf.inc("command")
        # `health`/`health detail`/`status` are leader-routed (NOT
        # read-only): the mgr digest and mute state live with the
        # leader, and a peon answering from local state would hide
        # SLOW_OPS, a mute, or in-flight progress
        read_only = prefix in ("mon stat", "osd dump", "osd tree",
                               "osd erasure-code-profile ls",
                               "osd erasure-code-profile get",
                               "mgr dump", "log last")
        if not read_only and not (self.paxos.is_leader()
                                  and self.paxos.is_active()):
            conn.send_message(self._retry_ack(tid, "not leader"))
            return
        try:
            out = await self._run_command(prefix, cmd)
            conn.send_message(MMonCommandAck({"tid": tid, "rc": 0,
                                              "out": out}))
        except (NotLeader, asyncio.TimeoutError) as e:
            # leadership churned mid-command: tell the client to retry
            # (against the new leader if we know it)
            conn.send_message(self._retry_ack(
                tid, f"retry: {type(e).__name__}: {e}"))
        except Exception as e:
            conn.send_message(MMonCommandAck(
                {"tid": tid, "rc": -22,
                 "error": f"{type(e).__name__}: {e}"}))

    def _retry_ack(self, tid: int, error: str) -> MMonCommandAck:
        """rc=-11 'bounce to the leader' ack with the hint we have."""
        leader = self.paxos.leader
        return MMonCommandAck(
            {"tid": tid, "rc": -11, "error": error,
             "leader": (self.monmap.ranks[leader]
                        if leader is not None else None),
             "leader_addr": (list(self.monmap.addr_of_rank(leader))
                             if leader is not None else None)})

    # -- health engine (health_check_map_t, src/mon/health_check.h) ----------

    DIGEST_STALE = 15.0         # ignore a mgr digest older than this

    def _raw_health_checks(self) -> dict[str, dict]:
        """The full check map: local map-derived checks + mgr-fed checks
        (SLOW_OPS, PG_DEGRADED/UNDERSIZED, OSD_NEARFULL/FULL) while the
        digest is fresh. Mutes are applied by the caller."""
        om = self.osdmon
        checks: dict[str, dict] = {}
        down = [i for i, st in om.osdmap.osds.items() if not st.up]
        if down:
            checks["OSD_DOWN"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(down)} osds down",
                "detail": [f"osd.{i} is down" for i in sorted(down)]}
        out = [i for i, st in om.osdmap.osds.items()
               if not getattr(st, "in_cluster", True)]
        if out:
            checks["OSD_OUT"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(out)} osds out",
                "detail": [f"osd.{i} is out" for i in sorted(out)]}
        quorum = sorted(self.paxos.quorum)
        if len(quorum) <= len(self.monmap.mons) // 2:
            checks["MON_QUORUM"] = {
                "severity": "HEALTH_ERR",
                "summary": f"quorum {quorum} of "
                           f"{len(self.monmap.mons)} monitors"}
        # global up-count vs per-pool min_size: a coarse availability
        # check (placement-level starvation is a pg-state concern the
        # mon does not track here)
        up_osds = sum(1 for st in om.osdmap.osds.values() if st.up)
        for pool in om.osdmap.pools.values():
            if up_osds < pool.min_size:
                checks.setdefault("POOL_UNAVAILABLE", {
                    "severity": "HEALTH_ERR",
                    "summary": "pools below min_size",
                    "detail": []})["detail"].append(
                    f"pool {pool.name!r} needs {pool.min_size} "
                    f"up osds, have {up_osds}")
        # MGR_DOWN: a mgr was active (mgrmap epoch moved) but none is
        # now — daemon reports and labeled metrics have stopped. A
        # cluster that never ran a mgr stays clean.
        if self.mgrmon.map.get("epoch", 0) > 0 \
                and not self.mgrmon.map.get("active_name"):
            checks["MGR_DOWN"] = {
                "severity": "HEALTH_WARN",
                "summary": "no active mgr (daemon reports stopped)"}
        if self.mgr_digest is not None and self._mgr_digest_mono and \
                time.monotonic() - self._mgr_digest_mono \
                < self.DIGEST_STALE:
            for code, chk in (self.mgr_digest.get("checks")
                              or {}).items():
                checks.setdefault(str(code), dict(chk))
        return checks

    def _active_mutes(self) -> dict[str, dict]:
        """Prune expired mutes (TTL), persisting the change."""
        now = time.time()
        expired = [c for c, m in self.health_mutes.items()
                   if m.get("expires") and now >= m["expires"]]
        for code in expired:
            del self.health_mutes[code]
            self.clog("WRN", f"mon.{self.name}",
                      f"health mute {code} expired")
        if expired:
            self.store.put_one("health", "mutes", self.health_mutes)
        return self.health_mutes

    def _health_checks(self, detail: bool = False) -> dict:
        """HEALTH_OK/WARN/ERR from the unmuted check map; muted checks
        are excluded from the summary status but reported under
        "muted" (fully, in `health detail`)."""
        checks = self._raw_health_checks()
        mutes = self._active_mutes()
        visible = {c: chk for c, chk in checks.items() if c not in mutes}
        if any(c["severity"] == "HEALTH_ERR" for c in visible.values()):
            status = "HEALTH_ERR"
        elif visible:
            status = "HEALTH_WARN"
        else:
            status = "HEALTH_OK"
        muted = {}
        for code, mute in mutes.items():
            entry = {"expires_in_s":
                     (round(mute["expires"] - time.time(), 1)
                      if mute.get("expires") else None)}
            if detail and code in checks:
                entry.update(checks[code])
            muted[code] = entry
        return {"status": status, "checks": visible, "muted": muted}

    def _log_health_transitions(self) -> None:
        """WARN+ check transitions land in the cluster log (the
        reference LogMonitor's `Health check failed:` lines)."""
        checks = self._raw_health_checks()
        for code, chk in checks.items():
            sev = chk.get("severity", "HEALTH_WARN")
            if self._prev_checks.get(code) != sev:
                self.clog("ERR" if sev == "HEALTH_ERR" else "WRN",
                          f"mon.{self.name}",
                          f"Health check failed: "
                          f"{chk.get('summary')} ({code})")
                flight.record("health_fail", code, severity=sev,
                              summary=chk.get("summary", ""))
                # WARN+ transition: freeze the ring — the run-up to a
                # SLOW_OPS / PG_DEGRADED flip is exactly what an
                # operator wants post-hoc
                flight.snapshot(f"health:{code}")
        for code in self._prev_checks:
            if code not in checks:
                self.clog("INF", f"mon.{self.name}",
                          f"Health check cleared: {code}")
                flight.record("health_clear", code)
        self._prev_checks = {c: chk.get("severity", "HEALTH_WARN")
                             for c, chk in checks.items()}

    async def _run_command(self, prefix: str, cmd: dict) -> dict:
        om = self.osdmon
        if prefix == "health":
            return self._health_checks()
        if prefix == "health detail":
            return self._health_checks(detail=True)
        if prefix == "health mute":
            code = cmd["code"]
            ttl = cmd.get("ttl")
            mutes = dict(self.health_mutes)
            mutes[code] = {
                "stamp": time.time(),
                "expires": time.time() + float(ttl) if ttl else None}
            await self._propose_health_mutes(mutes)
            self.clog("WRN", f"mon.{self.name}",
                      f"health check {code} muted"
                      + (f" for {float(ttl):.0f}s" if ttl else ""))
            return {"muted": code, "ttl": ttl}
        if prefix == "health unmute":
            existed = cmd["code"] in self.health_mutes
            if existed:
                mutes = dict(self.health_mutes)
                del mutes[cmd["code"]]
                await self._propose_health_mutes(mutes)
            return {"unmuted": cmd["code"], "existed": existed}
        if prefix == "mgr dump":
            out = dict(self.mgrmon.map)
            digest = self.mgr_digest or {}
            out["daemons"] = digest.get("daemons", {})
            out["digest_age_s"] = (
                round(time.monotonic() - self._mgr_digest_mono, 2)
                if self._mgr_digest_mono else None)
            return out
        if prefix == "mgr beacon":
            new_map = self.mgrmon.beacon(cmd.get("name", "?"),
                                         cmd.get("addr"))
            if new_map is not None:
                await self._propose_mgrmap(new_map)
                self.clog("WRN", f"mon.{self.name}",
                          f"mgr.{cmd.get('name', '?')} is now active")
            # the reply names the active mgr: a standby learns its role
            # from this and keeps its digest to itself
            return {"epoch": self.mgrmon.map.get("epoch", 0),
                    "active_name": self.mgrmon.map.get("active_name")}
        if prefix == "status":
            # `ceph -s` analog: health + mon + mgr + osd + pool summary
            up = sum(1 for st in om.osdmap.osds.values() if st.up)
            digest = self.mgr_digest or {}
            return {
                "health": self._health_checks(),
                "monmap": {"mons": sorted(self.monmap.mons),
                           "quorum": sorted(self.paxos.quorum),
                           "leader": self.paxos.leader},
                "mgrmap": {"active": self.mgrmon.map.get("active_name"),
                           "epoch": self.mgrmon.map.get("epoch", 0)},
                "osdmap": {"epoch": om.osdmap.epoch,
                           "num_osds": len(om.osdmap.osds),
                           "num_up_osds": up},
                "pools": {p.name: {"type": p.type, "size": p.size,
                                   "pg_num": p.pg_num}
                          for p in om.osdmap.pools.values()},
                "progress": digest.get("progress", []),
            }
        if prefix == "log last":
            n = int(cmd.get("num", 20))
            lines = list(self.cluster_log)
            level = cmd.get("level")
            if level:
                lines = [e for e in lines if e["level"] == level]
            return {"lines": lines[-n:] if n > 0 else []}
        if prefix == "mon stat":
            return {"name": self.name, "rank": self.rank,
                    "leader": self.paxos.leader,
                    "quorum": sorted(self.paxos.quorum),
                    "election_epoch": self.paxos.epoch}
        if prefix == "osd dump":
            return om.osdmap.to_dict()
        if prefix == "osd tree":
            crush = om.osdmap.crush
            return {"buckets": {b.name: {"type": b.type,
                                         "items": list(b.items),
                                         "weights": list(b.weights)}
                                for b in crush._buckets.values()}}
        if prefix == "osd erasure-code-profile ls":
            return {"profiles": sorted(om.osdmap.ec_profiles)}
        if prefix == "osd erasure-code-profile get":
            name = cmd["name"]
            return {"profile": om.osdmap.ec_profiles[name]}
        if prefix == "osd erasure-code-profile set":
            out = om.cmd_profile_set(cmd["name"], cmd.get("profile", {}))
            await om.propose_pending()
            return out
        if prefix == "osd pool create":
            out = om.cmd_pool_create(
                cmd["pool"], pg_num=int(cmd.get("pg_num", 32)),
                pool_type=cmd.get("pool_type", "replicated"),
                size=int(cmd.get("size", 3)),
                erasure_code_profile=cmd.get("erasure_code_profile", ""),
                crush_failure_domain=int(cmd.get("crush_failure_domain", 1)))
            await om.propose_pending()
            return out
        if prefix in ("osd pool mksnap", "osd pool rmsnap",
                      "osd pool selfmanaged snap create",
                      "osd pool selfmanaged snap rm"):
            if prefix.endswith("mksnap"):
                out = om.cmd_pool_snap(cmd["pool"], "mksnap",
                                       snap_name=cmd["snap"])
            elif prefix.endswith("rmsnap"):
                out = om.cmd_pool_snap(cmd["pool"], "rmsnap",
                                       snap_name=cmd["snap"])
            elif prefix.endswith("create"):
                out = om.cmd_pool_snap(cmd["pool"], "selfmanaged_create")
            else:
                out = om.cmd_pool_snap(cmd["pool"], "selfmanaged_rm",
                                       snapid=int(cmd["snapid"]))
            await om.propose_pending()
            # the epoch the snap committed in (>= is enough: any map at
            # this epoch carries the mutated pool record) — clients wait
            # on THIS, not on "my epoch + 1", which a concurrent
            # unrelated proposal could satisfy early
            out["epoch"] = om.osdmap.epoch
            return out
        if prefix == "osd pg-temp":
            # balancer/upmap plane (OSDMonitor prepare_command
            # "osd pg-temp"): override one PG's acting set; [] erases
            from ceph_tpu_torch.crush.osdmap import PG as PGId
            pool_id, ps = cmd["pgid"]
            osds = [int(o) for o in cmd.get("osds", [])]
            pending = om.get_pending()
            pending.new_pg_temp[PGId(int(pool_id), int(ps))] = osds
            await om.propose_pending()
            return {"pgid": [pool_id, ps], "osds": osds,
                    "epoch": om.osdmap.epoch}
        if prefix in ("osd out", "osd in", "osd down"):
            ids = [int(i) for i in cmd.get("ids", [])]
            unknown = [i for i in ids if i not in om.osdmap.osds]
            if unknown:
                # an unknown id must never enter paxos: the committed
                # incremental would KeyError on every map applier,
                # permanently wedging the map plane
                raise ValueError(f"osd ids {unknown} do not exist")
            pending = om.get_pending()
            for osd in ids:
                {"osd out": pending.new_out, "osd down": pending.new_down,
                 "osd in": pending.new_in}[prefix].append(osd)
            await om.propose_pending()
            return {"ids": ids}
        raise ValueError(f"unknown command {prefix!r}")
