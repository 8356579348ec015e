"""Process-wide device offload service: dynamic batching and multi-card
fan-out for EC + crc.

Port of ceph_tpu/offload/service.py, the admission queue between the
OSD's EC backend and the cards: every PG op that dispatched its own tiny
synchronous encode paid a launch and a host-to-device round trip for a
few KiB of work; the service coalesces them (the continuous-batching
discipline of an inference server).

  * submit: callers hand over a stripe, chunk or block batch (numpy) and
    await a future. Admission is gated by a byte-budget `Throttle`: when
    the queue is full the caller waits, so a wedged card backpressures
    the write path instead of buffering without bound.
  * size-bucketed dynamic batcher: jobs coalesce per bucket key (op kind
    + coding matrix + chunk geometry). A bucket flushes when its bytes
    reach `max_batch_bytes` or when the oldest job has lingered
    `linger_ms`.
  * fan-out: every device of the service's list is a dispatch slot with
    its own pipeline semaphore, pinned staging pages, copy stream and
    circuit breaker. Flushed buckets route device-affine (same bucket
    key, same card, so its matrix operands stay resident), spilling to
    the least-busy slot when the preferred one backs up. Batches at or
    past `device_shard_bytes` run stripe-sharded over a mesh of all the
    slots (K3 through parallel.mesh, bit-identical output) when there
    are at least two.
  * staging: a batch's jobs are stacked straight into a reused pinned
    page of the slot (at most `pipeline_depth` pages), the only host copy
    of the callers' bytes; it goes to the card on the slot's copy stream,
    the bucket's kernel runs on the device tensor, and the result comes
    back on the copy stream.
  * per-device circuit breaker: a card that fails fails its in-flight
    batch over to the next healthy card and leaves rotation until a
    half-open probe clears it. Only when every card is out does the host
    codec (the repo's native C++ GF(2^8) codec and crc, bit-identical)
    serve, and the service reports `degraded`. That fallback is the one
    path on which a card's batch is computed on the host.

The device list is explicit: default every visible card, raising
DeviceUnavailable without one; `devices=["cpu"]` (only when asked) runs
the kernels' plain versions on the CPU.

Observability, as in the reference: tracer spans `offload_queue_wait`
(admission -> dispatch, tag `batch_ops`) and `offload_batch` (links to
every rider's trace; tags `ops`, `bytes`, `device`, `copy_bytes`,
`copy_us`) nest under the submitting op's trace, the executor running
under the caller's context so the plugin's dispatch spans nest too.
Under `tracer.profile_dispatch()` the staged device call also tags the
batch span with its legs (`h2d_us`, `kernel_us`, `d2h_us`), each timed
by a pair of CUDA events on the stream it runs on; off that mode there
is no event and no extra synchronize. The copy ledger gets
`buffer_to_staging`, `h2d` and `d2h`; the flight recorder
`device_failover`, `breaker_trip` and `breaker_recover`.

One front end per event loop; under a thread `ShardPool`
(utils/reactor.py) each shard's loop gets its own admission queue,
buckets, slots and staging pages, while the device states, breakers and
serving mesh are ONE `_Topology` hung off the pool (`pool.shared`), so
every shard sees one rotation decision per device. Cross-shard callers
hand jobs over through `submit_threadsafe`; admin-socket hooks read and
flush through `status()`/`flush()`, which run on the service's loop.

Safety and test hooks, as in the reference: the tracked locks and the
`_Topology.note` taps feed the sanitizer's lockset recorder and
lockdep; staging pages register with its view guards and recycle in
`put_staging`; `qa.faultinject` device faults send a batch straight to
the host fallback; `qa.interleave` yields at `offload_dispatch`.
`OFFLOAD_OPTIONS`/`register_config` declare the `ec_offload_*` options
and hot-apply them to every live service.

Left out of this port: the device partition a process-backed reactor
worker takes (it comes with that pool), and the mgr device rows.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import contextvars
import os
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from ceph_tpu_torch import device as _device
from ceph_tpu_torch.qa import faultinject, interleave
from ceph_tpu_torch.utils import (copytrack, flight, reactor, sanitizer,
                                  tracer)
from ceph_tpu_torch.utils.dout import dout
from ceph_tpu_torch.utils.perf_counters import (TYPE_GAUGE, TYPE_HISTOGRAM,
                                                PerfCountersCollection)
from ceph_tpu_torch.utils.throttle import Throttle

# -- module-wide defaults (the reference's ec_offload_* option defaults) -----

_DEFAULTS: dict[str, Any] = {
    "enabled": True,
    "max_batch_bytes": 8 << 20,
    "linger_ms": 2.0,
    "max_queue_bytes": 64 << 20,
    "pipeline_depth": 2,
    "breaker_threshold": 1,
    "breaker_reset_s": 30.0,
    "crc_device": False,
    "device_count": 0,
    "device_shard_bytes": 32 << 20,
    "device_spill_threshold": 2,
    "device_peak_gbps": 0.0,
}

#: one service per event loop (a service holds loop-bound primitives);
#: under a reactor pool the device topology is shared (see _topo)
_instances_lock = threading.Lock()
_instances: dict[Any, "OffloadService"] = {}

_pool: concurrent.futures.ThreadPoolExecutor | None = None
_pool_lock = threading.Lock()

#: the open `offload_batch` span of the batch a task is dispatching (set
#: in _run_batch, read by _device_call to tag the profiled legs)
_batch_span: contextvars.ContextVar = contextvars.ContextVar(
    "offload_batch_span", default=None)


def _executor() -> concurrent.futures.ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            # enough workers for every slot's transfer/compute overlap
            # plus the host lane; threads spawn on demand, and the
            # per-slot pipeline semaphores bound how many batches run
            workers = max(4, min(16, (os.cpu_count() or 2) + 2))
            _pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="ec-offload")
        return _pool


_perf_lock = threading.Lock()


def _perf():
    coll = PerfCountersCollection.instance()
    with _perf_lock:
        pc = coll.get("offload")
        if pc is not None:
            return pc
        pc = coll.create("offload")
        pc.add("jobs", description="ops submitted to the offload queue")
        pc.add("batches", description="device batches dispatched")
        pc.add("coalesced_ops",
               description="ops that shared a device batch with others")
        pc.add("fallback_ops",
               description="ops served by the host codec fallback")
        pc.add("breaker_trips",
               description="circuit-breaker trips (device -> degraded)")
        pc.add("device_spills",
               description="batches routed off their affine device to "
                           "the least-busy one (load spillover)")
        pc.add("device_failovers",
               description="in-flight batches failed over from a "
                           "tripped device to another healthy device")
        pc.add("mesh_batches",
               description="oversized batches stripe-sharded across "
                           "the whole device mesh")
        pc.add("batch_ops", type=TYPE_HISTOGRAM,
               description="ops coalesced per device batch")
        pc.add("batch_bytes", type=TYPE_HISTOGRAM,
               description="bytes per device batch")
        pc.add("queue_wait_us", type=TYPE_HISTOGRAM,
               description="admission-to-dispatch queue wait (µs)")
        pc.add("queue_bytes", type=TYPE_GAUGE,
               description="bytes admitted and not yet completed")
        pc.add("inflight_batches", type=TYPE_GAUGE,
               description="batches occupying staging slots")
        for kind in ("enc", "dec", "crc", "rep"):
            pc.add(f"kernel_{kind}_gbps", type=TYPE_GAUGE,
                   description=f"{kind} kernel achieved GB/s "
                               f"(EWMA over device batches)")
            pc.add(f"kernel_{kind}_roofline_pct", type=TYPE_GAUGE,
                   description=f"{kind} kernel GB/s as % of "
                               f"device_peak_gbps (0 when no peak is "
                               f"configured)")
    return pc


class _InjectedDeviceFailure(RuntimeError):
    """faultinject device fault: deterministic — the batch goes
    straight to the host fallback (one armed failure = one fallback
    batch), never retried on another card."""


def _slot_labels(devices: list[torch.device]) -> list[str]:
    """One label per slot: `cuda:N` for a card, `cpu:I` for the I-th
    CPU entry (the reference's virtual CPU devices are cpu:0..cpu:7);
    a card named again gets `#n` (cuda:0, cuda:0#1)."""
    labels, seen, n_cpu = [], {}, 0
    for dev in devices:
        if dev.type == "cpu":
            base, n_cpu = f"cpu:{n_cpu}", n_cpu + 1
        else:
            base = str(dev)
        n = seen.get(base, 0)
        seen[base] = n + 1
        labels.append(base if n == 0 else f"{base}#{n}")
    return labels


def _as_numpy(batch) -> np.ndarray:
    return batch.numpy() if isinstance(batch, torch.Tensor) else batch


class _Job:
    """One submitted op: a stripe/block batch plus its completion.
    `data` is one array, or a LIST of row-compatible arrays (a scatter
    job, e.g. per-shard csum fragments): the fragments stack straight
    into the staging page at batch build."""

    __slots__ = ("data", "rows", "nbytes", "fut", "span", "t_submit")

    def __init__(self, data, fut: asyncio.Future):
        self.data = data
        if isinstance(data, list):
            self.rows = sum(f.shape[0] for f in data)
            self.nbytes = int(sum(f.nbytes for f in data))
        else:
            self.rows = data.shape[0]
            self.nbytes = int(data.nbytes)
        self.fut = fut
        self.span = tracer.start_span("offload_queue_wait")
        self.t_submit = time.perf_counter()


class _Bucket:
    """Pending jobs that can share one device dispatch."""

    __slots__ = ("key", "jobs", "nbytes", "dispatch", "fallback",
                 "shard_dispatch", "linger_task", "uses_device")

    def __init__(self, key: tuple, dispatch: Callable, fallback: Callable,
                 uses_device: bool, shard_dispatch: Callable | None = None):
        self.key = key
        self.jobs: list[_Job] = []
        self.nbytes = 0
        #: device buckets: (CPU-staged tensor moved to the slot's device)
        #: -> tensor there; host buckets: numpy -> numpy
        self.dispatch = dispatch
        #: numpy -> numpy on the host codec
        self.fallback = fallback
        #: mesh-wide stripe-sharded dispatch for oversized batches
        #: (None for job kinds with no sharded kernel, e.g. crc/repair)
        self.shard_dispatch = shard_dispatch
        self.linger_task: asyncio.Task | None = None
        # host-native buckets (e.g. crc jobs with crc_device off) bypass
        # the circuit breaker entirely: their success says nothing about
        # the device, and must not close a tripped breaker
        self.uses_device = uses_device


class _DeviceState:
    """Identity + circuit-breaker state for one device. Under a reactor
    pool every shard's service holds a slot onto the SAME state, so
    breaker evidence (from every shard loop and the executor's threads)
    feeds one rotation decision per device; transitions take `lock`."""

    __slots__ = ("label", "device", "lock", "degraded", "degraded_since",
                 "consec_failures", "probe_owner", "last_error")

    def __init__(self, label: str, device: torch.device | None):
        self.label = label
        self.device = device             # None = the host lane
        # lockset-recorded: the sanitizer proves the "transitions take
        # lock" contract at run time
        self.lock = sanitizer.make_lock(f"devstate:{label}")
        self.degraded = False
        self.degraded_since = 0.0
        self.consec_failures = 0
        # half-open probe claim: the claimant batch's token, or None.
        # Owner-checked (release_probe) so a batch that merely passed
        # through the device can never free another batch's claim.
        self.probe_owner: object | None = None
        self.last_error = ""


class _Topology:
    """The cross-shard half of the service: device states, the serving
    mesh and the mesh breaker. One per reactor pool (shared by every
    shard's service) or one per unpooled service."""

    def __init__(self):
        self.lock = sanitizer.make_lock("offload_topology")
        self.states: list[_DeviceState] | None = None
        #: the device list the states were built over (every shard must
        #: name the same one)
        self.devices: list[torch.device] | None = None
        self.mesh = None
        self.mesh_fns: dict[tuple, Callable] = {}
        self.mesh_degraded = False
        self.mesh_degraded_since = 0.0
        self.mesh_probe_inflight = False

    def note(self, field: str, write: bool) -> None:
        """Lockset-recorder tap: every shard thread touches this
        topology, so each field access feeds the sanitizer's conflict
        analysis (no-op unless recording is armed)."""
        sanitizer.note_shared_access(self, field, write)

    def reset(self) -> None:
        with self.lock:
            self.note("states", write=True)
            self.states = None
            self.devices = None
            self.mesh = None
            self.mesh_fns.clear()
            self.mesh_degraded = False
            self.mesh_probe_inflight = False

    def device_states(self, devices: list[torch.device]) -> list[_DeviceState]:
        """Build (once) the device list and, for two or more devices,
        the stripe-only serving mesh over them (every device does
        full-rate data-parallel work; a shard axis would only add padded
        parity rows at m=3). Later callers, other shards' services,
        reuse it; one naming a different list raises ValueError rather
        than being served on the first caller's devices. The mesh is
        built outside the lock (a racing duplicate build is discarded)."""
        devices = list(devices)
        with self.lock:
            self.note("states", write=False)
            if self.states is not None:
                return self._checked(devices)
        states = [_DeviceState(label, dev)
                  for label, dev in zip(_slot_labels(devices), devices)]
        mesh = None
        if len(states) >= 2:
            from ceph_tpu_torch.parallel import mesh as mesh_lib
            mesh = mesh_lib.make_mesh(devices=devices, stripe=len(devices),
                                      shard_max=1)
            dout("offload", 5, f"offload mesh up: {len(states)} devices, "
                               f"shape {mesh.shape}")
        with self.lock:
            self.note("states", write=True)
            if self.states is None:       # first finisher publishes
                self.states = states
                self.devices = devices
                self.mesh = mesh
            return self._checked(devices)

    def _checked(self, devices: list[torch.device]) -> list[_DeviceState]:
        """The published states, if they were built over `devices`
        (caller holds the lock)."""
        if devices != self.devices:
            raise ValueError(
                f"offload topology is shared by this reactor pool and "
                f"serves {[str(d) for d in self.devices]}; a service "
                f"over {[str(d) for d in devices]} cannot join it")
        return self.states

    def mesh_fn(self, cache_key: tuple, M: np.ndarray) -> Callable:
        """The cached stripe-sharded apply for matrix `M` (its operands
        are built on every device outside the lock; a racing double
        build loses to setdefault)."""
        with self.lock:
            self.note("mesh_fns", write=False)
            fn = self.mesh_fns.get(cache_key)
            mesh = self.mesh
        if fn is None:
            from ceph_tpu_torch.parallel import mesh as mesh_lib
            built = mesh_lib.sharded_apply_fn(mesh, M)
            with self.lock:
                self.note("mesh_fns", write=True)
                fn = self.mesh_fns.setdefault(cache_key, built)
        return fn


class _DeviceSlot:
    """One shard's dispatch handle onto a device: pipeline semaphore,
    reused staging pages (pinned for a card), one copy stream — all
    loop-bound, never shared — and the cross-shard `_DeviceState`
    breaker (fields proxy through to it)."""

    __slots__ = ("state", "sem", "depth", "inflight", "staging", "stream")

    def __init__(self, state: _DeviceState, depth: int):
        self.state = state
        self.depth = max(1, depth)
        self.sem = asyncio.Semaphore(self.depth)
        self.inflight = 0                # batches routed here, not done
        #: reused flat uint8 pages, at most `depth` (the double-buffer
        #: pair at depth 2); written on this service's loop only
        self.staging: list[torch.Tensor] = []
        dev = state.device
        self.stream = torch.cuda.Stream(dev) \
            if dev is not None and dev.type == "cuda" else None

    @property
    def label(self) -> str:
        return self.state.label

    @property
    def device(self) -> torch.device | None:
        return self.state.device

    @property
    def degraded(self) -> bool:
        return self.state.degraded

    @degraded.setter
    def degraded(self, v: bool) -> None:
        self.state.degraded = v

    @property
    def degraded_since(self) -> float:
        return self.state.degraded_since

    @degraded_since.setter
    def degraded_since(self, v: float) -> None:
        self.state.degraded_since = v

    @property
    def probe_owner(self):
        return self.state.probe_owner

    @probe_owner.setter
    def probe_owner(self, v) -> None:
        self.state.probe_owner = v

    @property
    def last_error(self) -> str:
        return self.state.last_error

    @property
    def probe_inflight(self) -> bool:
        return self.state.probe_owner is not None

    def release_probe(self, token) -> None:
        """Release the half-open probe claim IFF `token` owns it."""
        state = self.state
        with state.lock:
            if token is not None and state.probe_owner is token:
                state.probe_owner = None

    def get_staging(self, nbytes: int) -> torch.Tensor:
        best = -1
        for i, t in enumerate(self.staging):
            if t.numel() >= nbytes and (
                    best < 0 or t.numel() < self.staging[best].numel()):
                best = i
        if best >= 0:
            buf = self.staging.pop(best)
        else:
            buf = torch.empty(1 << max(12, (nbytes - 1).bit_length()),
                              dtype=torch.uint8,
                              pin_memory=self.stream is not None)
        if sanitizer.view_guards_active():
            # generation-track the page (the tensor object itself): views
            # handed out against this hand-out go stale at put_staging
            sanitizer.register_buffer(buf, "staging")
        return buf

    def put_staging(self, buf: torch.Tensor) -> None:
        if sanitizer.view_guards_active():
            # recycle point, reached only after the batch's copy stream
            # synchronized: a straggler view over this page raises
            # instead of reading the next batch's bytes
            sanitizer.recycle_buffer(buf)
        self.staging.append(buf)
        while len(self.staging) > self.depth:
            # keep the largest pages (they satisfy every batch size)
            smallest = min(range(len(self.staging)),
                           key=lambda i: self.staging[i].numel())
            del self.staging[smallest]


class OffloadService:
    """The per-loop admission queue + batcher + device router (module
    doc). `devices`: the dispatch targets, default every visible card
    (DeviceUnavailable without one)."""

    def __init__(self, loop: asyncio.AbstractEventLoop, devices=None):
        self._loop = loop
        self.devices = _device.resolve_all(devices)
        self.enabled = bool(_DEFAULTS["enabled"])
        self.max_batch_bytes = int(_DEFAULTS["max_batch_bytes"])
        self.linger_ms = float(_DEFAULTS["linger_ms"])
        self.pipeline_depth = max(1, int(_DEFAULTS["pipeline_depth"]))
        self.breaker_threshold = max(1, int(_DEFAULTS["breaker_threshold"]))
        self.breaker_reset_s = float(_DEFAULTS["breaker_reset_s"])
        self.crc_device = bool(_DEFAULTS["crc_device"])
        self.device_count = int(_DEFAULTS["device_count"])
        self.device_shard_bytes = int(_DEFAULTS["device_shard_bytes"])
        self.device_spill_threshold = max(
            1, int(_DEFAULTS["device_spill_threshold"]))
        self.device_peak_gbps = float(_DEFAULTS["device_peak_gbps"])
        self._throttle = Throttle("ec_offload_queue",
                                  int(_DEFAULTS["max_queue_bytes"]))
        self._space = asyncio.Event()
        self._buckets: dict[tuple, _Bucket] = {}
        self._tasks: set[asyncio.Task] = set()
        self.perf = _perf()
        # per-instance stats (the shared perf logger spans every service
        # the process ever made; these are this loop's numbers)
        self.stats = {"jobs": 0, "batches": 0, "coalesced_ops": 0,
                      "fallback_ops": 0, "breaker_trips": 0,
                      "batched_ops": 0, "mesh_batches": 0,
                      "device_spills": 0, "device_failovers": 0}
        # per-device utilization: busy wall time / bytes / batches per
        # dispatch target; fallback and host-native batches are
        # attributed to "host"
        self.device_stats: dict[str, dict] = {}
        self._dev_lock = threading.Lock()
        # the device/breaker/mesh half: ONE object shared by every shard
        # of a reactor pool, private for an unpooled loop. Resolved per
        # access (the _topo property): services are cached per loop
        # across pool lifetimes, and a service made before its loop
        # joined a pool must re-bind to the pool's topology
        self._topo_pool = None
        self._topo_obj: _Topology | None = None
        self._slots: list[_DeviceSlot] | None = None
        self._host_slot = _DeviceSlot(_DeviceState("host", None),
                                      self.pipeline_depth)
        self._last_error = ""
        # per-kernel-kind achieved-GB/s EWMA backing the roofline gauges
        self._kernel_gbps: dict[str, float] = {}

    @property
    def _topo(self) -> _Topology:
        pool = reactor.pool_for(self._loop)
        if pool is not None and \
                getattr(pool, "backend", "thread") != "thread":
            # process-backed shards share no memory: shared() is
            # structurally absent there, and each worker process keeps
            # its OWN topology over its partition of the cards (the
            # parent's control loop likewise stays private)
            pool = None
        if self._topo_obj is None or pool is not self._topo_pool:
            self._topo_pool = pool
            self._topo_obj = pool.shared("offload_topology", _Topology) \
                if pool is not None else _Topology()
            # slots reference the previous topology's device states:
            # rebuild them onto the new one at next dispatch
            self._slots = None
        return self._topo_obj

    # -- config --------------------------------------------------------------

    @property
    def max_queue_bytes(self) -> int:
        return self._throttle.max

    def apply_setting(self, name: str, value: Any) -> None:
        """Apply one ec_offload_* option (config-observer hot path)."""
        if name == "ec_offload_enabled":
            self.enabled = bool(value)
        elif name == "ec_offload_max_batch_bytes":
            self.max_batch_bytes = int(value)
        elif name == "ec_offload_linger_ms":
            self.linger_ms = float(value)
        elif name == "ec_offload_max_queue_bytes":
            self._throttle.reset_max(int(value))
            # observers can fire from an admin-socket thread: the waiter
            # event is loop-bound, so hop onto the loop to rotate it
            if self._on_loop():
                self._wake_waiters()
            elif not self._loop.is_closed():
                self._loop.call_soon_threadsafe(self._wake_waiters)
        elif name == "ec_offload_breaker_threshold":
            self.breaker_threshold = max(1, int(value))
        elif name == "ec_offload_breaker_reset_s":
            self.breaker_reset_s = float(value)
        elif name == "ec_offload_crc_device":
            self.crc_device = bool(value)
        elif name == "ec_offload_device_count":
            self.device_count = int(value)
            # in-flight batches keep their slot refs; new flushes see
            # the rebuilt topology (a shared reset: the observer applies
            # the change to every shard's service)
            self._slots = None
            self._topo.reset()
        elif name == "ec_offload_device_shard_bytes":
            self.device_shard_bytes = int(value)
        elif name == "ec_offload_device_spill_threshold":
            self.device_spill_threshold = max(1, int(value))
        elif name == "ec_offload_device_peak_gbps":
            self.device_peak_gbps = max(0.0, float(value))

    # -- dispatch topology ---------------------------------------------------

    def _topology(self) -> list[_DeviceSlot]:
        """The device slots (built on first use): one per device of the
        service's list, capped by device_count, plus the mesh over them
        for stripe-sharded oversized batches. Device states and the
        mesh are the (possibly pool-shared) topology's; the slots are
        this loop's own."""
        topo = self._topo            # a change of pool drops _slots
        if self._slots is not None:
            return self._slots
        devs = self.devices[:self.device_count] if self.device_count > 0 \
            else self.devices
        states = topo.device_states(devs)
        self._slots = [_DeviceSlot(st, self.pipeline_depth)
                       for st in states]
        return self._slots

    @property
    def _mesh(self):
        return self._topo.mesh

    def _slot_available(self, slot: _DeviceSlot) -> bool:
        """In rotation: healthy, or cooled down enough for a probe."""
        if not slot.degraded:
            return True
        return (time.monotonic() - slot.degraded_since
                >= self.breaker_reset_s) and not slot.probe_inflight

    def _route(self, bucket_key: tuple,
               exclude: set | None = None,
               claimant: object | None = None) -> _DeviceSlot | None:
        """Device-affine routing with least-busy spillover: the bucket
        key hashes to a preferred slot, abandoned only when that slot is
        out of rotation or `device_spill_threshold` batches busier than
        the least-busy one. None when every device is out of rotation.

        A degraded-but-cooled slot is claimed for its half-open probe
        here, at routing time, for `claimant`, so only one batch probes
        a possibly-still-dead card. The claim clears via
        _slot_success/_slot_failure, or owner-checked via release_probe
        on paths where neither ran (cancellation, the mesh detour)."""
        slots = self._topology()
        spill_counted = False
        while True:
            allowed = [s for s in slots
                       if self._slot_available(s)
                       and (exclude is None or s not in exclude)]
            if not allowed:
                return None
            pref = slots[hash(bucket_key) % len(slots)]
            least = min(allowed, key=lambda s: s.inflight)
            chosen = least
            if pref in allowed:
                if pref.inflight - least.inflight < \
                        self.device_spill_threshold:
                    chosen = pref
                elif least is not pref and not spill_counted:
                    # a true load spill: the preferred card was healthy
                    # but backed up; one routing decision = one spill
                    spill_counted = True
                    self.perf.inc("device_spills")
                    self.stats["device_spills"] += 1
            if chosen.degraded:
                # half-open probe claim (anonymous token when the caller
                # has none); losing the race re-routes around the slot
                state = chosen.state
                with state.lock:
                    if state.degraded and state.probe_owner is not None:
                        exclude = (set() if exclude is None
                                   else set(exclude)) | {chosen}
                        continue
                    if state.degraded:
                        state.probe_owner = claimant \
                            if claimant is not None else object()
            return chosen

    # -- public job API ------------------------------------------------------

    async def encode(self, ec_impl, stripes: np.ndarray) -> np.ndarray:
        """(S, k, C) data stripes -> (S, m, C) parity via the plugin's
        batched device API, coalesced with concurrent callers."""
        key = ("enc", ec_impl.coding_matrix.tobytes(), stripes.shape[2])

        def dispatch(batch: torch.Tensor) -> torch.Tensor:
            return ec_impl.encode_stripes(batch)

        def fallback(batch: np.ndarray) -> np.ndarray:
            return _host_apply(ec_impl.coding_matrix, batch)

        def shard_dispatch(batch) -> np.ndarray:
            return self._mesh_apply(key[:2], ec_impl.coding_matrix, batch)

        return await self._submit(key, stripes, dispatch, fallback,
                                  shard_dispatch=shard_dispatch)

    async def decode(self, ec_impl, avail_ids: tuple[int, ...],
                     want_ids: tuple[int, ...],
                     chunks: np.ndarray) -> np.ndarray:
        """(S, k, C) available chunks (stacked in avail_ids order) ->
        (S, len(want), C) reconstructed chunks. Jobs coalesce only with
        the same erasure pattern (a different survivor set is a
        different recovery matrix, hence a different bucket)."""
        avail_ids, want_ids = tuple(avail_ids), tuple(want_ids)
        key = ("dec", ec_impl.coding_matrix.tobytes(), avail_ids, want_ids,
               chunks.shape[2])

        def dispatch(batch: torch.Tensor) -> torch.Tensor:
            return ec_impl.decode_stripes(avail_ids, want_ids, batch)

        def _recovery():
            from ceph_tpu_torch.ops import rs_codec
            return rs_codec.recovery_matrix(ec_impl.coding_matrix,
                                            avail_ids, want_ids)

        def fallback(batch: np.ndarray) -> np.ndarray:
            return _host_apply(_recovery(), batch)

        def shard_dispatch(batch) -> np.ndarray:
            return self._mesh_apply(key[:4], _recovery(), batch)

        return await self._submit(key, chunks, dispatch, fallback,
                                  shard_dispatch=shard_dispatch)

    async def crc32c_blocks(self, blocks, block_size: int) -> np.ndarray:
        """(N, block_size) uint8, or a LIST of such arrays (a scatter
        job, e.g. one EC write's per-shard buffers), -> (N,) uint32
        per-block crc32c. Host-native by default; with crc_device on, the
        batch goes to a card and K2 computes it. Either way the work
        leaves the event loop and coalesces across callers."""
        key = ("crc", bool(self.crc_device), block_size)
        use_device = self.crc_device

        def dispatch(batch):
            if use_device:
                from ceph_tpu_torch.ops import crc32c as crc_dev
                return crc_dev.get_device_crc(
                    block_size, device=batch.device).blocks(batch)
            return _host_crc(batch, block_size)

        def fallback(batch: np.ndarray) -> np.ndarray:
            return _host_crc(batch, block_size)

        if isinstance(blocks, (list, tuple)):
            blocks = [np.ascontiguousarray(b).reshape(-1, block_size)
                      for b in blocks]
        else:
            blocks = np.ascontiguousarray(blocks)
        out = await self._submit(key, blocks, dispatch, fallback,
                                 uses_device=use_device)
        # K2 returns int64 crcs; the host crc uint32
        return out.astype(np.uint32, copy=False)

    async def repair(self, ec_impl, helpers: tuple[int, ...],
                     want: tuple[int, ...], frags: np.ndarray,
                     chunk_size: int) -> np.ndarray:
        """Sub-chunk regenerating repair units (the CLAY single-shard
        rebuild): (N, d, repair_per_chunk) helper fragment planes ->
        (N, chunk_size) rebuilt chunks, coalesced per (codec, erasure
        pattern, geometry) bucket. Host-staged (uses_device=False): the
        plugin's own decode does the transform, and its success says
        nothing about the card."""
        helpers, want = tuple(helpers), tuple(want)
        # codec identity by PROFILE, not instance: every PG backend holds
        # its own plugin object, and same profile => same repair math
        try:
            ident = tuple(sorted(ec_impl.get_profile().items()))
        except Exception:
            ident = id(ec_impl)
        key = ("rep", type(ec_impl).__name__, ident, helpers, want,
               frags.shape[2], chunk_size)

        def dispatch(batch: np.ndarray) -> np.ndarray:
            out = np.empty((batch.shape[0], chunk_size), dtype=np.uint8)
            for u in range(batch.shape[0]):
                chunks = {h: batch[u, j].tobytes()
                          for j, h in enumerate(helpers)}
                dec = ec_impl.decode(list(want), chunks, chunk_size)
                out[u] = np.frombuffer(dec[want[0]], dtype=np.uint8)
            return out

        return await self._submit(key, np.ascontiguousarray(frags),
                                  dispatch, dispatch, uses_device=False)

    # -- admission -----------------------------------------------------------

    def submit_threadsafe(self, method: str, *args,
                          **kw) -> concurrent.futures.Future:
        """Cross-loop submission seam: build one of the public job
        coroutines (`encode`/`decode`/`crc32c_blocks`/`repair`) and
        hand it to the owning loop via run_coroutine_threadsafe.
        Callers on other shards (or plain threads) get a concurrent
        Future; awaiting shards wrap it with asyncio.wrap_future. The
        admission queue, buckets and staging stay loop-bound — only the
        handoff crosses threads."""
        if self._loop.is_closed():
            raise RuntimeError("offload service's loop is closed")
        coro = getattr(self, method)(*args, **kw)
        return asyncio.run_coroutine_threadsafe(coro, self._loop)

    async def _submit(self, key: tuple, data, dispatch: Callable,
                      fallback: Callable, uses_device: bool = True,
                      shard_dispatch: Callable | None = None) -> np.ndarray:
        if not self.enabled:
            return self._inline(data, dispatch, fallback, uses_device)
        nbytes = int(sum(f.nbytes for f in data)) \
            if isinstance(data, list) else int(data.nbytes)
        await self._acquire(nbytes)
        self.perf.inc("jobs")
        self.stats["jobs"] += 1
        fut: asyncio.Future = self._loop.create_future()
        job = _Job(data, fut)
        bucket = self._buckets.get(key)
        if bucket is None:
            bucket = self._buckets[key] = _Bucket(key, dispatch, fallback,
                                                  uses_device,
                                                  shard_dispatch)
            bucket.linger_task = self._loop.create_task(
                self._linger_flush(key))
            self._track(bucket.linger_task)
        bucket.jobs.append(job)
        bucket.nbytes += nbytes
        if bucket.nbytes >= self.max_batch_bytes:
            self._flush_bucket(key)
        try:
            return await fut
        finally:
            # admission budget is held until the job's batch completed
            self._release(nbytes)

    def _inline(self, data, dispatch: Callable,
                fallback: Callable, uses_device: bool) -> np.ndarray:
        """Bypass (enabled=false): the per-op synchronous dispatch on the
        first slot, breaker semantics included (the baseline the
        service is compared with)."""
        if isinstance(data, list):
            # scatter job on the bypass path: one contiguous batch
            t0 = time.perf_counter()
            data = np.concatenate(data, axis=0)
            copytrack.copied("buffer_to_staging", int(data.nbytes),
                             time.perf_counter() - t0)
        self.perf.inc("jobs")
        self.stats["jobs"] += 1
        nbytes = int(data.nbytes)
        if not uses_device:
            t0 = time.perf_counter()
            out = dispatch(data)
            self._note_device("host", 1, nbytes, time.perf_counter() - t0)
            self._note_batch(1, nbytes)
            return out
        slot = self._topology()[0]
        if self._slot_available(slot):
            if slot.degraded:
                # released by _slot_success/_slot_failure just below
                slot.probe_owner = object()
            try:
                t0 = time.perf_counter()
                if faultinject.should_fail_device():
                    raise _InjectedDeviceFailure("injected device failure")
                out = _run_on_slot(slot, dispatch, _device.host_tensor(data))
                self._slot_success(slot)
                self._note_device(slot.label, 1, nbytes,
                                  time.perf_counter() - t0)
                self._note_batch(1, nbytes)
                return out
            except Exception as e:
                self._slot_failure(slot, e)
        self.perf.inc("fallback_ops")
        self.stats["fallback_ops"] += 1
        t0 = time.perf_counter()
        out = fallback(data)
        self._note_device("host", 1, nbytes,
                          time.perf_counter() - t0, fallback=True)
        return out

    async def _acquire(self, nbytes: int) -> None:
        if 0 < self._throttle.max <= nbytes:
            # oversized job: admit unconditionally (transient overshoot)
            # rather than starve behind smaller traffic
            self._throttle.take(nbytes)
        else:
            while not self._throttle.get_or_fail(nbytes):
                evt = self._space
                await evt.wait()
        self.perf.set("queue_bytes", self._throttle.current)

    def _release(self, nbytes: int) -> None:
        self._throttle.put(nbytes)
        self.perf.set("queue_bytes", self._throttle.current)
        self._wake_waiters()

    def _wake_waiters(self) -> None:
        evt, self._space = self._space, asyncio.Event()
        evt.set()

    # -- batching ------------------------------------------------------------

    def _track(self, task: asyncio.Task) -> None:
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _linger_flush(self, key: tuple) -> None:
        """Deadline flush: after linger_ms the bucket ships however full
        it is (bounded latency for a lone op on an idle cluster)."""
        await asyncio.sleep(self.linger_ms / 1000.0)
        bucket = self._buckets.pop(key, None)
        if bucket is not None and bucket.jobs:
            self._track(self._loop.create_task(self._run_batch(bucket)))

    def _flush_bucket(self, key: tuple) -> None:
        bucket = self._buckets.pop(key, None)
        if bucket is None:
            return
        if bucket.linger_task is not None:
            bucket.linger_task.cancel()
        if bucket.jobs:
            self._track(self._loop.create_task(self._run_batch(bucket)))

    def _on_loop(self) -> bool:
        try:
            return asyncio.get_running_loop() is self._loop
        except RuntimeError:
            return False

    def _from_loop(self, fn):
        """Run `fn` on the service's event loop and return its result:
        admin-socket hooks call from their own thread, and _buckets is
        only coherent on the loop (a dict mutating mid-iteration raises
        RuntimeError under exactly the load the command inspects)."""
        if self._on_loop():
            return fn()
        if self._loop.is_closed():
            return fn()         # loop gone: nothing is mutating anymore

        async def run():
            return fn()
        try:
            return asyncio.run_coroutine_threadsafe(
                run(), self._loop).result(timeout=2.0)
        except concurrent.futures.TimeoutError:
            # loop blocked (possibly by the very caller awaiting this
            # admin response in-process): serve a best-effort direct
            # snapshot, retrying the rare mid-mutation iteration
            for _ in range(5):
                try:
                    return fn()
                except RuntimeError:
                    continue
            return fn()

    def flush(self) -> dict:
        """Force-flush every pending bucket now (admin `ec offload
        flush`). Thread-safe: the mutating work only ever runs ON the
        loop — a busy loop gets a call_soon_threadsafe wake instead of
        an off-thread mutation (popping buckets from a foreign thread
        could strand their jobs' futures if create_task then fails)."""
        def impl():
            pending = {str(k): len(b.jobs)
                       for k, b in self._buckets.items()}
            self._flush_all()
            return {"flushed_buckets": len(pending),
                    "pending_ops": pending}
        if self._on_loop():
            return impl()
        if self._loop.is_closed():
            return {"flushed_buckets": 0, "pending_ops": {},
                    "error": "event loop closed"}

        async def run():
            return impl()
        try:
            return asyncio.run_coroutine_threadsafe(
                run(), self._loop).result(timeout=2.0)
        except concurrent.futures.TimeoutError:
            self._loop.call_soon_threadsafe(self._flush_all)
            return {"flushed_buckets": 0, "pending_ops": {},
                    "scheduled": True,
                    "error": "loop busy; flush scheduled"}

    def _flush_all(self) -> None:
        for key in list(self._buckets):
            self._flush_bucket(key)

    async def drain(self) -> None:
        """Flush and wait for every in-flight batch (tests/bench).
        Waits on the tasks not yet done: on Python 3.12 a gather over
        finished tasks completes without yielding, so waiting until the
        done-callbacks empty `_tasks` would spin forever."""
        self._flush_all()
        while True:
            pending = [t for t in self._tasks if not t.done()]
            if not pending:
                return
            await asyncio.gather(*pending, return_exceptions=True)

    def _stack(self, slot: _DeviceSlot, jobs: list[_Job]):
        """Jobs -> one contiguous batch. On a device slot every job, a
        lone one too, is stacked into the slot's reused staging page
        (pinned for a card): the one host copy of the callers' bytes,
        from which the batch goes to the card without another. On the
        host lane a lone single-array job is handed through by
        reference. The copy ledger records which. Returns (batch,
        staging page or None, seconds of the stacking copy)."""
        frags: list[np.ndarray] = []
        for j in jobs:
            if isinstance(j.data, list):
                frags.extend(j.data)
            else:
                frags.append(j.data)
        if slot.device is None and len(frags) == 1:
            copytrack.referenced("buffer_to_staging", jobs[0].nbytes)
            return frags[0], None, 0.0
        nbytes = sum(int(f.nbytes) for f in frags)
        rows = sum(f.shape[0] for f in frags)
        t0 = time.perf_counter()
        buf = slot.get_staging(nbytes)
        view = buf[:nbytes].view((rows,) + tuple(frags[0].shape[1:]))
        dst = view.numpy()
        row = 0
        for f in frags:
            np.copyto(dst[row:row + f.shape[0]], f)
            row += f.shape[0]
        dt = time.perf_counter() - t0
        copytrack.copied("buffer_to_staging", nbytes, dt)
        return (view if slot.device is not None else dst), buf, dt

    async def _run_batch(self, bucket: _Bucket) -> None:
        jobs = bucket.jobs
        token = object()         # this batch's probe-claim identity
        try:
            slot = self._host_slot if not bucket.uses_device \
                else (self._route(bucket.key, claimant=token)
                      or self._host_slot)
        except Exception as e:
            # no slot to run on (a device list the pool's shared
            # topology refuses): the riders get the error, not a hang
            for j in jobs:
                if not j.fut.done():
                    j.fut.set_exception(e)
            return
        slot.inflight += 1
        staging = None
        try:
            # the semaphore wait is INSIDE the try: a cancel delivered
            # while queued behind full staging slots must still cancel
            # the job futures, or their submitters hang forever
            async with slot.sem:
                self.perf.inc("inflight_batches")
                try:
                    now = time.perf_counter()
                    for j in jobs:
                        self.perf.hist_add("queue_wait_us",
                                           (now - j.t_submit) * 1e6)
                        if j.span is not None:
                            j.span.set_tag("batch_ops", len(jobs))
                            j.span.finish()
                    stacked, staging, stack_s = self._stack(slot, jobs)
                    nbytes = int(stacked.nbytes)
                    with tracer.span("offload_batch") as sp:
                        if sp is not None:
                            # span links: the coalesced batch serves
                            # riders of many traces; `trace get <rider>`
                            # pulls this span in through them
                            for j in jobs:
                                if j.span is not None and \
                                        j.span.trace_id != sp.trace_id:
                                    sp.add_link(j.span.context())
                        cv_token = _batch_span.set(sp)
                        try:
                            out, on_device = await self._dispatch(
                                bucket, slot, stacked, len(jobs), token)
                        finally:
                            _batch_span.reset(cv_token)
                        if sp is not None:
                            sp.set_tag("ops", len(jobs))
                            sp.set_tag("bytes", nbytes)
                            sp.set_tag("device", on_device)
                            sp.set_tag("copy_bytes",
                                       nbytes if staging is not None
                                       else 0)
                            sp.set_tag("copy_us", round(stack_s * 1e6, 1))
                    self._note_batch(len(jobs), nbytes)
                    row = 0
                    for j in jobs:
                        if not j.fut.done():
                            j.fut.set_result(out[row:row + j.rows])
                        row += j.rows
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    # pre-dispatch failure (stacking): release OUR probe
                    # claim, the breaker callbacks never ran
                    slot.release_probe(token)
                    for j in jobs:
                        if not j.fut.done():
                            j.fut.set_exception(e)
                finally:
                    if staging is not None:
                        slot.put_staging(staging)
                    self.perf.dec("inflight_batches")
        except asyncio.CancelledError:
            # un-claim OUR probe so a cooled-down device is not stuck
            # out of rotation forever
            slot.release_probe(token)
            for j in jobs:
                if not j.fut.done():
                    j.fut.cancel()
            raise
        finally:
            slot.inflight -= 1

    async def _in_pool(self, fn: Callable, batch) -> np.ndarray:
        """fn(batch) in the executor UNDER the caller's contextvar
        context: run_in_executor does not propagate it, which would
        orphan the plugin's tpu_*_dispatch spans into fresh root traces
        instead of nesting them under offload_batch."""
        ctx = contextvars.copy_context()
        return await self._loop.run_in_executor(
            _executor(), lambda: ctx.run(fn, batch))

    async def _device_call(self, slot: _DeviceSlot, fn: Callable,
                           stacked: torch.Tensor) -> np.ndarray:
        """One staged dispatch onto `slot`'s device, in the executor (see
        _run_on_slot). Under tracer.profile_dispatch the batch span gets
        the call's h2d/kernel/d2h legs."""
        sp = _batch_span.get() if tracer.profile_dispatch() else None
        return await self._in_pool(
            lambda batch: _run_on_slot(slot, fn, batch, sp), stacked)

    def _mesh_apply(self, cache_key: tuple, M: np.ndarray,
                    batch) -> np.ndarray:
        """Stripe-shard `batch` across the whole mesh through the cached
        sharded apply for matrix `M` (runs in the executor)."""
        out = self._topo.mesh_fn(cache_key, M)(batch)
        copytrack.copied("h2d", int(batch.nbytes))
        copytrack.copied("d2h", int(out.nbytes))
        return out

    def _mesh_allowed(self) -> bool:
        topo = self._topo
        if topo.mesh is None:
            return False
        with topo.lock:
            topo.note("mesh_degraded", write=False)
            if not topo.mesh_degraded:
                return True
            if (time.monotonic() - topo.mesh_degraded_since
                    >= self.breaker_reset_s) and \
                    not topo.mesh_probe_inflight:
                # half-open: claim the single probe batch (one claim
                # across shards: the lock makes it atomic); cleared on
                # the probe's success, failure, or cancellation
                topo.note("mesh_degraded", write=True)
                topo.mesh_probe_inflight = True
                return True
            return False

    async def _dispatch(self, bucket: _Bucket, slot: _DeviceSlot,
                        stacked, n_ops: int, token: object = None
                        ) -> tuple[np.ndarray, str]:
        """One staged dispatch with per-device failover and host-codec
        last resort. Returns (result, device label: slot/"mesh"/"host")."""
        if interleave.armed():
            # schedule explorer: let a racing batch reach the breaker/
            # staging state between routing and dispatch
            await interleave.yield_point("offload_dispatch")
        nbytes = int(stacked.nbytes)
        if not bucket.uses_device:
            t0 = time.perf_counter()
            out = await self._in_pool(bucket.dispatch, _as_numpy(stacked))
            self._note_device("host", n_ops, nbytes,
                              time.perf_counter() - t0)
            return out, "host"
        injected = slot is not self._host_slot \
            and faultinject.should_fail_device()
        if injected:
            self._slot_failure(slot,
                               _InjectedDeviceFailure("injected device "
                                                      "failure"))
        # oversized batches fan across the whole mesh on the stripe axis
        # instead of serializing on one card
        if (not injected and bucket.shard_dispatch is not None
                and nbytes >= self.device_shard_bytes
                and self._mesh_allowed()):
            topo = self._topo
            try:
                t0 = time.perf_counter()
                out = await self._in_pool(bucket.shard_dispatch, stacked)
                busy = time.perf_counter() - t0
                with topo.lock:
                    topo.note("mesh_degraded", write=True)
                    topo.mesh_probe_inflight = False
                    if topo.mesh_degraded:
                        topo.mesh_degraded = False
                        dout("offload", 1, "mesh dispatch recovered")
                self.perf.inc("mesh_batches")
                self.stats["mesh_batches"] += 1
                self._note_mesh(n_ops, nbytes, busy)
                self._note_kernel(bucket.key[0], nbytes, busy)
                # this batch never probed the routed card: return our
                # half-open claim, if _route granted one
                slot.release_probe(token)
                return out, "mesh"
            except asyncio.CancelledError:
                with topo.lock:
                    topo.mesh_probe_inflight = False
                slot.release_probe(token)
                raise
            except Exception as e:
                with topo.lock:
                    topo.note("mesh_degraded", write=True)
                    topo.mesh_probe_inflight = False
                    topo.mesh_degraded = True
                    topo.mesh_degraded_since = time.monotonic()
                self._last_error = f"{type(e).__name__}: {e}"
                dout("offload", 0,
                     f"mesh dispatch failed ({self._last_error}); "
                     f"falling back to single-device for "
                     f"{self.breaker_reset_s:.0f}s")
                # fall through to the single-device path
        failover_slots: list[_DeviceSlot] = []
        tried: set = set()
        try:
            while not injected and slot is not self._host_slot:
                try:
                    t0 = time.perf_counter()
                    out = await self._device_call(slot, bucket.dispatch,
                                                  stacked)
                    self._slot_success(slot)
                    busy_s = time.perf_counter() - t0
                    self._note_device(slot.label, n_ops, nbytes, busy_s)
                    self._note_kernel(bucket.key[0], nbytes, busy_s)
                    return out, slot.label
                except asyncio.CancelledError:
                    slot.release_probe(token)
                    raise
                except Exception as e:
                    self._slot_failure(slot, e)
                    tried.add(slot)
                    nxt = self._route(bucket.key, exclude=tried,
                                      claimant=token)
                    if nxt is None:
                        break
                    # fail the in-flight batch over to the next healthy
                    # card, deliberately WITHOUT its pipeline semaphore
                    # (two opposite failovers under full pipelines would
                    # deadlock); routing sees the load via inflight
                    self.perf.inc("device_failovers")
                    self.stats["device_failovers"] += 1
                    flight.record("device_failover", slot.label,
                                  to=nxt.label,
                                  error=f"{type(e).__name__}: {e}")
                    nxt.inflight += 1
                    failover_slots.append(nxt)
                    slot = nxt
            self.perf.inc("fallback_ops", n_ops)
            self.stats["fallback_ops"] += n_ops
            t0 = time.perf_counter()
            out = await self._in_pool(bucket.fallback, _as_numpy(stacked))
            self._note_device("host", n_ops, nbytes,
                              time.perf_counter() - t0, fallback=True)
            return out, "host"
        finally:
            for s in failover_slots:
                s.inflight -= 1

    def _note_device(self, device: str, n_ops: int, nbytes: int,
                     busy_s: float, fallback: bool = False) -> None:
        with self._dev_lock:
            d = self.device_stats.get(device)
            if d is None:
                d = self.device_stats[device] = {
                    "batches": 0, "ops": 0, "bytes": 0, "busy_s": 0.0,
                    "fallback_ops": 0}
            d["batches"] += 1
            d["ops"] += n_ops
            d["bytes"] += nbytes
            d["busy_s"] += busy_s
            if fallback:
                d["fallback_ops"] += n_ops

    def _note_kernel(self, kind, nbytes: int, busy_s: float) -> None:
        """Roofline gauges: achieved GB/s for this kernel kind (EWMA: one
        tiny linger-flushed batch must not zero a healthy trend) and,
        when a device peak is configured, its roofline fraction."""
        if busy_s <= 0 or kind not in ("enc", "dec", "crc", "rep"):
            return
        gbps = nbytes / busy_s / 1e9
        prev = self._kernel_gbps.get(kind)
        ewma = gbps if prev is None else 0.7 * prev + 0.3 * gbps
        self._kernel_gbps[kind] = ewma
        self.perf.set(f"kernel_{kind}_gbps", round(ewma, 4))
        peak = self.device_peak_gbps
        if peak > 0:
            self.perf.set(f"kernel_{kind}_roofline_pct",
                          round(100.0 * ewma / peak, 2))

    def _note_mesh(self, n_ops: int, nbytes: int, busy_s: float) -> None:
        """A mesh batch occupies every device for its wall time; bytes
        and ops are split across the stripe axis (integer shares,
        remainder to the low slots)."""
        slots = self._slots or []
        n = max(1, len(slots))
        for i, slot in enumerate(slots):
            ops = n_ops // n + (1 if i < n_ops % n else 0)
            nb = nbytes // n + (1 if i < nbytes % n else 0)
            self._note_device(slot.label, ops, nb, busy_s)

    def device_snapshot(self) -> dict[str, dict]:
        """Consistent copy of device_stats, safe off the loop thread."""
        with self._dev_lock:
            return {dev: dict(d) for dev, d in self.device_stats.items()}

    def device_metrics(self) -> dict:
        """Per-device counters for the MgrClient report path (an OSD's
        `device_cb`)."""
        return {dev: {"offload_device_busy_seconds": round(d["busy_s"], 6),
                      "offload_device_bytes": d["bytes"],
                      "offload_device_batches": d["batches"],
                      "offload_device_ops": d["ops"],
                      "offload_device_fallback_ops": d["fallback_ops"]}
                for dev, d in self.device_snapshot().items()}

    def _note_batch(self, n_ops: int, nbytes: int) -> None:
        self.perf.inc("batches")
        self.perf.inc("coalesced_ops", max(0, n_ops - 1))
        self.perf.hist_add("batch_ops", n_ops)
        self.perf.hist_add("batch_bytes", nbytes)
        self.stats["batches"] += 1
        self.stats["batched_ops"] += n_ops
        self.stats["coalesced_ops"] += max(0, n_ops - 1)

    # -- per-device circuit breaker ------------------------------------------

    @property
    def degraded(self) -> bool:
        """No device left in rotation (every slot tripped); the host
        codec serves."""
        slots = self._slots
        if not slots:
            return False
        return all(s.degraded for s in slots)

    def _slot_success(self, slot: _DeviceSlot) -> None:
        state = slot.state
        recovered = False
        with state.lock:
            # dispatch outcome is breaker evidence: any claim is consumed
            state.probe_owner = None
            state.consec_failures = 0
            if state.degraded:
                state.degraded = False
                recovered = True
        if recovered:
            dout("offload", 1,
                 f"device {slot.label} recovered; back in rotation")
            flight.record("breaker_recover", slot.label)

    def _slot_failure(self, slot: _DeviceSlot, e: Exception) -> None:
        state = slot.state
        tripped = False
        with state.lock:
            state.probe_owner = None
            state.consec_failures += 1
            state.last_error = f"{type(e).__name__}: {e}"
            self._last_error = state.last_error
            if state.degraded:
                state.degraded_since = time.monotonic()   # probe failed
                return
            if state.consec_failures >= self.breaker_threshold:
                state.degraded = True
                state.degraded_since = time.monotonic()
                tripped = True
        if tripped:
            self.perf.inc("breaker_trips")
            self.stats["breaker_trips"] += 1
            dout("offload", 0,
                 f"device {slot.label} failing ({slot.last_error}); "
                 f"removed from rotation for {self.breaker_reset_s:.0f}s"
                 + (" — no devices left, host codec serves"
                    if self.degraded else ""))
            flight.record("breaker_trip", slot.label,
                          error=slot.last_error,
                          all_degraded=self.degraded)

    # -- surfaces ------------------------------------------------------------

    def health_metrics(self) -> dict:
        """The health blob: `degraded` when no device is in rotation."""
        degraded = self.degraded
        slots = self._slots or []
        # the SERVICE became degraded when the LAST device left rotation
        since = max((s.degraded_since for s in slots if s.degraded),
                    default=0.0)
        return {"degraded": degraded,
                "degraded_for_s": round(time.monotonic() - since, 1)
                if degraded and since else 0.0,
                "devices_out": sum(1 for s in slots if s.degraded),
                "fallback_ops": self.stats["fallback_ops"],
                "breaker_trips": self.stats["breaker_trips"],
                "last_error": self._last_error if degraded else ""}

    def status(self) -> dict:
        """Admin-socket `ec offload status` (loop-coherent off-thread)."""
        return self._from_loop(self._status_impl)

    def _status_impl(self) -> dict:
        s = self.stats
        slots = self._slots or []
        return {
            "enabled": self.enabled,
            "degraded": self.degraded,
            "last_error": self._last_error,
            "settings": {"max_batch_bytes": self.max_batch_bytes,
                         "linger_ms": self.linger_ms,
                         "max_queue_bytes": self.max_queue_bytes,
                         "pipeline_depth": self.pipeline_depth,
                         "breaker_threshold": self.breaker_threshold,
                         "breaker_reset_s": self.breaker_reset_s,
                         "crc_device": self.crc_device,
                         "device_count": self.device_count,
                         "device_shard_bytes": self.device_shard_bytes,
                         "device_spill_threshold":
                             self.device_spill_threshold},
            "mesh": {"devices": len(slots),
                     "shape": dict(self._mesh.shape)
                     if self._mesh is not None else None,
                     "degraded": self._topo.mesh_degraded,
                     "mesh_batches": s["mesh_batches"]},
            "rotation": {sl.label: {"degraded": sl.degraded,
                                    "inflight": sl.inflight,
                                    "last_error": sl.last_error}
                         for sl in slots},
            "queue_bytes": self._throttle.current,
            "pending_buckets": {str(k): {"ops": len(b.jobs),
                                         "bytes": b.nbytes}
                                for k, b in self._buckets.items()},
            "jobs": s["jobs"],
            "batches": s["batches"],
            "coalesced_ops": s["coalesced_ops"],
            "fallback_ops": s["fallback_ops"],
            "breaker_trips": s["breaker_trips"],
            "device_spills": s["device_spills"],
            "device_failovers": s["device_failovers"],
            "mean_batch_ops": round(s["batched_ops"] / s["batches"], 3)
            if s["batches"] else 0.0,
            "devices": {dev: dict(d, busy_s=round(d["busy_s"], 6))
                        for dev, d in self.device_snapshot().items()},
        }


# -- the staged device call ----------------------------------------------------

def _run_on_slot(slot: _DeviceSlot, fn: Callable, batch: torch.Tensor,
                 sp=None) -> np.ndarray:
    """`batch` (a CPU tensor, pinned for a card) -> fn on `slot`'s device
    -> numpy. On a card: the upload on the slot's copy stream, `fn` on
    the card's current stream after it, the result back into pinned
    memory on the copy stream, one synchronize. On the CPU: fn(batch)
    (the kernels' plain versions). The copy ledger gets the bytes up and
    down.

    With `sp`, the open batch span of a profiled dispatch, the three legs
    run one after another, each timed on the stream it runs on (the
    host clock on the CPU, where there is no upload), and their sum
    lands on `sp` as its h2d_us / kernel_us / d2h_us tags."""
    dev = slot.device
    legs = _device.Legs(dev) if sp is not None else None
    if dev.type == "cpu":
        with _device.leg(legs, _device.KERNEL):
            res = fn(batch)
        with _device.leg(legs, _device.D2H):
            out = res.numpy()
        _device.note_roundtrip(legs, int(batch.nbytes), out.nbytes, sp)
        return out
    copy = slot.stream
    with torch.cuda.device(dev):
        compute = torch.cuda.current_stream(dev)
        with torch.cuda.stream(copy), _device.leg(legs, _device.H2D, copy):
            src = batch.to(dev, non_blocking=True)
        compute.wait_stream(copy)
        src.record_stream(compute)
        with _device.leg(legs, _device.KERNEL, compute):
            out = fn(src)
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        copy.wait_stream(compute)
        with torch.cuda.stream(copy), _device.leg(legs, _device.D2H, copy):
            host.copy_(out, non_blocking=True)
        out.record_stream(copy)
        copy.synchronize()
    _device.note_roundtrip(legs, int(batch.nbytes),
                           host.numel() * host.element_size(), sp)
    return host.numpy()


# -- host fallback kernels ---------------------------------------------------

def _host_apply(M: np.ndarray, batch: np.ndarray) -> np.ndarray:
    """(S, k, C) through the (r, k) GF(2^8) matrix on the host's native
    codec -> (S, r, C); bit-identical to the device kernel (same field,
    same matrices)."""
    from ceph_tpu_torch.native import ec_native
    M = np.ascontiguousarray(M, dtype=np.uint8)
    S, k, C = batch.shape
    flat = np.ascontiguousarray(batch.transpose(1, 0, 2)).reshape(k, S * C)
    out = np.empty((M.shape[0], S * C), dtype=np.uint8)
    ec_native.encode(M, flat, out)
    return np.ascontiguousarray(
        out.reshape(M.shape[0], S, C).transpose(1, 0, 2))


def _host_crc(batch: np.ndarray, block_size: int) -> np.ndarray:
    from ceph_tpu_torch.native import ec_native
    return ec_native.crc32c_blocks(
        np.ascontiguousarray(batch).reshape(-1), block_size)


# -- per-loop instance -------------------------------------------------------

def get_service(devices=None) -> OffloadService:
    """The running loop's service, created on first use over `devices`
    (default every visible card; DeviceUnavailable without one).
    `devices` is read only when the service is created."""
    loop = asyncio.get_running_loop()
    with _instances_lock:
        svc = _instances.get(loop)
        if svc is None:
            for stale in [lp for lp in _instances if lp.is_closed()]:
                del _instances[stale]
            svc = _instances[loop] = OffloadService(loop, devices)
    return svc


def service_for(loop) -> OffloadService | None:
    """An existing service by loop (no creation)."""
    with _instances_lock:
        return _instances.get(loop)


def get_service_or_none(devices=None) -> OffloadService | None:
    """get_service, or None outside a running event loop (sync callers
    dispatch inline)."""
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return None
    return get_service(devices)


def set_enabled(flag: bool) -> None:
    """Module-wide toggle (bench harness): defaults + live instances."""
    _DEFAULTS["enabled"] = bool(flag)
    with _instances_lock:
        services = list(_instances.values())
    for svc in services:
        svc.enabled = bool(flag)


def OFFLOAD_OPTIONS():
    """The ec_offload_* option schema (declared per daemon Config)."""
    from ceph_tpu_torch.utils.config import Option
    return [
        Option("ec_offload_enabled", "bool", _DEFAULTS["enabled"],
               "route EC/crc dispatches through the batching offload "
               "service (false = per-op inline dispatch)"),
        Option("ec_offload_max_batch_bytes", "size",
               _DEFAULTS["max_batch_bytes"],
               "flush a batch bucket at this many bytes", minimum=4096),
        Option("ec_offload_linger_ms", "float", _DEFAULTS["linger_ms"],
               "max time a job waits for batch-mates before the bucket "
               "ships anyway", minimum=0.0),
        Option("ec_offload_max_queue_bytes", "size",
               _DEFAULTS["max_queue_bytes"],
               "admission-queue byte budget (backpressure past this)",
               minimum=4096),
        Option("ec_offload_pipeline_depth", "int",
               _DEFAULTS["pipeline_depth"],
               "staging pages per device (the upload of batch N+1 "
               "overlaps the kernel of batch N); startup only",
               minimum=1),
        Option("ec_offload_breaker_threshold", "int",
               _DEFAULTS["breaker_threshold"],
               "consecutive errors on one device before removing it "
               "from rotation", minimum=1),
        Option("ec_offload_breaker_reset_s", "secs",
               _DEFAULTS["breaker_reset_s"],
               "per-device cooldown before a half-open probe batch"),
        Option("ec_offload_crc_device", "bool", _DEFAULTS["crc_device"],
               "run crc jobs on the device kernel (host-native when the "
               "transfer link is the bottleneck)"),
        Option("ec_offload_device_count", "int",
               _DEFAULTS["device_count"],
               "dispatch targets to fan batches across (0 = every "
               "device of the service's list); rebuilds the mesh on "
               "change", minimum=0),
        Option("ec_offload_device_shard_bytes", "size",
               _DEFAULTS["device_shard_bytes"],
               "batches at or past this stripe-shard across the whole "
               "device mesh instead of one card", minimum=4096),
        Option("ec_offload_device_spill_threshold", "int",
               _DEFAULTS["device_spill_threshold"],
               "inflight-batch lead over the least-busy device at "
               "which an affine bucket spills off its preferred card",
               minimum=1),
        Option("ec_offload_device_peak_gbps", "float",
               _DEFAULTS["device_peak_gbps"],
               "device memory-bandwidth peak in GB/s for the roofline "
               "gauges (kernel_*_roofline_pct); 0 leaves them at zero "
               "and only the absolute GB/s gauges move", minimum=0.0),
    ]


def register_config(config) -> None:
    """Declare the ec_offload_* options on `config` (idempotent) and
    hot-apply changes to the module defaults and every live service —
    `config set ec_offload_linger_ms 5` over an admin socket retunes
    the batcher live."""
    from ceph_tpu_torch.utils.config import ConfigError
    names = []
    for opt in OFFLOAD_OPTIONS():
        names.append(opt.name)
        try:
            config.declare(opt)
        except ConfigError:
            pass                    # another daemon already declared it

    def _on_change(name: str, value) -> None:
        key = name[len("ec_offload_"):]
        if key in _DEFAULTS:
            _DEFAULTS[key] = value
        # snapshot under the lock: a shard loop's first get_service()
        # can insert mid-iteration (observers fire on arbitrary threads)
        with _instances_lock:
            services = list(_instances.values())
        for svc in services:
            svc.apply_setting(name, value)

    config.add_observer(tuple(names), _on_change)
    # apply only values this Config OVERRIDES: re-applying plain
    # defaults would let a later daemon boot silently revert knobs an
    # operator tuned at run time on another daemon's socket
    diff = config.diff()
    for name in names:
        if name in diff:
            _on_change(name, config.get(name))
