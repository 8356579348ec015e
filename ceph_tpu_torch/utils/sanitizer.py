"""Runtime asyncio sanitizer: the dynamic half of radoslint.

The JAX package's static suite (its tools/radoslint) proves
task-lifecycle invariants over the AST; this module watches the same
invariants on a LIVE event loop, the way the reference pairs lockdep
(static ordering) with WITH_ASAN/WITH_TSAN builds (runtime). Enabled via the
`sanitizer_enabled` config option (hot-togglable), it arms three probes
on the daemon's loop, plus the interlock concurrency probes:

  * BUFFER GENERATION GUARDS — recycled buffers (offload staging
    pages, frame rx bodies) register with a generation counter that
    bumps at each recycle point; sanitizer mode wraps handed-out
    memoryviews in `GuardedView`, so a use-after-recycle raises
    `UseAfterRecycleError` AT THE ACCESS SITE instead of silently
    reading the next batch's bytes (the runtime twin of radoslint's
    `view-escape`/`view-across-await` rules);
  * LOCKSET RECORDER — TSan-lite for cross-shard shared state:
    `make_lock()` locks record per-thread locksets, and
    `note_shared_access()` on shared-object fields reports any pair of
    accesses from different threads with no common lock (at least one
    a write) through `san_lockset_conflicts` (the runtime twin of
    `shard-shared-mutation`);
  * FOREIGN call_soon RECORDER — `loop.call_soon` driven from a thread
    that doesn't own the loop is recorded (`san_foreign_call_soon`)
    before asyncio's own debug-mode raise, so teardown-time strays that
    swallow the RuntimeError still fail the conftest leak gate.

  * asyncio debug mode with a configurable slow-callback threshold —
    every callback that hogs the loop longer than
    `sanitizer_slow_callback_s` is logged through dout("san", ...) and
    counted (`san_slow_callbacks`), so an operator sees loop stalls in
    `perf dump` / the mgr report instead of a silent latency cliff;
  * a task factory that records each task's CREATION stack, so a
    leaked-task report ("Task was destroyed but it is pending!") names
    the spawn site — without it asyncio only shows where the coroutine
    was suspended, which for the messenger leak class is always the
    same uninformative `await queue.get()` line;
  * a loop exception handler that recognizes destroyed-pending-task
    reports, increments `san_task_leaks`, and douts the recorded spawn
    site.

Counters live in the process-wide PerfCountersCollection under the
"sanitizer" logger, so they ride the existing MgrClient report path
(extra_loggers) to the mgr like every other metric.

The port's copy of ceph_tpu/utils/sanitizer.py (jax-free; the port
imports nothing of the JAX package). The port's offload service hands
out staging pages that are CPU torch tensors: they register and recycle
here like any buffer, and a view over one is guarded through
`memoryview(page.numpy())` with the tensor itself as `buf`.
"""
from __future__ import annotations

import asyncio
import hashlib
import logging
import sys
import threading
import time
import weakref

from ceph_tpu_torch.utils import flight, loophook
from ceph_tpu_torch.utils.dout import dout
from ceph_tpu_torch.utils.perf_counters import PerfCountersCollection

DEFAULT_SLOW_CALLBACK_S = 0.1

_perf = None                      # lazy: PerfCounters("sanitizer")
#: weak so a dead loop's entry vanishes with it — an id()-keyed set
#: would make install() a silent no-op on a new loop that happens to
#: reuse the address
_installed_loops: "weakref.WeakSet[asyncio.AbstractEventLoop]" = \
    weakref.WeakSet()
#: daemon loops that registered via maybe_install()/install(): the
#: config observer fires on the admin-socket THREAD, which has no
#: running loop — changes are marshalled onto these with
#: call_soon_threadsafe
_tracked_loops: "weakref.WeakSet[asyncio.AbstractEventLoop]" = \
    weakref.WeakSet()
_log_bridge = None


def perf():
    """The sanitizer's perf counters, created on first use."""
    global _perf
    if _perf is None:
        coll = PerfCountersCollection.instance()
        pc = coll.get("sanitizer")
        if pc is None:
            pc = coll.create("sanitizer")
            pc.add("san_tasks_created",
                   description="tasks spawned while the sanitizer was armed")
            pc.add("san_slow_callbacks",
                   description="callbacks exceeding the slow-callback "
                               "threshold (event-loop stalls)")
            pc.add("san_task_leaks",
                   description="tasks destroyed while still pending "
                               "(the messenger _dispatch_loop leak class)")
            pc.add("san_view_guard_trips",
                   description="guarded views accessed after their "
                               "source buffer was recycled "
                               "(use-after-recycle caught at the "
                               "access site)")
            pc.add("san_lockset_conflicts",
                   description="cross-thread shared-state access pairs "
                               "with no common lock (TSan-lite)")
            pc.add("san_foreign_call_soon",
                   description="loop.call_soon driven from a thread "
                               "that does not own the loop")
            pc.add("san_lock_order_edges",
                   description="distinct lock-acquisition-order edges "
                               "recorded by lockdep")
            pc.add("san_lockdep_inversions",
                   description="lock-order cycles detected at acquire "
                               "time (each a latent deadlock)")
        _perf = pc
    return _perf


def spawn_site(task: asyncio.Task) -> str | None:
    """Creation stack recorded by the sanitizer task factory, rendered
    as 'file:line in func' innermost-first; None when the task was
    spawned before install() armed the factory."""
    frames = getattr(task, "_san_spawn_stack", None)
    if not frames:
        return None
    return " <- ".join(f"{fn}:{ln} in {name}"
                       for fn, ln, name in frames)


def _task_factory(loop, coro, **kwargs):
    task = asyncio.Task(coro, loop=loop, **kwargs)
    # raw frame walk, innermost-first, skipping the create_task/factory
    # machinery. NOT traceback.extract_stack: that reads (and
    # stat()s!) source files through linecache per spawn, which the
    # loop profiler measured at ~60% of a busy OSD loop — the sanitizer
    # must observe the loop, not load it.
    frames = []
    f = sys._getframe(1)
    while f is not None and len(frames) < 7:
        code = f.f_code
        if "/asyncio/" not in code.co_filename:
            frames.append((code.co_filename, f.f_lineno, code.co_name))
        f = f.f_back
    task._san_spawn_stack = frames
    perf().inc("san_tasks_created")
    return task


#: public handle: the loop profiler (utils/loopprof.py) arms this same
#: factory so sampled tasks carry their spawn sites, and teardown can
#: recognize (and correctly unwind) a factory it installed
task_factory = _task_factory


def armed(loop: asyncio.AbstractEventLoop) -> bool:
    """True while install() holds this loop (debug mode + factory)."""
    return loop in _installed_loops


class _SlowCallbackBridge(logging.Handler):
    """asyncio debug mode reports slow callbacks via logger.warning on
    the 'asyncio' logger; bridge those into dout + a counter."""

    def emit(self, record: logging.LogRecord) -> None:
        try:
            msg = record.getMessage()
        except Exception:
            return
        if "Executing" in msg and "took" in msg:
            perf().inc("san_slow_callbacks")
            dout("san", 1, f"slow callback: {msg}")


def _exception_handler(loop, context: dict) -> None:
    msg = context.get("message", "")
    task = context.get("task")
    if "was destroyed but it is pending" in msg and task is not None:
        perf().inc("san_task_leaks")
        site = spawn_site(task)
        dout("san", 0, f"leaked task {task.get_name()}: {msg}"
             + (f" (spawned at {site})" if site else ""))
    loop.default_exception_handler(context)


def install(loop: asyncio.AbstractEventLoop | None = None,
            slow_callback_s: float = DEFAULT_SLOW_CALLBACK_S,
            view_guards: bool = True) -> None:
    """Arm the sanitizer on `loop` (default: the running loop).
    Idempotent per loop; counters, view guards, and the lockset
    recorder are process-wide."""
    global _log_bridge
    if loop is None:
        loop = asyncio.get_running_loop()
    _tracked_loops.add(loop)
    if view_guards:
        set_view_guards(True)
    set_lockset_recording(True)
    if loop in _installed_loops:
        loop.slow_callback_duration = float(slow_callback_s)
        return
    loop.set_debug(True)
    loop.slow_callback_duration = float(slow_callback_s)
    loop.set_task_factory(_task_factory)
    loop.set_exception_handler(_exception_handler)
    _wrap_call_soon(loop)
    if _log_bridge is None:
        _log_bridge = _SlowCallbackBridge()
        logging.getLogger("asyncio").addHandler(_log_bridge)
    _installed_loops.add(loop)
    perf()                              # counters exist as soon as armed
    dout("san", 1, f"asyncio sanitizer armed (slow-callback "
                   f"threshold {slow_callback_s}s)")


def uninstall(loop: asyncio.AbstractEventLoop | None = None) -> None:
    if loop is None:
        loop = asyncio.get_running_loop()
    if loop not in _installed_loops:
        return
    loop.set_debug(False)
    loop.set_task_factory(None)
    loop.set_exception_handler(None)
    _unwrap_call_soon(loop)
    _installed_loops.discard(loop)
    if not len(_installed_loops):
        # last armed loop gone: the process-wide probes disarm with it
        set_view_guards(False)
        set_lockset_recording(False)


def register_config(config) -> None:
    """Declare the sanitizer options on `config` (idempotent) and watch
    them — `config set sanitizer_enabled true` over the admin socket
    arms the running loop live, matching tracer/offload hot reload."""
    from ceph_tpu_torch.utils.config import ConfigError, Option
    for opt in (Option("sanitizer_enabled", "bool", False,
                       "arm the runtime asyncio sanitizer (debug mode, "
                       "slow-callback log, task spawn-site tracking)"),
                Option("sanitizer_slow_callback_s", "float",
                       DEFAULT_SLOW_CALLBACK_S,
                       "loop-stall threshold logged by the sanitizer",
                       minimum=0.001),
                Option("sanitizer_view_guards", "bool", True,
                       "wrap pooled-buffer views in generation guards "
                       "while the sanitizer is armed (use-after-recycle "
                       "raises at the access site)"),
                Option("sanitizer_lockdep", "bool", False,
                       "arm the lock-order graph recorder + the "
                       "wait-for-graph deadlock watchdog (TrackedLock, "
                       "AdjustableSemaphore, Throttle acquisitions)"),
                Option("sanitizer_stuck_wait_s", "float",
                       DEFAULT_STUCK_WAIT_S,
                       "age threshold after which a parked lock/grant "
                       "wait is reported as stuck by the deadlock "
                       "watchdog (and annotated in MgrReports)",
                       minimum=0.05)):
        try:
            config.declare(opt)
        except ConfigError:
            pass                        # already declared by another daemon

    def _apply(loop: asyncio.AbstractEventLoop, name: str, value) -> None:
        if name == "sanitizer_enabled":
            install(loop, config.get("sanitizer_slow_callback_s"),
                    view_guards=config.get("sanitizer_view_guards")) \
                if value else uninstall(loop)
        elif name == "sanitizer_slow_callback_s" and \
                loop in _installed_loops:
            loop.slow_callback_duration = float(value)
        elif name == "sanitizer_view_guards" and \
                loop in _installed_loops:
            set_view_guards(bool(value))

    def _on_change(name: str, value) -> None:
        # lockdep state is process-wide and thread-safe: no loop
        # marshalling needed, a `config set` from the admin-socket
        # thread arms/retunes it directly
        if name == "sanitizer_lockdep":
            set_lockdep(bool(value),
                        stuck_wait_s=config.get("sanitizer_stuck_wait_s"))
            return
        if name == "sanitizer_stuck_wait_s":
            set_stuck_wait_s(float(value))
            return
        try:
            _apply(asyncio.get_running_loop(), name, value)
        except RuntimeError:
            # admin-socket thread: no loop here — marshal onto every
            # daemon loop that registered (set_debug/set_task_factory
            # must run on the loop's own thread)
            for loop in list(_tracked_loops):
                if not loop.is_closed():
                    loop.call_soon_threadsafe(_apply, loop, name, value)

    config.add_observer(("sanitizer_enabled", "sanitizer_slow_callback_s",
                         "sanitizer_view_guards", "sanitizer_lockdep",
                         "sanitizer_stuck_wait_s"), _on_change)


# -- buffer generation guards -------------------------------------------------
#
# Recycled pools (offload staging pages, and — once a pooled rx path
# lands — frame body buffers) register each buffer here; every recycle
# point bumps the buffer's generation. `guard_view()` captures the
# generation at hand-out, and every later access through the returned
# GuardedView re-checks it: a view that outlived its buffer's recycle
# raises at the access site, with the buffer label and both
# generations, instead of reading whatever the pool's next tenant
# wrote there.

class UseAfterRecycleError(RuntimeError):
    """A guarded view was accessed after its source buffer recycled."""


class _Epoch:
    """Generation cell for one tracked buffer (shared by the registry
    and every GuardedView derived from the buffer)."""

    __slots__ = ("gen", "label", "__weakref__")

    def __init__(self, label: str):
        self.gen = 0
        self.label = label


_epoch_lock = threading.Lock()
_epochs: dict[int, _Epoch] = {}          # id(buffer) -> epoch
#: non-weakrefable buffers (bytes) can't clean their entries via a
#: finalizer; bound the registry instead (sanitizer mode only)
_EPOCH_CAP = 8192
_view_guards = False


def view_guards_active() -> bool:
    """True while sanitizer mode wraps pooled views in guards."""
    return _view_guards


def set_view_guards(enabled: bool) -> None:
    global _view_guards
    _view_guards = bool(enabled)


def register_buffer(buf, label: str = "buffer") -> "_Epoch":
    """Track `buf` (idempotent): returns its generation cell. ndarray/
    bytearray entries self-clean via a finalizer; bytes (no weakref
    support) entries are capped instead."""
    key = id(buf)
    with _epoch_lock:
        ep = _epochs.get(key)
        if ep is not None:
            return ep
        ep = _epochs[key] = _Epoch(label)
        if len(_epochs) > _EPOCH_CAP:
            # drop oldest insertions (dict preserves order); their
            # guards degrade to unchecked, never to false trips
            for stale in list(_epochs)[:_EPOCH_CAP // 4]:
                del _epochs[stale]
    try:
        weakref.finalize(buf, _drop_epoch, key)
    except TypeError:
        pass                              # bytes: capped above
    return ep


def _drop_epoch(key: int) -> None:
    with _epoch_lock:
        _epochs.pop(key, None)


def recycle_buffer(buf) -> None:
    """Mark a recycle point: every view handed out against the
    buffer's previous generation becomes stale (guards raise)."""
    with _epoch_lock:
        ep = _epochs.get(id(buf))
    if ep is not None:
        ep.gen += 1


class GuardedView:
    """Sanitizer-mode proxy over a memoryview tied to its source
    buffer's generation. Implements the Python-level slice of the
    memoryview API (len/index/slice/bytes/tobytes/iteration); slicing
    yields guards sharing the ORIGINAL captured generation. `raw()` is
    the checked unwrap for numpy/native boundaries (`np.frombuffer`
    can't take a proxy) — the check there is the access-site check,
    after it the bytes are read by C code regardless."""

    __slots__ = ("_mv", "_epoch", "_gen")

    def __init__(self, mv: memoryview, epoch: _Epoch, gen: int | None = None):
        self._mv = mv
        self._epoch = epoch
        self._gen = epoch.gen if gen is None else gen

    def _check(self) -> None:
        if self._epoch.gen != self._gen:
            perf().inc("san_view_guard_trips")
            raise UseAfterRecycleError(
                f"view over recycled {self._epoch.label} buffer: "
                f"captured generation {self._gen}, buffer now at "
                f"{self._epoch.gen} — the memory holds another "
                f"batch's bytes")

    # -- checked accessors ---------------------------------------------------

    def raw(self) -> memoryview:
        self._check()
        return self._mv

    def __len__(self) -> int:
        self._check()
        return len(self._mv)

    @property
    def nbytes(self) -> int:
        self._check()
        return self._mv.nbytes

    @property
    def obj(self):
        self._check()
        return self._mv.obj

    def __getitem__(self, idx):
        self._check()
        if isinstance(idx, slice):
            return GuardedView(self._mv[idx], self._epoch, self._gen)
        return self._mv[idx]

    def __bytes__(self) -> bytes:
        self._check()
        return bytes(self._mv)

    def tobytes(self) -> bytes:
        self._check()
        return self._mv.tobytes()

    def __iter__(self):
        self._check()
        return iter(self._mv)

    def __eq__(self, other):
        self._check()
        if isinstance(other, GuardedView):
            other._check()
            other = other._mv
        return self._mv == other

    def __hash__(self):
        self._check()
        return hash(bytes(self._mv))

    def __repr__(self) -> str:
        state = "STALE" if self._epoch.gen != self._gen else "live"
        return (f"<GuardedView {self._epoch.label} gen={self._gen} "
                f"({state}) {len(self._mv)}B>")


def guard_view(view, buf=None, label: str = "buffer"):
    """Wrap `view` in a generation guard when guards are active.
    `buf` is the tracked source buffer (default: the view's base
    object). Non-memoryview values and disarmed mode pass through
    unchanged, so call sites need no mode branching."""
    if not _view_guards or not isinstance(view, memoryview):
        return view
    ep = register_buffer(view.obj if buf is None else buf, label)
    return GuardedView(view, ep)


def unwrap(data):
    """Checked unwrap at numpy/native ingestion boundaries: a
    GuardedView yields its raw memoryview (raising if stale); anything
    else passes through untouched."""
    if type(data) is GuardedView:
        return data.raw()
    return data


# -- lockset recorder (TSan-lite) ---------------------------------------------
#
# Cross-shard shared state (the offload device topology, ShardPool
# shared() services) is mutated from N reactor threads; the contract
# is "every access under the owning lock". `make_lock()` hands out
# locks that record per-thread locksets, and `note_shared_access()`
# at a shared field's touch points compares this access against the
# most recent access from every OTHER thread: different threads, no
# common lock, at least one write -> one `san_lockset_conflicts`
# increment plus a retained report. Recording is armed with the
# sanitizer (or explicitly via set_lockset_recording) so the product
# hot path pays one bool check when disarmed.

_lockset_tls = threading.local()
_lockset_on = False
_conflict_lock = threading.Lock()
_conflicts: list[dict] = []
_CONFLICT_CAP = 256
#: (id(owner), field) -> {thread_id: (lockset, is_write, site)}
_shared_last: dict[tuple[int, str], dict[int, tuple]] = {}
#: (id(owner), field) -> weakref to the owner the records describe —
#: the id-reuse guard (see note_shared_access)
_shared_owner_refs: dict[tuple[int, str], object] = {}
#: (id(owner), field, tid_a, tid_b) pairs already reported — one real
#: race on a hot path must report ONCE, not once per access
_reported_pairs: set[tuple] = set()


def set_lockset_recording(enabled: bool) -> None:
    global _lockset_on
    _lockset_on = bool(enabled)
    # clear on ARM as well as disarm: access records are keyed by
    # id(owner), and a freed owner's id gets recycled — records from a
    # previous recording window must never alias onto a new object
    with _conflict_lock:
        _shared_last.clear()
        _shared_owner_refs.clear()
        _reported_pairs.clear()


def lockset_recording() -> bool:
    return _lockset_on


class TrackedLock:
    """threading.Lock wrapper that records itself in the holding
    thread's lockset (always — the bookkeeping is two set ops; the
    conflict analysis is what's gated). Locksets hold the lock OBJECT,
    not its name: two same-named locks on different owners (every
    _Topology is "offload_topology") must not alias, or a thread
    holding the WRONG topology's lock would mask a real race."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()

    def _held(self) -> set:
        held = getattr(_lockset_tls, "held", None)
        if held is None:
            held = _lockset_tls.held = set()
        return held

    def acquire(self, *a, **kw) -> bool:
        if _lockdep_on:
            # BEFORE blocking: the order edge exists the moment the
            # attempt is made, which is what catches an inversion while
            # both parties are still parked rather than after the fact
            lockdep_will_lock(self.name)
            token = lockdep_wait_start(self.name, kind="lock")
        else:
            token = None
        ok = self._lock.acquire(*a, **kw)
        lockdep_wait_end(token)
        if ok:
            self._held().add(self)
            if _lockdep_on:
                lockdep_locked(self.name)
        return ok

    def release(self) -> None:
        self._held().discard(self)
        if _lockdep_on:
            lockdep_unlocked(self.name)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


def make_lock(name: str) -> TrackedLock:
    """A lockset-recorded lock for cross-shard shared state."""
    return TrackedLock(name)


def held_locks() -> frozenset:
    return frozenset(getattr(_lockset_tls, "held", ()) or ())


def note_shared_access(owner, field: str, write: bool,
                       site: str = "") -> None:
    """Record one access to shared state; report a conflict when a
    DIFFERENT thread last touched it with no common lock and either
    access is a write."""
    if not _lockset_on:
        return
    tid = threading.get_ident()
    locks = held_locks()
    key = (id(owner), field)
    with _conflict_lock:
        last = _shared_last.setdefault(key, {})
        # id-reuse guard WITHIN a recording window: if the key's
        # records belong to a freed object whose id was recycled onto
        # `owner`, comparing against them manufactures conflicts
        # between unrelated objects (their same-NAMED locks are
        # different identities). The weakref pins which object the
        # records describe; a mismatch restarts the key fresh.
        ref = _shared_owner_refs.get(key)
        if ref is None or ref() is not owner:
            if ref is not None:
                last.clear()
                # the recycled id's reported-pair dedup entries must go
                # too, or a REAL race on the new object between the
                # same two thread ids is silently deduped away
                for pair in [p for p in _reported_pairs
                             if p[0] == key[0] and p[1] == field]:
                    _reported_pairs.discard(pair)
            try:
                _shared_owner_refs[key] = weakref.ref(owner)
            except TypeError:
                # unweakrefable owner (__slots__ without __weakref__):
                # no identity guard possible — recycled-id aliasing
                # stays latent for such owners (none exist in-tree;
                # clearing per access would kill detection outright)
                _shared_owner_refs.pop(key, None)
        for other_tid, (other_locks, other_write, other_site) in \
                last.items():
            if other_tid == tid or not (write or other_write):
                continue
            if locks & other_locks:
                continue
            # dedup per (owner, field, LOCKSET pair): the same
            # conflicting access pattern on a hot loop reports once,
            # not once per access. Keyed by the lock-identity sets —
            # NOT thread idents: a joined thread's ident is only
            # sometimes recycled onto its successor, so tid-keyed
            # dedup held or failed at the OS's whim (the
            # test_interleave lockset flake), while the lockset pair
            # is what actually names the racing pattern.
            pair = (id(owner), field,
                    frozenset((frozenset(locks),
                               frozenset(other_locks))))
            if pair in _reported_pairs:
                continue
            _reported_pairs.add(pair)
            perf().inc("san_lockset_conflicts")
            names = sorted(lk.name for lk in locks)
            other_names = sorted(lk.name for lk in other_locks)
            report = {
                "owner": type(owner).__name__, "field": field,
                "a": {"thread": other_tid, "locks": other_names,
                      "write": other_write, "site": other_site},
                "b": {"thread": tid, "locks": names,
                      "write": write, "site": site},
            }
            if len(_conflicts) < _CONFLICT_CAP:
                _conflicts.append(report)
            dout("san", 0,
                 f"lockset conflict on {report['owner']}.{field}: "
                 f"threads {other_tid}/{tid} share no lock "
                 f"({other_names} vs {names})")
        last[tid] = (locks, write, site)


def lockset_conflicts() -> list[dict]:
    with _conflict_lock:
        return list(_conflicts)


def clear_lockset_conflicts() -> None:
    with _conflict_lock:
        _conflicts.clear()
        _shared_last.clear()
        _reported_pairs.clear()


# -- lockdep: acquisition-order graph + wait-for-graph watchdog ---------------
#
# The reference's src/common/lockdep.cc keeps a global lock-order graph
# and fails fast when an acquisition would close a cycle. Here the same
# graph is keyed by resource NAME (TrackedLock.name, Throttle.name, an
# AdjustableSemaphore's name) and fed at acquire-ATTEMPT time, so an
# inversion is reported while both parties are still parked. On top of
# the static order graph sits a live wait-for graph: every blocking
# acquire registers (context, resource, since) and every successful one
# registers a holder, so a periodic watchdog sweep can walk
# waiter -> resource -> holder edges and name an actual deadlock cycle
# (with task spawn sites) rather than just a latent ordering hazard.
# "Context" is the running asyncio task when there is one, else the
# thread — the same execution-context notion the lockset recorder uses,
# extended to coroutines.

DEFAULT_STUCK_WAIT_S = 5.0

_lockdep_lock = threading.Lock()
_lockdep_on = False
_stuck_wait_s = DEFAULT_STUCK_WAIT_S
#: (before, after) -> first-witness {"site": str}
_order_edges: dict[tuple[str, str], dict] = {}
_order_succ: dict[str, set[str]] = {}          # before -> {after, ...}
_inversions: list[dict] = []
_INVERSION_CAP = 64
_reported_cycles: set[frozenset] = set()
#: resource name -> {ctx_id: {"ctx": label, "count": n, "site": str}}
_holders: dict[str, dict[int, dict]] = {}
#: wait token -> {"ctx", "ctx_name", "resource", ...}
_waits: dict[int, dict] = {}
_wait_seq = 0
_thread_held = threading.local()
_watchdog: "_DeadlockWatchdog | None" = None
_last_scan: dict = {}


def lockdep_enabled() -> bool:
    return _lockdep_on


def _caller_site(skip: int = 2) -> str:
    """file:line of the nearest non-sanitizer, non-asyncio caller —
    raw frame walk, same rationale as the task factory."""
    f = sys._getframe(skip)
    while f is not None:
        fn = f.f_code.co_filename
        if "/asyncio/" not in fn and not fn.endswith("sanitizer.py") \
                and not fn.endswith("throttle.py"):
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
    return "?"


def _ctx() -> tuple[int, str, list]:
    """(context id, context label, held-resource list) for the current
    execution context: the running task inside a coroutine, else the
    thread. The held list lives on the task/thread object so it follows
    the context across awaits."""
    task = None
    try:
        task = asyncio.current_task()
    except RuntimeError:
        pass
    if task is not None:
        held = getattr(task, "_san_lockdep_held", None)
        if held is None:
            held = []
            task._san_lockdep_held = held
        return id(task), f"task:{task.get_name()}", held
    held = getattr(_thread_held, "held", None)
    if held is None:
        held = _thread_held.held = []
    t = threading.current_thread()
    return threading.get_ident(), f"thread:{t.name}", held


def set_stuck_wait_s(value: float) -> None:
    global _stuck_wait_s
    _stuck_wait_s = max(0.05, float(value))


def set_lockdep(enabled: bool, stuck_wait_s: float | None = None) -> None:
    """Arm/disarm the order-graph recorder and the deadlock watchdog.
    Arming clears previous graph state (same id-recycling argument as
    the lockset recorder: names persist, contexts do not)."""
    global _lockdep_on, _watchdog
    if stuck_wait_s is not None:
        set_stuck_wait_s(stuck_wait_s)
    enabled = bool(enabled)
    with _lockdep_lock:
        if enabled == _lockdep_on:
            pass
        elif enabled:
            _order_edges.clear()
            _order_succ.clear()
            _inversions.clear()
            _reported_cycles.clear()
            _holders.clear()
            _waits.clear()
            _last_scan.clear()
    _lockdep_on = enabled
    if enabled and (_watchdog is None or not _watchdog.is_alive()):
        _watchdog = _DeadlockWatchdog()
        _watchdog.start()
    elif not enabled and _watchdog is not None:
        _watchdog.stop()
        _watchdog = None
    if enabled:
        perf()                      # counters exist as soon as armed
    dout("san", 2, f"lockdep {'armed' if enabled else 'disarmed'} "
                   f"(stuck-wait threshold {_stuck_wait_s}s)")


def lockdep_will_lock(name: str) -> None:
    """Record order edges held->name for every resource the current
    context holds; a new edge that closes a cycle in the order graph is
    an inversion (reported once per distinct cycle)."""
    if not _lockdep_on:
        return
    _, ctx_name, held = _ctx()
    if not held:
        return
    site = _caller_site()
    for h in held:
        if h != name:
            _note_order_edge(h, name, ctx_name, site)


def _note_order_edge(before: str, after: str, ctx_name: str,
                     site: str) -> None:
    with _lockdep_lock:
        if (before, after) in _order_edges:
            return
        _order_edges[(before, after)] = {"site": site, "ctx": ctx_name}
        _order_succ.setdefault(before, set()).add(after)
        perf().inc("san_lock_order_edges")
        # does `after` already reach `before`? then this edge closes a
        # cycle: BFS for the reverse path so the witness can be
        # rendered edge by edge
        path = _find_path(after, before)
        if path is None:
            return
        cycle_edges = [(path[i], path[i + 1])
                       for i in range(len(path) - 1)] + [(before, after)]
        key = frozenset(cycle_edges)
        if key in _reported_cycles:
            return
        _reported_cycles.add(key)
        perf().inc("san_lockdep_inversions")
        witness = [{"before": a, "after": b,
                    "site": _order_edges.get((a, b), {}).get("site", "?"),
                    "ctx": _order_edges.get((a, b), {}).get("ctx", "?")}
                   for a, b in cycle_edges]
        digest = _cycle_digest([e[0] for e in cycle_edges])
        inv = {"cycle": path + [after], "edges": witness,
               "digest": digest, "detected_at": site,
               "detected_by": ctx_name}
        if len(_inversions) < _INVERSION_CAP:
            _inversions.append(inv)
    flight.record("lockdep_inversion", ctx_name, digest=digest,
                  cycle=inv["cycle"],
                  edges=[f"{e['before']}->{e['after']} at {e['site']}"
                         for e in witness])
    dout("san", 0,
         "lockdep: lock-order inversion "
         + " -> ".join(inv["cycle"]) + " — "
         + "; ".join(f"{e['before']}->{e['after']} at {e['site']} "
                     f"({e['ctx']})" for e in witness))


def _find_path(src: str, dst: str) -> list | None:
    """BFS path src..dst over the order graph (caller holds the lock)."""
    if src == dst:
        return [src]
    prev: dict[str, str] = {src: src}
    frontier = [src]
    while frontier:
        nxt = []
        for node in frontier:
            for succ in _order_succ.get(node, ()):
                if succ in prev:
                    continue
                prev[succ] = node
                if succ == dst:
                    path = [dst]
                    while path[-1] != src:
                        path.append(prev[path[-1]])
                    return path[::-1]
                nxt.append(succ)
        frontier = nxt
    return None


def _cycle_digest(resources: list) -> str:
    """Deterministic cycle fingerprint: the resource ring rotated to
    its lexicographically smallest phase, hashed. Task/thread labels
    are deliberately excluded — the digest must be bit-identical across
    replays of the same seeded scenario, and context names are not."""
    if not resources:
        return hashlib.sha256(b"").hexdigest()[:16]
    k = resources.index(min(resources))
    ring = resources[k:] + resources[:k]
    return hashlib.sha256("|".join(ring).encode()).hexdigest()[:16]


def lockdep_locked(name: str) -> None:
    if not _lockdep_on:
        return
    ctx_id, ctx_name, held = _ctx()
    held.append(name)
    with _lockdep_lock:
        ent = _holders.setdefault(name, {}).get(ctx_id)
        if ent is None:
            _holders[name][ctx_id] = {"ctx": ctx_name, "count": 1,
                                      "site": _caller_site()}
        else:
            ent["count"] += 1


def lockdep_unlocked(name: str) -> None:
    if not _lockdep_on:
        return
    ctx_id, _, held = _ctx()
    # remove the LAST occurrence: counted resources nest
    for i in range(len(held) - 1, -1, -1):
        if held[i] == name:
            del held[i]
            break
    with _lockdep_lock:
        by_ctx = _holders.get(name, {})
        hid = ctx_id
        if hid not in by_ctx and by_ctx:
            # semaphore handed across contexts (acquired by one task,
            # released by another): charge ANY holder entry — holder
            # identity is diagnostic, the count must not leak
            hid = next(iter(by_ctx))
        ent = by_ctx.get(hid)
        if ent is not None:
            ent["count"] -= 1
            if ent["count"] <= 0:
                del by_ctx[hid]
                if not by_ctx:
                    _holders.pop(name, None)


def lockdep_wait_start(resource: str, kind: str = "lock",
                       **detail) -> int | None:
    """Register a blocking wait on `resource` in the live wait-for
    graph; returns a token for lockdep_wait_end. `detail` carries
    attribution (entity=..., peer=..., tid=...) the distributed probe
    ships in MgrReports."""
    if not _lockdep_on:
        return None
    global _wait_seq
    ctx_id, ctx_name, held = _ctx()
    spawn = None
    try:
        task = asyncio.current_task()
        if task is not None:
            spawn = spawn_site(task)
    except RuntimeError:
        pass
    with _lockdep_lock:
        _wait_seq += 1
        token = _wait_seq
        _waits[token] = {"ctx": ctx_id, "ctx_name": ctx_name,
                         "resource": resource, "kind": kind,
                         "since": time.monotonic(),
                         "held": list(held), "site": _caller_site(),
                         "spawn_site": spawn, "detail": detail}
    return token


def lockdep_wait_end(token: int | None) -> None:
    if token is None:
        return
    with _lockdep_lock:
        _waits.pop(token, None)


def lockdep_inversions() -> list[dict]:
    with _lockdep_lock:
        return [dict(i) for i in _inversions]


def lockdep_order_edges() -> dict:
    with _lockdep_lock:
        return {f"{a} -> {b}": dict(w)
                for (a, b), w in _order_edges.items()}


def deadlock_scan(stuck_s: float | None = None) -> dict:
    """One sweep of the live wait-for graph: waiter-context ->
    resource -> holder-context edges, cycles among them, and
    age-threshold stuck waits. Pure read — safe from any thread (the
    watchdog's tick and the `deadlock dump` verb both call it)."""
    if stuck_s is None:
        stuck_s = _stuck_wait_s
    now = time.monotonic()
    with _lockdep_lock:
        waits = [dict(w) for w in _waits.values()]
        holders = {res: {cid: dict(e) for cid, e in by.items()}
                   for res, by in _holders.items()}
    ctx_names: dict[int, str] = {}
    edges = []                   # (waiter_ctx, resource, holder_ctx)
    adj: dict[int, list] = {}
    for w in waits:
        ctx_names[w["ctx"]] = w["ctx_name"]
        for hid, ent in holders.get(w["resource"], {}).items():
            ctx_names.setdefault(hid, ent["ctx"])
            if hid == w["ctx"]:
                continue         # re-entry, not a wait-for edge
            edges.append((w["ctx"], w["resource"], hid, w))
            adj.setdefault(w["ctx"], []).append((hid, w["resource"], w))
    cycles, seen_keys = [], set()
    for start in adj:
        path: list[tuple] = []
        on_path: dict[int, int] = {}

        def dfs(ctx) -> None:
            if ctx in on_path:
                loop_part = path[on_path[ctx]:]
                resources = [res for _, res, _ in loop_part]
                key = frozenset((c, r) for c, r, _ in loop_part)
                if key not in seen_keys:
                    seen_keys.add(key)
                    cycles.append({
                        "tasks": [ctx_names.get(c, str(c))
                                  for c, _, _ in loop_part],
                        "resources": resources,
                        "digest": _cycle_digest(resources),
                        "edges": [{
                            "waiter": ctx_names.get(c, str(c)),
                            "resource": r,
                            "holder": ctx_names.get(h, str(h)),
                            "waited_s": round(now - w["since"], 3),
                            "site": w["site"],
                            "spawn_site": w.get("spawn_site"),
                            "detail": w.get("detail") or {}}
                            for (c, r, w), (h, _, _) in zip(
                                loop_part,
                                loop_part[1:] + loop_part[:1])],
                    })
                return
            if ctx not in adj:
                return
            on_path[ctx] = len(path)
            for hid, res, w in adj[ctx]:
                path.append((ctx, res, w))
                dfs(hid)
                path.pop()
            del on_path[ctx]

        dfs(start)
    stuck = [{"ctx": w["ctx_name"], "resource": w["resource"],
              "kind": w["kind"], "age_s": round(now - w["since"], 3),
              "site": w["site"], "spawn_site": w.get("spawn_site"),
              "held": w["held"], "detail": w.get("detail") or {}}
             for w in waits if now - w["since"] >= stuck_s]
    return {"waits": len(waits), "edges": len(edges),
            "cycles": cycles, "stuck": stuck,
            "stuck_wait_s": stuck_s}


def wait_annotations(entity: str | None = None,
                     min_age_s: float | None = None) -> list[dict]:
    """Long-parked waits for the distributed probe: each OSD ships the
    ones it owns (detail entity= matches) in its MgrReport health leg,
    so the mgr can assemble the cross-daemon wait-for graph."""
    if not _lockdep_on:
        return []
    if min_age_s is None:
        min_age_s = _stuck_wait_s
    now = time.monotonic()
    out = []
    with _lockdep_lock:
        waits = [dict(w) for w in _waits.values()]
    for w in waits:
        age = now - w["since"]
        if age < min_age_s:
            continue
        detail = w.get("detail") or {}
        if entity is not None and detail.get("entity") != entity:
            continue
        out.append({"entity": detail.get("entity"),
                    "resource": w["resource"], "kind": w["kind"],
                    "age_s": round(age, 3), "task": w["ctx_name"],
                    "peer": detail.get("peer"),
                    "tid": detail.get("tid"),
                    "site": w["site"],
                    "spawn_site": w.get("spawn_site")})
    return out


def deadlock_dump() -> dict:
    """The `deadlock dump` admin-socket verb: lockdep graph stats,
    retained inversions, live waits/holders with task spawn sites, the
    watchdog's last detection, and a fresh scan."""
    with _lockdep_lock:
        waits = [dict(w) for w in _waits.values()]
        holders = {res: [dict(e) for e in by.values()]
                   for res, by in _holders.items()}
        inversions = [dict(i) for i in _inversions]
        n_edges = len(_order_edges)
        last = dict(_last_scan)
    now = time.monotonic()
    for w in waits:
        w["age_s"] = round(now - w.pop("since"), 3)
        w.pop("ctx", None)
    # parked-task census from the loopprof/task-factory mirrors: shows
    # what ELSE is parked next to the registered waits
    try:
        from ceph_tpu_torch.utils import loopprof
        parked = loopprof.parked_tasks()
    except Exception:
        parked = []
    return {"lockdep": _lockdep_on,
            "stuck_wait_s": _stuck_wait_s,
            "order_edges": n_edges,
            "inversions": inversions,
            "waits": waits,
            "holders": holders,
            "parked_tasks": parked,
            "last_detection": last,
            "scan": deadlock_scan()}


class _DeadlockWatchdog(threading.Thread):
    """Periodic wait-for-graph sweep: a detected cycle or an over-age
    stuck wait drops a flight crumb + dout once per distinct signature,
    and the latest positive scan is retained for `deadlock dump`."""

    def __init__(self):
        super().__init__(name="san-deadlock-watchdog", daemon=True)
        self._stop = threading.Event()
        self._crumbed: set[str] = set()
        self._stuck_crumbed: set[tuple] = set()

    def stop(self) -> None:
        self._stop.set()

    def run(self) -> None:
        while not self._stop.is_set():
            # sweep well inside the detection budget (<2s from park to
            # report even with the default 5s stuck threshold, since
            # cycle detection does not wait for the age threshold)
            self._stop.wait(min(0.5, _stuck_wait_s / 2))
            if self._stop.is_set() or not _lockdep_on:
                continue
            try:
                scan = deadlock_scan()
            except Exception as e:
                dout("san", 1, f"deadlock watchdog sweep failed: "
                               f"{type(e).__name__} {e}")
                continue
            if scan["cycles"] or scan["stuck"]:
                with _lockdep_lock:
                    _last_scan.clear()
                    _last_scan.update(scan, stamp=time.time())
            for cyc in scan["cycles"]:
                if cyc["digest"] in self._crumbed:
                    continue
                self._crumbed.add(cyc["digest"])
                flight.record(
                    "deadlock_cycle", "lockdep",
                    digest=cyc["digest"], resources=cyc["resources"],
                    tasks=cyc["tasks"],
                    edges=[f"{e['waiter']} waits {e['resource']} "
                           f"held by {e['holder']}"
                           for e in cyc["edges"]])
                dout("san", 0,
                     "DEADLOCK: " + " ; ".join(
                         f"{e['waiter']} waits on {e['resource']} "
                         f"held by {e['holder']} "
                         f"(spawned {e['spawn_site']})"
                         for e in cyc["edges"]))
            for s in scan["stuck"]:
                key = (s["ctx"], s["resource"])
                if key in self._stuck_crumbed:
                    continue
                self._stuck_crumbed.add(key)
                flight.record("stuck_wait", s["ctx"],
                              resource=s["resource"], age_s=s["age_s"],
                              site=s["site"], detail=s["detail"])
                dout("san", 1,
                     f"stuck wait: {s['ctx']} parked on "
                     f"{s['resource']} for {s['age_s']}s at {s['site']}")


# -- foreign-loop call_soon recorder ------------------------------------------

_foreign_lock = threading.Lock()
_foreign_call_soon: list[dict] = []
_FOREIGN_CAP = 256


def _record_foreign_call_soon(loop, cb) -> None:
    perf().inc("san_foreign_call_soon")
    code = getattr(cb, "__code__", None)
    func = getattr(cb, "func", None)          # functools.partial
    if code is None and func is not None:
        code = getattr(func, "__code__", None)
    site = (f"{code.co_filename}:{code.co_firstlineno}"
            if code is not None else repr(cb))
    with _foreign_lock:
        if len(_foreign_call_soon) < _FOREIGN_CAP:
            _foreign_call_soon.append({
                "loop": repr(loop), "callback": site,
                "thread": threading.get_ident()})
    dout("san", 0, f"foreign-thread call_soon on {loop!r}: {site} — "
                   f"use call_soon_threadsafe")


def take_foreign_call_soon() -> list[dict]:
    """Drain recorded foreign-thread call_soon events (the conftest
    teardown gate consumes this after every test)."""
    with _foreign_lock:
        out = list(_foreign_call_soon)
        _foreign_call_soon.clear()
    return out


def _wrap_call_soon(loop) -> None:
    owner = threading.get_ident()

    def make(orig):
        def call_soon(callback, *args, **kwargs):
            # armed-gate at CALL time: a buried wrapper can outlive
            # uninstall (see utils/loophook) and must pass through
            if loop in _installed_loops and \
                    threading.get_ident() != owner:
                # record BEFORE asyncio's debug-mode raise: a caller
                # that swallows the RuntimeError still fails the
                # teardown gate
                _record_foreign_call_soon(loop, callback)
            return orig(callback, *args, **kwargs)
        return call_soon

    loophook.wrap(loop, "san_call_soon", make)


def _unwrap_call_soon(loop) -> None:
    loophook.unwrap(loop, "san_call_soon")


def maybe_install(config=None) -> None:
    """Arm the sanitizer on the running loop when enabled. Daemons call
    this from start(); with no config (mds/rgw/client tools) it is a
    no-op unless another daemon in the process already armed the loop."""
    if config is None:
        return
    try:
        # track this daemon's loop even while disabled, so a later
        # `config set sanitizer_enabled true` from the admin-socket
        # thread knows which loop(s) to arm
        _tracked_loops.add(asyncio.get_running_loop())
        if config.get("sanitizer_enabled"):
            install(slow_callback_s=config.get("sanitizer_slow_callback_s"),
                    view_guards=config.get("sanitizer_view_guards"))
        if config.get("sanitizer_lockdep"):
            set_lockdep(True,
                        stuck_wait_s=config.get("sanitizer_stuck_wait_s"))
    except Exception:
        pass                            # options not declared on this config
