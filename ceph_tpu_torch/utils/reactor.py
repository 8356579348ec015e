"""Sharded reactor runtime: N OS threads, each owning one asyncio loop.

A single Python event loop that carries every daemon and client is one
core's worth of frame parsing and dispatch, however many devices the
offload service fans across. This module is the Crimson/seastar analog:
a pool of reactor *shards*, each an OS thread running its own event
loop, with daemons placed whole onto shards —

  * shard 0 is the CALLING loop (the harness/main loop): the mon, mgr,
    and clients stay there, exactly like the pre-shard world;
  * OSDs are placed round-robin across all shards (`place()`), so the
    data-plane daemons stop sharing one reactor;
  * a `ShardPool(1)` is the degenerate case: no threads, no behavior
    change — the knob dials concurrency without forking the code path.

Loop-affinity discipline: loop-bound objects (asyncio primitives, the
OffloadService) belong to exactly one shard. Touching one from another
shard must go through the threadsafe seams — `run_on()` /
`run_on_each()` here, `loop.call_soon_threadsafe`, or
`asyncio.run_coroutine_threadsafe` — never a bare `call_soon`/
`create_task` on a foreign loop handle.

The pool also carries `shared(key, factory)`: process-level services
that must span every shard (the offload device topology and its
per-device circuit breakers) hang their one shared instance off the
pool instead of the loop, so four shards see one breaker state per
card rather than four conflicting ones.

`ProcShardPool` is the process-backed mode: the shards are spawned
worker processes (`python -m ceph_tpu_torch.utils.reactor_worker`), each
with its own interpreter, loop and offload front end, and so its own
CUDA context on the card. A worker is a fresh interpreter started by
fork and exec, so no CUDA context of the parent crosses into it.

The port's copy of ceph_tpu/utils/reactor.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import functools
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Callable

from ceph_tpu_torch.utils import flight
from ceph_tpu_torch.utils.async_util import reap_all
from ceph_tpu_torch.utils.dout import dout

#: process-wide switch-interval management: the 0.5 ms bound is a
#: property of "any multi-shard pool is live", not of one pool — two
#: overlapping pools with per-pool save/restore would let the first
#: shutdown restore 5 ms under the second pool, then the second
#: shutdown "restore" 0.5 ms forever. Refcounted instead.
_switch_lock = threading.Lock()
_multi_pool_count = 0
_saved_interval: float | None = None


def _switch_interval_enter(interval_s: float) -> None:
    global _multi_pool_count, _saved_interval
    with _switch_lock:
        if _multi_pool_count == 0:
            _saved_interval = sys.getswitchinterval()
            sys.setswitchinterval(interval_s)
        _multi_pool_count += 1


def _switch_interval_exit() -> None:
    global _multi_pool_count, _saved_interval
    with _switch_lock:
        if _multi_pool_count == 0:
            return
        _multi_pool_count -= 1
        if _multi_pool_count == 0 and _saved_interval is not None:
            sys.setswitchinterval(_saved_interval)
            _saved_interval = None


#: loop -> [(pool, shard_index), ...]; the process-wide placement
#: registry. Lets loop-keyed services (offload, loopprof) answer "which
#: shard am I, and which pool do I share state with" from any thread.
#: A STACK per loop, not a single slot: the parent loop is shard 0 of a
#: live ProcShardPool AND of a nested thread ShardPool in mixed mode —
#: the inner pool's teardown must restore the outer registration, not
#: erase it.
_registry_lock = threading.Lock()
_by_loop: dict[asyncio.AbstractEventLoop, list[tuple]] = {}


def _register(loop, pool, index: int) -> None:
    with _registry_lock:
        for stale in [lp for lp in _by_loop if lp.is_closed()]:
            del _by_loop[stale]
        _by_loop.setdefault(loop, []).append((pool, index))


def _unregister(loop, pool=None) -> None:
    """Remove `pool`'s registration of `loop` (the newest entry when
    pool is None), restoring whatever outer pool registered it first."""
    with _registry_lock:
        stack = _by_loop.get(loop)
        if not stack:
            return
        if pool is None:
            stack.pop()
        else:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][0] is pool:
                    del stack[i]
                    break
        if not stack:
            del _by_loop[loop]


def pool_for(loop) -> "ShardPool | None":
    """The ShardPool `loop` belongs to (None for unpooled loops —
    standalone tests and single-loop tools keep their private world)."""
    with _registry_lock:
        stack = _by_loop.get(loop)
        return stack[-1][0] if stack else None


def shard_index_of(loop) -> int | None:
    with _registry_lock:
        stack = _by_loop.get(loop)
        return stack[-1][1] if stack else None


def shard_label(loop) -> str | None:
    """Stable display label ("shard0"...) for exports, or None."""
    idx = shard_index_of(loop)
    return None if idx is None else f"shard{idx}"


def current_pool() -> "ShardPool | None":
    """The running loop's pool, or None (callable from coroutines)."""
    try:
        return pool_for(asyncio.get_running_loop())
    except RuntimeError:
        return None


class Shard:
    """One reactor: an event loop plus the thread that runs it (thread
    is None for shard 0, which borrows the creating loop)."""

    __slots__ = ("index", "loop", "thread", "ready")

    def __init__(self, index: int):
        self.index = index
        self.loop: asyncio.AbstractEventLoop | None = None
        self.thread: threading.Thread | None = None
        self.ready = threading.Event()


class ShardPool:
    """`n` reactor shards: the creating loop plus n-1 loop threads.

    Must be constructed on a running event loop (it becomes shard 0).
    `shutdown()` reaps every thread shard's leftover tasks before
    stopping its loop, so a pool teardown is as tail-clean as a daemon
    stop (no "Task was destroyed but it is pending")."""

    START_TIMEOUT = 10.0

    #: shards share this process's memory (the ProcShardPool analog is
    #: "process"); consumers like the offload topology key their
    #: shared-vs-private decision on this
    backend = "thread"

    #: GIL switch interval while a multi-shard pool is live. A
    #: cross-shard hop (call_soon_threadsafe wakeup, socket readable on
    #: another shard) can wait up to a FULL switch interval for the GIL
    #: when every loop thread is busy; at CPython's default 5 ms that
    #: convoys a multi-hop EC write into tens of ms of pure handoff
    #: latency. 0.5 ms trades a little single-thread throughput for
    #: bounded cross-shard latency.
    SWITCH_INTERVAL_S = 0.0005

    def __init__(self, num_shards: int, name: str = "reactor"):
        if num_shards < 1:
            raise ValueError("a reactor pool needs at least one shard")
        self.name = name
        self._closed = False
        self._holds_switch_interval = num_shards > 1
        if self._holds_switch_interval:
            _switch_interval_enter(self.SWITCH_INTERVAL_S)
        self._shared_lock = threading.Lock()
        self._shared: dict[str, Any] = {}
        shard0 = Shard(0)
        shard0.loop = asyncio.get_running_loop()
        shard0.ready.set()
        self._shards = [shard0]
        _register(shard0.loop, self, 0)
        try:
            for i in range(1, num_shards):
                shard = Shard(i)
                shard.thread = threading.Thread(
                    target=self._shard_main, args=(shard,),
                    name=f"{name}-shard{i}", daemon=True)
                self._shards.append(shard)
                shard.thread.start()
            for shard in self._shards[1:]:
                if not shard.ready.wait(self.START_TIMEOUT):
                    raise RuntimeError(f"{name} shard {shard.index} "
                                       f"never came up")
        except BaseException:
            # a failed boot must not leak running shard threads nor
            # leave the process-wide switch interval degraded
            self._abort_started_shards()
            raise
        dout("reactor", 1, f"{name}: {num_shards} shard(s) up")

    def _abort_started_shards(self) -> None:
        if self._holds_switch_interval:
            _switch_interval_exit()
            self._holds_switch_interval = False
        for shard in self._shards[1:]:
            loop = shard.loop
            if loop is not None and not loop.is_closed():
                loop.call_soon_threadsafe(loop.stop)
            if shard.thread is not None:
                shard.thread.join(self.START_TIMEOUT)
        _unregister(self._shards[0].loop, self)
        self._closed = True

    # -- placement -----------------------------------------------------------

    @property
    def num_shards(self) -> int:
        return len(self._shards)

    def place(self, seq: int) -> int:
        """Round-robin shard index for the seq-th data-plane daemon."""
        return seq % len(self._shards)

    def loop(self, index: int) -> asyncio.AbstractEventLoop:
        return self._shards[index].loop

    # -- cross-shard seams ---------------------------------------------------

    async def run_on(self, index: int, coro) -> Any:
        """Run `coro` on shard `index` and await its result from the
        calling shard. Same-shard awaits inline; cross-shard hops via
        run_coroutine_threadsafe (the call_soon_threadsafe handoff)."""
        target = self._shards[index].loop
        if target is asyncio.get_running_loop():
            return await coro
        cfut = asyncio.run_coroutine_threadsafe(coro, target)
        return await asyncio.wrap_future(cfut)

    async def run_on_each(self, fn: Callable[[], Any]) -> list:
        """Run sync `fn()` ON every shard's loop thread (shard 0
        inline) — the arming hook for per-loop instruments (loopprof
        install/uninstall need the loop thread's ident)."""
        out = []
        for shard in self._shards:
            if shard.loop is asyncio.get_running_loop():
                out.append(fn())
                continue
            done: concurrent.futures.Future = concurrent.futures.Future()

            def call(done=done):
                try:
                    done.set_result(fn())
                except BaseException as e:   # marshal failures back whole
                    done.set_exception(e)
            shard.loop.call_soon_threadsafe(call)
            out.append(await asyncio.wrap_future(done))
        return out

    # -- pool-scoped shared state --------------------------------------------

    def shared(self, key: str, factory: Callable[[], Any]) -> Any:
        """Get-or-create the pool-wide instance of a cross-shard
        service (one offload device topology per pool, not per loop)."""
        with self._shared_lock:
            obj = self._shared.get(key)
            if obj is None:
                obj = self._shared[key] = factory()
            return obj

    # -- lifecycle -----------------------------------------------------------

    def _shard_main(self, shard: Shard) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        shard.loop = loop
        _register(loop, self, shard.index)
        shard.ready.set()
        try:
            loop.run_forever()
            # post-stop drain: anything still pending here was created
            # after the final reap (or leaked past a daemon stop) —
            # cancel-and-await so loop.close() destroys nothing pending
            leftovers = asyncio.all_tasks(loop)
            if leftovers:
                loop.run_until_complete(reap_all(leftovers))
            loop.run_until_complete(loop.shutdown_asyncgens())
            loop.run_until_complete(loop.shutdown_default_executor())
        finally:
            try:
                from ceph_tpu_torch.utils import loopprof
                loopprof.uninstall(loop)     # defensive: sampler unarm
            except Exception:
                pass
            _unregister(loop, self)
            loop.close()

    async def _drain_shard(self) -> None:
        """Runs ON a thread shard: reap every task but ourselves."""
        cur = asyncio.current_task()
        await reap_all([t for t in asyncio.all_tasks() if t is not cur])

    async def shutdown(self, timeout: float = 20.0) -> None:
        """Reap and stop every thread shard (idempotent). The daemons
        on each shard must already be stopped — this reaps stragglers,
        parks the loop, and joins the thread."""
        if self._closed:
            return
        self._closed = True
        if self._holds_switch_interval:
            _switch_interval_exit()
            self._holds_switch_interval = False
        for shard in self._shards[1:]:
            loop = shard.loop
            if loop is None or loop.is_closed():
                continue
            cfut = asyncio.run_coroutine_threadsafe(
                self._drain_shard(), loop)
            try:
                await asyncio.wait_for(asyncio.wrap_future(cfut), timeout)
            except Exception as e:
                dout("reactor", 1,
                     f"{self.name}: shard {shard.index} drain failed "
                     f"({type(e).__name__}: {e}); stopping it anyway")
                cfut.cancel()
            loop.call_soon_threadsafe(loop.stop)
            if shard.thread is not None:
                await asyncio.get_running_loop().run_in_executor(
                    None, shard.thread.join, timeout)
        _unregister(self._shards[0].loop, self)
        dout("reactor", 1, f"{self.name}: pool down")


# ---------------------------------------------------------------------------
# process-backed shards: the true GIL escape
# ---------------------------------------------------------------------------
#
# The thread-backed ShardPool buys loops, not parallelism: every loop
# thread still serializes on one interpreter lock. The process-backed
# mode below spawns the shards as real OS processes — each worker runs
# its own interpreter, its own event loop, its own OffloadService front
# end over a PARTITIONED device topology (and so its own CUDA context
# on the card: a worker is fork + exec, never a bare fork) — and the
# messenger already speaks TCP between daemons, so the data path crosses
# the process boundary with zero new wire plumbing. What needs building
# is the lifecycle (spawn/supervise/reap/respawn) and the seams:
#
#   * control channel: each worker binds an AdminSocket (the same
#     plumbing every daemon already exposes) and the parent drives it
#     with JSON verbs — boot_osd / stop_osd / config set / inject /
#     worker status / profile dump / shutdown. Hot-togglable knobs reach
#     worker observers through `config set` exactly as an operator's
#     would.
#   * supervision: a parent-loop task polls worker liveness; a dead
#     worker is reaped immediately (no zombies) and its OSDs go through
#     the EXISTING reporter-quorum mark-down — peers stop hearing
#     heartbeats, report failures, the mon marks down. `respawn()`
#     re-spawns the worker and re-boots its recorded OSDs.
#   * rejected conveniences: `shared()` and `run_on()` raise — there is
#     no cross-process memory and a coroutine cannot be marshalled.
#     State crosses through `call()` (JSON over the control channel) or
#     the cluster's own wire protocol, full stop.
#
# A ProcShardPool never touches the GIL switch interval: its shards do
# not share an interpreter, so the 0.5 ms override would be a pure
# context-switch tax on the parent (and the refcount above keeps a
# concurrently-live thread pool's override correct in mixed mode).


class _WorkerShard:
    """In-worker identity stub: `pool_for()` / `shard_index_of()` inside
    a spawned worker process resolve to this, so shard labels (loopprof
    gauges, `OSD.shard` in daemon status) carry the POOL-WIDE shard
    index the parent assigned — not a pid-local counter. Cross-process
    conveniences are structurally absent: state is marshalled over the
    admin-socket control channel."""

    backend = "process"

    def __init__(self, name: str, index: int):
        self.name = name
        self.index = index

    def shared(self, key: str, factory: Callable[[], Any]) -> Any:
        raise NotImplementedError(
            "shared() inside a process-backed shard: cross-process "
            "memory does not exist — marshal state over the control "
            "channel or the cluster wire protocol")


def adopt_worker_shard(index: int, name: str = "reactor") -> None:
    """Register the RUNNING loop as pool-wide shard `index` of a
    process-backed pool (called once by the worker entry point before
    any daemon boots, so every loop-keyed service sees the identity)."""
    _register(asyncio.get_running_loop(), _WorkerShard(name, index), index)


class _ProcWorker:
    """Parent-side record of one spawned shard worker."""

    __slots__ = ("index", "proc", "socket_path", "boot_specs",
                 "osd_overrides", "alive", "generation")

    def __init__(self, index: int):
        self.index = index
        self.proc: subprocess.Popen | None = None
        self.socket_path = ""
        # whoami -> boot_osd request payload; respawn() replays these so
        # a killed worker's daemons rejoin under their original ids
        self.boot_specs: dict[int, dict] = {}
        # whoami -> {option: value} set through a per-OSD handle
        # (WorkerOSDRef.config_set); replayed after a respawned boot so
        # a rejoining daemon keeps its operator-set knobs too
        self.osd_overrides: dict[int, dict] = {}
        self.alive = False
        self.generation = 0


class ProcShardPool:
    """`reactor_procs` worker PROCESSES plus the calling loop (shard 0).

    Placement mirrors the thread pool — OSDs round-robin over the
    workers (shard indices 1..n) while the mon/mgr/clients stay on the
    parent loop — but each worker is a spawned interpreter running
    `ceph_tpu_torch.utils.reactor_worker`, so shard parallelism is deliverable
    CPU parallelism, not GIL time-slicing. Construction spawns the
    processes; `await start()` waits for every control channel to come
    up and arms the supervisor. `shutdown()` drains workers through the
    `shutdown` verb (each worker bounded-stops its daemons and reaps its
    loop's stragglers before exiting), then reaps the processes — the
    parent side leaves no pending tasks behind (conftest leak gate)."""

    backend = "process"
    START_TIMEOUT = 30.0
    SUPERVISE_INTERVAL_S = 0.25

    def __init__(self, num_procs: int, name: str = "reactor",
                 base_dir: str | None = None):
        if num_procs < 1:
            raise ValueError("a process pool needs at least one worker")
        self.name = name
        self.num_procs = num_procs
        self._closed = False
        self._started = False
        self._loop0 = asyncio.get_running_loop()
        self._supervisor: asyncio.Task | None = None
        self._own_dir = base_dir is None
        self._dir = base_dir or tempfile.mkdtemp(prefix="reactor-proc-")
        # operator-set hot knobs, replayed onto a respawned worker's
        # re-booted OSDs so it rejoins with the SAME effective config as
        # its peers (a fresh process knows nothing of earlier
        # broadcasts). Values are (seq, value): per-OSD and pool-wide
        # settings replay in their ORIGINAL chronological order, so the
        # newest write wins after a respawn exactly as it did live.
        self._config_overrides: dict[str, tuple[int, Any]] = {}
        self._override_seq = 0
        self._workers = [_ProcWorker(i + 1) for i in range(num_procs)]
        _register(self._loop0, self, 0)
        try:
            for w in self._workers:
                self._spawn(w)
        except BaseException:
            self._kill_all()
            for w in self._workers:
                if w.socket_path:
                    try:
                        os.unlink(w.socket_path)
                    except OSError:
                        pass
            if self._own_dir:
                try:
                    os.rmdir(self._dir)
                except OSError:
                    pass
            _unregister(self._loop0, self)
            raise

    # -- spawn / supervise ----------------------------------------------------

    def _spawn(self, w: _ProcWorker) -> None:
        if w.socket_path:
            # a SIGKILLed worker never unlinked its previous-generation
            # socket; reap the file here or crash/respawn cycles leak
            # them (and keep our own mkdtemp dir from ever emptying)
            try:
                os.unlink(w.socket_path)
            except OSError:
                pass
        w.generation += 1
        w.socket_path = os.path.join(
            self._dir, f"rw{w.index}.{w.generation}.sock")
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get(
            "PYTHONPATH", "")
        # device-affine card partitioning: worker j of W serves the
        # round-robin slice devs[j::W] (devs[:1] when there are fewer
        # cards than workers), so per-card warmth stays process-local
        # (device.resolve_all reads this where it lists every card)
        env["CEPH_TPU_OFFLOAD_DEVICE_PARTITION"] = \
            f"{w.index - 1}/{self.num_procs}"
        w.proc = subprocess.Popen(
            [sys.executable, "-m", "ceph_tpu_torch.utils.reactor_worker",
             "--index", str(w.index), "--socket", w.socket_path,
             "--pool-name", self.name],
            env=env, stdout=subprocess.DEVNULL)
        w.alive = True
        dout("reactor", 2, f"{self.name}: worker shard{w.index} spawned "
                           f"(pid {w.proc.pid})")

    async def start(self, timeout: float | None = None) -> None:
        """Wait until every worker's control channel answers, then arm
        the supervisor. Must run on the creating (shard 0) loop."""
        await self._wait_ready(self._workers, timeout)
        if self._supervisor is None:
            self._supervisor = asyncio.get_running_loop().create_task(
                self._supervise())
        self._started = True
        dout("reactor", 1,
             f"{self.name}: {self.num_procs} worker process(es) up")

    async def _wait_ready(self, workers: list[_ProcWorker],
                          timeout: float | None = None) -> None:
        deadline = time.monotonic() + (timeout or self.START_TIMEOUT)
        for w in workers:
            while True:
                if w.proc is not None and w.proc.poll() is not None:
                    raise RuntimeError(
                        f"{self.name} worker shard{w.index} exited "
                        f"rc={w.proc.returncode} before its control "
                        f"channel came up")
                try:
                    await self.call(w.index, "version", timeout=2.0)
                    break
                except Exception:
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"{self.name} worker shard{w.index} control "
                            f"channel never came up") from None
                    await asyncio.sleep(0.05)

    async def _supervise(self) -> None:
        """Reap dead workers promptly: a SIGKILLed (or crashed) worker
        must not linger as a zombie, and its death is WARN-logged — the
        mark-down of its OSDs rides the existing peer-heartbeat
        reporter-quorum path, no parent intervention needed."""
        while True:
            await asyncio.sleep(self.SUPERVISE_INTERVAL_S)
            for w in self._workers:
                if w.alive and w.proc is not None \
                        and w.proc.poll() is not None:
                    w.proc.wait()       # already exited: reap, no block
                    w.alive = False
                    dout("reactor", 1,
                         f"{self.name}: worker shard{w.index} died "
                         f"(rc {w.proc.returncode}); reaped — its OSDs "
                         f"will be marked down via heartbeat loss")
                    flight.record("worker_death", f"shard{w.index}",
                                  pool=self.name, pid=w.proc.pid,
                                  rc=w.proc.returncode,
                                  osds=sorted(w.boot_specs))

    # -- placement / identity -------------------------------------------------

    @property
    def num_shards(self) -> int:
        return self.num_procs + 1

    def place(self, seq: int) -> int:
        """Round-robin WORKER shard for the seq-th data-plane daemon
        (never 0: the parent keeps the control plane)."""
        return 1 + seq % self.num_procs

    def loop(self, index: int) -> asyncio.AbstractEventLoop:
        if index != 0:
            raise NotImplementedError(
                f"shard {index} runs in another process: its loop is "
                f"not addressable from the parent — use call()")
        return self._loop0

    def worker_alive(self, index: int) -> bool:
        return self._worker(index).alive

    def worker_pid(self, index: int) -> int | None:
        w = self._worker(index)
        return w.proc.pid if w.proc is not None else None

    def _worker(self, index: int) -> _ProcWorker:
        if not 1 <= index <= self.num_procs:
            raise IndexError(f"no worker shard {index}")
        return self._workers[index - 1]

    # -- rejected thread-pool conveniences ------------------------------------

    def shared(self, key: str, factory: Callable[[], Any]) -> Any:
        raise NotImplementedError(
            "ProcShardPool.shared(): cross-process memory does not "
            "exist — marshal explicit state through call() (the "
            "admin-socket control channel) instead")

    async def run_on(self, index: int, coro) -> Any:
        coro.close()        # unawaited-coroutine warning suppression
        raise NotImplementedError(
            "ProcShardPool.run_on(): a coroutine (and anything its "
            "closure captures) cannot cross a process boundary — use "
            "call(index, request) with JSON-marshalled arguments")

    # -- control channel ------------------------------------------------------

    async def call(self, index: int, request: dict | str,
                   timeout: float = 30.0) -> Any:
        """One JSON verb to worker `index` over its admin-socket
        control channel (executor-hopped: the parent loop never blocks
        on the socket). Raises RuntimeError on a verb-level error."""
        from ceph_tpu_torch.utils.admin_socket import admin_command
        w = self._worker(index)
        resp = await asyncio.get_running_loop().run_in_executor(
            None, functools.partial(admin_command, w.socket_path,
                                    request, timeout))
        if "error" in resp:
            raise RuntimeError(f"worker shard{index}: {resp['error']}")
        return resp.get("result")

    async def config_set(self, name: str, value) -> dict:
        """Propagate one hot-togglable option to every live worker's
        daemons: each worker applies it to its OSDs' Configs, so the
        observers (offload batcher, pipeline depth, profiler, SLO
        engine...) fire in the owning process exactly as they would
        from an operator's `config set`. Recorded once ANY worker
        accepted it — so respawn() replays it onto a rejoining worker,
        while a key/value every worker rejected is not replayed
        forever. A worker whose channel is already dead (it is being
        reaped; a respawn replays the recorded overrides anyway) must
        not abort the broadcast for the rest — the live workers are
        driven CONCURRENTLY so one wedged channel cannot stack
        timeouts either. With NO live workers the override is recorded
        unconditionally: deferring it to the respawn replay is the
        whole point of the record."""
        live = [w for w in self._workers if w.alive]

        async def one(w: _ProcWorker):
            try:
                return await self.call(
                    w.index, {"prefix": "config set", "key": name,
                              "value": value}), None
            except Exception as e:
                return {"error": str(e)}, str(e)

        results = await asyncio.gather(*[one(w) for w in live])
        out = {f"shard{w.index}": res
               for w, (res, _err) in zip(live, results)}
        errors = {f"shard{w.index}": err
                  for w, (_res, err) in zip(live, results)
                  if err is not None}
        if errors and len(errors) == len(live):
            raise RuntimeError(
                f"{self.name}: config set {name} accepted by no "
                f"worker: {errors}")
        self._override_seq += 1
        self._config_overrides[name] = (self._override_seq, value)
        return out

    async def boot_osd(self, whoami: int,
                       mon_addrs: list[tuple[str, int]],
                       crush_location: dict | None = None,
                       timeout: float = 60.0,
                       device: str = "cuda") -> dict:
        """Boot OSD `whoami` on `device` in its placed worker; the spec
        is recorded so respawn() can replay it. A worker that cannot
        open the device fails the boot (DeviceUnavailable in the
        RuntimeError's message)."""
        if self._closed:
            raise RuntimeError(f"{self.name}: pool is shut down")
        idx = self.place(whoami)
        spec = {"whoami": whoami,
                "mon_addrs": [list(a) for a in mon_addrs],
                "crush_location": crush_location, "device": device}
        res = await self.call(idx, {"prefix": "boot_osd", **spec},
                              timeout=timeout)
        # record AFTER the worker accepted: a failed boot the caller
        # never admitted must not be replayed by a later respawn (the
        # same record-after-accept rule as config_set)
        self._worker(idx).boot_specs[whoami] = spec
        res["shard"] = idx
        return res

    def record_osd_override(self, whoami: int, name: str,
                            value) -> None:
        """Remember a per-OSD knob (WorkerOSDRef.config_set) so a
        respawned worker replays it onto that daemon's fresh boot, in
        chronological order with the pool-wide broadcasts."""
        w = self._worker(self.place(whoami))
        self._override_seq += 1
        w.osd_overrides.setdefault(whoami, {})[name] = \
            (self._override_seq, value)

    async def stop_osd(self, whoami: int, timeout: float = 30.0) -> None:
        idx = self.place(whoami)
        await self.call(idx, {"prefix": "stop_osd", "whoami": whoami},
                        timeout=timeout)
        # untrack only after the worker confirmed the stop: a failed
        # stop leaves a running daemon, and a later respawn must still
        # know about it
        self._worker(idx).boot_specs.pop(whoami, None)
        self._worker(idx).osd_overrides.pop(whoami, None)

    async def inject_crash(self, index: int) -> dict:
        """Drive the worker's faultinject `crash` verb: the worker
        SIGKILLs itself — heartbeat silence, reporter quorum, mark-down,
        exactly like an OOM-killed production daemon host. The SIGKILL
        deliberately races the JSON reply (that's the point of a
        crash): a connection torn down before the response flushed
        still means the kill fired."""
        import json
        flight.record("inject_crash", f"shard{index}", pool=self.name,
                      osds=sorted(self._worker(index).boot_specs))
        try:
            return await self.call(index, {"prefix": "inject",
                                           "what": "crash"},
                                   timeout=10.0)
        except (json.JSONDecodeError, OSError, ValueError):
            return {"injected": "crash", "shard": index,
                    "confirmed": False}

    async def respawn(self, index: int, timeout: float | None = None) -> dict:
        """Replace a dead worker with a fresh process and re-boot its
        recorded OSDs (fresh stores; recovery repopulates them)."""
        if self._closed:
            # shutdown is idempotent and already ran (or is running):
            # spawning now would orphan a process nothing ever reaps
            raise RuntimeError(f"{self.name}: pool is shut down")
        w = self._worker(index)
        if w.alive:
            raise RuntimeError(f"worker shard{index} is still alive")
        self._spawn(w)
        await self._wait_ready([w], timeout)
        booted = []
        for spec in list(w.boot_specs.values()):
            res = await self.call(index, {"prefix": "boot_osd", **spec},
                                  timeout=60.0)
            booted.append(res)
        # replay the operator's hot knobs — pool-wide broadcasts AND
        # per-OSD handle settings, in their ORIGINAL chronological
        # order (a broadcast that superseded a per-OSD value must win
        # again): a fresh process knows nothing of earlier config_set
        # calls, and rejoining with defaults while peers run tightened
        # values diverges the cluster silently
        replays = [(seq, None, name, value)
                   for name, (seq, value)
                   in self._config_overrides.items()]
        replays += [(seq, whoami, name, value)
                    for whoami, opts in w.osd_overrides.items()
                    if whoami in w.boot_specs
                    for name, (seq, value) in opts.items()]
        for _seq, whoami, name, value in sorted(replays):
            req = {"prefix": "config set", "key": name, "value": value}
            if whoami is not None:
                req["whoami"] = whoami
            try:
                await self.call(index, req)
            except Exception as e:
                dout("reactor", 1,
                     f"{self.name}: shard{index} config replay "
                     f"{name}={value!r} failed ({e})")
        dout("reactor", 1, f"{self.name}: worker shard{index} respawned "
                           f"(pid {w.proc.pid}), {len(booted)} OSD(s) "
                           f"re-booted")
        flight.record("worker_respawn", f"shard{index}", pool=self.name,
                      pid=w.proc.pid, osds_rebooted=len(booted))
        return {"pid": w.proc.pid, "osds": booted}

    # -- cross-process observability ------------------------------------------

    async def profile_stats(self) -> dict:
        """Pool-wide loop profiler view: the parent's own shard stats
        merged with every live worker's (`profile dump` over the
        control channel), keyed by POOL-WIDE shard label, plus the
        cross-process busy skew the bench trend guard watches."""
        from ceph_tpu_torch.utils import loopprof
        # the parent contributes ONLY its own shard-0 loop: the
        # process-wide _per_loop store can carry stale shard1..N labels
        # from an earlier THREAD-pool profiling run in this process,
        # which would contaminate the identically-labeled worker stats
        parts = [{lbl: d for lbl, d in loopprof.shard_stats().items()
                  if lbl == "shard0"}]
        for w in self._workers:
            if not w.alive:
                continue
            try:
                prof = await self.call(w.index, "profile dump")
                parts.append(prof.get("shards", {}))
            except Exception as e:
                dout("reactor", 3,
                     f"{self.name}: shard{w.index} profile fetch "
                     f"failed ({type(e).__name__}: {e})")
        shards = loopprof.merge_shard_stats(*parts)
        # skew over the WORKER shards only: shard 0 is the control
        # plane and hosts no OSDs by design here (unlike the thread
        # pool), so including its near-idle loop would pin the skew at
        # ~1.0 and bury real worker imbalance
        workers = {lbl: d for lbl, d in shards.items()
                   if lbl != "shard0"}
        return {"shards": shards,
                "shard_busy_skew": loopprof.shard_busy_skew(workers)}

    # -- lifecycle ------------------------------------------------------------

    def _kill_all(self) -> None:
        for w in self._workers:
            if w.proc is not None and w.proc.poll() is None:
                try:
                    w.proc.kill()
                    w.proc.wait(5.0)
                except Exception:
                    pass
            w.alive = False

    async def shutdown(self, timeout: float = 20.0) -> None:
        """Drain and reap every worker (idempotent): graceful shutdown
        verb first (the worker bounded-stops its daemons and reaps its
        loop before exiting), escalate to SIGTERM/SIGKILL on a wedge."""
        if self._closed:
            return
        self._closed = True
        if self._supervisor is not None:
            await reap_all([self._supervisor])
            self._supervisor = None
        loop = asyncio.get_running_loop()

        async def drain(w: _ProcWorker) -> None:
            if w.proc is None:
                return
            if w.alive and w.proc.poll() is None:
                try:
                    await self.call(w.index, "shutdown", timeout=5.0)
                except Exception:
                    pass
            try:
                await asyncio.wait_for(loop.run_in_executor(
                    None, w.proc.wait), timeout)
            except Exception:
                dout("reactor", 1, f"{self.name}: worker shard{w.index} "
                                   f"did not exit cleanly; killing")
                try:
                    w.proc.send_signal(signal.SIGTERM)
                    await asyncio.wait_for(loop.run_in_executor(
                        None, w.proc.wait), 5.0)
                except Exception:
                    w.proc.kill()
                    await loop.run_in_executor(None, w.proc.wait)
            w.alive = False
            try:
                os.unlink(w.socket_path)
            except OSError:
                pass

        # drain workers CONCURRENTLY: the per-worker verb/wait/escalate
        # chains are independent, and a serial drain would cost
        # num_procs x timeout wall clock when several workers wedge
        await asyncio.gather(*[drain(w) for w in self._workers])
        if self._own_dir:
            try:
                os.rmdir(self._dir)
            except OSError:
                pass
        _unregister(self._loop0, self)
        dout("reactor", 1, f"{self.name}: process pool down")
