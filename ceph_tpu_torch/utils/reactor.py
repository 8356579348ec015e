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

The port's copy of the thread half of ceph_tpu/utils/reactor.py
(jax-free; the port imports nothing of the JAX package). The
process-backed pool (`ProcShardPool`, its worker entry point) comes
with the OSD daemon, which its workers boot.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import sys
import threading
from typing import Any, Callable

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
