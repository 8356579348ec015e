"""Seed-deterministic schedule-interleaving explorer.

Op completion order is a real degree of freedom (same-PG ops to
different objects execute concurrently behind the ordered pg-log
slice), daemons run on N reactor threads, and the offload service
coalesces work opportunistically — so "the tests pass" increasingly
means "the tests pass under the one schedule asyncio happened to
pick". This module makes the schedule an *input*: it wraps an event
loop so ready-callback order is bounded-shuffled and explicit yield
points stretch the racy windows, with every decision derived from
`(seed, site, per-site counter)` exactly like qa/faultinject — one
seed IS one schedule, replayable bit-identically.

Mechanics:

  * `loop.call_soon` is wrapped: each callback consults the explorer
    and is either posted immediately or DEFERRED by k ready-queue
    round-trips (k <= max_defer, drawn from the seed). A deferred
    callback is re-posted through the original call_soon each hop, so
    the loop always owns it — no starvation, no deadlock, every
    callback runs within a bounded number of rounds. Reader/writer
    (socket) callbacks bypass call_soon and are not shuffled; task
    steps and future completions — the bulk of scheduling decisions —
    all pass through here.
  * `maybe_yield(site)` hooks at the racy product seams (messenger
    dispatch, the PG execution slice, offload batch dispatch) insert
    0..max_yields `sleep(0)` suspensions, again seed-derived, widening
    windows a convoyed 2-core CI box would otherwise never open.
  * every ACTED decision appends `(site, n, action)` to the schedule
    log; `digest()` hashes it, and the qa tier asserts same seed =>
    same digest twice in a row (the replay contract).

The explorer composes with qa/faultinject (inject faults INTO a chosen
schedule) and with the sanitizer's generation guards / lockset
recorder (catch the corruption the schedule exposes at its source).

The port's copy of ceph_tpu/qa/interleave.py: the same seed draws the
same decisions in both packages.
"""
from __future__ import annotations

import asyncio
import contextlib
import functools
import hashlib
import os
import random
import threading
from typing import Any

from ceph_tpu_torch.utils import loophook

#: retained schedule-log entries (the digest covers ALL decisions via
#: a running hash, so truncation never weakens the replay contract)
LOG_CAP = 65536

#: module flag mirroring "any explorer installed": the product yield
#: hooks pay one attribute read when exploration is off
_armed = False
_installed: dict[asyncio.AbstractEventLoop, "Explorer"] = {}


def armed() -> bool:
    return _armed


class Explorer:
    """One seeded schedule: per-site counters + decision log."""

    def __init__(self, seed: int = 0, defer_p: float = 0.3,
                 max_defer: int = 3, yield_p: float = 0.3,
                 max_yields: int = 2):
        self.seed = int(seed)
        self.defer_p = float(defer_p)
        self.max_defer = max(1, int(max_defer))
        self.yield_p = float(yield_p)
        self.max_yields = max(1, int(max_yields))
        self.log: list[tuple[str, int, str]] = []
        self.decisions = 0
        self._counts: dict[str, int] = {}
        self._hash = hashlib.sha256(str(self.seed).encode())
        # counters/log mutate from every shard thread the explorer is
        # installed on; decisions are lock-cheap
        self._lock = threading.Lock()

    # -- deterministic decisions ---------------------------------------------

    def _draw(self, site: str) -> tuple[float, int]:
        """One uniform draw for event n of `site`: a pure function of
        (seed, site, n), independent of cross-site interleaving — the
        same derivation contract as qa/faultinject."""
        n = self._counts.get(site, 0)
        self._counts[site] = n + 1
        return random.Random(f"{self.seed}:{site}:{n}").random(), n

    def _note(self, site: str, n: int, action: str) -> None:
        entry = f"{site}#{n}:{action}"
        self._hash.update(entry.encode())
        self.log.append((site, n, action))
        if len(self.log) > LOG_CAP:
            del self.log[: len(self.log) - LOG_CAP]

    def decide_defer(self, site: str) -> int:
        """Ready-queue hops to defer a callback by (0 = run in order)."""
        with self._lock:
            self.decisions += 1
            u, n = self._draw(site)
            if u >= self.defer_p:
                return 0
            k = 1 + random.Random(
                f"{self.seed}:defer:{site}:{n}").randrange(self.max_defer)
            self._note(site, n, f"defer{k}")
            return k

    def decide_yields(self, site: str) -> int:
        """sleep(0) suspensions to insert at a yield point (0 = none)."""
        with self._lock:
            self.decisions += 1
            u, n = self._draw(site)
            if u >= self.yield_p:
                return 0
            k = 1 + random.Random(
                f"{self.seed}:yield:{site}:{n}").randrange(self.max_yields)
            self._note(site, n, f"yield{k}")
            return k

    # -- replay surface -------------------------------------------------------

    def digest(self) -> str:
        """Running hash over every acted decision: two runs of the same
        workload under the same seed produce the same digest."""
        with self._lock:
            return self._hash.hexdigest()

    def status(self) -> dict:
        with self._lock:
            return {"seed": self.seed,
                    "decisions": self.decisions,
                    "acted": len(self.log),
                    "digest": self._hash.hexdigest(),
                    "log_tail": [list(e) for e in self.log[-50:]]}


class _DeferredHandle:
    """Handle-shaped proxy for a deferred callback: `cancel()` works
    across hops (each hop re-checks before re-posting)."""

    __slots__ = ("real", "_cancelled")

    def __init__(self):
        self.real: asyncio.Handle | None = None
        self._cancelled = False

    def cancel(self) -> None:
        self._cancelled = True
        if self.real is not None:
            self.real.cancel()

    def cancelled(self) -> bool:
        return self._cancelled


def _site_of(cb) -> str:
    """Stable schedule-site name for a ready callback. Task steps name
    the task's coroutine code location (deterministic across runs,
    unlike task names/ids); plain callbacks name their code object."""
    owner = getattr(cb, "__self__", None)
    if isinstance(owner, asyncio.Task):
        coro = owner.get_coro()
        code = getattr(coro, "cr_code", None) or \
            getattr(coro, "gi_code", None)
        if code is not None:
            return (f"task:{os.path.basename(code.co_filename)}:"
                    f"{code.co_firstlineno}")
        return "task:?"
    f = cb
    while isinstance(f, functools.partial):
        f = f.func
    code = getattr(f, "__code__", None)
    if code is not None:
        return (f"cb:{os.path.basename(code.co_filename)}:"
                f"{code.co_firstlineno}")
    return f"cb:{getattr(f, '__qualname__', type(f).__name__)}"


def install(loop: asyncio.AbstractEventLoop, explorer: Explorer) -> None:
    """Arm `explorer` on `loop`: wrap call_soon with the bounded
    shuffler. Idempotent per loop (the newest explorer wins)."""
    global _armed

    def make(orig):
        def call_soon(callback, *args, **kwargs):
            # armed-gate at CALL time: a buried wrapper can outlive
            # uninstall (see utils/loophook) and must pass through
            ex = _installed.get(loop)
            if ex is None or getattr(callback, "_ilv_hop", False):
                return orig(callback, *args, **kwargs)
            k = ex.decide_defer(_site_of(callback))
            if k <= 0:
                return orig(callback, *args, **kwargs)
            box = _DeferredHandle()

            def hop(remaining):
                if box._cancelled:
                    return
                if remaining <= 0:
                    # the callback runs in its OWN handle (exception
                    # context, cancellation) — hops only reorder it
                    box.real = orig(callback, *args, **kwargs)
                else:
                    box.real = orig(hop, remaining - 1)

            hop._ilv_hop = True
            box.real = orig(hop, k - 1)
            return box
        return call_soon

    loophook.wrap(loop, "ilv_call_soon", make)
    _installed[loop] = explorer
    _armed = True


def uninstall(loop: asyncio.AbstractEventLoop) -> None:
    """Disarm (already-deferred callbacks still run via the original
    call_soon — nothing is dropped; a buried wrapper stays in the
    chain as a pass-through, see utils/loophook)."""
    global _armed
    _installed.pop(loop, None)
    loophook.unwrap(loop, "ilv_call_soon")
    _armed = bool(_installed)


def explorer_for(loop) -> Explorer | None:
    return _installed.get(loop)


def current_explorer() -> Explorer | None:
    try:
        return _installed.get(asyncio.get_running_loop())
    except RuntimeError:
        return None


async def yield_point(site: str) -> None:
    """Product-seam hook: suspend 0..max_yields times, seed-derived.
    Call sites gate on `interleave.armed()` so the disarmed cost is
    one module-attribute read."""
    ex = current_explorer()
    if ex is None:
        return
    for _ in range(ex.decide_yields(site)):
        await asyncio.sleep(0)


@contextlib.asynccontextmanager
async def explore(seed: int, **kw: Any):
    """Arm a fresh Explorer on the running loop for the block:

        async with interleave.explore(seed=7) as ex:
            ...workload...
        digest = ex.digest()
    """
    ex = Explorer(seed, **kw)
    loop = asyncio.get_running_loop()
    install(loop, ex)
    try:
        yield ex
    finally:
        uninstall(loop)
