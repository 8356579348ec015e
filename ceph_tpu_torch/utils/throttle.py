"""Throttle + HeartbeatMap + AdjustableSemaphore: backpressure and
stuck-thread detection.

Re-creations of the reference's `Throttle` (src/common/Throttle.{h,cc}:
blocking counted-resource budget used on every IO path) and
`HeartbeatMap` (src/common/HeartbeatMap.{h,cc}: every worker thread
checks in with a grace deadline; `is_healthy` flags stuck threads and a
suicide grace escalates to process abort). `AdjustableSemaphore` is the
AsyncReserver analog's slot pool, resizable live so reservation-backed
knobs (osd_max_recovery_in_flight) can be retuned mid-storm.

The port's copy of ceph_tpu/utils/throttle.py (jax-free; the
port imports nothing of the JAX package).
"""
from __future__ import annotations

import asyncio
import threading
import time

from ceph_tpu_torch.utils import sanitizer


class AdjustableSemaphore(asyncio.Semaphore):
    """asyncio.Semaphore whose slot count can be resized while held.

    Growing releases the extra slots immediately (waiters wake);
    shrinking takes free slots now and absorbs the rest as current
    holders release — in-flight work is never cancelled, the pool just
    refills to the smaller limit (the reference's AsyncReserver adjusts
    max_allowed the same way). Implemented as a release-absorption debt
    rather than driving `_value` negative: 3.10.9+/3.12 Semaphore's
    acquire() fast-paths on `locked()` (`_value == 0 or waiters`), so a
    negative `_value` would pass every acquire and DISABLE the throttle
    exactly when a mid-storm shrink needs it. Must be resized from the
    owning event loop's thread.
    """

    def __init__(self, value: int, name: str | None = None):
        super().__init__(value)
        #: lockdep identity: named semaphores register every acquire
        #: with the sanitizer's order graph + wait-for graph exactly
        #: like make_lock() locks; anonymous ones stay untracked
        self.name = name
        #: attribution merged into the wait record (entity=..., so the
        #: distributed probe can ship this wait in MgrReports)
        self.lockdep_detail: dict = {}
        self._limit = value
        self._debt = 0      # releases to absorb instead of freeing
        #: the loop the semaphore is bound to, captured at first
        #: acquire. Under the sharded reactor a release/resize issued
        #: from another shard's loop (or a plain thread) must NOT touch
        #: `_value`/`_debt`/the waiter queue directly — they are
        #: owner-loop state, and a cross-thread mutation corrupts the
        #: count or wakes a waiter on the wrong loop. Foreign callers
        #: are marshalled across with call_soon_threadsafe.
        self._owner_loop: asyncio.AbstractEventLoop | None = None

    async def acquire(self) -> bool:
        if self._owner_loop is None:
            self._owner_loop = asyncio.get_running_loop()
        if self.name is None or not sanitizer.lockdep_enabled():
            return await super().acquire()
        sanitizer.lockdep_will_lock(self.name)
        token = sanitizer.lockdep_wait_start(self.name, kind="semaphore",
                                             **self.lockdep_detail)
        try:
            ok = await super().acquire()
        finally:
            sanitizer.lockdep_wait_end(token)
        if ok:
            sanitizer.lockdep_locked(self.name)
        return ok

    async def acquire_timeout(self, timeout: float) -> bool:
        """Bounded acquire that keeps lockdep attribution in THIS
        context. `asyncio.wait_for(sem.acquire(), t)` runs acquire()
        inside an ephemeral wrapper task, so the hold would be charged
        to a context that is already dead — and a wait-for-graph cycle
        through this semaphore could never close on the real holder.
        Raises asyncio.TimeoutError like wait_for."""
        if self._owner_loop is None:
            self._owner_loop = asyncio.get_running_loop()
        if self.name is None or not sanitizer.lockdep_enabled():
            return await asyncio.wait_for(super().acquire(), timeout)
        sanitizer.lockdep_will_lock(self.name)
        token = sanitizer.lockdep_wait_start(self.name, kind="semaphore",
                                             **self.lockdep_detail)
        try:
            ok = await asyncio.wait_for(super().acquire(), timeout)
        finally:
            sanitizer.lockdep_wait_end(token)
        if ok:
            sanitizer.lockdep_locked(self.name)
        return ok

    @property
    def limit(self) -> int:
        return self._limit

    def _foreign_caller(self) -> bool:
        """True when called off the owning loop (another shard's loop
        thread, or no loop at all) while the owner is still alive."""
        owner = self._owner_loop
        if owner is None or owner.is_closed():
            return False
        try:
            return asyncio.get_running_loop() is not owner
        except RuntimeError:
            return True

    def resize(self, new_limit: int) -> None:
        if self._foreign_caller():
            self._owner_loop.call_soon_threadsafe(self._resize_impl,
                                                  new_limit)
            return
        self._resize_impl(new_limit)

    def _resize_impl(self, new_limit: int) -> None:
        new_limit = max(1, int(new_limit))
        delta = new_limit - self._limit
        self._limit = new_limit
        if delta > 0:
            # pay down any absorption debt first; free the remainder
            pay = min(self._debt, delta)
            self._debt -= pay
            for _ in range(delta - pay):
                self._release_impl()
        elif delta < 0:
            shrink = -delta
            take_now = min(self._value, shrink)
            self._value -= take_now
            self._debt += shrink - take_now

    def release(self) -> None:
        if self.name is not None and sanitizer.lockdep_enabled():
            # in the RELEASER's context: lockdep falls back to any
            # holder entry when a semaphore is handed across contexts
            sanitizer.lockdep_unlocked(self.name)
        if self._foreign_caller():
            # acquired on shard A, released on shard B: hand the
            # release to the owning loop whole (count mutation AND
            # waiter wakeup), so `_value` can never lose an update
            self._owner_loop.call_soon_threadsafe(self._release_impl)
            return
        self._release_impl()

    def _release_impl(self) -> None:
        if self._debt > 0:
            self._debt -= 1     # absorbed: the pool shrank past this slot
            return
        super().release()


class Throttle:
    """Blocking budget of `max_count` units (bytes, ops, ...)."""

    def __init__(self, name: str, max_count: int):
        self.name = name
        #: lockdep resource identity — prefixed so a Throttle can never
        #: alias a TrackedLock/semaphore of the same short name
        self._lockdep_name = f"throttle:{name}"
        self._max = max_count
        self._count = 0
        self._cond = threading.Condition()

    @property
    def current(self) -> int:
        with self._cond:
            return self._count

    @property
    def max(self) -> int:
        with self._cond:
            return self._max

    def reset_max(self, max_count: int) -> None:
        with self._cond:
            self._max = max_count
            self._cond.notify_all()

    def get(self, count: int = 1, timeout: float | None = None) -> bool:
        """Block until `count` units fit (or timeout). Requests larger than
        the whole budget are admitted alone, like the reference."""
        tracked = sanitizer.lockdep_enabled()
        if tracked:
            sanitizer.lockdep_will_lock(self._lockdep_name)
        token = None
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            with self._cond:
                while not self._fits(count):
                    if tracked and token is None:
                        token = sanitizer.lockdep_wait_start(
                            self._lockdep_name, kind="throttle")
                    remaining = None if deadline is None else \
                        deadline - time.monotonic()
                    if remaining is not None and remaining <= 0:
                        return False
                    self._cond.wait(remaining)
                self._count += count
        finally:
            sanitizer.lockdep_wait_end(token)
        if tracked:
            sanitizer.lockdep_locked(self._lockdep_name)
        return True

    def take(self, count: int = 1) -> int:
        """Unconditionally take (may exceed max) — reference Throttle::take."""
        with self._cond:
            self._count += count
            taken = self._count
        if sanitizer.lockdep_enabled():
            sanitizer.lockdep_locked(self._lockdep_name)
        return taken

    def get_or_fail(self, count: int = 1) -> bool:
        with self._cond:
            if not self._fits(count):
                return False
            self._count += count
        if sanitizer.lockdep_enabled():
            sanitizer.lockdep_locked(self._lockdep_name)
        return True

    def put(self, count: int = 1) -> int:
        if sanitizer.lockdep_enabled():
            sanitizer.lockdep_unlocked(self._lockdep_name)
        with self._cond:
            self._count = max(0, self._count - count)
            self._cond.notify_all()
            return self._count

    def _fits(self, count: int) -> bool:
        if self._max <= 0:
            return True
        if count >= self._max:
            return self._count == 0
        return self._count + count <= self._max


class HeartbeatHandle:
    def __init__(self, name: str, grace: float, suicide_grace: float):
        self.name = name
        self.grace = grace
        self.suicide_grace = suicide_grace
        self.deadline = 0.0
        self.suicide_deadline = 0.0
        self.suicide_fired = False

    def reset(self, now: float) -> None:
        self.deadline = now + self.grace
        self.suicide_deadline = now + self.suicide_grace if \
            self.suicide_grace > 0 else 0.0
        self.suicide_fired = False


class HeartbeatMap:
    """Worker-thread liveness registry (HeartbeatMap.h)."""

    def __init__(self, on_suicide=None):
        self._lock = threading.Lock()
        self._handles: dict[int, HeartbeatHandle] = {}
        self._next = 0
        self._on_suicide = on_suicide

    def add_worker(self, name: str, grace: float,
                   suicide_grace: float = 0.0) -> int:
        with self._lock:
            hid = self._next
            self._next += 1
            handle = HeartbeatHandle(name, grace, suicide_grace)
            handle.reset(time.monotonic())
            self._handles[hid] = handle
            return hid

    def remove_worker(self, hid: int) -> None:
        with self._lock:
            self._handles.pop(hid, None)

    def touch(self, hid: int) -> None:
        """The worker's check-in (reset_timeout)."""
        now = time.monotonic()
        with self._lock:
            handle = self._handles.get(hid)
            if handle is not None:
                handle.reset(now)

    def is_healthy(self) -> tuple[bool, list[str]]:
        """(healthy, names of overdue workers); fires on_suicide for any
        worker past its suicide grace."""
        now = time.monotonic()
        unhealthy = []
        suicides = []
        with self._lock:
            for handle in self._handles.values():
                if now > handle.deadline:
                    unhealthy.append(handle.name)
                if handle.suicide_deadline and now > handle.suicide_deadline \
                        and not handle.suicide_fired:
                    handle.suicide_fired = True  # escalate exactly once
                    suicides.append(handle.name)
        for name in suicides:
            if self._on_suicide is not None:
                self._on_suicide(name)
        return (not unhealthy, unhealthy)
