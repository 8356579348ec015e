"""Throttle: backpressure by a blocking counted-resource budget.

Re-creation of the reference's `Throttle` (src/common/Throttle.{h,cc}:
the budget used on every IO path). The port's copy of the `Throttle`
class of ceph_tpu/utils/throttle.py, without its `sanitizer.lockdep_*`
hooks (the sanitizer is not ported yet) and without the blocking `get`,
which no port module calls (the offload service admits through
`get_or_fail`/`take` on its event loop). The module's other classes
(`AdjustableSemaphore`, `HeartbeatMap`) come with the modules that use
them.
"""
from __future__ import annotations

import threading


class Throttle:
    """Blocking budget of `max_count` units (bytes, ops, ...)."""

    def __init__(self, name: str, max_count: int):
        self.name = name
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

    def take(self, count: int = 1) -> int:
        """Unconditionally take (may exceed max) — reference Throttle::take."""
        with self._cond:
            self._count += count
            return self._count

    def get_or_fail(self, count: int = 1) -> bool:
        with self._cond:
            if not self._fits(count):
                return False
            self._count += count
        return True

    def put(self, count: int = 1) -> int:
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
