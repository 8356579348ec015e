"""dout-style subsystem logging with crash-dump ring buffer.

Re-creation of the reference's logging core (SURVEY §5.5): `dout(N)`
macros gate on a per-subsystem (log_level, gather_level) pair
(src/common/subsys.h); messages below log_level still land in an
in-memory ring buffer if below gather_level, and the ring is dumped on
crash (src/log/Log.cc "recent" events). Python logging handles the
sinks; this module adds the subsystem gating + ring.

The port's copy of ceph_tpu/utils/dout.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import collections
import logging
import sys
import threading
import time
import traceback

# default (log_level, gather_level) per subsystem — mirrors the shape of
# src/common/subsys.h entries, trimmed to this framework's components
DEFAULT_SUBSYS = {
    "": (0, 5),
    "ec": (1, 5),
    "osd": (1, 5),
    "mon": (1, 5),
    "ms": (0, 5),
    "objectstore": (1, 3),
    "crush": (1, 1),
    "client": (0, 5),
    "bench": (1, 5),
}

_RING_SIZE = 10000


class LogRing:
    """Recent-events ring dumped on crash."""

    def __init__(self, size: int = _RING_SIZE):
        self._ring = collections.deque(maxlen=size)
        self._lock = threading.Lock()

    def add(self, entry: str) -> None:
        with self._lock:
            self._ring.append(entry)

    def entries(self) -> list[str]:
        with self._lock:
            return list(self._ring)

    def dump(self, out=None) -> list[str]:
        out = out or sys.stderr
        entries = self.entries()
        print(f"--- begin dump of recent events ({len(entries)}) ---",
              file=out)
        for e in entries:
            print(e, file=out)
        print("--- end dump of recent events ---", file=out)
        return entries


class DoutLogger:
    """Per-process gated logger (the CephContext log surface)."""

    def __init__(self, name: str = "ceph-tpu-torch"):
        self.name = name
        self.ring = LogRing()
        self._levels = dict(DEFAULT_SUBSYS)
        self._lock = threading.Lock()
        self._py = logging.getLogger(name)
        if not self._py.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter("%(message)s"))
            self._py.addHandler(handler)
            self._py.setLevel(logging.DEBUG)
            self._py.propagate = False

    def set_level(self, subsys: str, log_level: int,
                  gather_level: int | None = None) -> None:
        with self._lock:
            old = self._levels.get(subsys, (0, 5))
            self._levels[subsys] = (log_level,
                                    old[1] if gather_level is None
                                    else gather_level)

    def get_level(self, subsys: str) -> tuple[int, int]:
        with self._lock:
            return self._levels.get(subsys, self._levels[""])

    def dout(self, subsys: str, level: int, message: str) -> None:
        log_level, gather_level = self.get_level(subsys)
        if level > log_level and level > gather_level:
            return
        stamp = time.strftime("%Y-%m-%dT%H:%M:%S")
        entry = f"{stamp} {self.name} {level:2d} {subsys}: {message}"
        self.ring.add(entry)
        if level <= log_level:
            self._py.info(entry)

    def dump_recent(self, out=None) -> list[str]:
        return self.ring.dump(out)

    def install_crash_dump(self) -> None:
        """Dump the ring on unhandled exceptions (signal_handler analog)."""
        previous = sys.excepthook

        def hook(exc_type, exc, tb):
            # let the previous hook print the traceback (exactly once),
            # then dump the ring
            if previous not in (None, hook):
                previous(exc_type, exc, tb)
            else:
                traceback.print_exception(exc_type, exc, tb)
            self.dump_recent()

        sys.excepthook = hook


_global: DoutLogger | None = None
_global_lock = threading.Lock()


def get_logger() -> DoutLogger:
    global _global
    with _global_lock:
        if _global is None:
            _global = DoutLogger()
        return _global


def dout(subsys: str, level: int, message: str) -> None:
    get_logger().dout(subsys, level, message)
