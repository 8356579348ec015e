"""PerfCounters: typed runtime metrics with JSON dump.

Re-creation of the reference's perf counter machinery
(src/common/perf_counters.h): counters are u64 (monotonic), gauge
(u64 up/down), time (accumulated seconds), or avg (sum + count pairs,
read as a consistent tuple); histograms are power-of-two bucketed. A
process-wide `PerfCountersCollection` aggregates per-component instances
and serves the admin-socket `perf dump` / `perf schema` commands.

The port's copy of ceph_tpu/utils/perf_counters.py (jax-free; the port
imports nothing of the JAX package).
"""
from __future__ import annotations

import math
import threading
import time
from typing import Iterable

TYPE_U64 = "u64"
TYPE_GAUGE = "gauge"
TYPE_TIME = "time"
TYPE_AVG = "avg"
TYPE_HISTOGRAM = "histogram"


def pow2_bucket(value: float) -> int:
    """Power-of-two bucket index: bucket i counts values in
    [2^i, 2^(i+1)); 4096 lands in "2^12". The ONE bucketing rule —
    every histogram source (these counters, the per-client latency
    tables) must share it or cross-source merges and the exporter's
    cumulative `le` edges silently disagree."""
    return max(0, min(63, int(value).bit_length() - 1)) if value >= 1 \
        else 0


class PerfCounters:
    """One component's named counters (PerfCountersBuilder output)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._types: dict[str, str] = {}
        self._desc: dict[str, str] = {}
        self._values: dict[str, float] = {}
        self._counts: dict[str, int] = {}
        self._buckets: dict[str, list[int]] = {}

    def add(self, key: str, type: str = TYPE_U64, description: str = "") -> None:
        if type not in (TYPE_U64, TYPE_GAUGE, TYPE_TIME, TYPE_AVG,
                        TYPE_HISTOGRAM):
            raise ValueError(f"unknown counter type {type}")
        with self._lock:
            if key in self._types:
                raise ValueError(f"counter {key} already exists")
            self._types[key] = type
            self._desc[key] = description
            self._values[key] = 0
            self._counts[key] = 0
            if type == TYPE_HISTOGRAM:
                self._buckets[key] = [0] * 64

    def _check(self, key: str, *allowed: str) -> str:
        t = self._types.get(key)
        if t is None:
            raise KeyError(f"no counter {key}")
        if allowed and t not in allowed:
            raise TypeError(f"counter {key} is {t}, not {allowed}")
        return t

    def inc(self, key: str, amount: int = 1) -> None:
        self._check(key, TYPE_U64, TYPE_GAUGE)
        with self._lock:
            self._values[key] += amount

    def dec(self, key: str, amount: int = 1) -> None:
        self._check(key, TYPE_GAUGE)
        with self._lock:
            self._values[key] -= amount

    def set(self, key: str, value: float) -> None:
        self._check(key, TYPE_U64, TYPE_GAUGE)
        with self._lock:
            self._values[key] = value

    def tinc(self, key: str, seconds: float) -> None:
        self._check(key, TYPE_TIME)
        with self._lock:
            self._values[key] += seconds

    def time(self, key: str):
        """Context manager accumulating elapsed wall time into a TIME
        counter."""
        counters = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                counters.tinc(key, time.perf_counter() - self.t0)
                return False

        return _Timer()

    def avg_add(self, key: str, value: float) -> None:
        self._check(key, TYPE_AVG)
        with self._lock:
            self._values[key] += value
            self._counts[key] += 1

    def hist_add(self, key: str, value: float) -> None:
        self._check(key, TYPE_HISTOGRAM)
        bucket = pow2_bucket(value)
        with self._lock:
            self._buckets[key][bucket] += 1
            self._values[key] += value
            self._counts[key] += 1

    def dump(self) -> dict:
        with self._lock:
            out = {}
            for key, t in self._types.items():
                if t == TYPE_AVG:
                    out[key] = {"avgcount": self._counts[key],
                                "sum": self._values[key]}
                elif t == TYPE_HISTOGRAM:
                    buckets = {f"2^{i}": n
                               for i, n in enumerate(self._buckets[key]) if n}
                    out[key] = {"count": self._counts[key],
                                "sum": self._values[key],
                                "buckets": buckets}
                else:
                    out[key] = self._values[key]
            return out

    def schema(self) -> dict:
        with self._lock:
            return {key: {"type": t, "description": self._desc[key]}
                    for key, t in self._types.items()}

    def reset(self) -> None:
        """Zero every counter (admin-socket `perf reset`): values, avg
        counts, and histogram buckets — the schema survives."""
        with self._lock:
            for key in self._types:
                self._values[key] = 0
                self._counts[key] = 0
                if key in self._buckets:
                    self._buckets[key] = [0] * 64


class PerfCountersCollection:
    """Process-wide registry (perf dump aggregates all components)."""

    _instance: "PerfCountersCollection | None" = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._lock = threading.Lock()
        self._loggers: dict[str, PerfCounters] = {}

    @classmethod
    def instance(cls) -> "PerfCountersCollection":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def create(self, name: str) -> PerfCounters:
        return self.register(PerfCounters(name))

    def register(self, pc: PerfCounters) -> PerfCounters:
        """Insert an already-built (possibly subclassed) PerfCounters —
        pull-model loggers like the copyflow ledger mirror override
        dump() and register themselves here."""
        with self._lock:
            if pc.name in self._loggers:
                raise ValueError(
                    f"perf counters {pc.name} already registered")
            self._loggers[pc.name] = pc
            return pc

    def remove(self, name: str) -> None:
        with self._lock:
            self._loggers.pop(name, None)

    def get(self, name: str) -> PerfCounters | None:
        with self._lock:
            return self._loggers.get(name)

    def dump(self, logger: str | None = None) -> dict:
        with self._lock:
            items = (self._loggers.items() if logger is None
                     else [(logger, self._loggers[logger])])
        return {name: pc.dump() for name, pc in items}

    def schema(self) -> dict:
        with self._lock:
            items = list(self._loggers.items())
        return {name: pc.schema() for name, pc in items}

    def reset(self, logger: str | None = None) -> dict:
        """Zero all counters (or one logger's): `perf reset` analog."""
        with self._lock:
            items = (list(self._loggers.items()) if logger is None
                     else [(logger, self._loggers[logger])])
        for _, pc in items:
            pc.reset()
        return {"reset": [name for name, _ in items]}
