"""Crash records + the shared crash-injection exception.

Two halves:

  * `SimulatedCrash` — one exception class for every storage tier's
    fail_* test hooks (FileStore WAL window, BlueStore txc window, LSM
    WAL window) so harness code can catch it without knowing which
    layer raised.

  * A process-wide crash registry — the src/mgr/crash-module analog:
    daemons that catch a fatal exception post a crash record
    (`record()`), each daemon ships its unarchived count on the
    MgrClient health-metric path, the mgr digests any non-zero count
    into a RECENT_CRASH health warning, and the admin socket serves
    `crash ls` / `crash archive` (the reference's `ceph crash` verbs).
    Archiving acknowledges a record: it stays listable with
    `crash ls {"all": true}` but leaves the health surface.

The port's copy of ceph_tpu/utils/crash.py (jax-free; the
port imports nothing of the JAX package).
"""
from __future__ import annotations

import threading
import time
import traceback


class SimulatedCrash(Exception):
    """Raised by a fail_* test hook at the exact point a real crash
    would interrupt a commit; the durable state before the hook must
    fully reconstruct on remount."""


_lock = threading.Lock()
_records: list[dict] = []
_seq = 0

#: retained records (ring): a crash-looping daemon must not grow the
#: registry unboundedly
MAX_RECORDS = 256


def record(entity: str, exc: BaseException,
           backtrace: str | None = None) -> dict:
    """Post one crash record; returns it. Safe from any thread.

    Recurrences coalesce: a record site inside a retry loop (the mgr
    module tick, the scrub scheduler) firing every period must not
    flood the ring and evict genuine one-off crashes — an unarchived
    record with the same (entity, type, message) just gains a `count`
    and a fresh `last_stamp`."""
    global _seq
    if backtrace is None:
        backtrace = "".join(traceback.format_exception(
            type(exc), exc, exc.__traceback__)).strip()
    exc_type, message = type(exc).__name__, str(exc)
    with _lock:
        for r in reversed(_records):
            if not r["archived"] and r["entity"] == entity \
                    and r["exc_type"] == exc_type \
                    and r["message"] == message:
                r["count"] += 1
                r["last_stamp"] = time.time()
                return dict(r)
        _seq += 1
        now = time.time()
        rec = {"crash_id": f"{int(now)}_{_seq}",
               "stamp": now,
               "last_stamp": now,
               "count": 1,
               "entity": entity,
               "exc_type": exc_type,
               "message": message,
               "backtrace": backtrace,
               "archived": False}
        _records.append(rec)
        if len(_records) > MAX_RECORDS:
            del _records[: len(_records) - MAX_RECORDS]
    from ceph_tpu_torch.utils.dout import dout
    dout("crash", 1, f"{entity} crash recorded: {exc_type}: {message}")
    # black-box the moment: the crash event itself plus a frozen copy
    # of the flight ring — the events LEADING UP to the crash must
    # survive later wraparound (local import: flight pulls dout, and
    # this module must stay importable from anywhere)
    from ceph_tpu_torch.utils import flight
    flight.record("crash", entity, exc_type=exc_type, message=message)
    flight.snapshot(f"crash:{entity}:{exc_type}")
    return rec


def recent(entity: str | None = None) -> list[dict]:
    """Unarchived records, optionally for one entity — the health
    surface (`RECENT_CRASH` counts these)."""
    with _lock:
        return [dict(r) for r in _records
                if not r["archived"]
                and (entity is None or r["entity"] == entity)]


def ls(show_all: bool = False) -> list[dict]:
    """`crash ls` payload: records newest-first, backtrace elided to
    its LAST line (the exception itself — the line an operator triages
    by; recent() serves the full record)."""
    with _lock:
        rows = [r for r in _records if show_all or not r["archived"]]
    return [{**{k: r[k] for k in ("crash_id", "stamp", "entity",
                                  "exc_type", "message", "count",
                                  "archived")},
             "backtrace_last": r["backtrace"].splitlines()[-1]
             if r["backtrace"] else ""}
            for r in reversed(rows)]


def archive(crash_id: str | None = None) -> int:
    """Acknowledge records (all when crash_id is None): they leave the
    health surface but stay listable with show_all. Returns the number
    archived."""
    n = 0
    with _lock:
        for r in _records:
            if r["archived"]:
                continue
            if crash_id is not None and r["crash_id"] != crash_id:
                continue
            r["archived"] = True
            n += 1
    return n


def reset() -> None:
    """Drop every record (tests)."""
    global _seq
    with _lock:
        _records.clear()
        _seq = 0
