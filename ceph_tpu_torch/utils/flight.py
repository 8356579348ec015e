"""Flight recorder: a per-process bounded ring of structured events.

The cluster's black box. Every site that already KNOWS something
happened — a slow op crossing the OpTracker threshold, an offload
circuit breaker tripping, a heartbeat mark-down reaching reporter
quorum, a shard worker dying, a hot config change, a fault-injection
decision, a pipeline window stall — drops one small structured event
here, and a failure-storm post-mortem reads as a timeline instead of a
grep across interleaved dout streams. The analog of the reference's
in-memory log ring (src/log/Log.cc "recent" events) crossed with the
OSD's OpTracker history, but for CLUSTER-LEVEL happenings rather than
log lines or single ops.

Timestamps are hybrid (the TrackedOp contract): `mono`
(time.monotonic) is authoritative for ordering and survives wall-clock
jumps; `wall` (time.time) is display-only. A dump carries one
(mono_now, wall_now) anchor pair taken at dump time, so a merger can
place each ring's events on a shared estimated-wall axis
(t_est = mono + (wall_now - mono_now)) without ever trusting the wall
stamps recorded mid-run — `merge_timelines` below is that merger, and
the mgr's `timeline dump` uses it to interleave rings from multiple OS
processes into one causally-ordered story.

Process-wide on purpose: co-located daemons (several OSDs in one shard
worker) share the ring exactly as they share one crash ring and one
dout ring — the (pid, boot, seq) triple identifies every event
globally, so a consumer receiving the same ring through two daemons'
reports dedups trivially.

Snapshots freeze a copy of the ring at a moment the system deemed
interesting (a crash record, a WARN+ health transition) so the events
LEADING UP to the incident survive ring wraparound afterwards.

The port's copy of ceph_tpu/utils/flight.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import os
import threading
import time

from ceph_tpu_torch.utils.dout import dout

#: ring capacity default (flight_ring_capacity)
DEFAULT_CAPACITY = 512
#: bounded auto-snapshot store: post-mortems want the LAST few
#: incidents, and an unbounded list is exactly the leak this module
#: exists to avoid
MAX_SNAPSHOTS = 8

_lock = threading.Lock()
_events: list[dict] = []
_seq = 0
_dropped = 0
_enabled = True
_capacity = DEFAULT_CAPACITY
_snapshots: list[dict] = []
#: per-process boot token: distinguishes a respawned worker's ring
#: from its predecessor's even though the pid may be recycled
_boot = f"{os.getpid():x}.{os.urandom(4).hex()}"


def record(etype: str, entity: str = "", **detail) -> dict | None:
    """Append one event; returns it (None when the recorder is off).

    Hot-path discipline: one lock, one dict, one list append — callers
    sit on op dispatch and heartbeat paths, so anything heavier (I/O,
    formatting) belongs in dump(), not here.
    """
    global _seq, _dropped
    if not _enabled:
        return None
    ev = {"seq": 0, "mono": time.monotonic(), "wall": time.time(),
          "type": str(etype), "entity": str(entity),
          "detail": detail}
    with _lock:
        _seq += 1
        ev["seq"] = _seq
        _events.append(ev)
        overflow = len(_events) - _capacity
        if overflow > 0:
            del _events[:overflow]
            _dropped += overflow
    return ev


def _anchored(events: list[dict]) -> dict:
    return {"pid": os.getpid(), "boot": _boot,
            "mono_now": time.monotonic(), "wall_now": time.time(),
            "dropped": _dropped, "enabled": _enabled,
            "capacity": _capacity, "events": events}


def dump(etype: str | None = None, entity: str | None = None) -> dict:
    """The ring (oldest first) plus the anchor pair a merger needs.
    Optional filters narrow by event type / entity substring."""
    with _lock:
        events = [dict(e, detail=dict(e["detail"])) for e in _events]
    if etype is not None:
        events = [e for e in events if e["type"] == etype]
    if entity is not None:
        events = [e for e in events if entity in e["entity"]]
    return _anchored(events)


def events_since(cursor: int) -> dict:
    """Events with seq > cursor (the incremental-shipping leg: the
    MgrClient keeps a cursor per session and ships only the tail)."""
    with _lock:
        events = [dict(e, detail=dict(e["detail"]))
                  for e in _events if e["seq"] > cursor]
    return _anchored(events)


def last_seq() -> int:
    with _lock:
        return _seq


def reset() -> dict:
    """Clear the ring (admin `events reset`, and the flight leg of
    `perf reset`). Snapshots survive: they are frozen incident records,
    and a reset taken while diagnosing must not destroy the evidence."""
    global _dropped
    with _lock:
        n = len(_events)
        _events.clear()
        _dropped = 0
    return {"cleared": n}


def snapshot(reason: str) -> dict:
    """Freeze a copy of the ring under `reason` (crash.record and WARN+
    health transitions call this automatically)."""
    snap = dump()
    snap["reason"] = str(reason)
    snap["snapped_wall"] = snap["wall_now"]
    with _lock:
        _snapshots.append(snap)
        del _snapshots[:-MAX_SNAPSHOTS]
    dout("flight", 2, f"flight snapshot ({reason}): "
                      f"{len(snap['events'])} event(s)")
    return snap


def snapshots() -> list[dict]:
    with _lock:
        return list(_snapshots)


def clear_snapshots() -> int:
    with _lock:
        n = len(_snapshots)
        _snapshots.clear()
    return n


def configure(enabled: bool | None = None,
              capacity: int | None = None) -> None:
    global _enabled, _capacity, _dropped
    with _lock:
        if enabled is not None:
            _enabled = bool(enabled)
        if capacity is not None:
            _capacity = max(8, int(capacity))
            overflow = len(_events) - _capacity
            if overflow > 0:
                del _events[:overflow]
                _dropped += overflow


def status() -> dict:
    with _lock:
        return {"enabled": _enabled, "capacity": _capacity,
                "events": len(_events), "seq": _seq,
                "dropped": _dropped, "snapshots": len(_snapshots),
                "boot": _boot}


# -- cross-process merge ------------------------------------------------------

def merge_timelines(rings: list[dict]) -> list[dict]:
    """Interleave ring dumps from several processes into one
    causally-ordered timeline.

    Each ring's anchor pair gives its monotonic->wall offset AT DUMP
    TIME (offset = wall_now - mono_now), so every event lands at
    t_est = mono + offset: per-ring order is exactly monotonic order
    (wall jumps mid-run cannot reorder), and cross-ring alignment is as
    good as the dump-time clocks — on one host, the same clock. Ties
    break on (boot, seq) so the merge is deterministic.

    Duplicate rings (the same (pid, boot) ring received through two
    co-located daemons' reports) dedup by (boot, seq).
    """
    merged: dict[tuple, dict] = {}
    for ring in rings:
        if not isinstance(ring, dict):
            continue
        try:
            offset = float(ring["wall_now"]) - float(ring["mono_now"])
        except (KeyError, TypeError, ValueError):
            continue
        pid = ring.get("pid")
        boot = str(ring.get("boot", pid))
        for ev in ring.get("events") or []:
            if not isinstance(ev, dict) or "mono" not in ev:
                continue
            key = (boot, ev.get("seq"))
            if key in merged:
                continue
            merged[key] = dict(ev, pid=pid, boot=boot,
                               t_est=float(ev["mono"]) + offset)
    return sorted(merged.values(),
                  key=lambda e: (e["t_est"], e["boot"],
                                 e.get("seq") or 0))


# -- config plumbing ----------------------------------------------------------

_DEFAULTS = {"enabled": True, "capacity": DEFAULT_CAPACITY}


def FLIGHT_OPTIONS(Option) -> list:
    """The flight_* option family (declared per-daemon, applied to the
    PROCESS-wide recorder — co-located daemons share the ring, so the
    newest write wins, same as the crash ring's subsystem levels)."""
    return [
        Option("flight_enabled", "bool", _DEFAULTS["enabled"],
               "record structured events into the per-process flight "
               "ring (admin `events dump`; auto-snapshotted on crash "
               "and WARN+ health transitions)"),
        Option("flight_ring_capacity", "int", _DEFAULTS["capacity"],
               "flight-recorder ring size in events; the ring is the "
               "memory bound — oldest events drop past it",
               minimum=8),
    ]


def register_config(config) -> None:
    """Idempotently declare the flight_* knobs on `config` and arm an
    observer that applies them to the process-wide recorder."""
    from ceph_tpu_torch.utils.config import ConfigError, Option
    names = []
    for opt in FLIGHT_OPTIONS(Option):
        names.append(opt.name)
        try:
            config.declare(opt)
        except ConfigError:
            pass                    # another daemon already declared it

    def _on_change(name: str, value) -> None:
        key = name[len("flight_"):]
        if key == "enabled":
            _DEFAULTS["enabled"] = bool(value)
            configure(enabled=value)
        elif key == "ring_capacity":
            _DEFAULTS["capacity"] = int(value)
            configure(capacity=value)

    config.add_observer(tuple(names), _on_change)
    # replay values set before this daemon registered (the faultinject
    # replay rule: a second daemon in the process must not miss knobs
    # the first one's operator already tightened)
    diff = config.diff()
    for name in names:
        if name in diff:
            _on_change(name, config.get(name))
