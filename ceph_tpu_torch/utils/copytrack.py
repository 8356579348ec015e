"""Byte-flow copy ledger: bytes-copied vs bytes-referenced per stage.

The gap between a device encode and an EC write through the service is
transfer- and event-loop-bound, and the zero-copy buffer discipline
needs a before/after meter: without one, "we removed a copy" is a
code-review claim, not a measurement. This module is that meter — a
process-wide ledger the data path feeds at every point where bytes
either move (copied) or merely change hands (referenced):

  frame_tx           message segments assembled into a wire frame blob
  frame_rx           wire blob sliced back into frame segment buffers
  frame_to_buffer    message data handed to the codec-facing buffer
                     (np.frombuffer = referenced; bytes() = copied)
  buffer_to_staging  per-op buffers stacked into a staged device batch
  h2d                staged batch transferred into device memory
  d2h                device result transferred back to host memory
  reply_assemble     host result planes copied into per-shard replies

Each stage tracks copied bytes, referenced bytes, copy wall time, and
event count. The hot-path cost is one lock + three int adds per event
(events are per-op/per-frame, never per-byte). Surfaces:

  * `snapshot()` — the raw ledger (bench attribution stage, tests);
  * span attributes — the offload batch / encode spans tag their own
    copy bytes+time, so `trace dump` shows where an op's copies were;
  * perf counters — a pull-model "copyflow" logger in the process-wide
    collection: values sync from the ledger at dump() time, so they
    ride `perf dump`, the MgrClient report stream, and /metrics like
    any other counter without double bookkeeping on the hot path.

The port's copy of ceph_tpu/utils/copytrack.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import threading

from ceph_tpu_torch.utils.perf_counters import (PerfCounters,
                                                PerfCountersCollection)

#: the pipeline stages, in data-path order (the attribution waterfall
#: renders them in this order)
STAGES = ("frame_tx", "frame_rx", "frame_to_buffer",
          "buffer_to_staging", "h2d", "d2h", "reply_assemble")

_lock = threading.Lock()
_copied = dict.fromkeys(STAGES, 0)
_referenced = dict.fromkeys(STAGES, 0)
_seconds = dict.fromkeys(STAGES, 0.0)
_events = dict.fromkeys(STAGES, 0)


def copied(stage: str, nbytes: int, seconds: float = 0.0) -> None:
    """Record `nbytes` physically copied at `stage` (optionally with the
    wall time the copy took, for the attribution copy bucket)."""
    with _lock:
        _copied[stage] += int(nbytes)
        _seconds[stage] += seconds
        _events[stage] += 1


def referenced(stage: str, nbytes: int) -> None:
    """Record `nbytes` passed through `stage` zero-copy (a view/window
    changed hands; no bytes moved)."""
    with _lock:
        _referenced[stage] += int(nbytes)
        _events[stage] += 1


def snapshot() -> dict:
    """The ledger as one dict: per-stage and totals."""
    with _lock:
        stages = {s: {"copied_bytes": _copied[s],
                      "referenced_bytes": _referenced[s],
                      "copy_seconds": round(_seconds[s], 6),
                      "events": _events[s]}
                  for s in STAGES}
    return {"stages": stages,
            "copied_bytes_total": sum(d["copied_bytes"]
                                      for d in stages.values()),
            "referenced_bytes_total": sum(d["referenced_bytes"]
                                          for d in stages.values()),
            "copy_seconds_total": round(sum(d["copy_seconds"]
                                            for d in stages.values()), 6)}


def amplification(bytes_written: int) -> float:
    """Copy amplification: bytes physically copied anywhere in the
    pipeline per byte the client logically wrote. The zero-copy work's
    target metric — 0.0 when nothing was written."""
    if bytes_written <= 0:
        return 0.0
    with _lock:
        total = sum(_copied.values())
    return round(total / bytes_written, 3)


def reset() -> None:
    with _lock:
        for s in STAGES:
            _copied[s] = 0
            _referenced[s] = 0
            _seconds[s] = 0.0
            _events[s] = 0


class _CopyflowCounters(PerfCounters):
    """Pull-model perf counters: values sync from the ledger when
    dumped, so the per-event hot path never touches the counter lock."""

    def __init__(self):
        super().__init__("copyflow")
        for s in STAGES:
            self.add(f"copied_bytes_{s}",
                     description=f"bytes physically copied at the "
                                 f"{s} stage")
            self.add(f"referenced_bytes_{s}",
                     description=f"bytes passed zero-copy through the "
                                 f"{s} stage")
            self.add(f"copy_micros_{s}",
                     description=f"wall time (µs) spent copying at the "
                                 f"{s} stage")

    def dump(self) -> dict:
        snap = snapshot()
        for s, d in snap["stages"].items():
            self.set(f"copied_bytes_{s}", d["copied_bytes"])
            self.set(f"referenced_bytes_{s}", d["referenced_bytes"])
            self.set(f"copy_micros_{s}", round(d["copy_seconds"] * 1e6))
        return super().dump()


def perf() -> PerfCounters:
    """The ledger's perf-counter mirror, registered on first use (so it
    rides the MgrClient `extra_loggers` report path and /metrics)."""
    coll = PerfCountersCollection.instance()
    pc = coll.get("copyflow")
    if pc is None:
        try:
            pc = coll.register(_CopyflowCounters())
        except ValueError:
            pc = coll.get("copyflow")   # another shard loop won the race
    return pc
