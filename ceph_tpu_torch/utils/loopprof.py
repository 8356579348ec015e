"""Event-loop sampling profiler: where OSD loop wall time actually goes.

A service pass can be event-loop-bound as much as transfer-bound,
but the sanitizer only reports callbacks that exceed a threshold — it
cannot say what FRACTION of the loop's time each code path eats,
which is the number the sharded-OSD work will be judged on.
This module is the missing instrument: a wall-clock sampling profiler
(the py-spy idea, scoped to registered event loops) built on the same
task-factory hooks as `utils/sanitizer.py`.

How it works:

  * `install()` registers the RUNNING loop (recording its thread id)
    and arms the sanitizer's task factory when none is set, so every
    sampled task carries its spawn site;
  * one daemon sampler thread wakes at `profiler_sample_hz` and reads
    each registered loop thread's current Python frame via
    `sys._current_frames()`:
      - a frame parked in `selectors.select` is an IDLE sample;
      - anything else is a BUSY sample, attributed to the innermost
        frame outside loop machinery (the stall site) and to the span
        kind the loop's current task is inside (tracer.task_span_name
        — populated whenever tracing is on);
  * `dump()` renders loop-busy-fraction, executor queue depth, and the
    top-N stall sites with their span-kind mix — the admin-socket
    `profile dump` / `profile reset` commands on every daemon.

Config-gated and hot-togglable (`profiler_enabled`,
`profiler_sample_hz`), same observer discipline as the sanitizer: a
`config set` from the admin-socket thread marshals onto every tracked
loop. Sampling costs one _current_frames() walk per tick on the
SAMPLER thread; the loop itself pays nothing per sample.

The port's copy of ceph_tpu/utils/loopprof.py (jax-free; the
port imports nothing of the JAX package).
"""
from __future__ import annotations

import asyncio
import sys
import threading
import time
import weakref

from ceph_tpu_torch.utils import sanitizer, tracer
from ceph_tpu_torch.utils.dout import dout
from ceph_tpu_torch.utils.perf_counters import (TYPE_GAUGE, PerfCounters,
                                          PerfCountersCollection)

DEFAULT_HZ = 100.0
TOP_N = 10

#: frames from these paths are loop/executor machinery, never the stall
#: site an operator can act on
_SKIP_PARTS = ("/asyncio/", "/selectors.py", "/concurrent/futures/",
               "/threading.py", "loopprof.py")

_lock = threading.Lock()
#: loop -> {"thread_id", "owns_factory"}; strong keys on purpose — the
#: sampler prunes closed loops each tick, and teardown asserts emptiness
_loops: dict = {}
#: loops that registered via maybe_install(): config changes from the
#: admin-socket thread are marshalled onto these (sanitizer pattern)
_tracked_loops: "weakref.WeakSet[asyncio.AbstractEventLoop]" = \
    weakref.WeakSet()
_thread: threading.Thread | None = None
_interval = 1.0 / DEFAULT_HZ

_samples = 0
_busy_samples = 0
_sites: dict[str, dict] = {}    # site -> {"samples": n, "kinds": {...}}
#: per-loop sample counts, keyed by the loop's shard label (the sharded
#: reactor's "shard0"/"shard1"... when the loop belongs to a pool, else
#: a stable "loop<N>" fallback): the per-shard loop_busy_fraction the
#: sharded-OSD work is graded on rides these through dump() and the
#: exporter mirror
_per_loop: dict[str, dict] = {}     # label -> {"samples", "busy"}
_loop_seq = 0


# -- sampling ----------------------------------------------------------------

def _site(frame) -> str:
    fn = frame.f_code.co_filename
    short = "/".join(fn.split("/")[-2:])
    return f"{short}:{frame.f_lineno} in {frame.f_code.co_name}"


def _classify(frame) -> tuple[bool, str]:
    """(busy, stall_site) for one sampled thread frame. A loop parked
    in the selector poll is idle; anything else is busy, attributed to
    the innermost frame outside loop machinery."""
    g = frame
    while g is not None:
        code = g.f_code
        if code.co_filename.endswith("selectors.py") and \
                code.co_name == "select":
            return False, ""
        g = g.f_back
    g = frame
    while g is not None:
        fn = g.f_code.co_filename
        if not any(p in fn for p in _SKIP_PARTS):
            return True, _site(g)
        g = g.f_back
    return True, _site(frame)


def _task_kind(loop) -> str:
    """Span kind (or coroutine identity) of the loop's current task,
    read cross-thread: asyncio keeps the per-loop current task in a
    plain dict the GIL makes safe to read."""
    task = None
    try:
        task = asyncio.tasks._current_tasks.get(loop)
    except Exception:
        pass
    kind = tracer.task_span_name(task)
    if kind is None and task is not None:
        coro = task.get_coro()
        kind = getattr(coro, "__qualname__", None) or task.get_name()
    return kind or "unattributed"


def _record(loop, frame) -> None:
    global _samples, _busy_samples
    busy, site = _classify(frame)
    kind = _task_kind(loop) if busy else ""
    with _lock:
        _samples += 1
        st = _loops.get(loop)
        label = st["label"] if st is not None else "loop?"
        per = _per_loop.get(label)
        if per is None:
            per = _per_loop[label] = {"samples": 0, "busy": 0}
        per["samples"] += 1
        if not busy:
            return
        _busy_samples += 1
        per["busy"] += 1
        d = _sites.get(site)
        if d is None:
            d = _sites[site] = {"samples": 0, "kinds": {}}
        d["samples"] += 1
        d["kinds"][kind] = d["kinds"].get(kind, 0) + 1


def _sample_loop() -> None:
    global _thread
    while True:
        time.sleep(_interval)
        with _lock:
            for lp in [lp for lp in _loops if lp.is_closed()]:
                del _loops[lp]
            if not _loops:
                _thread = None
                return
            targets = [(st["thread_id"], lp)
                       for lp, st in _loops.items()]
        frames = sys._current_frames()
        for tid, lp in targets:
            f = frames.get(tid)
            if f is not None:
                _record(lp, f)


# -- lifecycle ---------------------------------------------------------------

def install(loop: asyncio.AbstractEventLoop | None = None,
            sample_hz: float = DEFAULT_HZ) -> None:
    """Arm the profiler on `loop` (default: the running loop). Must run
    on the loop's own thread — the sampler needs its thread id.
    Idempotent per loop; stats are process-wide."""
    global _thread, _interval
    if loop is None:
        loop = asyncio.get_running_loop()
    _tracked_loops.add(loop)
    _interval = 1.0 / max(1.0, float(sample_hz))
    global _loop_seq
    try:
        from ceph_tpu_torch.utils import reactor
        label = reactor.shard_label(loop)
    except Exception:
        label = None
    with _lock:
        if loop not in _loops:
            owns = loop.get_task_factory() is None
            if owns:
                # ride the sanitizer's factory: sampled tasks then carry
                # their spawn site for the stall report
                loop.set_task_factory(sanitizer.task_factory)
            if label is None:
                label = f"loop{_loop_seq}"
                _loop_seq += 1
            _loops[loop] = {"thread_id": threading.get_ident(),
                            "owns_factory": owns, "label": label}
        start_thread = _thread is None
        if start_thread:
            _thread = threading.Thread(target=_sample_loop, daemon=True,
                                       name="loopprof-sampler")
        # span CMs mirror their name per-task only while a sampler can
        # read it — the mirror costs weak-dict ops on the tracing hot
        # path, so the tracer keeps it off otherwise
        tracer.set_task_naming(True)
    if start_thread:
        _thread.start()
    perf()
    dout("prof", 1, f"loop profiler armed at {1.0 / _interval:.0f} Hz")


def uninstall(loop: asyncio.AbstractEventLoop | None = None) -> None:
    """Disarm `loop`: stop sampling it and unwind the task factory we
    installed (leaving a sanitizer-armed factory in place)."""
    if loop is None:
        loop = asyncio.get_running_loop()
    with _lock:
        st = _loops.pop(loop, None)
        if not _loops:
            tracer.set_task_naming(False)
    if st and st["owns_factory"] and not loop.is_closed() \
            and loop.get_task_factory() is sanitizer.task_factory \
            and not sanitizer.armed(loop):
        loop.set_task_factory(None)


def installed_loops() -> list:
    """Live (non-closed) loops the sampler is armed on — the conftest
    leak gate asserts this is empty after every test."""
    with _lock:
        return [lp for lp in _loops if not lp.is_closed()]


def parked_tasks(limit: int = 64) -> list[dict]:
    """Census of pending tasks across every tracked loop, each with its
    spawn site and current suspension point: the deadlock watchdog's
    `deadlock dump` lays this next to the registered lock/grant waits so
    an operator sees what ELSE is parked around a cycle. Best-effort
    cross-thread read — all_tasks retries its weak-set snapshot and the
    coroutine frame walk is a GIL-safe peek."""
    loops: set = set()
    with _lock:
        loops.update(lp for lp in _loops if not lp.is_closed())
    loops.update(lp for lp in list(_tracked_loops) if not lp.is_closed())
    out: list[dict] = []
    for lp in loops:
        try:
            tasks = asyncio.all_tasks(lp)
        except RuntimeError:
            continue
        for t in tasks:
            if t.done():
                continue
            entry = {"task": t.get_name(),
                     "spawn_site": sanitizer.spawn_site(t)}
            try:
                frames = t.get_stack(limit=1)
                if frames:
                    f = frames[-1]
                    entry["parked_at"] = (
                        f"{f.f_code.co_filename}:{f.f_lineno} "
                        f"in {f.f_code.co_name}")
            except Exception:
                pass
            out.append(entry)
            if len(out) >= limit:
                return out
    return out


# -- surfaces ----------------------------------------------------------------

def _executor_depth() -> int:
    """Best-effort queued-work depth across the offload staging pool
    and each tracked loop's default executor."""
    depth = 0
    try:
        from ceph_tpu_torch.offload import service as _offload_svc
        pool = _offload_svc._pool
        if pool is not None:
            depth += pool._work_queue.qsize()
    except Exception:
        pass
    with _lock:
        loops = list(_loops)
    for lp in loops:
        q = getattr(getattr(lp, "_default_executor", None),
                    "_work_queue", None)
        if q is not None:
            try:
                depth += q.qsize()
            except Exception:
                pass
    return depth


def shard_stats() -> dict[str, dict]:
    """Per-shard (per sampled loop) busy fractions — the shard-local
    registries, merged: {"shard0": {"samples", "busy_samples",
    "loop_busy_fraction"}, ...}."""
    with _lock:
        per = {label: dict(d) for label, d in _per_loop.items()}
    return {label: {
        "samples": d["samples"],
        "busy_samples": d["busy"],
        "loop_busy_fraction": round(d["busy"] / d["samples"], 4)
        if d["samples"] else 0.0}
        for label, d in sorted(per.items())}


def merge_shard_stats(*parts: dict[str, dict]) -> dict[str, dict]:
    """Merge per-process `shard_stats()` snapshots into one pool-wide
    view, keyed by shard label. Under the process-backed reactor each
    worker samples its OWN loop and labels it with the pool-wide shard
    index (`reactor.adopt_worker_shard`), so the parent can fetch every
    worker's stats over the control channel and hand the union to
    `shard_busy_skew` — the cross-process number the bench trend guard
    watches. Same-label snapshots (a respawned worker's fresh process)
    sum counters and recompute the fraction."""
    merged: dict[str, dict] = {}
    for part in parts:
        for label, d in (part or {}).items():
            m = merged.setdefault(label, {"samples": 0, "busy_samples": 0})
            m["samples"] += int(d.get("samples", 0))
            m["busy_samples"] += int(d.get("busy_samples", 0))
    return {label: {
        "samples": m["samples"],
        "busy_samples": m["busy_samples"],
        "loop_busy_fraction": round(m["busy_samples"] / m["samples"], 4)
        if m["samples"] else 0.0}
        for label, m in sorted(merged.items())}


def shard_busy_skew(shards: dict[str, dict] | None = None) -> float:
    """(max-min)/max busy fraction across sampled shards: 0 = balanced
    load, 1 = one shard saturated while another idles. The trend guard
    flags rises — a placement/affinity regression shows up here before
    it shows up in MB/s."""
    if shards is None:
        shards = shard_stats()
    fr = [d["loop_busy_fraction"] for d in shards.values()
          if d["samples"] > 0]
    if len(fr) < 2 or max(fr) <= 0:
        return 0.0
    return round((max(fr) - min(fr)) / max(fr), 4)


def dump(top_n: int | None = None) -> dict:
    """Admin-socket `profile dump`: merged busy fraction, per-shard
    busy fractions + skew, executor depth, and the top stall sites with
    their span-kind mix."""
    with _lock:
        samples, busy = _samples, _busy_samples
        sites = {s: {"samples": d["samples"], "kinds": dict(d["kinds"])}
                 for s, d in _sites.items()}
        enabled = any(not lp.is_closed() for lp in _loops)
        hz = 1.0 / _interval
    top = sorted(sites.items(), key=lambda kv: -kv[1]["samples"])
    top = top[:top_n if top_n else TOP_N]
    shards = shard_stats()
    return {
        "enabled": enabled,
        "sample_hz": round(hz, 1),
        "samples": samples,
        "busy_samples": busy,
        "loop_busy_fraction": round(busy / samples, 4) if samples
        else 0.0,
        "shards": shards,
        "shard_busy_skew": shard_busy_skew(shards),
        "executor_queue_depth": _executor_depth(),
        "top_stalls": [
            {"site": s, "samples": d["samples"],
             "pct": round(100.0 * d["samples"] / busy, 1) if busy
             else 0.0,
             "span_kinds": dict(sorted(d["kinds"].items(),
                                       key=lambda kv: -kv[1]))}
            for s, d in top],
    }


def reset() -> dict:
    """Admin-socket `profile reset`: zero samples and stall sites."""
    global _samples, _busy_samples
    with _lock:
        cleared = _samples
        _samples = 0
        _busy_samples = 0
        _sites.clear()
        _per_loop.clear()
    return {"cleared_samples": cleared}


class _LoopprofCounters(PerfCounters):
    """Pull-model mirror: values sync from the sample store at dump()
    time so they ride the MgrClient report path and /metrics."""

    def __init__(self):
        super().__init__("loopprof")
        self.add("loop_samples",
                 description="profiler samples taken on this process's "
                             "event loops")
        self.add("loop_busy_samples",
                 description="samples that caught the loop executing "
                             "(not parked in the selector)")
        self.add("loop_busy_fraction", type=TYPE_GAUGE,
                 description="busy samples / total samples since reset")
        self.add("executor_queue_depth", type=TYPE_GAUGE,
                 description="work items queued behind the staging/"
                             "default executors")
        self.add("shard_busy_skew", type=TYPE_GAUGE,
                 description="(max-min)/max loop busy fraction across "
                             "reactor shards (0 = balanced)")

    def dump(self) -> dict:
        with _lock:
            samples, busy = _samples, _busy_samples
        self.set("loop_samples", samples)
        self.set("loop_busy_samples", busy)
        self.set("loop_busy_fraction",
                 round(busy / samples, 4) if samples else 0.0)
        self.set("executor_queue_depth", _executor_depth())
        shards = shard_stats()
        self.set("shard_busy_skew", shard_busy_skew(shards))
        for label, d in shards.items():
            key = f"loop_busy_fraction_{label}"
            if key not in self._types:
                # per-shard gauges materialize as shards appear: the
                # exporter then renders one family per reactor shard.
                # Concurrent dumpers (exporter scrape + admin perf
                # dump) can race the check — the loser's add is a no-op
                try:
                    self.add(key, type=TYPE_GAUGE,
                             description=f"busy fraction of reactor "
                                         f"{label}'s event loop")
                except ValueError:
                    pass
            self.set(key, d["loop_busy_fraction"])
        return super().dump()


def perf() -> PerfCounters:
    coll = PerfCountersCollection.instance()
    pc = coll.get("loopprof")
    if pc is None:
        try:
            pc = coll.register(_LoopprofCounters())
        except ValueError:
            pc = coll.get("loopprof")   # another shard loop won the race
    return pc


# -- config ------------------------------------------------------------------

def register_config(config) -> None:
    """Declare the profiler options on `config` (idempotent) and watch
    them — `config set profiler_enabled true` over the admin socket
    arms the running loop live, matching sanitizer/tracer hot reload."""
    from ceph_tpu_torch.utils.config import ConfigError, Option
    for opt in (Option("profiler_enabled", "bool", False,
                       "arm the event-loop sampling profiler "
                       "(loop-busy-fraction, top stall sites)"),
                Option("profiler_sample_hz", "float", DEFAULT_HZ,
                       "loop profiler sampling frequency",
                       minimum=1.0)):
        try:
            config.declare(opt)
        except ConfigError:
            pass                        # already declared by another daemon

    def _apply(loop: asyncio.AbstractEventLoop, name: str, value) -> None:
        global _interval
        if name == "profiler_enabled":
            install(loop, config.get("profiler_sample_hz")) \
                if value else uninstall(loop)
        elif name == "profiler_sample_hz":
            _interval = 1.0 / max(1.0, float(value))

    def _on_change(name: str, value) -> None:
        try:
            _apply(asyncio.get_running_loop(), name, value)
        except RuntimeError:
            # admin-socket thread: no loop here — marshal onto every
            # registered daemon loop (install must read the loop
            # thread's ident on that thread)
            for loop in list(_tracked_loops):
                if not loop.is_closed():
                    loop.call_soon_threadsafe(_apply, loop, name, value)

    config.add_observer(("profiler_enabled", "profiler_sample_hz"),
                        _on_change)


def maybe_install(config=None) -> None:
    """Arm the profiler on the running loop when enabled; always track
    the loop so a later `config set profiler_enabled true` from the
    admin-socket thread knows where to arm."""
    if config is None:
        return
    try:
        _tracked_loops.add(asyncio.get_running_loop())
        if config.get("profiler_enabled"):
            install(sample_hz=config.get("profiler_sample_hz"))
    except Exception:
        pass                            # options not declared on this config
