"""The port's PG layers that need no cluster (ceph_tpu_torch/osd/pglog.py,
osd/scheduler/, utils/work_queue.py) against the JAX package's, on the
CPU.

The cases of tests/test_qos.py (the dmclock scheduler and the sharded op
queue), tests/test_pglog_persist.py and the first three of
tests/test_pg_pipeline.py run through both packages: each reference test
source is exec'd as written and with its imports renamed to the port
(`load_reference_tests`). Then a seeded stream of appends, trims, reqid
invalidations and rewinds goes into a PGLog of each package, and the
persisted omap bytes (one key per entry, tests/test_pglog_persist.py's
delta stream) and the persisted log must be equal at every round; and
one seeded scheduler trace (enqueues, schedule, charges under an
injected clock) must give the same order, phases and tags.
"""
from __future__ import annotations

import asyncio
import inspect
import json
import os
import random
import re
import signal

import pytest

from ceph_tpu.osd.pglog import LogEntry as RefLogEntry, PGLog as RefPGLog
from ceph_tpu.osd.scheduler import (MClockScheduler as RefScheduler,
                                    default_profile as ref_profile)
from ceph_tpu_torch.osd.pglog import LogEntry, PGLog
from ceph_tpu_torch.osd.scheduler import MClockScheduler, default_profile

from tests.test_torch_kv_objectstore import TESTS, load_reference_tests

HARD_TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _guards():
    """A hard timeout that fires even in a loop that never yields, and
    the port's own leak gates (tests/conftest.py gates the reference's
    modules)."""
    def expire(signum, frame):
        raise TimeoutError(f"test ran past {HARD_TIMEOUT_S} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, HARD_TIMEOUT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
    from ceph_tpu_torch.utils import loopprof, sanitizer
    assert not loopprof.installed_loops(), "port loopprof left armed"
    strays = sanitizer.take_foreign_call_soon()
    assert not strays, f"port sanitizer saw foreign call_soon: {strays}"


def _reference_cases(name: str) -> list[str]:
    src = open(os.path.join(TESTS, name + ".py")).read()
    return re.findall(r"^def (test_\w+)\(", src, re.M)


QOS = _reference_cases("test_qos")
PGLOG = _reference_cases("test_pglog_persist")
PIPELINE = _reference_cases("test_pg_pipeline")[:3]
CASES = ([("test_qos", c) for c in QOS]
         + [("test_pglog_persist", c) for c in PGLOG]
         + [("test_pg_pipeline", c) for c in PIPELINE])


def test_case_counts():
    assert (len(QOS), len(PGLOG), len(PIPELINE)) == (19, 2, 3)
    # the first three of test_pg_pipeline boot no cluster
    src = open(os.path.join(TESTS, "test_pg_pipeline.py")).read()
    for case in PIPELINE:
        body = src.split(f"def {case}(", 1)[1].split("\ndef ", 1)[0]
        assert "ClusterHarness" not in body and "tmp_path" not in body


@pytest.mark.parametrize("pkg", ["ref", "port"])
@pytest.mark.parametrize("name,case", CASES)
def test_reference_case(name, case, pkg, monkeypatch):
    mod = load_reference_tests(name, pkg == "port", [], {})
    if pkg == "port":
        assert "ceph_tpu_torch" in repr(
            getattr(mod, "PGLog", None) or getattr(mod, "ShardedOpQueue",
                                                   None)), name
    fn = getattr(mod, case)
    args = {"monkeypatch": monkeypatch}
    fn(*[args[p] for p in inspect.signature(fn).parameters])


# -- persisted PG-log bytes ----------------------------------------------------

def _apply_delta(disk: dict, log, key_of) -> None:
    full, dirty = log.take_dirty()
    if full:
        for k in [k for k in disk if k.startswith(log.KEY_PREFIX)]:
            del disk[k]
        for e in log.entries:
            disk[key_of(e.version)] = json.dumps(e.to_dict()).encode()
        return
    for k, v in dirty.items():
        if v is None:
            disk.pop(k, None)
        else:
            disk[k] = json.dumps(v.to_dict()).encode()


def _log_stream(pglog_cls, entry_cls, seed: int):
    """The persisted state after each round of a seeded stream: the omap
    keys and bytes, and the log's own `to_dict()` as JSON bytes."""
    rng = random.Random(seed)
    log, disk, seq, out = pglog_cls(), {}, 0, []
    for _ in range(30):
        for _ in range(rng.randrange(1, 120)):
            seq += 1
            log.append(entry_cls(version=(1 + seq // 500, seq),
                                 op=rng.choice(["modify", "delete"]),
                                 oid=f"o{rng.randrange(12)}",
                                 reqid=(rng.randrange(4), seq)),
                       complete=rng.random() < 0.8)
        if rng.random() < 0.3 and log.entries:
            log.invalidate_reqids_for(log.entries[-1].oid, (0, 0))
        if rng.random() < 0.2 and log.entries:
            cut = log.entries[max(0, len(log.entries) - 7)].version
            log.merge_log([], cut)
        for e in log.entries[-5:]:
            log.mark_complete(e.version)
        _apply_delta(disk, log, pglog_cls.entry_key)
        out.append((dict(sorted(disk.items())),
                    json.dumps(log.to_dict(), sort_keys=True).encode(),
                    tuple(log.head), tuple(log.tail),
                    tuple(log.last_complete)))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_persisted_pglog_bytes_equal(seed):
    ref = _log_stream(RefPGLog, RefLogEntry, seed)
    port = _log_stream(PGLog, LogEntry, seed)
    assert len(port) == len(ref) == 30
    for i, (r, p) in enumerate(zip(ref, port)):
        assert p == r, f"round {i}"
    # and either package's persisted form loads in the other
    disk, raw = port[-1][0], json.loads(port[-1][1])
    meta = {"head": raw["head"], "tail": raw["tail"],
            "missing": raw.get("missing", {})}
    assert RefPGLog.from_omap(meta, disk).to_dict() == \
        PGLog.from_omap(meta, disk).to_dict()
    assert PGLog.from_dict(raw).to_dict() == RefPGLog.from_dict(raw).to_dict()


# -- one scheduler trace through both packages --------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _sched_trace(sched_cls, profile_fn, seed: int):
    rng = random.Random(seed)
    clk = _Clock()
    s = sched_cls(profile_fn(), clock=clk)
    s.configure(client_reservation=1.0, client_limit=12.0,
                tenant_profiles={"t1": {"weight": 3.0},
                                 "t2": {"reservation": 2.0, "limit": 5.0}})
    names = ["t0", "t1", "t2", "class:recovery", "class:scrub"]
    klass = {"class:recovery": "recovery", "class:scrub": "scrub"}
    backlog = {n: 0 for n in names}
    out = []
    for _ in range(400):
        if rng.random() < 0.45:
            n = rng.choice(names)
            if s.note_enqueue(n, klass.get(n, "client")):
                backlog[n] += 1
            else:
                out.append(("shed", n))
        ready = [n for n in names if backlog[n]]
        if not ready:
            continue
        order, defer, blocker = s.schedule(ready)
        if not order:
            out.append(("defer", round(defer, 9), blocker))
            clk.t += defer
            continue
        name, phase = order[0]
        backlog[name] -= 1
        s.charge(name, s.cost_of(rng.choice([0, 4096, 65536, 262144])),
                 phase=phase)
        out.append((name, phase, s.tag_columns(name)))
        clk.t += rng.choice([0.0, 0.001, 0.01])
    return out, s.status()


@pytest.mark.parametrize("seed", [4, 5])
def test_scheduler_trace_equal(seed):
    ref = _sched_trace(RefScheduler, ref_profile, seed)
    port = _sched_trace(MClockScheduler, default_profile, seed)
    assert port == ref
    assert sum(1 for t in port[0] if len(t) == 3 and t[0] != "defer") > 100


def test_queue_dispatch_order_equal():
    """The sharded op queue of each package drains the same mixed
    backlog (clients, recovery, scrub; mclock on) in the same order."""
    from ceph_tpu.utils.work_queue import ShardedOpQueue as RefQueue
    from ceph_tpu_torch.utils.work_queue import ShardedOpQueue

    async def drain(q_cls):
        q = q_cls(num_shards=1, clock=_Clock())
        q.set_mclock_enabled(True)
        order: list = []
        rng = random.Random(9)

        async def item(t):
            order.append(t)
        plan = [(rng.choice(["a", "b", "c"]),
                 rng.choice(["client", "client", "recovery", "scrub"]),
                 rng.choice([0, 65536])) for _ in range(60)]
        for i, (ent, kl, nb) in enumerate(plan):
            q.enqueue("k", lambda i=i, ent=ent: item((i, ent)),
                      entity=ent if kl == "client" else None, klass=kl,
                      nbytes=nb)
        q.start()
        deadline = asyncio.get_running_loop().time() + 5
        while len(order) < len(plan):
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.01)
        await q.stop()
        return order

    ref = asyncio.run(asyncio.wait_for(drain(RefQueue), 20))
    port = asyncio.run(asyncio.wait_for(drain(ShardedOpQueue), 20))
    assert port == ref and len(port) == 60
