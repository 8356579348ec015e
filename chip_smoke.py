#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's erasure-code data path on one NVIDIA card.

    python3 chip_smoke.py [--json PATH]

Builds the port's kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card (exact equality: all values
are integers), drives the main paths through the entry points a user calls
at the BASELINE configuration (k=8, m=3, 1 MiB chunks) and checks what
comes out against the host codec:

  phases 0-4  build; K1 and K2 against their plain versions (K2 at 1 to
              2^16 blocks, ragged and off 16-byte alignment); the OSD's
              ECUtil encode / degraded read / shard rebuild with the
              `cuda` plugin, BlueStore checksums, HashInfo; the
              benchmark and the kernels' times (K2 at 256,
              1024, 2^15 and 2^16 blocks of 4 KiB, beside a torch sum
              over the same bytes as a read yardstick);
  phase 5     K3 (the sharded encode's per-device step, parity plus
              checksum) against its plain version;
  phase 6     the mesh: the sharded pipeline step and mesh_storage_impl
              under ECUtil, on a 1x1 mesh and a 2x2 mesh over one card
              named four times (and over every card when there are two or
              more);
  phase 7     the offload service, the OSD's asynchronous EC data path:
              concurrent encode_async / decode_concat_async /
              decode_shards_async / calculate_async at the default
              settings, with 128 MiB batches and the device crc, and over
              two slots on one card with a mesh threshold low enough that
              a batch goes through K3; no batch may reach the host
              fallback;
  phase 8     K3's time at the 1x1 mesh's (16,8,1 MiB) -> (16,3) and
              the 2x2 mesh's per-device (8,8,1 MiB) -> (8,2), and the
              device operations one call runs (must be 1);
  phase 9     every erasure-code plugin with device=cuda: the corpus
              (ec_non_regression.check_all, 11 entries, every archived
              chunk byte-equal), then isa k=8 m=3, shec k=6 m=4 c=3, clay
              k=8 m=4 d=11, lrc k=4 m=2 l=3 and jerasure liberation k=4
              m=2 w=7 at 1 MiB chunks through ECUtil: encode, K2
              checksums of every shard, decode_concat / decode_shards
              of the 4-stripe object under every single erasure and 8
              seeded multi-erasure patterns, the scalar contract, and
              clay's MSR repair from sub-chunk reads; held against the
              same plugin built with device=cpu. K1 must launch for every plugin but liberation
              (its GF(2) codec runs on the host), K2 for all; each
              plugin's run is traced by torch.profiler (phase 10 reads
              the card's idle share from it);
  phase 9b    the plugins' scalar encode / decode GB/s (ec_benchmark
              --mode scalar) and K1's time at clay's largest plane batch;
  phase 10    the traced device path: phase 7's default pass with tracing
              off, with tracing on (GB/s, the critical path's stages per
              op class, the offload_batch spans), with tracing on under
              torch.profiler (the card's idle share over the pass: one
              minus the union of its kernels and copies in the pass's
              window), and with dispatch profiling on (per 8 MiB encode
              batch: queue wait, stacking copy, upload, kernel and
              download by CUDA events, the span's wall time; the legs
              must fit in it); the copy ledger's h2d / d2h bytes must
              equal what the pass sent up and brought back, the flight
              ring must hold no failover or breaker trip; one inline
              ECUtil encode and decode from host buffers under dispatch
              profiling (the plugin's legs, equal results); and the idle
              share of each plugin's run in phase 9, which runs under
              the profiler;
  phase 11    the port's bench_driver: --stage device on the card (every
              key measured) and --stage mesh_scaling over 1, 2 and 4
              slots of it (bit-identical);
  phase 12    the thread-sharded reactor: phase 7's default pass on each
              of 4 shards' services over one shared topology (GB/s
              beside one shard alone, the card's idle share, loop lag
              under loopprof, the pinned pages held), one armed device
              failure over 4 shards x 4 slots of the card (one breaker
              trip pool-wide), a cross-shard submit_threadsafe (K2 and
              K1), the pass again with the sanitizer armed (no lockset
              conflict, view-guard trip, lockdep inversion or foreign
              call_soon), one shard's writes under the interleave
              explorer, and `ec offload status` / `flush` through an
              admin socket. A multi-shard pool holds the GIL switch
              interval at 0.5 ms, so it runs after every timed phase
              but 13;
  phase 13    an EC object through placement, the wire and eleven
              BlueStores (the storage pattern of the OSD's ECBackend,
              tests/test_objectstore.py:185): an OSDMap of 11 OSDs on 5
              hosts places a 128 MiB object (16 stripes x 8 x 1 MiB,
              seed 42) of an EC pool (plugin cuda, k=8 m=3, indep, failure
              domain osd); ECUtil encodes it on the card, 176
              MOSDECSubOpWrite of 1 MiB cross two loopback Messengers
              (the native frame codec must be active) into 11 BlueStores
              on the LSM, one Transaction a message (13a, the card traced
              by torch.profiler); every store remounts and reads its shard
              back through the per-AU csum verify, equal to the card's
              shards, beside K2 over the same AUs as a comparison line
              (13b); a byte flipped in one data shard's block file makes
              its read raise EIO and the object decodes on the card from
              the other 10 shards read over the wire (13c); an
              Incremental marks host0's OSDs out, pg_temp keeps the
              acting set on the shards' homes, and the object decodes from
              the 8 survivors (13d). Every byte must equal the object's;
  phase 14    an EC pool on a booted cluster: one Monitor and 11 OSDs in
              this process with device=cuda, each on its own BlueStore
              (on the LSM), a profile plugin=cuda k=8 m=3 and `osd pool
              create ecpool 32 erasure` (the mon derives 4 KiB chunks, a
              32 KiB stripe), the device crc on through osd.0's config,
              one RadosClient with 16 ops in flight (rados bench's -t):
              64 objects of 4 MiB (seed 42) written (14a, the card traced
              by torch.profiler) and read back (14b); one OSD killed and
              every object read degraded once it is marked down (14c);
              the OSD back on an empty BlueStore, timed until every PG is
              clean (14d); one shard byte flipped by a raw store write
              and every PG deep-scrubbed: exactly that shard is found and
              repaired (14e); every shard on every OSD equal to the host
              codec's encode; `ec offload status` from osd.0's admin
              socket (14f); no batch may reach the host fallback. Per
              step: seconds and GB/s of client bytes, the service's
              device batches and riders a batch, K1-K3 launches;
  phase 15    phase 14's pool with its OSDs in worker processes that each
              open the card (`ephemeral_cluster(reactor_procs=N)`, OSDs
              on MemStore, a MgrDaemon on this loop): 15a the process
              curve, reactor_procs 0 (every OSD on this loop), 2 and 4
              (capped at the cores): boot, 32 objects of 4 MiB written and
              read (GB/s of client bytes), every object equal, a deep scrub of every PG with 0
              errors, fallback_ops 0 in every process (`ec offload
              status` through each worker's control channel), K1 and K2
              launches summed over the processes, pinned staging bytes
              and card memory per worker; 15b on the widest write, the
              card's share two ways (nvidia-smi's utilization.gpu on a
              side thread, and the services' offload_device_busy_seconds
              from the mgr's index once per worker); 15c the mgr's
              /metrics carries one ceph_device row per OSD, one device
              failure armed in one worker raises TPU_OFFLOAD_DEGRADED
              naming that worker's OSDs alone while writes go on equal on
              the host codec, and the check clears once the breaker's
              probe recovers; 15d a worker SIGKILLed with its CUDA
              context, its OSDs marked down, every object read degraded
              through K1 in the survivors, the worker respawned (it
              re-opens the card) and the pool clean again; 15e the
              bench driver's cluster_tpu and attribution stages on the
              card, each a child process;
  phase 16    the access layers with their data in EC pools: a vstart
              cluster (VCluster: one mon, 11 OSDs on MemStore with
              device=cuda, a mgr and its gateway rgw.0) with one profile
              plugin=cuda k=8 m=3 and three EC data pools made by `osd
              pool create <name> 32 erasure`, the device crc on; 16a an
              RBD image (`rbd create --data-pool rbd_ec`, 4 MiB objects):
              128 MiB in 32 object-aligned writes, 16 in flight (the card
              traced by torch.profiler), 256 random 4 KiB overwrites (the
              EC read-modify-write path), the range read back against a
              model; 16b an S3 bucket on a second gateway whose data pool
              is rgw_ec: 16 PUTs of 4 MiB over HTTP, 16 connections, a
              multipart upload of three 5 MiB parts, every object and one
              range read back, every ETag the crc32c of its bytes; 16c a
              CephFS (an MDS on cephfs_metadata with data pool fs_ec, 4
              MiB stripes): a 64 MiB file in 4 MiB writes, 128 random 4
              KiB overwrites, the file read back, an 8 MiB file unlinked
              and purged; 16d every shard on every OSD equal to the host
              codec's encode of the models; 16f the mgr's daemon index
              (osd, mon, mds, rgw), its /metrics rows for the MDS, both
              gateways and one ceph_device row per OSD, and health, read
              while every OSD is up; 16e osd.5 stopped, marked down, and
              every image, S3 and file byte read degraded through K1;
              16g the bench driver's --stage cluster as a child process.
              Per step: seconds, GB/s of client bytes (IOPS for the
              overwrites), device batches and riders a batch, K1-K3
              launches; no batch may reach the host fallback;
  phase 17    the failure storm and the interleave sweep, the bench
              driver's stages as child processes: 17a --stage
              failure_storm (11 OSDs on this card with a clay k=8 m=3
              d=10 pool whose jerasure MDS code runs K1: three OSDs
              killed under mixed load and revived, one OSD's shards
              rebuilt through clay's sub-chunk plan, repair ratio
              0.4167; the flight-recorder drill over 2 worker processes
              that each open the card, one SIGKILLed and a device fault
              tripping a survivor's breaker; the deadlock drill) and 17b
              --stage interleave (72 seeded schedules over a plugin cuda
              k=2 m=1 pool on the card, where the reference's is
              jerasure, bare, with the sanitizer and with the flight
              recorder and a mgr). Each child reports its own
              K1-K3 launches and host fallbacks on a stderr line; K1 must
              launch in both and no op may reach the host fallback in
              them (the drill's armed worker is a process of its own);
  phase 18    the client fleet: 18a --stage scrub_storm (11 OSDs of a
              vstart cluster with a mgr on this card, a clay k=8 m=3
              d=10 pool whose MDS code is cuda, 128 two-stripe objects:
              one deep-scrub round hashed on the host, one with the
              device crc on, whose digests run K2; then 200 clients of
              tools/rados_swarm over 2 worker processes, 48 of them paced
              victims, 6 s with scrub off and 6 s with scrub churning
              over 12 bit-rotted objects; 3 more rotted objects raise
              and clear PG_DAMAGED and OSD_SCRUB_ERRORS) and 18b --stage
              swarm (200 librados clients, 16 slow readers, for 6 s on 4
              OSDs with a mgr, pool plugin cuda k=2 m=1, where the
              reference's is jerasure; SLO_VIOLATIONS fired and muted,
              the exporter's ceph_client_* families). Every rot object
              must be found and repaired, the device round must batch
              its digests through the offload service, K1 must launch in
              both children and K2 in 18a's, and no op may reach the
              host fallback. The clients never open the card;
  phase 19    the QoS storm: --stage qos_storm (the dmclock scheduler
              under 1000 librados clients over 3 worker processes: 24
              bullies, 24 streamers, 24 spammers, 64 paced victims and
              the paced rest, on 4 OSDs of a vstart cluster with a mgr
              on this card, pool plugin cuda k=2 m=2, where the
              reference's is jerasure): a polite baseline, the storm
              with the scheduler off, with it on and per-tenant
              profiles while osd.3 is killed, 200 degraded objects are
              written and it is revived (recovery through the
              scheduler's reservation), and under the shed policy at
              queue depth 8; the mgr's per-tenant view and the
              exporter's ceph_qos_* families. The child exits 1 on a
              False fairness grade or a client error (the victims' SLO
              grade is recorded, not gated); recovery
              pushes, sheds and client-visible throttles must happen,
              K1 must launch in the child and no op may reach the host
              fallback there.

Phase 1 also holds K1 at the plugins' shapes: (1,k,N) -> r for k 3, 6,
8, 12, r 1-4 and N clay's plane batches and ragged 1 MiB.

Each path's launch counts are set to 0 just before it and read just after;
a kernel of the path launched no time fails the run. Nothing is caught: any
failure exits non-zero. Without a card it exits 2 and prints no result.

Output: progress lines, the card's name and power limit as nvidia-smi
reports them, a JSON line {"kernels": [...]}, and last
{"ok": true, "device": {...}}. --json also writes every measurement to
PATH (phase 13's under `store_path`, phase 14's under `cluster`, phase
15's under `procs`, phase 16's under `access`, phase 17's under
`stages17`, phase 18's under `stages18`, phase 19's under `stages19`).
"""
from __future__ import annotations

import argparse
import contextlib
import io
import itertools
import json
import os
import statistics
import subprocess
import sys
import threading
import time

K, M = 8, 3
CHUNK = 1 << 20                 # 1 MiB chunks
BATCH = 16                      # stripes per launch (the on-chip batch)
CSUM_BLOCK = 4096               # BlueStore csum block
CRC_BATCH = 1 << 16             # blocks per crc launch
K2_BLOCKS = (1, 7, 256, 1024, 1 << 15, 1 << 16)    # K2 held to plain at
K2_TIMED = (256, 1024, 1 << 15, 1 << 16)           # and timed at (4 KiB)
SERVICE_WRITES = 16             # concurrent one-stripe writes per pass
SHARDS = 4                      # phase 12: reactor shards (front ends)
SHARD_PASSES = 3                # timed passes each, 4 shards and 1 shard
FAULT_WRITES = 4                # phase 12b/e: one-stripe encodes a shard
XSHARD_BLOCKS = 1024            # phase 12c: 4 KiB blocks of the crc job
STORE_LAYOUT = (3, 3, 2, 2, 1)  # phase 13: OSDs a host (tests/test_crush.py:83)
STORE_SEED = 42                 # phase 13: the object's bytes
CLUSTER_PGS = 32                # phase 14: pg_num of the EC pool
CLUSTER_OBJECTS = 64            # phase 14: objects (cut this, never the size)
CLUSTER_OBJECT = 4 << 20        # phase 14: RBD's and CephFS's object size
CLUSTER_INFLIGHT = 16           # phase 14: ops in flight (rados bench -t)
CLUSTER_SEED = 42               # phase 14: the objects' bytes
PROC_COUNTS = (0, 2, 4)         # phase 15a: reactor_procs (0: one loop)
PROC_OBJECTS = 32               # phase 15a: objects (phase 14's halved)
PROC_FAULT_SHARD = 1            # phase 15c: the worker whose card call fails
PROC_CRASH_SHARD = 4            # phase 15d: the worker killed (2 OSDs of 11)
HB_GRACE_DEFAULT = 3.0          # phase 15d: osd_heartbeat_grace's default
# phase 15e: the cluster stages' curves, capped through their own knobs
STAGE_KNOBS = {"CEPH_TPU_REACTOR_SHARDS": "2", "CEPH_TPU_REACTOR_PROCS": "2"}
REPO = os.path.dirname(os.path.abspath(__file__))
ERASURES = ((0, 1, 2), (4, 8, 10), (7, 9, 10))
MESH_ERASURES = ((0, 1, 2), (1, K, K + 2))     # __graft_entry__.py's
CORPUS = os.path.join(REPO, "ceph-erasure-code-corpus")
# phase 9: the corpus profiles of every plugin, at full width
PLUGINS = (("isa", {"k": "8", "m": "3", "technique": "reed_sol_van"}),
           ("shec", {"k": "6", "m": "4", "c": "3"}),
           ("clay", {"k": "8", "m": "4", "d": "11"}),
           ("lrc", {"k": "4", "m": "2", "l": "3"}),
           ("jerasure", {"k": "4", "m": "2", "technique": "liberation",
                         "w": "7"}))
PLUGIN_STRIPES = 4              # stripes per object written
MULTI_ERASURES = 8              # seeded patterns of 2..m erasures
# K1's N at the plugins' shapes: clay k=8 m=4 d=11 at 1 MiB chunks decodes
# planes of 16 KiB in batches of nz planes; lrc's and shec's are ragged
PLUGIN_WIDTHS = (16 << 10, 7 * (16 << 10), 16 * (16 << 10), CHUNK - 1,
                 CHUNK + 128)

# phase 11: the keys of the reference bench driver's device stage
DEVICE_STAGE_KEYS = ("platform", "backend_init_s", "tpu_encode", "tpu_decode",
                     "device_peak_gbps", "tpu_encode_roofline_pct",
                     "tpu_crc32c", "link_h2d_cold_gbps", "link_h2d_gbps",
                     "tpu_encode_host", "host_encode_link_efficiency",
                     "scalar_encode", "elapsed_s")

# (bytes/s, dense int8 op/s) by card name: NVIDIA's H100 data sheet
_CARD_RATES = {"NVIDIA H100 80GB HBM3": (3.35e12, 1979e12),     # SXM
               "NVIDIA H100 PCIe": (2.0e12, 1513e12)}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_rates(name: str) -> tuple[float, float]:
    if name not in _CARD_RATES:
        raise RuntimeError(f"no memory and int8 rates known for {name!r}; "
                           f"bounds need one of {sorted(_CARD_RATES)}")
    return _CARD_RATES[name]


def bound_ms(nbytes: float, ops: float, rates) -> tuple[float, str]:
    t_bytes = nbytes / rates[0] * 1e3
    t_ops = ops / rates[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Device time of one call of fn: `reps` calls queued back to back
    between one pair of CUDA events, divided by reps. One untimed call is
    queued before the start event, so the stream is busy when it fires and
    the host's work between launches hides behind the device's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_isolated_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median time of one call of fn bracketed alone by CUDA events on an
    idle stream: the device time plus the host's launch work for it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled_ms(torch, fn, kernel: str, reps: int = 20) -> float | None:
    """Mean device time of one launch of `kernel` over `reps` calls of fn,
    from torch.profiler's trace of the card: the kernel's own duration,
    without the host's launch work. None when the trace holds no launch
    of it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if kernel in ev.key and ev.count:
            us = getattr(ev, "device_time", None)
            if us is None:
                us = getattr(ev, "cuda_time", None)
            return None if us is None else us / 1e3
    return None


def device_ops_per_call(torch, fn, reps: int = 10) -> tuple[float, list]:
    """Device operations (kernels, memsets, copies) the profiler's trace
    of the card holds per call of fn, and their names. A trace that
    holds no device activity at all is taken again, up to three times:
    a profiler session started right after another has come back empty
    on the card while the calls in it ran (the kernel's results are
    held against its plain version elsewhere)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if ops:
            break
    return len(ops) / reps, sorted({e.name for e in ops})


class DeviceWindow:
    """torch.profiler's trace of the card around a block: on exit,
    `window_s` is the block's span on the profiler's clock, `busy_s` the
    union of the card's kernels, copies and memsets inside it, and
    `idle_share` one minus their ratio."""

    LABEL = "chip_smoke_window"

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.mark = record_function(self.LABEL)
        self.mark.__enter__()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.mark.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self._measure()
        return False

    def _measure(self) -> None:
        cuda = self.torch.autograd.DeviceType.CUDA
        events = self.prof.events()
        marks = [e for e in events
                 if e.name == self.LABEL and e.device_type != cuda]
        if len(marks) != 1:
            raise AssertionError(f"{len(marks)} window marks in the trace")
        lo, hi = marks[0].time_range.start, marks[0].time_range.end
        spans = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi))
                       for e in events
                       if e.device_type == cuda and e.name != self.LABEL
                       and e.time_range.end > lo and e.time_range.start < hi)
        busy, end = 0.0, lo
        for a, b in spans:
            if b > end:
                busy += b - max(a, end)
                end = b
        self.device_ops = len(spans)
        self.window_s = (hi - lo) / 1e6
        self.busy_s = busy / 1e6
        if not 0.0 < self.busy_s <= self.window_s:
            raise AssertionError(f"device busy {self.busy_s} s in a window "
                                 f"of {self.window_s} s ({len(spans)} "
                                 f"device operations)")
        self.idle_share = 1.0 - self.busy_s / self.window_s


class TracedWindow:
    """The port's observability around a block: the tracer on (and
    dispatch profiling when asked), the copy ledger and flight ring
    reset; on exit the tracer is off again and `spans`, `ledger` and
    `events` hold what the block left."""

    def __init__(self, profile_dispatch: bool = False, device=None):
        self.profile_dispatch = profile_dispatch
        self.device = device             # a DeviceWindow to nest, or None

    def __enter__(self):
        from ceph_tpu_torch.utils import copytrack, flight, tracer
        self.tracer, self.copytrack, self.flight = tracer, copytrack, flight
        tracer.reset()
        copytrack.reset()
        flight.reset()
        tracer.enable(max_spans=1 << 16)
        tracer.set_profile_dispatch(self.profile_dispatch)
        if self.device is not None:
            self.device.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            if self.device is not None:
                self.device.__exit__(*exc)
        finally:
            self.tracer.disable()
            self.tracer.set_profile_dispatch(False)
        self.spans = [sp for t in self.tracer.dump()["traces"]
                      for sp in t["spans"]]
        self.ledger = self.copytrack.snapshot()["stages"]
        self.events = self.flight.dump()["events"]
        return False


def share(x: float | None) -> str:
    """A share as a percentage; n/a where nothing was traced."""
    return "n/a" if x is None else f"{x * 100:.2f}%"


def quantiles(values) -> dict:
    """Median and 90th percentile (numpy's linear interpolation)."""
    import numpy as np
    return {"median": float(np.median(values)),
            "p90": float(np.percentile(values, 90)), "n": len(values)}


def max_abs_err(a, b) -> int:
    """Largest |a - b| over two integer tensors of one shape."""
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def phase_k3(torch, np, dev, rand_bytes) -> tuple[int, int]:
    """K3 against its plain version, parity and checksum, exactly: full
    width with all rows (a 1x1 mesh), every row slice of the padded
    matrix at shard 2 and 3, ragged N, a recovery matrix; r = 1, 2, 4, 5
    (one and two row groups), k = 1, 3, 20, b = 1, data at a 1-byte
    offset into its storage, an all-zero slice (checksum 0), and two
    launches back to back on one stream (the second must find the ticket
    counter reset). Returns (max_abs_err, cases)."""
    from ceph_tpu_torch.ec import gf256
    from ceph_tpu_torch.ops import rs_codec
    from ceph_tpu_torch.parallel.mesh import shard_operands
    coding = gf256.reed_sol_van_matrix(K, M)
    avail = tuple(i for i in range(K + M) if i not in (0, 9, 10))[:K]
    R = rs_codec.recovery_matrix(coding, avail, (0, 9, 10))
    full = rand_bytes(BATCH, K, CHUNK)
    rng = np.random.default_rng(31)

    def operands(Mx, n_shard=1, part=0):
        return shard_operands(Mx, n_shard, dev)[part]

    cases = [("full width", operands(coding), full),
             ("recovery matrix", operands(R), full)]
    cases += [(f"shard {j}/{n}", operands(coding, n, j), full)
              for n in (2, 3) for j in range(n)]
    cases += [(f"shard {n - 1}/{n} N={w}", operands(coding, n, n - 1),
               rand_bytes(3, K, w))
              for w in (1, 4097, CHUNK + 3) for n in (1, 2)]
    cases += [(f"r={r}", operands(rng.integers(0, 256, (r, K),
                                                dtype=np.uint8)),
               rand_bytes(3, K, 65536)) for r in (1, 2, 4, 5)]
    cases += [(f"k={k}", operands(rng.integers(0, 256, (M, k),
                                                dtype=np.uint8)),
               rand_bytes(2, k, 65536 + 16)) for k in (1, 3, 20)]
    cases.append(("b=1", operands(coding), full[:1]))
    unaligned = rand_bytes(3 * K * 4096 + 1)[1:].view(3, K, 4096)
    if unaligned.data_ptr() % 16 == 0:
        raise AssertionError("the offset view is 16-byte aligned")
    cases.append(("base + 1 byte", operands(coding), unaligned))
    zero = operands(coding, 4, 3)               # the padding row of m=3 / 4
    if zero[0].any():
        raise AssertionError("shard 3/4 of a 3-row matrix is not all zero")
    cases.append(("all-zero slice", zero, full))
    worst = 0
    for label, (packed, bitm), x in cases:
        parity, csum = rs_codec.encode_local(packed, bitm, x)
        again, csum2 = rs_codec.encode_local(packed, bitm, x)  # same stream
        plain, plain_csum = rs_codec.encode_local_plain(bitm, x)
        err = max(max_abs_err(parity, plain), max_abs_err(again, plain),
                  abs(int(csum) - int(plain_csum)),
                  abs(int(csum2) - int(plain_csum)))
        worst = max(worst, err)
        if err:
            raise AssertionError(f"K3 {label} at {tuple(x.shape)} -> r="
                                 f"{packed.shape[0]} differs from plain: "
                                 f"{err}")
        if label == "all-zero slice" and int(csum) != 0:
            raise AssertionError(f"K3 all-zero slice checksum {int(csum)}")
    return worst, len(cases)


def phase_mesh(torch, np, dev, rand_bytes) -> list[str]:
    """The sharded pipeline step (errs == 0, checksum equal to K3's plain
    version over the whole batch) and mesh_storage_impl under ECUtil
    (byte-equal to the host codec), for each mesh layout. Returns the
    layouts run."""
    from ceph_tpu_torch.ec import gf256
    from ceph_tpu_torch.native import ec_native
    from ceph_tpu_torch.ops import rs_codec
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.parallel import mesh as mesh_lib
    layouts = [("1x1 over cuda:0", [dev], None),
               ("2x2 over [cuda:0] x 4", [dev] * 4, 2)]
    if dev.type == "cuda" and torch.cuda.device_count() >= 2:
        layouts.append((f"every card ({torch.cuda.device_count()})",
                        None, None))
    else:
        log("phase 6: one card: the mesh over real devices is skipped "
            "(it runs when torch.cuda.device_count() >= 2)")
    coding = gf256.reed_sol_van_matrix(K, M)
    data = rand_bytes(BATCH, K, CHUNK)
    _, want_csum = rs_codec.encode_local_plain(
        torch.from_numpy(gf256.matrix_to_bitmatrix(coding)).to(dev), data)
    sinfo = ec_util.StripeInfo(K, K * CHUNK)
    n_stripes = 5                          # not a multiple of stripe 2
    payload = np.random.default_rng(3).integers(
        0, 256, n_stripes * sinfo.stripe_width, dtype=np.uint8).tobytes()
    stripes = np.frombuffer(payload, dtype=np.uint8).reshape(
        n_stripes, K, CHUNK)
    host_parity = np.empty((n_stripes, M, CHUNK), dtype=np.uint8)
    for s in range(n_stripes):
        ec_native.encode(coding, stripes[s], host_parity[s])
    for label, devs, stripe in layouts:
        mesh = mesh_lib.make_mesh(devices=devs, stripe=stripe)
        for erased in MESH_ERASURES:
            errs, csum = mesh_lib.sharded_pipeline_step_fn(
                mesh, K, M, erased)(data)
            if int(errs) != 0 or int(csum) != int(want_csum):
                raise AssertionError(
                    f"mesh {label} erased {erased}: {int(errs)} bytes "
                    f"differ, checksum {int(csum)} != {int(want_csum)}")
        impl = mesh_lib.mesh_storage_impl(mesh, K, M)
        shards = {i: bytes(b) for i, b in
                  ec_util.encode(sinfo, impl, payload).items()}
        for j in range(M):
            if shards[K + j] != host_parity[:, j].tobytes():
                raise AssertionError(f"mesh {label}: parity {j} differs "
                                     f"from the host codec")
        for lost in MESH_ERASURES:
            have = {i: b for i, b in shards.items() if i not in lost}
            rebuilt = ec_util.decode_shards(sinfo, impl, have, lost)
            if any(rebuilt[i] != shards[i] for i in lost):
                raise AssertionError(f"mesh {label}: rebuild {lost}")
            if ec_util.decode_concat(sinfo, impl, have) != payload:
                raise AssertionError(f"mesh {label}: degraded read {lost}")
        log(f"phase 6: mesh {label} {mesh.shape}: pipeline step at "
            f"{tuple(data.shape)} errs 0 for erasures "
            f"{list(MESH_ERASURES)}, checksum {int(csum)} equal to K3's "
            f"plain version over the batch; mesh_storage_impl under ECUtil "
            f"({n_stripes} stripes): parity equal to the host codec, "
            f"rebuilds and degraded reads bit-identical")
    return [label for label, _, _ in layouts]


class ServicePass:
    """Phase 7's default pass: SERVICE_WRITES one-stripe writes, made
    from a seed, with their synchronous results. `run` drives one pass
    through a service on the running loop: every write's encode_async,
    every sync-path shard's calculate_async, and decode_concat_async /
    decode_shards_async for the patterns of ERASURES, all concurrent;
    `check` holds what it returned byte-equal to the synchronous path."""

    def __init__(self, np, code):
        from ceph_tpu_torch.osd import ec_util
        from ceph_tpu_torch.utils.checksummer import Checksummer
        self.code = code
        self.sinfo = sinfo = ec_util.StripeInfo(K, K * CHUNK)
        rng = np.random.default_rng(11)
        self.writes = [rng.integers(0, 256, sinfo.stripe_width,
                                    dtype=np.uint8).tobytes()
                       for _ in range(SERVICE_WRITES)]
        self.sync = [{i: bytes(b)
                      for i, b in ec_util.encode(sinfo, code, w).items()}
                     for w in self.writes]
        host_cs = Checksummer("crc32c", CSUM_BLOCK, use_device=False)
        self.want_csums = [host_cs.calculate(sh[i]) for sh in self.sync
                           for i in range(K + M)]
        self.lost = [ERASURES[w % len(ERASURES)]
                     for w in range(SERVICE_WRITES)]
        self.haves = [{i: b for i, b in sh.items() if i not in p}
                      for sh, p in zip(self.sync, self.lost)]
        self.nbytes = (len(self.writes) * sinfo.stripe_width   # encode in
                       + sum(len(b) for sh in self.sync
                             for b in sh.values())            # csums
                       + 2 * K * CHUNK * len(self.haves))     # decodes in
        # bytes a pass sends to its slots and brings back: every encode,
        # decode_concat and decode_shards job is k chunks up; parity, the
        # lost data chunks and the lost chunks come down (the crc jobs
        # stay on the host unless crc_device is on)
        self.device_up = 3 * len(self.writes) * K * CHUNK
        self.device_down = CHUNK * sum(M + sum(1 for i in p if i < K)
                                       + len(p) for p in self.lost)

    async def run(self, svc) -> tuple:
        import asyncio

        from ceph_tpu_torch.osd import ec_util
        from ceph_tpu_torch.utils.checksummer import Checksummer
        sinfo, code = self.sinfo, self.code
        cs = Checksummer("crc32c", CSUM_BLOCK)
        t0 = time.perf_counter()
        results = await asyncio.gather(
            asyncio.gather(*[ec_util.encode_async(sinfo, code, w, service=svc)
                             for w in self.writes]),
            asyncio.gather(*[cs.calculate_async(sh[i], service=svc)
                             for sh in self.sync for i in range(K + M)]),
            asyncio.gather(*[ec_util.decode_concat_async(
                sinfo, code, h, service=svc) for h in self.haves]),
            asyncio.gather(*[ec_util.decode_shards_async(
                sinfo, code, h, p, service=svc)
                for h, p in zip(self.haves, self.lost)]))
        wall = time.perf_counter() - t0
        await svc.drain()
        return results, wall

    def check(self, np, results) -> None:
        enc, csums, concat, rebuilt = results
        for w, (got, want) in enumerate(zip(enc, self.sync)):
            if {i: bytes(b) for i, b in got.items()} != want:
                raise AssertionError(f"service encode of write {w} differs")
        for j, (got, want) in enumerate(zip(csums, self.want_csums)):
            if not np.array_equal(got, want):
                raise AssertionError(f"service checksums of shard {j} "
                                     f"differ")
        if concat != self.writes:
            raise AssertionError("service degraded reads differ")
        for sh, p, got in zip(self.sync, self.lost, rebuilt):
            if any(got[i] != sh[i] for i in p):
                raise AssertionError(f"service rebuild {p} differs")


def phase_service(torch, np, devices, window=None, **settings) -> dict:
    """One ServicePass through the service over `devices`, with
    `settings` set on it. `window`, a context manager, is entered around
    the pass alone. Returns the service's numbers for the pass."""
    import asyncio

    from ceph_tpu_torch import offload
    from ceph_tpu_torch.ec.registry import factory
    code = factory("cuda", {"k": str(K), "m": str(M),
                            "device": str(devices[0])})
    sp = ServicePass(np, code)

    async def drive():
        svc = offload.get_service(devices)
        for name, value in settings.items():
            setattr(svc, name, value)
        results, wall = await sp.run(svc)
        return results, wall, dict(svc.stats), svc.device_snapshot()

    from ceph_tpu_torch.ops import crc32c, rs_codec
    # the references above launched K1 themselves: count from here
    rs_codec.launches = crc32c.launches = rs_codec.encode_local_launches = 0
    with window if window is not None else contextlib.nullcontext():
        results, wall, stats, devs = asyncio.run(drive())
    launches = {"gf_bitmatrix": rs_codec.launches,
                "crc32c_blocks": crc32c.launches,
                "gf_bitmatrix_csum": rs_codec.encode_local_launches}
    sp.check(np, results)
    if stats["fallback_ops"] or stats["breaker_trips"]:
        raise AssertionError(f"service fell back to the host: {stats}")
    if "cuda:0" not in devs and devices[0].type == "cuda":
        raise AssertionError(f"no batch ran on cuda:0: {sorted(devs)}")
    if stats["coalesced_ops"] <= 0:
        raise AssertionError(f"nothing coalesced: {stats}")
    return {"wall_s": wall, "bytes": sp.nbytes, "stats": stats,
            "launches": launches, "device_up": sp.device_up,
            "device_down": sp.device_down,
            "ms_per_batch": wall / stats["batches"] * 1e3,
            "gb_per_s": sp.nbytes / wall / 1e9,
            "devices": {d: {"batches": v["batches"], "busy_s": v["busy_s"]}
                        for d, v in devs.items()}}


def service_split(torch, np, dev) -> dict:
    """Where one service device call of an 8 MiB encode batch goes, each
    piece timed alone on the host clock (median of 10 ms, results kept
    alive as the service's callers keep them): the stacking copy into
    the slot's pinned page, a fresh pinned result buffer, the upload,
    K1 and download with their synchronize, and the whole staged call."""
    import statistics as stats_

    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.offload import service as svc_mod
    code = factory("cuda", {"k": str(K), "m": str(M), "device": str(dev)})
    slot = svc_mod._DeviceSlot(svc_mod._DeviceState(str(dev), dev), 2)
    job = np.random.default_rng(5).integers(0, 256, (1, K, CHUNK),
                                            dtype=np.uint8)
    page = slot.get_staging(job.nbytes)
    batch = page[:job.nbytes].view(job.shape)
    kept = []

    def median_ms(fn):
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            kept.append(fn())
            times.append((time.perf_counter() - t0) * 1e3)
        return stats_.median(times)

    def transfers():
        src = batch.to(dev, non_blocking=True)
        out = code.encode_stripes(src)
        host = torch.empty(out.shape, dtype=torch.uint8, device="cpu")
        host.copy_(out)
        return host

    svc_mod._run_on_slot(slot, code.encode_stripes, batch)     # warm
    split = {
        "stack_ms": median_ms(lambda: np.copyto(batch.numpy(), job)),
        "pinned_result_alloc_ms": median_ms(lambda: torch.empty(
            (1, M, CHUNK), dtype=torch.uint8, pin_memory=True)),
        "h2d_k1_d2h_pageable_ms": median_ms(transfers),
        "staged_call_ms": median_ms(lambda: svc_mod._run_on_slot(
            slot, code.encode_stripes, batch)),
    }
    del kept
    return split


def critpath_by_class(spans: list[dict]) -> dict:
    """The critical path of every trace in `spans`, averaged per op
    class: ops, mean total us and mean us per stage."""
    from ceph_tpu_torch.utils import critpath
    by_trace: dict[str, list[dict]] = {}
    for sp in spans:
        by_trace.setdefault(sp["trace_id"], []).append(sp)
    sums: dict[str, dict] = {}
    for trace in by_trace.values():
        cp = critpath.critical_path(trace)
        c = sums.setdefault(cp["op_class"], {
            "ops": 0, "total_us": 0.0,
            "stages": dict.fromkeys(critpath.STAGES, 0.0)})
        c["ops"] += 1
        c["total_us"] += cp["total_us"]
        for stage, us in cp["stages"].items():
            c["stages"][stage] += us
    return {cls: {"ops": c["ops"], "total_us": c["total_us"] / c["ops"],
                  "stages": {st: us / c["ops"]
                             for st, us in c["stages"].items()}}
            for cls, c in sorted(sums.items())}


def dispatch_split(spans: list[dict]) -> dict:
    """Where an 8 MiB encode batch's time goes, from a pass traced with
    dispatch profiling on: medians over the encode batches (offload_batch
    spans of K chunks with a tpu_encode_dispatch child) of the riders'
    queue wait, the stacking copy, the legs the CUDA events timed, the
    span's wall time, and the wall time outside the legs (host time in
    the executor). Fails unless every batch span's legs fit in its wall
    time (each figure is rounded to 0.1 us)."""
    by_id = {sp["span_id"]: sp for sp in spans}
    children: dict[str, list[str]] = {}
    for sp in spans:
        children.setdefault(sp["parent_id"], []).append(sp["name"])
    legs = ("h2d_us", "kernel_us", "d2h_us")
    batches = [sp for sp in spans if sp["name"] == "offload_batch"]
    for sp in batches:
        if sum(sp["tags"].get(leg, 0.0) for leg in legs) > \
                sp["duration_us"] + 0.2:
            raise AssertionError(f"offload_batch legs exceed its wall: {sp}")
    enc = [sp for sp in batches if sp["tags"]["bytes"] == K * CHUNK
           and "tpu_encode_dispatch" in children.get(sp["span_id"], ())]
    if not enc or any(leg not in sp["tags"] for sp in enc for leg in legs):
        raise AssertionError(f"{len(enc)} 8 MiB encode batches, some "
                             f"without timed legs")
    waits = [sp["duration_us"] for sp in spans
             if sp["name"] == "offload_queue_wait"
             and by_id.get(sp["parent_id"], {}).get("name") == "ec_encode"]
    out = {"batches": len(enc), "queue_wait_us": quantiles(waits)}
    for key in ("copy_us",) + legs:
        out[key] = quantiles([sp["tags"][key] for sp in enc])
    out["wall_us"] = quantiles([sp["duration_us"] for sp in enc])
    out["host_us"] = quantiles([
        sp["duration_us"] - sum(sp["tags"][leg] for leg in legs)
        for sp in enc])
    return out


def inline_split(torch, np, dev) -> dict:
    """The cuda plugin's host path under dispatch profiling: one ECUtil
    encode of 4 stripes and a 3-erasure decode_concat of it, inline; the
    results must equal the untraced calls', and each tpu_*_dispatch
    span's legs (CUDA events per sub-batch, one after another) must fit
    in its wall time. Returns each span's legs and wall time."""
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.osd import ec_util
    code = factory("cuda", {"k": str(K), "m": str(M), "device": str(dev)})
    sinfo = ec_util.StripeInfo(K, K * CHUNK)
    data = np.random.default_rng(13).integers(
        0, 256, 4 * sinfo.stripe_width, dtype=np.uint8).tobytes()
    want = {i: bytes(b) for i, b in ec_util.encode(sinfo, code, data).items()}
    have = {i: b for i, b in want.items() if i not in ERASURES[0]}
    win = TracedWindow(profile_dispatch=True)
    with win:
        got = {i: bytes(b)
               for i, b in ec_util.encode(sinfo, code, data).items()}
        concat = ec_util.decode_concat(sinfo, code, have)
    if got != want or concat != data:
        raise AssertionError("a profiled inline encode / decode differs")
    legs = ("h2d_us", "kernel_us", "d2h_us")
    out = {}
    for sp in win.spans:
        if sp["name"] not in ("tpu_encode_dispatch", "tpu_decode_dispatch"):
            continue
        if any(leg not in sp["tags"] for leg in legs) or \
                sum(sp["tags"][leg] for leg in legs) > sp["duration_us"] + 0.2:
            raise AssertionError(f"plugin legs missing or past wall: {sp}")
        out[sp["name"]] = {**{leg: sp["tags"][leg] for leg in legs},
                           "wall_us": sp["duration_us"],
                           "bytes": sp["tags"]["bytes"]}
    if len(out) != 2:
        raise AssertionError(f"dispatch spans {sorted(out)}")
    return out


def phase_traced(torch, np, dev) -> dict:
    """Phase 7's default pass with tracing off, with tracing on, with
    tracing on under the profiler and with dispatch profiling on; what
    the spans, the card's trace, the copy ledger and the flight ring say
    of it."""
    out = {"off": phase_service(torch, np, [dev])}
    traced = TracedWindow()
    out["traced"] = phase_service(torch, np, [dev], window=traced)
    batches = [sp["duration_us"] for sp in traced.spans
               if sp["name"] == "offload_batch"]
    if len(batches) != out["traced"]["stats"]["batches"]:
        raise AssertionError(f"{len(batches)} offload_batch spans for "
                             f"{out['traced']['stats']['batches']} batches")
    out["batch_wall_us"] = quantiles(batches)
    out["critpath"] = critpath_by_class(traced.spans)
    card = DeviceWindow(torch)
    out["profiled"] = phase_service(torch, np, [dev],
                                    window=TracedWindow(device=card))
    out["idle"] = {"share": card.idle_share, "busy_s": card.busy_s,
                   "window_s": card.window_s, "device_ops": card.device_ops}
    legs = TracedWindow(profile_dispatch=True)
    out["dispatch"] = phase_service(torch, np, [dev], window=legs)
    out["split"] = dispatch_split(legs.spans)
    for label in ("traced", "profiled", "dispatch"):
        if out[label]["launches"]["gf_bitmatrix"] <= 0:
            raise AssertionError(f"the {label} pass never launched K1")
    # the copy ledger against what the pass moved
    res = out["dispatch"]
    up = sum(sp["tags"]["bytes"] for sp in legs.spans
             if sp["name"] == "offload_batch"
             and sp["tags"]["device"] != "host")
    out["ledger"] = {stage: legs.ledger[stage] for stage in
                     ("buffer_to_staging", "h2d", "d2h")}
    if not (legs.ledger["h2d"]["copied_bytes"] == res["device_up"] == up):
        raise AssertionError(f"ledger h2d {legs.ledger['h2d']}, spans {up}, "
                             f"the pass sent {res['device_up']}")
    if legs.ledger["d2h"]["copied_bytes"] != res["device_down"]:
        raise AssertionError(f"ledger d2h {legs.ledger['d2h']}, the pass "
                             f"brought back {res['device_down']}")
    bad = [ev for ev in legs.events + traced.events
           if ev["type"] in ("device_failover", "breaker_trip")]
    if bad:
        raise AssertionError(f"flight events of a failing card: {bad}")
    out["flight_events"] = len(legs.events) + len(traced.events)
    out["inline"] = inline_split(torch, np, dev)
    return out


def log_traced(obs: dict) -> None:
    """Phase 10's lines: each pass's GB/s, the batch spans, the critical
    path per op class, the card's idle share, the profiled split of an
    8 MiB encode batch and the copy ledger."""
    for label, what in (("off", "tracing off"), ("traced", "tracing on"),
                        ("profiled", "tracing on, under torch.profiler"),
                        ("dispatch", "dispatch profiling on")):
        r = obs[label]
        log(f"phase 10: default pass, {what}: {r['gb_per_s']:.3f} GB/s "
            f"({r['wall_s'] * 1e3:.1f} ms for {r['bytes'] / 2**20:.0f} MiB, "
            f"{r['stats']['batches']} batches, host clock), launches "
            f"{r['launches']}")
    bw = obs["batch_wall_us"]
    log(f"phase 10: {bw['n']} offload_batch spans, wall median "
        f"{bw['median']:.1f} us, p90 {bw['p90']:.1f} us")
    for cls, c in obs["critpath"].items():
        stages = ", ".join(f"{st} {us:.1f}" for st, us in c["stages"].items())
        log(f"phase 10: critical path of {cls} ({c['ops']} traces), mean "
            f"us: total {c['total_us']:.1f} = {stages}")
    idle = obs["idle"]
    card_batches = sum(d["batches"] for label, d in
                       obs["profiled"]["devices"].items() if label != "host")
    log(f"phase 10: the card over the profiled pass: busy "
        f"{idle['busy_s'] * 1e3:.2f} ms of a {idle['window_s'] * 1e3:.1f} ms "
        f"window ({idle['device_ops']} kernels and copies, "
        f"{idle['busy_s'] * 1e3 / card_batches:.3f} ms per batch on the "
        f"card), idle share {share(idle['share'])}")
    sp = obs["split"]
    log(f"phase 10: per 8 MiB encode batch ({sp['batches']} batches, "
        f"dispatch profiling, medians in us): queue wait "
        f"{sp['queue_wait_us']['median']:.1f}, stacking copy "
        f"{sp['copy_us']['median']:.1f}, h2d {sp['h2d_us']['median']:.1f}, "
        f"kernel {sp['kernel_us']['median']:.1f}, d2h "
        f"{sp['d2h_us']['median']:.1f} (CUDA events), span wall "
        f"{sp['wall_us']['median']:.1f}, host time in the executor "
        f"{sp['host_us']['median']:.1f}; every batch's legs within its wall")
    led = obs["ledger"]
    log(f"phase 10: copy ledger of the pass: h2d "
        f"{led['h2d']['copied_bytes']} bytes, d2h "
        f"{led['d2h']['copied_bytes']} bytes (equal to what the pass sent "
        f"and brought back), buffer_to_staging "
        f"{led['buffer_to_staging']['copied_bytes']} copied / "
        f"{led['buffer_to_staging']['referenced_bytes']} referenced; "
        f"{obs['flight_events']} flight events, no failover or breaker "
        f"trip, fallback_ops 0")
    for name, sp in obs["inline"].items():
        log(f"phase 10: inline ECUtil, {name} of {sp['bytes'] / 2**20:.0f} "
            f"MiB from host buffers, dispatch profiling: h2d "
            f"{sp['h2d_us']:.1f} us, kernel {sp['kernel_us']:.1f} us, d2h "
            f"{sp['d2h_us']:.1f} us (CUDA events, summed over sub-batches), "
            f"span wall {sp['wall_us']:.1f} us; results equal untraced")


def plugins_idle(windows: dict) -> dict:
    """The card's busy time and idle share in each plugin's run of phase
    9, from the DeviceWindow it ran in."""
    out = {}
    for pname, w in windows.items():
        out[pname] = {"share": w.idle_share, "busy_s": w.busy_s,
                      "window_s": w.window_s, "device_ops": w.device_ops}
        log(f"phase 10: {pname} (phase 9's run, under the profiler): busy "
            f"{w.busy_s * 1e3:.2f} ms of {w.window_s * 1e3:.1f} ms, idle "
            f"share {share(w.idle_share)}")
    return out


def _loop_lag(stop, period_s: float = 0.002):
    """On the running loop until `stop` (a threading.Event) is set: how
    late each `period_s` sleep wakes (the loop's lag) and the deepest
    executor queue seen (loopprof's reading) at each wake."""
    import asyncio

    from ceph_tpu_torch.utils import loopprof

    async def tick():
        lags, depth = [], 0
        while not stop.is_set():
            t0 = time.perf_counter()
            await asyncio.sleep(period_s)
            lags.append(time.perf_counter() - t0 - period_s)
            depth = max(depth, loopprof._executor_depth())
        return {"lag_ms": quantiles([x * 1e3 for x in lags])
                if lags else None,
                "lag_max_ms": max(lags) * 1e3 if lags else None,
                "executor_depth_max": depth}
    return tick()


async def _reactor_pool(torch, np, dev, sp, window_cls) -> dict:
    """Phases 12a and 12c-12f on one ShardPool of SHARDS front ends,
    each shard's service over [dev]."""
    import asyncio
    import shutil
    import tempfile

    from ceph_tpu_torch import offload
    from ceph_tpu_torch.native import ec_native
    from ceph_tpu_torch.offload import service as svc_mod
    from ceph_tpu_torch.ops import crc32c, rs_codec
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.qa import interleave
    from ceph_tpu_torch.utils import loopprof, reactor, sanitizer
    from ceph_tpu_torch.utils.admin_socket import AdminSocket, admin_command
    out: dict = {}
    label = "cuda:0" if dev.type == "cuda" else "cpu:0"
    pool = reactor.ShardPool(SHARDS)
    try:
        out["switch_interval_s"] = sys.getswitchinterval()
        if out["switch_interval_s"] != reactor.ShardPool.SWITCH_INTERVAL_S:
            raise AssertionError(f"switch interval "
                                 f"{out['switch_interval_s']} in the pool")

        async def shard_pass():
            return await sp.run(offload.get_service([dev]))

        async def pool_pass() -> float:
            t0 = time.perf_counter()
            done = await asyncio.gather(*[pool.run_on(i, shard_pass())
                                          for i in range(SHARDS)])
            wall = time.perf_counter() - t0
            for results, _ in done:
                sp.check(np, results)
            return wall

        async def one_pass() -> float:
            results, wall = await shard_pass()
            sp.check(np, results)
            return wall

        # -- 12a: four front ends over one card ------------------------------
        k1_before = rs_codec.launches
        await pool_pass()                  # warm: every shard's pages
        pool_walls, one_walls = [], []
        for _ in range(SHARD_PASSES):
            one_walls.append(await one_pass())
            pool_walls.append(await pool_pass())
        services = await pool.run_on_each(
            lambda: offload.get_service([dev]))
        if len({id(s) for s in services}) != SHARDS:
            raise AssertionError("the shards share a service")
        if len({id(s._topo) for s in services}) != 1:
            raise AssertionError("the shards' services do not share one "
                                 "topology")
        fallback = sum(s.stats["fallback_ops"] for s in services)
        if fallback or rs_codec.launches <= k1_before:
            raise AssertionError(f"pool passes: fallback_ops {fallback}, "
                                 f"K1 launches "
                                 f"{rs_codec.launches - k1_before}")
        pages = [t for s in services for sl in s._slots for t in sl.staging]
        with window_cls(torch) as win:
            profiled_wall = await pool_pass()
        stop = threading.Event()
        loopprof.reset()
        await pool.run_on_each(loopprof.install)
        try:
            lag_tasks = [asyncio.ensure_future(
                pool.run_on(i, _loop_lag(stop))) for i in range(SHARDS)]
            await asyncio.sleep(0.01)
            prof_wall = await pool_pass()
            stop.set()
            lags = await asyncio.gather(*lag_tasks)
            busy = loopprof.shard_stats()
        finally:
            stop.set()
            await pool.run_on_each(loopprof.uninstall)
        if loopprof.installed_loops():
            raise AssertionError("loopprof still armed after uninstall")
        pool_gbps = [SHARDS * sp.nbytes / w / 1e9 for w in pool_walls]
        one_gbps = [sp.nbytes / w / 1e9 for w in one_walls]
        out["a"] = {
            "pool_walls_s": pool_walls, "one_walls_s": one_walls,
            "pool_gb_per_s": pool_gbps, "one_gb_per_s": one_gbps,
            "pool_gb_per_s_median": statistics.median(pool_gbps),
            "one_gb_per_s_median": statistics.median(one_gbps),
            "pass_bytes": sp.nbytes,
            "staging_pages": len(pages),
            "staging_bytes": sum(t.numel() for t in pages),
            "profiled_wall_s": profiled_wall,
            "device_ops": getattr(win, "device_ops", None),
            "busy_s": getattr(win, "busy_s", None),
            "idle_share": win.idle_share,
            "loopprof_wall_s": prof_wall,
            "loop_busy": busy,
            "loop_lag": {f"shard{i}": lag for i, lag in enumerate(lags)},
            "fallback_ops": fallback,
            "batches": sum(s.stats["batches"] for s in services)}

        # -- 12c: a cross-shard submission -----------------------------------
        svc1 = services[1]

        async def set_crc_device(flag):
            svc1.crc_device = flag
        rng = np.random.default_rng(12)
        blocks = rng.integers(0, 256, (XSHARD_BLOCKS, CSUM_BLOCK),
                              dtype=np.uint8)
        stripes = rng.integers(0, 256, (BATCH, K, CHUNK), dtype=np.uint8)
        k2_before = crc32c.launches
        await pool.run_on(1, set_crc_device(True))
        try:
            crcs = await asyncio.wrap_future(svc1.submit_threadsafe(
                "crc32c_blocks", blocks, CSUM_BLOCK))
            parity = await asyncio.wrap_future(svc1.submit_threadsafe(
                "encode", sp.code, stripes))
        finally:
            await pool.run_on(1, set_crc_device(False))
        if not np.array_equal(
                crcs, ec_native.crc32c_blocks(blocks.reshape(-1),
                                              CSUM_BLOCK)):
            raise AssertionError("cross-shard crc32c_blocks differs from "
                                 "the host's")
        if not np.array_equal(parity, svc_mod._host_apply(
                sp.code.coding_matrix, stripes)):
            raise AssertionError("cross-shard encode differs from the "
                                 "host's")
        if crc32c.launches <= k2_before:
            raise AssertionError("the cross-shard crc job never launched "
                                 "K2")
        out["c"] = {"crc_blocks": XSHARD_BLOCKS,
                    "encode_shape": list(stripes.shape),
                    "k2_launches": crc32c.launches - k2_before}

        # -- 12d: the sanitizer armed over 12a's pass ------------------------
        trips = sanitizer.perf().dump()["san_view_guard_trips"]
        sanitizer.take_foreign_call_soon()
        sanitizer.set_lockdep(True)
        await pool.run_on_each(lambda: sanitizer.install(view_guards=True))
        try:
            sanitizer.clear_lockset_conflicts()
            san_wall = await pool_pass()
            conflicts = sanitizer.lockset_conflicts()
            inversions = sanitizer.lockdep_inversions()
        finally:
            await pool.run_on_each(sanitizer.uninstall)
            sanitizer.set_lockdep(False)
        foreign = sanitizer.take_foreign_call_soon()
        new_trips = sanitizer.perf().dump()["san_view_guard_trips"] - trips
        if conflicts or inversions or foreign or new_trips:
            raise AssertionError(
                f"sanitizer over the pool pass: lockset conflicts "
                f"{conflicts}, lockdep inversions {inversions}, foreign "
                f"call_soon {foreign}, view-guard trips {new_trips}")
        out["d"] = {"wall_s": san_wall,
                    "gb_per_s": SHARDS * sp.nbytes / san_wall / 1e9,
                    "lockset_conflicts": 0, "lockdep_inversions": 0,
                    "view_guard_trips": 0, "foreign_call_soon": 0}

        # -- 12e: one shard's writes under the interleave explorer -----------
        async def explored():
            svc = offload.get_service([dev])
            async with interleave.explore(seed=7) as ex:
                outs = await asyncio.gather(*[
                    ec_util.encode_async(sp.sinfo, sp.code, w, service=svc)
                    for w in sp.writes[:FAULT_WRITES]])
                await svc.drain()
            # the explorer's per-site decision count
            return outs, ex.digest(), ex._counts.get("offload_dispatch", 0)
        outs, digest, at_dispatch = await pool.run_on(1, explored())
        for w, got in enumerate(outs):
            if {i: bytes(b) for i, b in got.items()} != sp.sync[w]:
                raise AssertionError(f"explored write {w} differs")
        if at_dispatch < 1:
            raise AssertionError("the explorer made no decision at "
                                 "offload_dispatch")
        out["e"] = {"digest": digest, "offload_dispatch_decisions":
                    at_dispatch}

        # -- 12f: the admin socket -------------------------------------------
        tmp = tempfile.mkdtemp(prefix="asok")
        path = os.path.join(tmp, "osd.asok")
        asok = AdminSocket(path)
        asok.register_command("ec offload status",
                              lambda req: svc1.status(),
                              "offload service: queue/batch/fallback "
                              "stats + settings")
        asok.register_command("ec offload flush", lambda req: svc1.flush(),
                              "force-flush every pending offload batch "
                              "bucket")
        asok.start()
        try:
            running = asyncio.run_coroutine_threadsafe(shard_pass(),
                                                       pool.loop(1))
            # from the main thread, while shard 1 runs its pass
            status = admin_command(path, "ec offload status")
            flushed = admin_command(path, "ec offload flush")
            perf = admin_command(path, "perf dump")
            crashes = admin_command(path, "crash ls")
            results, _ = await asyncio.wrap_future(running)
            sp.check(np, results)
        finally:
            asok.stop()
            shutil.rmtree(tmp, ignore_errors=True)
        row = status.get("result", {}).get("devices", {}).get(label, {})
        if "error" in status or row.get("batches", 0) <= 0 or \
                status["result"]["last_error"]:
            raise AssertionError(f"ec offload status: {status}")
        if "flushed_buckets" not in flushed.get("result", {}):
            raise AssertionError(f"ec offload flush: {flushed}")
        if perf.get("result", {}).get("offload", {}).get("jobs", 0) <= 0:
            raise AssertionError("perf dump holds no offload counters")
        if crashes.get("result") != []:
            raise AssertionError(f"crash ls: {crashes}")
        out["f"] = {"status_batches": row["batches"],
                    "flushed_buckets": flushed["result"]["flushed_buckets"]}
    finally:
        await pool.shutdown()
    return out


async def _reactor_fault(np, dev, sp) -> dict:
    """Phase 12b: SHARDS front ends, each over [dev] * 4 (four slots on
    one card), one armed device failure."""
    import asyncio

    from ceph_tpu_torch import offload
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.qa import faultinject
    from ceph_tpu_torch.utils import flight, reactor
    from ceph_tpu_torch.utils.config import Config
    devices = [dev] * 4
    pool = reactor.ShardPool(SHARDS)
    cfg = Config()
    offload.register_config(cfg)
    try:
        services = await pool.run_on_each(
            lambda: offload.get_service(devices))
        # through the observer into every live service
        cfg.set("ec_offload_breaker_reset_s", 0.5)
        cfg.set("ec_offload_linger_ms", 1)
        if any(s.breaker_reset_s != 0.5 or s.linger_ms != 1.0
               for s in services):
            raise AssertionError("config set did not reach every service")

        async def submit_many(n):
            svc = offload.get_service(devices)
            outs = await asyncio.gather(*[
                ec_util.encode_async(sp.sinfo, sp.code, w, service=svc)
                for w in sp.writes[:n]])
            return [{i: bytes(b) for i, b in o.items()} == sp.sync[w]
                    for w, o in enumerate(outs)]

        async def round_(n):
            oks = await asyncio.gather(*[pool.run_on(i, submit_many(n))
                                         for i in range(SHARDS)])
            if not all(ok for shard in oks for ok in shard):
                raise AssertionError("an encode differs from the "
                                     "synchronous path")

        def totals():
            return (sum(s.stats["fallback_ops"] for s in services),
                    sum(s.stats["breaker_trips"] for s in services))

        await round_(1)                    # warm every shard
        if len({id(s._topo) for s in services}) != 1:
            raise AssertionError("the shards do not share one topology")
        fb0, tr0 = totals()
        flight.reset()
        faultinject.reset(seed=0)
        faultinject.set_enabled(True)
        faultinject.arm_device_failures(1)
        try:
            await round_(FAULT_WRITES)
        finally:
            faultinject.set_enabled(False)
        fb1, tr1 = totals()
        outs = {s.health_metrics()["devices_out"] for s in services}
        events = flight.dump()["events"]
        injected = [e for e in events if e["type"] == "fault_injected"]
        tripped = [e for e in events if e["type"] == "breaker_trip"]
        if tr1 - tr0 != 1 or not 1 <= fb1 - fb0 <= FAULT_WRITES:
            raise AssertionError(f"armed failure: {tr1 - tr0} breaker "
                                 f"trips, {fb1 - fb0} fallback ops")
        if len(outs) != 1 or not outs <= {0, 1} or \
                any(s.degraded for s in services):
            raise AssertionError(f"devices_out by shard {outs}")
        if len(injected) != 1 or injected[0]["entity"] != \
                "device_oneshot" or len(tripped) != 1:
            raise AssertionError(f"flight ring: {injected} {tripped}")
        await asyncio.sleep(0.6)           # past breaker_reset_s
        await round_(1)
        fb2, _ = totals()
        after = {s.health_metrics()["devices_out"] for s in services}
        if fb2 != fb1 or after != {0}:
            raise AssertionError(f"clean round: {fb2 - fb1} new fallback "
                                 f"ops, devices_out {after}")
        return {"breaker_trips": tr1 - tr0, "fallback_ops": fb1 - fb0,
                "devices_out_after_fault": sorted(outs),
                "tripped": tripped[0]["entity"],
                "devices_out_after_reset": 0}
    finally:
        for name in ("ec_offload_breaker_reset_s", "ec_offload_linger_ms"):
            cfg.rm(name)                   # back to the defaults
        faultinject.reset(seed=0)
        await pool.shutdown()


def phase_reactor(torch, np, dev, window_cls=None) -> dict:
    """Phase 12: the sharded service on the card. `window_cls`, default
    DeviceWindow, traces the card over one pool pass."""
    import asyncio

    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.ops import crc32c, rs_codec
    code = factory("cuda", {"k": str(K), "m": str(M), "device": str(dev)})
    sp = ServicePass(np, code)
    saved = sys.getswitchinterval()
    # the references above launched K1 themselves: count from here
    rs_codec.launches = crc32c.launches = rs_codec.encode_local_launches = 0

    def restored() -> float:
        if sys.getswitchinterval() != saved:
            raise AssertionError(f"switch interval "
                                 f"{sys.getswitchinterval()} after "
                                 f"shutdown, {saved} before the pool")
        return saved
    out = asyncio.run(_reactor_pool(torch, np, dev, sp,
                                    window_cls or DeviceWindow))
    out["switch_interval_after_s"] = restored()
    out["b"] = asyncio.run(_reactor_fault(np, dev, sp))
    restored()
    out["launches"] = {"gf_bitmatrix": rs_codec.launches,
                       "crc32c_blocks": crc32c.launches,
                       "gf_bitmatrix_csum": rs_codec.encode_local_launches}
    return out


def log_reactor(r: dict, smi: str) -> None:
    a, b, c, d, e, f = (r[x] for x in "abcdef")
    log(f"phase 12a: {SHARDS} shards over one card ({smi}; GIL switch "
        f"interval {r['switch_interval_s'] * 1e3:.1f} ms in the pool, "
        f"{r['switch_interval_after_s'] * 1e3:.1f} ms after): pool pass "
        f"{SHARDS} x {a['pass_bytes'] / 2**20:.0f} MiB at "
        f"{a['pool_gb_per_s_median']:.3f} GB/s median of "
        f"{[round(x, 3) for x in a['pool_gb_per_s']]}, one shard alone "
        f"{a['one_gb_per_s_median']:.3f} GB/s median of "
        f"{[round(x, 3) for x in a['one_gb_per_s']]} (host clock); "
        f"fallback_ops {a['fallback_ops']}, {a['batches']} batches")
    log(f"phase 12a: card over one pool pass: busy "
        f"{a['busy_s'] if a['busy_s'] is None else round(a['busy_s'], 4)} s "
        f"of {a['profiled_wall_s']:.4f} s, idle {share(a['idle_share'])}; "
        f"staging pages held by the {SHARDS} shards' slots: "
        f"{a['staging_pages']} ({a['staging_bytes'] / 2**20:.0f} MiB pinned)")
    for shard, lag in a["loop_lag"].items():
        busy = a["loop_busy"].get(shard, {})
        log(f"phase 12a: {shard} under loopprof: loop busy "
            f"{busy.get('loop_busy_fraction')}, lag "
            f"{lag['lag_ms']} ms (max {lag['lag_max_ms']} ms), executor "
            f"queue depth max {lag['executor_depth_max']}")
    log(f"phase 12b: one armed device failure over {SHARDS} shards x 4 "
        f"slots: {b['breaker_trips']} breaker trip ({b['tripped']}), "
        f"{b['fallback_ops']} fallback ops, devices_out "
        f"{b['devices_out_after_fault']}, 0 after the reset")
    log(f"phase 12c: shard 0 -> shard 1 submit_threadsafe: crc32c_blocks "
        f"of {c['crc_blocks']} x 4 KiB ({c['k2_launches']} K2 launches) and "
        f"an encode of {c['encode_shape']}, equal to the host's")
    log(f"phase 12d: sanitizer armed (view guards, locksets, lockdep): "
        f"pool pass {d['gb_per_s']:.3f} GB/s beside 12a's "
        f"{a['pool_gb_per_s_median']:.3f}; 0 conflicts, inversions, trips, "
        f"foreign call_soon")
    log(f"phase 12e: explorer seed 7, {e['offload_dispatch_decisions']} "
        f"decisions at offload_dispatch, digest {e['digest'][:16]}")
    log(f"phase 12f: admin socket: ec offload status {f['status_batches']} "
        f"batches on the card, flush {f['flushed_buckets']} buckets; launches "
        f"on the reactor path {r['launches']}")


def phase_bench_driver(dev, yardstick_gbps: float) -> dict:
    """The port's bench_driver through its `main`: --stage device, every
    key of the reference's stage present and measured, and --stage
    mesh_scaling, bit-identical over 1, 2 and 4 slots of the card."""
    from ceph_tpu_torch.tools import bench_driver
    stages = {}
    for stage in ("device", "mesh_scaling"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = bench_driver.main(["--stage", stage, "--device", str(dev)])
        line = buf.getvalue().strip().splitlines()[-1]
        log(f"phase 11: bench_driver --stage {stage}: {line}")
        if rc != 0:
            raise AssertionError(f"bench_driver --stage {stage} exited {rc}")
        stages[stage] = json.loads(line)
    dstage = stages["device"]
    missing = [key for key in DEVICE_STAGE_KEYS if key not in dstage]
    if missing or any(dstage[key] <= 0 for key in DEVICE_STAGE_KEYS
                      if key != "platform"):
        raise AssertionError(f"device stage keys missing {missing} or not "
                             f"measured: {dstage}")
    if not stages["mesh_scaling"]["scaling_bit_identical"]:
        raise AssertionError("mesh_scaling: parity differs across meshes")
    log(f"phase 11: device_peak_gbps {dstage['device_peak_gbps']} (x + 1.0 "
        f"over one buffer) beside phase 4's read yardstick "
        f"{yardstick_gbps:.1f} GB/s")
    return stages


def plugin_chunk(code) -> int:
    """The smallest chunk of at least 1 MiB that the plugin lays out as it
    is and that BlueStore's 4 KiB csum blocks tile: 1 MiB, except for
    liberation w=7, whose chunks are multiples of w * 64 bytes."""
    k = code.get_data_chunk_count()
    chunk = CHUNK
    while code.get_chunk_size(k * chunk) != chunk:
        chunk += CSUM_BLOCK
    return chunk


def erasure_patterns(code, rng) -> list[tuple[int, ...]]:
    """Every single erasure, then MULTI_ERASURES distinct patterns of 2 to
    m erasures drawn by rng among those the plugin can decode: shec and
    lrc are not MDS, and their own minimum_to_decode decides."""
    from ceph_tpu_torch.ec.interface import ErasureCodeError
    n = code.get_chunk_count()
    m = n - code.get_data_chunk_count()
    multi: list[tuple[int, ...]] = []
    for _ in range(10000):
        if len(multi) == MULTI_ERASURES:
            break
        size = int(rng.integers(2, m + 1))
        lost = tuple(sorted(int(i) for i in rng.choice(n, size,
                                                       replace=False)))
        if lost in multi:
            continue
        try:
            code.minimum_to_decode(set(lost), set(range(n)) - set(lost))
        except ErasureCodeError:
            continue
        multi.append(lost)
    if len(multi) < MULTI_ERASURES:
        raise AssertionError(f"only {len(multi)} decodable patterns")
    return [(i,) for i in range(n)] + multi


def phase_plugins(torch, np, dev, window=None) -> dict:
    """Every plugin on `dev`: the corpus through ec_non_regression, then
    each of PLUGINS at full width through ECUtil (encode an object of
    PLUGIN_STRIPES stripes, K2 checksums of every shard, decode_concat
    and decode_shards of the object under every single erasure and the
    seeded multi-erasure patterns), its scalar encode and decode of one
    stripe, and for clay one MSR repair from sub-chunk reads. Outputs are held against the same plugin built with
    device=cpu on the same bytes and against the payload. Each plugin's
    launch counts are read from 0 around its own run. `window(name)`,
    when given, returns a context manager entered around each plugin's
    run on the card. Returns the measurements; asserts nothing about the
    counts."""
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.ops import crc32c, rs_codec
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.tools import ec_non_regression
    from ceph_tpu_torch.utils.checksummer import Checksummer

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out: dict = {}
    rs_codec.launches = crc32c.launches = 0
    t0 = time.perf_counter()
    errors = ec_non_regression.check_all(CORPUS, str(dev))
    sync()
    if errors:
        raise AssertionError(f"corpus differs on {dev}: {errors}")
    out["corpus"] = {"entries": len(os.listdir(os.path.join(CORPUS, "v1"))),
                     "seconds": time.perf_counter() - t0,
                     "launches": {"gf_bitmatrix": rs_codec.launches}}
    dev_cs = Checksummer("crc32c", CSUM_BLOCK, use_device=True, device=dev)
    host_cs = Checksummer("crc32c", CSUM_BLOCK, use_device=False)
    for idx, (name, profile) in enumerate(PLUGINS):
        code = factory(name, {**profile, "device": str(dev)})
        ref = factory(name, {**profile, "device": "cpu"})
        k, n = code.get_data_chunk_count(), code.get_chunk_count()
        chunk = plugin_chunk(code)
        sinfo = ec_util.StripeInfo(k, k * chunk)
        rng = np.random.default_rng(90 + idx)
        payload = rng.integers(0, 256, PLUGIN_STRIPES * sinfo.stripe_width,
                               dtype=np.uint8).tobytes()
        patterns = erasure_patterns(ref, rng)
        stripe = payload[:sinfo.stripe_width]
        rs_codec.launches = crc32c.launches = 0
        win = window(name) if window is not None else contextlib.nullcontext()
        with win:
            t0 = time.perf_counter()
            shards = {i: bytes(b) for i, b in
                      ec_util.encode(sinfo, code, payload).items()}
            csums = {i: dev_cs.calculate(b) for i, b in shards.items()}
            scalar = code.encode(range(n), stripe)
            for lost in patterns:
                have = {i: b for i, b in shards.items() if i not in lost}
                if ec_util.decode_concat(sinfo, code, have) != payload:
                    raise AssertionError(f"{name} decode_concat {lost}")
                rebuilt = ec_util.decode_shards(sinfo, code, have, lost)
                if any(rebuilt[i] != shards[i] for i in lost):
                    raise AssertionError(f"{name} decode_shards {lost}")
            lost = patterns[n]
            have = {i: b for i, b in scalar.items() if i not in lost}
            if code.decode(set(lost), have, chunk) != {i: scalar[i]
                                                       for i in lost}:
                raise AssertionError(f"{name} scalar decode {lost}")
            repair = None
            if name == "clay":
                repair = clay_repair(np, ec_util, code, sinfo, shards,
                                     chunk)
            sync()
            seconds = time.perf_counter() - t0
        launches = {"gf_bitmatrix": rs_codec.launches,
                    "crc32c_blocks": crc32c.launches}
        # what came out, against the CPU build of the same plugin
        want = {i: bytes(b)
                for i, b in ec_util.encode(sinfo, ref, payload).items()}
        if shards != want:
            raise AssertionError(f"{name}: shards differ from device=cpu")
        if scalar != {i: b[:chunk] for i, b in want.items()}:
            raise AssertionError(f"{name}: scalar encode differs")
        for i, b in shards.items():
            if not np.array_equal(csums[i], host_cs.calculate(b)):
                raise AssertionError(f"{name}: shard {i} checksums differ")
        out[name] = {
            "profile": profile, "chunk": chunk, "stripes": PLUGIN_STRIPES,
            "patterns": [list(p) for p in patterns], "seconds": seconds,
            "launches": launches, "repair": repair}
    return out


def clay_repair(np, ec_util, code, sinfo, shards, chunk) -> dict:
    """One MSR repair of chunk 5: its plan's sub-chunk runs read from the
    d helpers of the first stripe through the plugin's decode, then the
    same plan over the whole object through ECUtil's fragment rebuild.
    Each helper must give 1/q of its chunk."""
    lost, n = 5, code.get_chunk_count()
    sub = code.get_sub_chunk_count()
    minimum = code.minimum_to_decode({lost}, set(range(n)) - {lost})
    stripes = len(shards[0]) // chunk
    helpers, frags = {}, {}
    for cid, runs in minimum.items():
        planes = np.frombuffer(shards[cid], dtype=np.uint8).reshape(
            stripes, sub, -1)
        fetched = np.concatenate([planes[:, off:off + cnt]
                                  for off, cnt in runs], axis=1)
        if fetched[0].size * code.q != chunk:
            raise AssertionError(f"helper {cid} gives {fetched[0].size} of "
                                 f"{chunk} bytes, not 1/{code.q}")
        helpers[cid] = fetched[0].tobytes()
        frags[cid] = fetched.tobytes()
    if len(helpers) != code.d:
        raise AssertionError(f"{len(helpers)} helpers, not d={code.d}")
    got = code.decode({lost}, helpers, chunk)
    if got[lost] != shards[lost][:chunk]:
        raise AssertionError("clay repair from sub-chunks differs")
    rebuilt = ec_util.decode_shards(sinfo, code, frags, [lost],
                                    fragments=True)
    if rebuilt[lost] != shards[lost]:
        raise AssertionError("clay fragment rebuild differs")
    read = sum(map(len, helpers.values()))
    return {"lost": lost, "helpers": len(helpers), "read_bytes": read,
            "chunk": chunk, "read_share_of_chunk": read / (code.d * chunk)}


def phase_plugin_bench(torch, np, dev, rates) -> dict:
    """`ec_benchmark --mode scalar` encode and decode at 1 MiB chunks for
    the plugins that launch K1, and K1 at clay's largest plane batch:
    its encode's 64 planes of 16 KiB in one apply, (1,8,1 MiB) -> (1,4),
    back to back, on the card (profiler) and through the host `apply`
    that clay calls (upload, launch, download; median of 10, host
    clock)."""
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.ops import rs_codec
    from ceph_tpu_torch.tools import ec_benchmark
    out: dict = {"bench": {}}
    for name, profile in PLUGINS[:4]:
        k = int(profile["k"])
        for workload in ("encode", "decode"):
            cfg = ec_benchmark.BenchConfig(
                plugin=name, workload=workload, size=k * CHUNK,
                iterations=4, erasures=1, seed=42, parameters=dict(profile),
                mode="scalar", warmup=1, device=str(dev))
            res = ec_benchmark.run_bench(cfg)
            out["bench"][f"{name} {workload}"] = {
                "seconds": res.seconds, "kib": res.kib,
                "gb_per_s": res.gb_per_s}
    clay = factory("clay", {**PLUGINS[2][1], "device": str(dev)})
    kp = clay.k + clay.nu
    grid = clay.q * clay.t
    R = rs_codec.recovery_matrix(clay.mds.coding_matrix, tuple(range(kp)),
                                 tuple(range(kp, grid)))
    codec = rs_codec.MatrixCodec.get(R)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    x = torch.randint(0, 256, (1, kp, CHUNK), dtype=torch.uint8, device=dev,
                      generator=gen)
    host = x[0].cpu().numpy()
    r = R.shape[0]
    bound, by = bound_ms((kp + r) * CHUNK, 2 * (8 * r) * (8 * kp) * CHUNK,
                         rates)
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        codec.apply(host, dev)
        times.append((time.perf_counter() - t0) * 1e3)
    out["clay_batch"] = {
        "shape": f"(1,{kp},{CHUNK}) -> (1,{r},{CHUNK})",
        "ms": time_ms(torch, lambda: codec.apply_batch_device(x), 30),
        "profiled_ms": profiled_ms(torch, lambda: codec.apply_batch_device(x),
                                   "gf_bitmatrix_kernel"),
        "host_apply_ms": statistics.median(times),
        "bound_ms": bound, "bound_by": by}
    return out


# -- phase 13: an EC object through placement, the wire and the stores -------

def port_modules():
    """The port's modules that phase 13 composes. Its CPU test hands
    `StorePath` the JAX package's modules under the same names, so one
    composition runs through either package."""
    import types

    from ceph_tpu_torch import crush, objectstore
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.msg import frames, messages, messenger
    from ceph_tpu_torch.osd import ec_util
    return types.SimpleNamespace(
        crush=crush, objectstore=objectstore, factory=factory,
        frames=frames, messages=messages, messenger=messenger,
        ec_util=ec_util)


class StorePath:
    """The storage pattern of the OSD's ECBackend
    (tests/test_objectstore.py:185), composed from the modules in `mods`:
    an OSDMap of `sum(layout)` OSDs on `len(layout)` hosts places one EC
    object's PG (an `indep` rule, failure domain osd); each OSD has its
    own BlueStore on the LSM under `root`. The object's shards travel as
    MOSDECSubOpWrite / MOSDECSubOpRead between two Messengers over
    loopback; the far side queues one Transaction a message on the
    acting OSD's store (the shard collection, a write at the chunk's
    offset, the `hinfo_key` xattr) and answers with the reply type.

    `profile` is the pool's EC profile in the map; the code is built
    from it with `code_extra` added (the device). Host 0 must hold m
    OSDs: phase 13d takes it out and decodes from the k survivors."""

    POOL, OBJECT = "ecpool", "ecobj"
    TIMEOUT_S = 300.0

    def __init__(self, mods, root: str, k: int, m: int, chunk: int,
                 stripes: int, layout, profile: dict,
                 code_extra: dict | None = None, seed: int = 42):
        import numpy as np
        self.mods, self.root = mods, root
        self.k, self.m, self.chunk, self.stripes = k, m, chunk, stripes
        crush = mods.crush
        cm = crush.CrushMap()
        top = cm.add_bucket(10, "default")
        self.host_of: dict[int, int] = {}
        osd = 0
        for h, count in enumerate(layout):
            host = cm.add_bucket(1, f"host{h}")
            cm.add_item(top, host, float(count))
            for _ in range(count):
                cm.add_item(host, osd, 1.0, name=f"osd.{osd}")
                self.host_of[osd] = h
                osd += 1
        cm.make_simple_rule(0, "ec", "default", failure_domain_type=0,
                            mode="indep")
        om = self.osdmap = crush.OSDMap(cm)
        for o in range(osd):
            om.add_osd(o, addr=f"127.0.0.1:{6800 + o}")
            om.set_up(o, True)
        om.ec_profiles["ec"] = dict(profile)
        self.pool = om.create_pool(self.POOL, type="erasure", size=k + m,
                                   min_size=k, pg_num=8, crush_rule=0,
                                   ec_profile="ec", stripe_width=k * chunk)
        om.inc_epoch()
        self.pg = om.object_to_pg(self.POOL, self.OBJECT)
        self.acting = list(om.pg_to_up_acting_osds(self.pg)[1])
        if sorted(self.acting) != list(range(osd)) or osd != k + m:
            raise AssertionError(f"acting set {self.acting} of {osd} OSDs "
                                 f"for k={k} m={m}")
        self.lost = [s for s in range(k + m)
                     if self.host_of[self.acting[s]] == 0]
        if len(self.lost) != m or min(self.lost) >= k:
            raise AssertionError(f"host0 holds shards {self.lost}: phase "
                                 f"13 needs m of them, a data shard first")
        self.rot_shard = min(self.lost)
        self.code = mods.factory(profile["plugin"],
                                 {**profile, **(code_extra or {})})
        self.sinfo = mods.ec_util.StripeInfo(k, k * chunk)
        self.data = np.random.default_rng(seed).integers(
            0, 256, stripes * k * chunk, dtype=np.uint8).tobytes()
        os_ = mods.objectstore
        self.stores = {}
        for o in range(osd):
            st = os_.BlueStore(os.path.join(root, f"osd.{o}"))
            st.mkfs()
            st.mount()
            self.stores[o] = st
        self._tid = 0
        self._pending: dict = {}

    # -- names ---------------------------------------------------------------

    def cid(self, shard: int):
        return self.mods.objectstore.CollectionId.make_pg(
            self.pool.id, self.pg.ps, shard=shard)

    def oid(self, shard: int):
        return self.mods.objectstore.Ghobject(
            pool=self.pool.id, name=self.OBJECT, shard=shard)

    # -- the wire ------------------------------------------------------------

    async def start(self) -> None:
        ms, msgs = self.mods.messenger, self.mods.messages
        os_ = self.mods.objectstore
        path = self
        self.store_s = 0.0

        class ShardSide(ms.Dispatcher):
            """The acting OSDs' side: one Transaction a sub-write, one
            store read a sub-read."""

            async def ms_dispatch(self, conn, msg):
                p = msg.payload
                if isinstance(msg, (msgs.MOSDECSubOpWrite,
                                    msgs.MOSDECSubOpRead)):
                    store = path.stores[p["osd"]]
                    (pool, ps), shard = p["pgid"], p["shard"]
                    cid = os_.CollectionId.make_pg(pool, ps, shard=shard)
                    oid = os_.Ghobject(pool=pool, name=p["oid"], shard=shard)
                reply = {"tid": p.get("tid"), "shard": p.get("shard"),
                         "rc": 0}
                if isinstance(msg, msgs.MOSDECSubOpWrite):
                    t = os_.Transaction()
                    if not store.collection_exists(cid):
                        t.create_collection(cid)
                    t.write(cid, oid, p["chunk_off"], msg.data)
                    t.setattrs(cid, oid, {"hinfo_key": p["hinfo"].encode()})
                    t0 = time.perf_counter()
                    try:
                        store.queue_transaction(t)
                    except os_.StoreError as e:
                        reply.update(rc=-5, error=f"{e.code} {e}")
                    path.store_s += time.perf_counter() - t0
                    conn.send_message(msgs.MOSDECSubOpWriteReply(reply))
                    return True
                if isinstance(msg, msgs.MOSDECSubOpRead):
                    data = b""
                    try:
                        data = store.read(cid, oid)
                    except os_.StoreError as e:
                        reply.update(rc=-5 if e.code == "EIO" else -2,
                                     error=f"{e.code} {e}")
                    conn.send_message(msgs.MOSDECSubOpReadReply(reply, data))
                    return True
                return False

        class PrimarySide(ms.Dispatcher):
            async def ms_dispatch(self, conn, msg):
                fut = path._pending.pop(msg.payload.get("tid"), None)
                if fut is None or fut.done():
                    return False
                fut.set_result(msg)
                return True

        self.server = ms.Messenger("osd.shards")
        self.server.add_dispatcher(ShardSide())
        addr = await self.server.bind()
        self.client = ms.Messenger("osd.primary")
        self.client.add_dispatcher(PrimarySide())
        self.conn = await self.client.connect(addr,
                                              ms.Policy.lossless_peer())

    async def stop(self) -> None:
        await self.client.shutdown()
        await self.server.shutdown()

    async def _exchange(self, messages: list) -> list:
        """Send every message on the one connection; their replies, in
        order."""
        import asyncio
        loop = asyncio.get_running_loop()
        futs = []
        for msg in messages:
            self._tid += 1
            msg.payload["tid"] = self._tid
            self._pending[self._tid] = fut = loop.create_future()
            futs.append(fut)
            self.conn.send_message(msg)
        return await asyncio.wait_for(asyncio.gather(*futs), self.TIMEOUT_S)

    def _read_msg(self, shard: int, osd: int):
        return self.mods.messages.MOSDECSubOpRead({
            "pgid": [self.pool.id, self.pg.ps], "oid": self.OBJECT,
            "shard": shard, "osd": osd})

    # -- 13a-13d -------------------------------------------------------------

    async def write(self) -> dict:
        """13a: encode the object, then every (stripe, shard) chunk as
        one MOSDECSubOpWrite with the cumulative HashInfo of its stripe."""
        import json
        eu, msgs = self.mods.ec_util, self.mods.messages
        c, n = self.chunk, self.k + self.m
        t0 = time.perf_counter()
        shards = eu.encode(self.sinfo, self.code, self.data)
        t1 = time.perf_counter()
        self.shards = {s: memoryview(shards[s]).cast("B") for s in range(n)}
        hinfo = eu.HashInfo(n)
        subs = []
        for st in range(self.stripes):
            chunks = {s: self.shards[s][st * c:(st + 1) * c]
                      for s in range(n)}
            hinfo.append(st * c, chunks)
            blob = json.dumps(hinfo.to_dict())
            for s in range(n):
                subs.append(msgs.MOSDECSubOpWrite(
                    {"pgid": [self.pool.id, self.pg.ps], "oid": self.OBJECT,
                     "shard": s, "osd": self.acting[s], "chunk_off": st * c,
                     "hinfo": blob}, chunks[s]))
        t2 = time.perf_counter()
        self.store_s = 0.0
        replies = await self._exchange(subs)
        t3 = time.perf_counter()
        bad = [r.payload for r in replies if r.payload["rc"]]
        if bad or len(replies) != n * self.stripes:
            raise AssertionError(f"sub-writes failed: {bad[:3]}")
        return {"messages": len(subs), "encode_s": t1 - t0,
                "hinfo_s": t2 - t1, "exchange_s": t3 - t2,
                "store_s": self.store_s,
                "wire_s": t3 - t2 - self.store_s, "wall_s": t3 - t0,
                "object_bytes": len(self.data),
                "shard_bytes": n * self.stripes * c}

    def au_csums(self, shard: int) -> list:
        """The per-AU crc32c list BlueStore keeps in a shard's onode."""
        on = self.stores[self.acting[shard]]._onode(self.cid(shard),
                                                    self.oid(shard))
        return [x for _, _, crcs in on["extents"] for x in crcs]

    def remount(self) -> dict:
        """13b: umount and mount every store, read each shard back
        through BlueStore's per-AU csum verify; the bytes must be the
        encode's."""
        t0 = time.perf_counter()
        for st in self.stores.values():
            st.umount()
        for st in self.stores.values():
            st.mount()
        t1 = time.perf_counter()
        self.readback = {}
        for s, osd in enumerate(self.acting):
            self.readback[s] = self.stores[osd].read(self.cid(s), self.oid(s))
        t2 = time.perf_counter()
        for s, b in self.readback.items():
            if b != self.shards[s]:
                raise AssertionError(f"shard {s} read back differs")
        self.csums = {s: self.au_csums(s) for s in self.readback}
        self.hinfo_keys = {s: self.stores[osd].getattr(
            self.cid(s), self.oid(s), "hinfo_key")
            for s, osd in enumerate(self.acting)}
        return {"remount_s": t1 - t0, "read_s": t2 - t1,
                "aus": sum(len(v) for v in self.csums.values()),
                "bytes": sum(len(b) for b in self.readback.values())}

    async def bitrot_read(self) -> dict:
        """13c: flip one byte in one AU of a data shard's block file; its
        read raises EIO, the shard counts as lost, and the object decodes
        from the other k+m-1 shards read over the wire."""
        osd = self.acting[self.rot_shard]
        store = self.stores[osd]
        unit, count, _ = store._onode(self.cid(self.rot_shard),
                                      self.oid(self.rot_shard))["extents"][0]
        at = (unit + count // 2) * 4096 + 100
        store.umount()
        with open(os.path.join(self.root, f"osd.{osd}", "block"),
                  "r+b") as f:
            f.seek(at)
            b = f.read(1)
            f.seek(at)
            f.write(bytes([b[0] ^ 0x40]))
        store.mount()
        t0 = time.perf_counter()
        replies = await self._exchange(
            [self._read_msg(s, o) for s, o in enumerate(self.acting)])
        t1 = time.perf_counter()
        got = {}
        errors = {}
        for r in replies:
            if r.payload["rc"]:
                errors[r.payload["shard"]] = r.payload["error"]
            else:
                got[r.payload["shard"]] = r.data
        if sorted(errors) != [self.rot_shard] or \
                not errors[self.rot_shard].startswith("EIO"):
            raise AssertionError(f"bitrot read errors {errors}")
        self.decoded_rot = self.mods.ec_util.decode_concat(
            self.sinfo, self.code, got)
        t2 = time.perf_counter()
        if self.decoded_rot != self.data:
            raise AssertionError("decode after bitrot differs")
        return {"rot_shard": self.rot_shard, "osd": osd, "at": at,
                "error": errors[self.rot_shard], "shards_read": len(got),
                "read_s": t1 - t0, "decode_s": t2 - t1,
                "bytes": sum(len(v) for v in got.values())}

    async def host_out_read(self) -> dict:
        """13d: an Incremental marks host0's OSDs out. CRUSH re-places
        the PG (the up set); as an OSD would until backfill, the same
        Incremental pins the acting set with pg_temp to the shards'
        present homes, with holes where host0's OSDs were. The object
        decodes from the k survivors."""
        crush = self.mods.crush
        om = self.osdmap
        out = sorted(o for o, h in self.host_of.items() if h == 0)
        holes = [crush.CRUSH_NONE if s in self.lost else o
                 for s, o in enumerate(self.acting)]
        om.apply_incremental(crush.Incremental(
            epoch=om.epoch + 1, new_out=out, new_pg_temp={self.pg: holes}))
        up, acting = (list(v) for v in om.pg_to_up_acting_osds(self.pg))
        self.up_after, self.acting_after = up, acting
        if acting != holes or up.count(crush.CRUSH_NONE) != self.m or \
                set(up) & set(out):
            raise AssertionError(f"after host0 out: up {up}, acting "
                                 f"{acting}, expected acting {holes}")
        survivors = [s for s, o in enumerate(acting) if o != crush.CRUSH_NONE]
        t0 = time.perf_counter()
        replies = await self._exchange(
            [self._read_msg(s, acting[s]) for s in survivors])
        t1 = time.perf_counter()
        if any(r.payload["rc"] for r in replies):
            raise AssertionError([r.payload for r in replies
                                  if r.payload["rc"]])
        got = {r.payload["shard"]: r.data for r in replies}
        self.decoded_out = self.mods.ec_util.decode_concat(
            self.sinfo, self.code, got)
        t2 = time.perf_counter()
        if self.decoded_out != self.data:
            raise AssertionError("decode with host0 out differs")
        return {"out": out, "acting_before": list(self.acting),
                "up_after": up, "acting_after": acting,
                "erasures": len(self.lost),
                "read_s": t1 - t0, "decode_s": t2 - t1,
                "gb_per_s": len(self.data) / (t2 - t0) / 1e9}

    def close(self) -> None:
        for st in self.stores.values():
            st.umount()


async def drive_store_path(path: StorePath, window=None) -> dict:
    """13a-13d on `path`; `window`, a context manager, is entered around
    13a alone. The native frame codec must be the one in use: a run that
    fell back to the Python codec would measure something else (the
    stores' crc needs the same native library)."""
    if not path.mods.frames.native_active():
        raise AssertionError("the native frame codec is not active")
    await path.start()
    try:
        with window if window is not None else contextlib.nullcontext():
            a = await path.write()
        b = path.remount()
        c = await path.bitrot_read()
        d = await path.host_out_read()
    finally:
        await path.stop()
    return {"a": a, "b": b, "c": c, "d": d}


def phase_store_path(torch, np, dev, smi: str, rates, window_cls=None,
                     stripes: int = BATCH) -> dict:
    """Phase 13 on the card: StorePath at the north star's width (k=8
    m=3, 1 MiB chunks, `stripes` stripes, 11 BlueStores on 5 hosts) with
    plugin `cuda`, in a temporary directory removed at the end; the
    card's idle share over 13a (`window_cls`, default DeviceWindow);
    and, as a comparison line, the stores' AUs through K2 on the card
    against the stores' host crc."""
    import asyncio
    import shutil
    import tempfile

    from ceph_tpu_torch.ops import crc32c, rs_codec
    from ceph_tpu_torch.utils.checksummer import Checksummer
    root = tempfile.mkdtemp(prefix="chip_smoke_stores_")
    try:
        path = StorePath(port_modules(), root, K, M, CHUNK, stripes,
                         STORE_LAYOUT,
                         {"plugin": "cuda", "k": str(K), "m": str(M),
                          "technique": "reed_sol_van",
                          "crush-failure-domain": "osd"},
                         {"device": str(dev)}, seed=STORE_SEED)
        window = (window_cls or DeviceWindow)(torch)
        rs_codec.launches = crc32c.launches = rs_codec.encode_local_launches = 0
        out = asyncio.run(drive_store_path(path, window))
        out["launches"] = {"gf_bitmatrix": rs_codec.launches,
                           "crc32c_blocks": crc32c.launches,
                           "gf_bitmatrix_csum": rs_codec.encode_local_launches}
        out["idle_share"] = window.idle_share
        out["busy_s"] = getattr(window, "busy_s", None)
        out["window_s"] = getattr(window, "window_s", None)
        # comparison line: the same AUs through K2 on the card
        blocks = np.frombuffer(b"".join(path.readback[s] for s in
                                        sorted(path.readback)),
                               dtype=np.uint8).reshape(-1, 4096)
        host = Checksummer("crc32c", 4096)
        t0 = time.perf_counter()
        host_csums = host.calculate(blocks)
        host_s = time.perf_counter() - t0
        stored = np.asarray([x for s in sorted(path.csums)
                             for x in path.csums[s]], dtype=np.uint32)
        on_card = torch.from_numpy(blocks.copy()).to(dev)
        dev_csums = Checksummer("crc32c", 4096).calculate(on_card)
        if not (np.array_equal(host_csums, stored)
                and np.array_equal(np.asarray(dev_csums, np.uint32),
                                   stored)):
            raise AssertionError("K2 or the host crc differs from the "
                                 "stores' per-AU csums")
        k2 = crc32c.Crc32cDevice(4096, device=dev)
        nb = blocks.shape[0]
        bound, by = (bound_ms(nb * CSUM_BLOCK + 8 * nb,
                              2 * (8 * CSUM_BLOCK) * 32 * nb, rates)
                     if rates else (None, None))      # phase 4's accounting
        out["k2_compare"] = {
            "blocks": int(blocks.shape[0]), "host_ms": host_s * 1e3,
            "k2_ms": (time_ms(torch, lambda: k2.blocks(on_card), 10)
                      if dev.type == "cuda" else None),
            "bound_ms": bound, "bound_by": by}
        out["acting"] = {"before": path.acting, "after": path.acting_after,
                         "up_after": path.up_after}
        path.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["card"] = smi
    return out


def log_store_path(r: dict, smi: str) -> None:
    a, b, c, d = r["a"], r["b"], r["c"], r["d"]
    gbs = lambda nbytes, s: nbytes / s / 1e9     # noqa: E731
    log(f"phase 13a [{smi}]: EC object of {a['object_bytes'] >> 20} MiB, "
        f"k={K} m={M}, {a['messages']} MOSDECSubOpWrite of "
        f"{CHUNK >> 20} MiB to {len(r['acting']['before'])} BlueStores: "
        f"encode {a['encode_s'] * 1e3:.1f} ms "
        f"({gbs(a['object_bytes'], a['encode_s']):.3f} GB/s), HashInfo "
        f"{a['hinfo_s'] * 1e3:.1f} ms, frames and messenger "
        f"{a['wire_s'] * 1e3:.1f} ms "
        f"({gbs(a['shard_bytes'], a['wire_s']):.3f} GB/s of shards), "
        f"queue_transaction summed over the stores {a['store_s'] * 1e3:.1f} "
        f"ms ({gbs(a['shard_bytes'], a['store_s']):.3f} GB/s); whole write "
        f"{a['wall_s'] * 1e3:.1f} ms "
        f"({gbs(a['object_bytes'], a['wall_s']):.3f} GB/s of object); card "
        f"idle {share(r['idle_share'])} of 13a; K1 launches in phase 13: "
        f"{r['launches']['gf_bitmatrix']}")
    log(f"phase 13b [{smi}]: remount of the stores {b['remount_s'] * 1e3:.1f}"
        f" ms, read back {b['bytes'] >> 20} MiB through {b['aus']} per-AU "
        f"csum verifies {b['read_s'] * 1e3:.1f} ms, equal to the card's "
        f"shards")
    k2 = r["k2_compare"]
    on_card = ("not measured (no card)" if k2["k2_ms"] is None else
               f"{k2['k2_ms']:.4f} ms back to back (bound {k2['bound_ms']:.4f}"
               f" ms by {k2['bound_by']}, data already on the card)")
    log(f"phase 13b [{smi}]: comparison, not BlueStore's path: the same "
        f"{k2['blocks']} AUs through K2 on the card {on_card} against the "
        f"stores' host crc {k2['host_ms']:.2f} ms; csum vectors equal")
    log(f"phase 13c [{smi}]: bitrot in shard {c['rot_shard']} (osd."
        f"{c['osd']}, byte {c['at']}): read raised {c['error'][:40]!r}; "
        f"{c['shards_read']} shards read over the wire in "
        f"{c['read_s'] * 1e3:.1f} ms, decode on the card "
        f"{c['decode_s'] * 1e3:.1f} ms, object bytes equal")
    log(f"phase 13d [{smi}]: osds {d['out']} out: acting "
        f"{d['acting_before']} -> {d['acting_after']} (pg_temp; CRUSH's up "
        f"set {d['up_after']}); k survivors read "
        f"{d['read_s'] * 1e3:.1f} ms, decode ({d['erasures']} erasures) "
        f"{d['decode_s'] * 1e3:.1f} ms: degraded read "
        f"{d['gb_per_s']:.3f} GB/s, object bytes equal")


# -- phase 14: an EC pool on a booted cluster ----------------------------------

def cluster_modules():
    """The port's modules that phase 14 boots, by the names that
    `ClusterPass` reads."""
    import types

    from ceph_tpu_torch import offload
    from ceph_tpu_torch.mon import MonMap, Monitor
    from ceph_tpu_torch.native import ec_native
    from ceph_tpu_torch.objectstore import BlueStore, Transaction
    from ceph_tpu_torch.ops import crc32c, rs_codec
    from ceph_tpu_torch.osd.daemon import OSD
    from ceph_tpu_torch.rados import RadosClient
    from ceph_tpu_torch.utils.admin_socket import admin_command
    return types.SimpleNamespace(
        Monitor=Monitor, MonMap=MonMap, OSD=OSD, RadosClient=RadosClient,
        BlueStore=BlueStore, Transaction=Transaction, offload=offload,
        ec_native=ec_native, rs_codec=rs_codec, crc32c=crc32c,
        admin_command=admin_command)


class ClusterPass:
    """Phase 14: one Monitor and k+m OSDs in this process, as a user
    boots them, each OSD with `device` and its own BlueStore (on the LSM)
    under `root`; an EC pool with plugin `cuda` (`osd pool create ...
    erasure`: the mon derives 4 KiB chunks, upstream's default stripe
    unit); one RadosClient with `inflight` ops in flight. Every OSD's
    host is its own (`host{osd}`), so each PG's acting set holds every
    OSD. The device crc is on (`ec_offload_crc_device`, set through
    osd.0's config), so the shard csums and deep scrub's digests go to
    the card as the encodes and decodes do. The client waits for an op
    as librados does (`rados_osd_op_timeout` 0 upstream) and resends it
    only on a map change or a fault: `RadosClient`'s 5 s attempt is
    shorter than a 4 MiB write's wait behind 15 others on one loop over
    BlueStore, and a write resent before it commits runs again at its
    primary, behind the first."""

    POOL = "ecpool"
    TIMEOUT_S = 120.0
    OP_TIMEOUT_S = 60.0     # the client's op and attempt timeout

    def __init__(self, mods, root: str, device: str, k: int, m: int,
                 pg_num: int, objects: int, obj_bytes: int, inflight: int,
                 seed: int = 42):
        import numpy as np
        self.mods, self.root, self.device = mods, root, device
        self.k, self.m, self.pg_num = k, m, pg_num
        self.n_osds = k + m
        self.inflight = inflight
        blob = np.random.default_rng(seed).integers(
            0, 256, objects * obj_bytes, dtype=np.uint8)
        self.data = {f"obj{i:03d}": blob[i * obj_bytes:(i + 1) * obj_bytes]
                     .tobytes() for i in range(objects)}
        self.obj_bytes = obj_bytes
        self.osds: dict = {}
        self.mon = self.client = self.io = None
        self.asok = os.path.join(root, "osd.0.asok")

    # -- the cluster -----------------------------------------------------------

    async def start_osd(self, i: int, store_name: str | None = None):
        store = self.mods.BlueStore(os.path.join(self.root,
                                                 store_name or f"osd.{i}"))
        osd = self.mods.OSD(
            i, self.mon_addrs, store=store, device=self.device,
            admin_socket_path=self.asok if i == 0 else None)
        # 14e's deep scrub must be the one that meets the flipped byte:
        # the background scrub rounds wait past the run
        osd.config.set("osd_scrub_interval", 3600.0)
        self.osds[i] = osd
        await osd.start()
        return osd

    async def boot(self) -> dict:
        import asyncio
        import socket
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        monmap = self.mods.MonMap({"a": ("127.0.0.1", port)})
        self.mon_addrs = list(monmap.mons.values())
        t0 = time.perf_counter()
        self.mon = self.mods.Monitor("a", monmap, store_path=os.path.join(
            self.root, "mon.a.json"))
        await self.mon.start()
        while not (self.mon.paxos.is_leader() and self.mon.paxos.is_active()):
            await asyncio.sleep(0.02)
        for i in range(self.n_osds):
            await self.start_osd(i)
        self.client = self.mods.RadosClient(self.mon_addrs)
        self.client.OP_TIMEOUT = self.OP_TIMEOUT_S
        self.client.ATTEMPT_TIMEOUT = self.OP_TIMEOUT_S
        await self.client.connect()
        await self.client.command({
            "prefix": "osd erasure-code-profile set", "name": "ecprof",
            "profile": {"plugin": "cuda", "k": str(self.k),
                        "m": str(self.m), "device": self.device}})
        out = await self.client.pool_create(
            self.POOL, pg_num=self.pg_num, pool_type="erasure",
            erasure_code_profile="ecprof")
        self.osds[0].config.set("ec_offload_crc_device", True)
        self.svc = self.mods.offload.get_service()
        if not self.svc.crc_device:
            raise AssertionError("ec_offload_crc_device did not reach the "
                                 "service")
        self.io = self.client.ioctx(self.POOL)
        pool = self.osds[0].osdmap.get_pool(self.POOL)
        self.stripe_width = pool.stripe_width
        await self.wait_clean()
        return {"boot_s": time.perf_counter() - t0, "pool": out,
                "stripe_width": pool.stripe_width,
                "chunk": pool.stripe_width // self.k}

    async def wait_clean(self) -> float:
        """Seconds until every PG of the pool is active on a full acting
        set with nothing left to recover."""
        import asyncio
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        while True:
            prim = [pg for o in self.osds.values() for pg in o.pgs.values()
                    if pg.pool.name == self.POOL and pg.is_primary()]
            if len(prim) == self.pg_num and all(
                    pg.state == "active" and not pg._pending_recovery
                    and not pg._deferred_activate
                    and sorted(pg.acting) == list(range(self.n_osds))
                    for pg in prim):
                return loop.time() - t0
            if loop.time() - t0 > self.TIMEOUT_S:
                raise TimeoutError(f"pool {self.POOL} never clean")
            await asyncio.sleep(0.05)

    async def stop(self) -> None:
        import asyncio
        if self.client is not None:
            await asyncio.wait_for(self.client.shutdown(), 30)
        for osd in list(self.osds.values()):
            await asyncio.wait_for(osd.stop(), 30)
        if self.mon is not None:
            await asyncio.wait_for(self.mon.stop(), 30)

    # -- traffic ---------------------------------------------------------------

    def _counts(self) -> dict:
        rs, crc = self.mods.rs_codec, self.mods.crc32c
        return {"gf_bitmatrix": rs.launches, "crc32c_blocks": crc.launches,
                "gf_bitmatrix_csum": rs.encode_local_launches,
                "batches": self.svc.stats["batches"],
                "riders": self.svc.stats["batched_ops"],
                "fallback_ops": self.svc.stats["fallback_ops"],
                # a tid per attempt, a reqid per op
                "resends": self.client._tid - self.client._reqseq}

    async def _step(self, fn) -> dict:
        """Run `fn`, a coroutine function; its seconds, and what the
        service and the kernels did meanwhile."""
        before = self._counts()
        t0 = time.perf_counter()
        out = await fn() or {}
        out["seconds"] = time.perf_counter() - t0
        after = self._counts()
        d = {k: after[k] - before[k] for k in after}
        out["launches"] = {k: d[k] for k in ("gf_bitmatrix", "crc32c_blocks",
                                             "gf_bitmatrix_csum")}
        out["batches"] = d["batches"]
        out["riders_per_batch"] = (d["riders"] / d["batches"]
                                   if d["batches"] else None)
        out["fallback_ops"] = d["fallback_ops"]
        out["resends"] = d["resends"]
        return out

    async def _each(self, fn) -> float:
        """`fn` on every object, `inflight` at once; the slowest call's
        seconds."""
        import asyncio
        sem = asyncio.Semaphore(self.inflight)

        async def one(oid):
            async with sem:
                t0 = time.perf_counter()
                await fn(oid)
                return time.perf_counter() - t0
        return max(await asyncio.gather(*[one(oid) for oid in self.data]))

    async def write_all(self) -> dict:
        slowest = await self._each(
            lambda oid: self.io.write_full(oid, self.data[oid]))
        return {"bytes": len(self.data) * self.obj_bytes,
                "slowest_op_s": slowest}

    async def read_all(self) -> dict:
        async def read(oid):
            if await self.io.read(oid) != self.data[oid]:
                raise AssertionError(f"{oid} read back differs")
        slowest = await self._each(read)
        return {"bytes": len(self.data) * self.obj_bytes,
                "slowest_op_s": slowest}

    async def kill(self, victim: int) -> dict:
        """Stop `victim`, wait until every survivor's map has it down,
        then read every object degraded."""
        import asyncio
        t0 = time.perf_counter()
        await self.osds.pop(victim).stop()
        while not all(victim in o.osdmap.osds and not o.osdmap.osds[victim].up
                      for o in self.osds.values()):
            if time.perf_counter() - t0 > self.TIMEOUT_S:
                raise TimeoutError(f"osd.{victim} never marked down")
            await asyncio.sleep(0.05)
        down_s = time.perf_counter() - t0
        acting = sorted({tuple(pg.acting) for o in self.osds.values()
                         for pg in o.pgs.values() if pg.is_primary()})
        if any(victim in a for a in acting):
            raise AssertionError(f"osd.{victim} still acting: {acting}")
        t1 = time.perf_counter()
        out = await self.read_all()
        out.update(down_s=down_s, read_s=time.perf_counter() - t1,
                   victim=victim, acting_sample=list(acting[0]))
        return out

    async def recover(self, victim: int) -> dict:
        """`victim` back on an empty BlueStore (a replaced disk): recovery
        rebuilds its shard of every object; seconds until clean."""
        t0 = time.perf_counter()
        await self.start_osd(victim, store_name=f"osd.{victim}.replaced")
        boot_s = time.perf_counter() - t0
        clean_s = await self.wait_clean()
        pushed = sum(o.perf.dump().get("recovery_push", 0)
                     for o in self.osds.values())
        return {"boot_s": boot_s, "clean_s": clean_s, "pushes": pushed,
                "bytes": len(self.data) * self.obj_bytes // self.k}

    def _primary(self, oid: str):
        for o in self.osds.values():
            for pg in o.pgs.values():
                if pg.is_primary() and oid in pg.list_objects():
                    return pg
        raise AssertionError(f"no primary holds {oid}")

    async def scrub(self) -> dict:
        """Flip one byte of one shard by a raw store write (the store's
        own csums stay consistent, tests/test_scrub.py:30-38), then
        deep-scrub every PG: exactly that shard must be found and
        repaired."""
        oid = sorted(self.data)[len(self.data) // 2]
        prim = self._primary(oid)
        holder = next(i for i in sorted(self.osds) if i != prim.host.whoami)
        osd = self.osds[holder]
        vpg = next(pg for pg in osd.pgs.values() if oid in pg.list_objects())
        cid, gh = vpg.backend.coll(), vpg.backend.ghobject(oid)
        blob = bytearray(osd.store.read(cid, gh))
        at = len(blob) // 3
        blob[at] ^= 0xFF
        osd.store.queue_transaction(
            self.mods.Transaction().write(cid, gh, 0, bytes(blob)))
        results = []
        for o in self.osds.values():
            for pg in o.pgs.values():
                if pg.pool.name == self.POOL and pg.is_primary():
                    res = await pg.scrub(deep=True)
                    results.append((pg.pgid.ps, res))
        errors = sum(r["errors"] for _, r in results)
        repaired = sum(r["repaired"] for _, r in results)
        bad = sorted(o for _, r in results for o in r["inconsistent"])
        if (errors, repaired, bad) != (1, 1, [oid]):
            raise AssertionError(f"deep scrub found {errors} errors, "
                                 f"repaired {repaired}, inconsistent {bad}; "
                                 f"flipped {oid} on osd.{holder}")
        return {"pgs": len(results), "errors": errors, "repaired": repaired,
                "flipped": {"oid": oid, "osd": holder, "at": at},
                "bytes": self.n_osds * len(self.data) * self.obj_bytes
                // self.k}

    async def admin_status(self) -> dict:
        import asyncio
        st = await asyncio.to_thread(self.mods.admin_command, self.asok,
                                     "ec offload status")
        if "error" in st or st["result"]["last_error"] \
                or st["result"]["degraded"]:
            raise AssertionError(f"ec offload status: {st}")
        return st["result"]

    def check_shards(self, np) -> dict:
        """Every shard on every OSD equals the host codec's
        (native/ec_native.cc) encode of its object's stripes."""
        from ceph_tpu_torch.ec import gf256
        coding = gf256.reed_sol_van_matrix(self.k, self.m)
        chunk = self.stripe_width // self.k
        want = {}
        for oid, data in self.data.items():
            d = np.frombuffer(data, dtype=np.uint8).reshape(
                -1, self.k, chunk).transpose(1, 0, 2).reshape(self.k, -1)
            par = np.empty((self.m, d.shape[1]), dtype=np.uint8)
            self.mods.ec_native.encode(coding, d, par)
            want[oid] = np.concatenate([d, par])
        seen = 0
        for i, osd in self.osds.items():
            st = osd.store
            for cid in st.list_collections():
                for gh in st.collection_list(cid):
                    attrs = st.getattrs(cid, gh)
                    if gh.name not in want or "shard" not in attrs:
                        continue
                    s = int(attrs["shard"])
                    if st.read(cid, gh) != want[gh.name][s].tobytes():
                        raise AssertionError(f"osd.{i} shard {s} of "
                                             f"{gh.name} differs from the "
                                             f"host codec's")
                    seen += 1
        if seen != self.n_osds * len(self.data):
            raise AssertionError(f"{seen} shards found, expected "
                                 f"{self.n_osds * len(self.data)}")
        return {"shards": seen}


async def drive_cluster(cp: ClusterPass, np, window=None) -> dict:
    """14a-14f on `cp`; `window`, a context manager, is entered around
    14a alone. It is entered and left on a thread of its own: starting
    the profiler and reading its trace take seconds, and on the loop's
    thread they would stall every daemon's heartbeats at once."""
    import asyncio
    import concurrent.futures
    out = {"boot": await cp.boot()}
    side = concurrent.futures.ThreadPoolExecutor(1)
    loop = asyncio.get_running_loop()
    try:
        async def traced_write():
            if window is None:
                return await cp.write_all()
            t0 = time.perf_counter()
            await loop.run_in_executor(side, window.__enter__)
            enter_s = time.perf_counter() - t0
            try:
                res = await cp.write_all()
            finally:
                t0 = time.perf_counter()
                await loop.run_in_executor(side, window.__exit__,
                                           None, None, None)
            res.update(window_enter_s=enter_s,
                       window_exit_s=time.perf_counter() - t0)
            return res
        out["a"] = await cp._step(traced_write)
        out["b"] = await cp._step(cp.read_all)
        victim = cp.n_osds - 1
        out["c"] = await cp._step(lambda: cp.kill(victim))
        out["d"] = await cp._step(lambda: cp.recover(victim))
        out["e"] = await cp._step(cp.scrub)
        out["shards"] = cp.check_shards(np)
        out["f"] = await cp.admin_status()
        out["fallback_ops"] = cp.svc.stats["fallback_ops"]
    finally:
        side.shutdown()
        await cp.stop()
    if out["fallback_ops"]:
        raise AssertionError(f"{out['fallback_ops']} ops reached the host "
                             f"fallback")
    return out


def phase_cluster(torch, np, dev, smi: str, window_cls=None,
                  objects: int = CLUSTER_OBJECTS,
                  obj_bytes: int = CLUSTER_OBJECT) -> dict:
    """Phase 14 on `dev`: ClusterPass at the north star's code (plugin
    cuda, k=8 m=3) with the mon's 4 KiB chunks, `objects` objects of
    `obj_bytes`, in a temporary directory removed at the end; the card's
    idle share over 14a (`window_cls`, default DeviceWindow). Run it
    after phase 0: the monitor instantiates the plugin on the card while
    it validates the profile, and a first-use build there would stall
    it."""
    import asyncio
    import shutil
    import tempfile
    mods = cluster_modules()
    root = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    try:
        cp = ClusterPass(mods, root, str(dev), K, M, CLUSTER_PGS, objects,
                         obj_bytes, CLUSTER_INFLIGHT, seed=CLUSTER_SEED)
        window = (window_cls or DeviceWindow)(torch)
        mods.rs_codec.launches = mods.crc32c.launches = 0
        mods.rs_codec.encode_local_launches = 0
        out = asyncio.run(asyncio.wait_for(drive_cluster(cp, np, window),
                                           900))
        out["launches"] = {"gf_bitmatrix": mods.rs_codec.launches,
                           "crc32c_blocks": mods.crc32c.launches,
                           "gf_bitmatrix_csum":
                               mods.rs_codec.encode_local_launches}
        out["idle_share"] = window.idle_share
        out["busy_s"] = getattr(window, "busy_s", None)
        out["window_s"] = getattr(window, "window_s", None)
        out["objects"], out["object_bytes"] = objects, obj_bytes
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["card"] = smi
    return out


def log_cluster(r: dict, smi: str) -> None:
    gbs = lambda nbytes, s: nbytes / s / 1e9     # noqa: E731

    def line(step, what, nbytes, seconds, of="client bytes"):
        s = r[step]
        rpb = s["riders_per_batch"]
        log(f"phase 14{step} [{smi}]: {what}: {seconds:.3f} s, "
            f"{gbs(nbytes, seconds):.3f} GB/s of {of} (host clock); "
            f"{s['batches']} device batches, "
            f"{'n/a' if rpb is None else f'{rpb:.2f}'} riders a batch; "
            f"launches K1 {s['launches']['gf_bitmatrix']}, K2 "
            f"{s['launches']['crc32c_blocks']}, K3 "
            f"{s['launches']['gf_bitmatrix_csum']}; client resends "
            f"{s['resends']}" + (f", slowest op {s['slowest_op_s']:.3f} s"
                                 if "slowest_op_s" in s else ""))
    b = r["boot"]
    log(f"phase 14 [{smi}]: 1 mon + {K + M} OSDs booted, pool "
        f"{ClusterPass.POOL} pg_num {CLUSTER_PGS} (plugin cuda k={K} m={M}, "
        f"{b['chunk']}-byte chunks, stripe {b['stripe_width']}) clean in "
        f"{b['boot_s']:.2f} s; {r['objects']} objects of "
        f"{r['object_bytes'] >> 20} MiB, {CLUSTER_INFLIGHT} in flight")
    total = r["objects"] * r["object_bytes"]
    line("a", "write_full every object", total, r["a"]["seconds"])
    busy = "n/a" if r["busy_s"] is None else f"{r['busy_s'] * 1e3:.1f} ms"
    log(f"phase 14a [{smi}]: card idle {share(r['idle_share'])} of the "
        f"writes ({busy} busy)")
    line("b", "read every object", total, r["b"]["seconds"])
    c = r["c"]
    line("c", f"osd.{c['victim']} killed, marked down in "
         f"{c['down_s']:.2f} s, every object read degraded", total,
         c["read_s"])
    d = r["d"]
    line("d", f"osd.{c['victim']} back on an empty store, {d['pushes']} "
         f"shards pushed, clean after {d['clean_s']:.2f} s", d["bytes"],
         d["clean_s"], of="rebuilt shard bytes")
    e = r["e"]
    line("e", f"one byte flipped in {e['flipped']['oid']} on osd."
         f"{e['flipped']['osd']}, deep scrub of {e['pgs']} PGs: "
         f"{e['errors']} error, {e['repaired']} repaired", e["bytes"],
         e["seconds"], of="shard bytes scrubbed")
    f = r["f"]
    log(f"phase 14f [{smi}]: ec offload status from osd.0's admin socket: "
        f"enabled {f['enabled']}, degraded {f['degraded']}, crc_device "
        f"{f['settings']['crc_device']}; every shard of {r['shards']['shards']}"
        f" equal to the host codec's; fallback_ops {r['fallback_ops']}; "
        f"launches in phase 14: {r['launches']}")


# -- phase 15: the EC pool's OSDs in worker processes --------------------------

class SmiSampler:
    """nvidia-smi's utilization.gpu (the share of the last sample period
    in which any kernel ran, across every context on the card) read on a
    side thread while the block runs."""

    QUERY = ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits"]

    def __enter__(self):
        self.samples: list[float] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            out = subprocess.run(self.QUERY, capture_output=True, text=True,
                                 check=True, timeout=30).stdout
            self.samples.append(float(out.strip().splitlines()[0]))
            self._stop.wait(0.05)

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        if exc[0] is None and not self.samples:
            raise AssertionError("nvidia-smi gave no utilization sample")
        return False

    @property
    def mean(self) -> float | None:
        return statistics.mean(self.samples) / 100 if self.samples else None


def proc_modules():
    """The port's modules that phase 15 drives, by the names that
    `ProcCluster` reads."""
    import types

    from ceph_tpu_torch.mgr import MgrDaemon
    from ceph_tpu_torch.ops import crc32c, rs_codec
    from ceph_tpu_torch.tools.cluster_boot import ephemeral_cluster
    return types.SimpleNamespace(MgrDaemon=MgrDaemon, rs_codec=rs_codec,
                                 crc32c=crc32c,
                                 ephemeral_cluster=ephemeral_cluster)


class ProcCluster:
    """Phase 15: phase 14's pool with its OSDs in `procs` worker processes
    (`ephemeral_cluster(reactor_procs=procs)`; 0 puts every OSD on this
    process's loop, the baseline), each OSD on a MemStore (process-backed
    OSDs build their own stores), and a MgrDaemon on this loop (shard 0)
    whose index takes every OSD's reports; one RadosClient with
    `inflight` ops in flight. The device crc is on and background scrubs
    wait past the run, as in phase 14."""

    POOL = "ecpool"
    TIMEOUT_S = 120.0
    REPORT_PERIOD = 0.25        # the mgr hands it to every daemon

    def __init__(self, mods, device: str, procs: int, k: int, m: int,
                 pg_num: int, data: dict, inflight: int):
        self.mods, self.device, self.procs = mods, device, procs
        self.k, self.m, self.pg_num = k, m, pg_num
        self.n_osds = k + m
        self.data, self.inflight = data, inflight
        self.obj_bytes = len(next(iter(data.values())))

    # -- the cluster -----------------------------------------------------------

    async def boot(self, stack) -> dict:
        t0 = time.perf_counter()
        self.client, self.osds, self.mon = await stack.enter_async_context(
            self.mods.ephemeral_cluster(
                self.n_osds, prefix="chip_smoke_procs_",
                reactor_procs=self.procs, device=self.device))
        boot_s = time.perf_counter() - t0
        self.pool = self.osds[0].pool if self.procs else None
        self.mgr = self.mods.MgrDaemon(list(self.mon.monmap.mons.values()),
                                       modules=[], exporter_port=0)
        self.mgr.REPORT_PERIOD = self.mgr.TICK_INTERVAL = self.REPORT_PERIOD
        await self.mgr.start()
        stack.push_async_callback(self.mgr.stop)
        await self.config_set("osd_scrub_interval", 3600.0)
        await self.config_set("ec_offload_crc_device", True)
        t1 = time.monotonic()
        await self.client.command({
            "prefix": "osd erasure-code-profile set", "name": "ecprof",
            "profile": {"plugin": "cuda", "k": str(self.k),
                        "m": str(self.m), "device": self.device}})
        await self.client.pool_create(self.POOL, pg_num=self.pg_num,
                                      pool_type="erasure",
                                      erasure_code_profile="ecprof")
        self.io = self.client.ioctx(self.POOL)
        clean_s = await self.wait_clean(t1)
        sw = self.client.osdmap.get_pool(self.POOL).stripe_width
        return {"boot_s": boot_s, "clean_s": clean_s,
                "stripe_width": sw, "chunk": sw // self.k}

    def shards(self) -> list[int]:
        """The live workers' shard indices."""
        return [i for i in range(1, self.procs + 1)
                if self.pool.worker_alive(i)]

    def hosted(self, shard: int) -> list[int]:
        return sorted(o.whoami for o in self.osds if o.shard == shard)

    async def config_set(self, key: str, value) -> None:
        if self.pool is not None:
            await self.pool.config_set(key, value)
        else:
            for osd in self.osds:
                osd.config.set(key, value)

    async def wait_reports(self, since: float, names) -> dict:
        """Each daemon in `names`' state once the mgr holds a report of
        it received after `since` (time.monotonic())."""
        import asyncio
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        while True:
            sts = {n: self.mgr.daemon_index.daemons.get(n) for n in names}
            if all(st is not None and st.last_report_mono > since
                   for st in sts.values()):
                return sts
            if loop.time() - t0 > self.TIMEOUT_S:
                raise TimeoutError(f"no report since the mark from "
                                   f"{[n for n, st in sts.items() if st is None or st.last_report_mono <= since]}")
            await asyncio.sleep(0.05)

    async def wait_clean(self, since: float) -> float:
        """Seconds until every OSD reported (after `since`) each of its
        PGs active (a primary) or a replica, pg_num primaries in all,
        pg_num x (k+m) PG copies, none degraded or undersized: the
        operator's view through the mgr, the one that reaches OSDs in
        other processes."""
        import asyncio
        t0 = time.monotonic()
        names = [f"osd.{i}" for i in range(self.n_osds)]
        while True:
            hms = [st.health_metrics for st in
                   (await self.wait_reports(since, names)).values()]
            states = [hm.get("pg_states") or {} for hm in hms]
            if (sum(sum(s.values()) for s in states)
                    == self.pg_num * self.n_osds
                    and sum(s.get("active", 0) for s in states)
                    == self.pg_num
                    and all(set(s) <= {"active", "replica"} for s in states)
                    and not any(hm.get("degraded_pgs")
                                or hm.get("undersized_pgs") for hm in hms)):
                return time.monotonic() - t0
            if time.monotonic() - t0 > self.TIMEOUT_S:
                raise TimeoutError(f"pool never clean: {states}")
            since = time.monotonic()
            await asyncio.sleep(0.05)

    # -- traffic ---------------------------------------------------------------

    async def _each(self, fn, oids) -> None:
        import asyncio
        sem = asyncio.Semaphore(self.inflight)

        async def one(oid):
            async with sem:
                await fn(oid)
        await asyncio.gather(*[one(oid) for oid in oids])

    async def write_all(self, prefix: str = "") -> float:
        t0 = time.perf_counter()
        await self._each(lambda oid: self.io.write_full(
            prefix + oid, self.data[oid]), self.data)
        return time.perf_counter() - t0

    async def read_all(self, prefix: str = "") -> float:
        async def read(oid):
            if await self.io.read(prefix + oid) != self.data[oid]:
                raise AssertionError(f"{prefix + oid} read back differs")
        t0 = time.perf_counter()
        await self._each(read, self.data)
        return time.perf_counter() - t0

    async def scrub(self) -> dict:
        """Deep scrub of every PG, on every primary, awaited: one OSD
        after another, as on one loop (primaries of different processes
        scrubbing at once cross their replicas' reservations, and each
        crossing waits out the reservation timeout)."""
        t0 = time.perf_counter()
        results = {}
        if self.pool is None:
            for osd in self.osds:
                results.update(await osd.scrub_all(deep=True))
        else:
            for i in self.shards():
                results.update(await self.pool.call(
                    i, {"prefix": "scrub", "deep": True}, timeout=150.0))
        out = {"seconds": time.perf_counter() - t0, "pgs": len(results),
               "errors": sum(r["errors"] for r in results.values()),
               "repaired": sum(r["repaired"] for r in results.values())}
        if (out["pgs"], out["errors"]) != (self.pg_num, 0):
            raise AssertionError(f"deep scrub: {out}")
        return out

    # -- the device side of every process ------------------------------------

    async def reset_launches(self) -> None:
        if self.pool is None:
            rs, crc = self.mods.rs_codec, self.mods.crc32c
            rs.launches = crc.launches = rs.encode_local_launches = 0
            return
        for i in self.shards():
            await self.pool.call(i, {"prefix": "device status",
                                     "reset": True})

    async def device_status(self) -> dict:
        """{shard: the worker's `device status`} (launch counts, pinned
        staging bytes, card memory of its context); shard 0 alone for
        the one-loop baseline."""
        if self.pool is None:
            rs, crc = self.mods.rs_codec, self.mods.crc32c
            return {0: {"launches": {
                "gf_bitmatrix": rs.launches, "crc32c_blocks": crc.launches,
                "gf_bitmatrix_csum": rs.encode_local_launches}}}
        return {i: await self.pool.call(i, {"prefix": "device status"})
                for i in self.shards()}

    async def launches(self) -> dict:
        st = await self.device_status()
        return {kn: sum(s["launches"][kn] for s in st.values())
                for kn in ("gf_bitmatrix", "crc32c_blocks",
                           "gf_bitmatrix_csum")}

    async def fallback_ops(self) -> dict:
        """{shard: fallback_ops} of each process's offload service."""
        if self.pool is None:
            from ceph_tpu_torch import offload
            return {0: offload.get_service().stats["fallback_ops"]}
        return {i: (await self.osds[self.hosted(i)[0]].admin(
            "ec offload status"))["fallback_ops"] for i in self.shards()}

    async def device_busy(self, since: float) -> dict:
        """{shard: offload_device_busy_seconds summed over the cards}
        from the mgr's index, once per process (co-hosted OSDs report
        one service), from reports received after `since`."""
        reps = ({0: 0} if self.pool is None else
                {i: self.hosted(i)[0] for i in self.shards()})
        sts = await self.wait_reports(since, [f"osd.{w}"
                                              for w in reps.values()])
        return {i: sum(c.get("offload_device_busy_seconds", 0.0)
                       for dev, c in sts[f"osd.{w}"].device_metrics.items()
                       if dev != "host")
                for i, w in reps.items()}

    async def device_rows(self) -> dict:
        """The exporter's /metrics, fetched over HTTP: the
        ceph_offload_device_batches rows, {daemon: [device, ...]}."""
        _, _, text = await http(self.mgr.exporter.addr, "GET", "/metrics")
        return device_rows(text.decode())

    # -- 15c and 15d ------------------------------------------------------------

    async def health_check(self, code: str):
        h = await self.client.command({"prefix": "health detail"})
        return h["checks"].get(code)

    async def fault_drill(self, shard: int) -> dict:
        """One device failure armed for each device slot of one worker
        (one on a card): its breakers trip, its OSDs run EC on the host
        codec (equal bytes) and the mgr raises TPU_OFFLOAD_DEGRADED
        naming them alone; the breakers' probes recover and the check
        clears."""
        import asyncio
        code = "TPU_OFFLOAD_DEGRADED"
        victims = {f"osd.{w}" for w in self.hosted(shard)}
        await self.config_set("ec_offload_breaker_reset_s", 2.0)
        base = await self.fallback_ops()
        slots = len((await self.pool.call(
            shard, {"prefix": "device status"}))["devices"])
        armed = await self.pool.call(shard, {
            "prefix": "inject", "whoami": self.hosted(shard)[0],
            "what": "device", "count": slots})
        t0 = time.perf_counter()
        rounds, raised, named = 0, None, None
        oids = sorted(self.data)[:self.inflight]
        while raised is None:
            if time.perf_counter() - t0 > self.TIMEOUT_S:
                raise TimeoutError(f"{code} never raised")
            prefix = f"fault{rounds}-"
            await self._each(lambda oid: self.io.write_full(
                prefix + oid, self.data[oid]), oids)
            for oid in oids:
                if await self.io.read(prefix + oid) != self.data[oid]:
                    raise AssertionError(f"{prefix + oid} differs")
            rounds += 1
            await asyncio.sleep(2 * self.REPORT_PERIOD)
            check = await self.health_check(code)
            if check is not None:
                raised = time.perf_counter() - t0
                named = {d.split(":")[0] for d in check["detail"]}
        if named != victims:
            raise AssertionError(f"{code} names {sorted(named)}, the "
                                 f"worker hosts {sorted(victims)}")
        t1 = time.perf_counter()
        while await self.health_check(code) is not None:
            if time.perf_counter() - t1 > self.TIMEOUT_S:
                raise TimeoutError(f"{code} never cleared")
            # the breaker lets a probe batch through after its reset
            # window: keep the worker's OSDs encoding
            await self._each(lambda oid: self.io.write_full(
                "probe-" + oid, self.data[oid]), oids[:4])
            await asyncio.sleep(0.25)
        after = await self.fallback_ops()
        fell = {i: after[i] - base[i] for i in after}
        if fell[shard] <= 0 or any(n for i, n in fell.items() if i != shard):
            raise AssertionError(f"host fallbacks by worker: {fell}")
        return {"shard": shard, "named": sorted(named), "armed": armed,
                "rounds": rounds, "raised_s": raised,
                "cleared_s": time.perf_counter() - t1, "fallback_ops": fell}

    async def crash_drill(self, shard: int) -> dict:
        """SIGKILL a worker that holds a CUDA context: its OSDs are marked
        down, every object reads back degraded (K1 in the survivors),
        and a respawned worker re-opens the card and rejoins; timed to a
        clean pool and read back healthy."""
        import asyncio
        victims = self.hosted(shard)
        if len(victims) > self.m - 1:
            raise AssertionError(f"worker {shard} hosts {victims}: the pool "
                                 f"would fall below min_size k+1")
        await self.config_set("osd_heartbeat_grace", 2.0)
        omap = self.mon.osdmon.osdmap
        t0 = time.perf_counter()
        pid = self.pool.worker_pid(shard)
        await self.pool.inject_crash(shard)
        while self.pool.worker_alive(shard):
            if time.perf_counter() - t0 > self.TIMEOUT_S:
                raise TimeoutError("the killed worker was never reaped")
            await asyncio.sleep(0.05)
        reaped_s = time.perf_counter() - t0
        while any(omap.is_up(v) for v in victims):
            if time.perf_counter() - t0 > self.TIMEOUT_S:
                raise TimeoutError(f"osds {victims} never marked down")
            await asyncio.sleep(0.05)
        down_s = time.perf_counter() - t0
        # the default grace again before the rejoin: the respawned OSDs
        # and the recovery they start load every loop at once, and a
        # tight grace then marks live OSDs down
        await self.config_set("osd_heartbeat_grace", HB_GRACE_DEFAULT)
        await self.reset_launches()
        read_s = await self.read_all()
        k1 = (await self.launches())["gf_bitmatrix"]
        if k1 <= 0:
            raise AssertionError("the degraded reads never launched K1")
        t1 = time.perf_counter()
        res = await self.pool.respawn(shard)
        respawn_s = time.perf_counter() - t1
        if sorted(o["whoami"] for o in res["osds"]) != victims:
            raise AssertionError(f"respawn re-booted {res['osds']}")
        since = time.monotonic()
        while not all(omap.is_up(v) for v in victims):
            if time.perf_counter() - t1 > self.TIMEOUT_S:
                raise TimeoutError(f"osds {victims} never rejoined")
            await asyncio.sleep(0.05)
        clean_s = await self.wait_clean(since)
        cards = (await self.pool.call(shard, {"prefix": "device status"})
                 )["cuda"]
        healthy_read_s = await self.read_all()
        return {"shard": shard, "osds": victims, "pid": pid,
                "new_pid": res["pid"], "reaped_s": reaped_s,
                "down_s": down_s, "degraded_read_s": read_s,
                "degraded_k1": k1, "respawn_s": respawn_s,
                "clean_s": clean_s, "cards": cards,
                "healthy_read_s": healthy_read_s}


async def drive_procs(mods, device: str, procs: int, data: dict,
                      widest: bool, sampler_cls, card_used) -> dict:
    """15a on a fresh ProcCluster with `procs` workers; on the widest,
    15b's two measures of the card's share over its writes, then 15c and
    15d on the same cluster. `card_used()` is the card's used memory in
    bytes (None on the CPU)."""
    import contextlib
    pc = ProcCluster(mods, device, procs, K, M, CLUSTER_PGS, data,
                     CLUSTER_INFLIGHT)
    used0 = card_used()
    async with contextlib.AsyncExitStack() as stack:
        out = {"procs": procs, "boot": await pc.boot(stack)}
        used1 = card_used()
        await pc.reset_launches()
        busy0 = await pc.device_busy(time.monotonic()) if widest else None
        sampler = sampler_cls() if widest else contextlib.nullcontext()
        with sampler:
            out["write_s"] = await pc.write_all()
        if widest:
            busy1 = await pc.device_busy(time.monotonic())
            busy = sum(busy1[i] - busy0[i] for i in busy1)
            out["share"] = {"smi_utilization": sampler.mean,
                            "smi_samples": len(sampler.samples),
                            "busy_s_by_shard": {
                                str(i): busy1[i] - busy0[i] for i in busy1},
                            "busy_s": busy,
                            "busy_share": busy / out["write_s"]}
        out["read_s"] = await pc.read_all()
        out["scrub"] = await pc.scrub()
        out["launches"] = await pc.launches()
        out["fallback_ops"] = await pc.fallback_ops()
        for kname in ("gf_bitmatrix", "crc32c_blocks"):
            if out["launches"][kname] <= 0:
                raise AssertionError(f"procs={procs} never launched {kname}")
        if any(out["fallback_ops"].values()):
            raise AssertionError(f"host fallbacks: {out['fallback_ops']}")
        if procs:
            st = await pc.device_status()
            out["workers"] = {str(i): {"pid": s["pid"],
                                       "devices": s["devices"],
                                       "pinned_bytes": s["pinned_bytes"],
                                       "cuda": s["cuda"]}
                              for i, s in st.items()}
            out["card_used_per_worker"] = (
                (used1 - used0) / procs if used0 is not None else None)
        if widest:
            rows = await pc.device_rows()
            out["device_rows"] = rows
            if sorted(rows) != sorted(f"osd.{i}" for i in range(K + M)):
                raise AssertionError(f"/metrics device rows: {rows}")
            out["fault"] = await pc.fault_drill(PROC_FAULT_SHARD)
            out["crash"] = await pc.crash_drill(procs)
    return out


def run_stage(label: str, stage: str, device: str, timeout_s: float,
              env: dict | None = None) -> dict:
    """The port's bench_driver --stage `stage` on `device` as a child
    process, as phase 11 runs its stages: one JSON line, exit 0 only
    when every key was measured and every flag holds. On a card the
    child's stderr line of launches is read into `launches`: its own
    K1-K3 launches and host fallbacks, counted from 0 at its start."""
    import signal

    from ceph_tpu_torch.tools.bench_driver import LAUNCH_LINE
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ceph_tpu_torch.tools.bench_driver",
         "--stage", stage, "--device", device],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        # the stage's own workers are in its session: stop them too
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    wall = time.perf_counter() - t0
    line = stdout.strip().splitlines()[-1] if stdout.strip() else ""
    log(f"phase {label}: bench_driver --stage {stage} ({wall:.1f} s): "
        f"{line}")
    if proc.returncode != 0:
        log(stderr[-4000:])
        raise AssertionError(f"bench_driver --stage {stage} exited "
                             f"{proc.returncode}")
    out = {"wall_s": wall, "record": json.loads(line)}
    counts = [ln[len(LAUNCH_LINE):] for ln in stderr.splitlines()
              if ln.startswith(LAUNCH_LINE)]
    if device != "cpu":
        if len(counts) != 1:
            raise AssertionError(f"bench_driver --stage {stage} printed "
                                 f"{len(counts)} launch lines")
        out["launches"] = json.loads(counts[0])
        log(f"phase {label}: launches in the child {out['launches']}")
    return out


def phase_stages(device: str, timeout_s: float = 600.0) -> dict:
    """15e: the port's bench_driver --stage cluster_tpu and --stage
    attribution on `device`, each a child process, their curves capped
    by the stages' own knobs in its environment."""
    env = dict(os.environ, **STAGE_KNOBS)
    return {stage: run_stage("15e", stage, device, timeout_s, env)
            for stage in ("cluster_tpu", "attribution")}


def phase_procs(torch, np, dev, smi: str, sampler_cls=SmiSampler,
                objects: int = PROC_OBJECTS,
                obj_bytes: int = CLUSTER_OBJECT, stages: bool = True
                ) -> dict:
    """Phase 15 on `dev`: 15a over PROC_COUNTS capped at this machine's
    cores, 15b-15d on the widest, 15e the two cluster bench stages."""
    import asyncio
    mods = proc_modules()
    cores = len(os.sched_getaffinity(0))
    counts = [n for n in PROC_COUNTS if n <= cores]
    if counts[-1] < PROC_CRASH_SHARD:
        raise AssertionError(f"{cores} cores: 15d needs {PROC_CRASH_SHARD} "
                             f"workers")
    blob = np.random.default_rng(CLUSTER_SEED).integers(
        0, 256, objects * obj_bytes, dtype=np.uint8)
    data = {f"obj{i:03d}": blob[i * obj_bytes:(i + 1) * obj_bytes].tobytes()
            for i in range(objects)}
    device = "cuda" if dev.type == "cuda" else "cpu"

    def card_used():
        if dev.type != "cuda":
            return None
        free, total = torch.cuda.mem_get_info(dev)
        return total - free
    out = {"cores": cores, "counts": counts, "objects": objects,
           "object_bytes": obj_bytes, "runs": {}}
    for n in counts:
        t0 = time.perf_counter()
        r = asyncio.run(asyncio.wait_for(drive_procs(
            mods, device, n, data, n == counts[-1], sampler_cls, card_used),
            600))
        r["phase_s"] = time.perf_counter() - t0
        out["runs"][str(n)] = r
        log_procs_run(r, objects * obj_bytes, smi)
    # 15a's launches of every run, and 15d's degraded reads
    out["launches"] = {kn: sum(r["launches"][kn] for r in out["runs"].values())
                       for kn in ("gf_bitmatrix", "crc32c_blocks",
                                  "gf_bitmatrix_csum")}
    out["launches"]["gf_bitmatrix"] += \
        out["runs"][str(counts[-1])]["crash"]["degraded_k1"]
    if stages:
        out["stages"] = phase_stages(device)
    out["card"] = smi
    return out


def log_procs_run(r: dict, total: int, smi: str) -> None:
    n = r["procs"]
    b = r["boot"]
    where = "one loop" if n == 0 else f"{n} worker process(es)"
    log(f"phase 15a [{smi}]: reactor_procs={n} ({where}): booted in "
        f"{b['boot_s']:.2f} s, pool clean {b['clean_s']:.2f} s later "
        f"({b['chunk']}-byte chunks); write {r['write_s']:.3f} s "
        f"({total / r['write_s'] / 1e9:.3f} GB/s of client bytes), read "
        f"{r['read_s']:.3f} s ({total / r['read_s'] / 1e9:.3f} GB/s), every "
        f"object equal; deep scrub of {r['scrub']['pgs']} PGs "
        f"{r['scrub']['seconds']:.2f} s, {r['scrub']['errors']} errors; "
        f"fallback_ops by process {r['fallback_ops']}; launches summed "
        f"over processes K1 {r['launches']['gf_bitmatrix']}, K2 "
        f"{r['launches']['crc32c_blocks']}, K3 "
        f"{r['launches']['gf_bitmatrix_csum']} (host clock)")
    for i, w in sorted(r.get("workers", {}).items()):
        log(f"phase 15a [{smi}]: worker {i} pid {w['pid']} on "
            f"{w['devices']}: pinned staging {w['pinned_bytes'] / 2**20:.1f}"
            f" MiB, card memory of its context {w['cuda']}")
    if r.get("card_used_per_worker") is not None:
        log(f"phase 15a [{smi}]: card memory used per worker (the card's "
            f"used memory after boot minus before, over {n}): "
            f"{r['card_used_per_worker'] / 2**20:.0f} MiB")
    if "share" in r:
        s = r["share"]
        smi_u = "n/a" if s["smi_utilization"] is None \
            else f"{s['smi_utilization'] * 100:.1f}%"
        log(f"phase 15b [{smi}]: the card's share over the widest write: "
            f"nvidia-smi utilization.gpu {smi_u} (mean of "
            f"{s['smi_samples']} samples); the services' "
            f"offload_device_busy_seconds from the mgr, once per worker, "
            f"{s['busy_s']:.4f} s of {r['write_s']:.3f} s "
            f"({s['busy_share'] * 100:.2f}%; by worker "
            f"{ {k: round(v, 4) for k, v in s['busy_s_by_shard'].items()} }"
            f"); neither is a CUPTI union of the card's kernels")
    if "fault" in r:
        f = r["fault"]
        log(f"phase 15c [{smi}]: /metrics device rows {r['device_rows']}; "
            f"one device failure armed in worker {f['shard']}: "
            f"TPU_OFFLOAD_DEGRADED raised after {f['raised_s']:.2f} s "
            f"naming {f['named']} alone, writes equal on the host codec "
            f"({f['rounds']} rounds), cleared {f['cleared_s']:.2f} s later "
            f"by the breaker's probe; host fallbacks by worker "
            f"{f['fallback_ops']}")
    if "crash" in r:
        c = r["crash"]
        log(f"phase 15d [{smi}]: worker {c['shard']} (pid {c['pid']}, "
            f"osds {c['osds']}) SIGKILLed: reaped {c['reaped_s']:.2f} s, "
            f"marked down {c['down_s']:.2f} s; every object read degraded "
            f"in {c['degraded_read_s']:.3f} s ({total / c['degraded_read_s'] / 1e9:.3f} "
            f"GB/s, K1 {c['degraded_k1']} in the survivors); respawned "
            f"(pid {c['new_pid']}, card {c['cards']}) in "
            f"{c['respawn_s']:.2f} s, clean {c['clean_s']:.2f} s later, "
            f"read back healthy in {c['healthy_read_s']:.3f} s")
    log(f"phase 15a [{smi}]: reactor_procs={n}: {r['phase_s']:.1f} s")


# -- phase 16: the access layers (RBD, S3, CephFS) on EC pools -----------------

def access_modules():
    """The port's modules that phase 16 composes, by the names that
    `AccessPass` reads. Its CPU test hands `AccessPass` the JAX package's
    modules under the same names, so one composition runs through
    either package."""
    import types

    from ceph_tpu_torch import offload
    from ceph_tpu_torch.mds import CephFS, MDSDaemon
    from ceph_tpu_torch.mds.daemon import data_oid
    from ceph_tpu_torch.native import ec_native
    from ceph_tpu_torch.ops import crc32c, rs_codec
    from ceph_tpu_torch.rbd import RBD, Image
    from ceph_tpu_torch.rgw import RGWGateway
    from ceph_tpu_torch.rgw.gateway import _data_oid
    from ceph_tpu_torch.tools.vstart import VCluster

    def counts() -> dict:
        return {"gf_bitmatrix": rs_codec.launches,
                "crc32c_blocks": crc32c.launches,
                "gf_bitmatrix_csum": rs_codec.encode_local_launches}

    def reset() -> None:
        rs_codec.launches = crc32c.launches = 0
        rs_codec.encode_local_launches = 0
    return types.SimpleNamespace(
        VCluster=VCluster, RBD=RBD, Image=Image, RGWGateway=RGWGateway,
        MDSDaemon=MDSDaemon, CephFS=CephFS, fs_data_oid=data_oid,
        rgw_data_oid=_data_oid, ec_native=ec_native, offload=offload,
        plugin="cuda", counts=counts, reset=reset,
        profile_extra=lambda device: {"device": device},
        cluster_kwargs=lambda device: {"device": device})


#: phase 16's traffic on the card: 4 MiB objects (RBD's order 22 and
#: CephFS's file layout); cut the counts, never the sizes
ACCESS_SIZES = {
    "obj": 4 << 20,              # RBD object, CephFS stripe, S3 object
    "image": 1 << 30,            # 16a: the image's size
    "rbd_objects": 32,           # 16a: 128 MiB written, object-aligned
    "rbd_overwrites": 256,       # 16a: random 4 KiB overwrites (EC RMW)
    "s3_objects": 16,            # 16b: PUT over HTTP
    "s3_part": 5 << 20,          # 16b: S3's minimum part size
    "s3_parts": 3,
    "fs_objects": 16,            # 16c: one 64 MiB file
    "fs_overwrites": 128,        # 16c: random 4 KiB overwrites (EC RMW)
    "fs_purge_objects": 2,       # 16c: an 8 MiB file unlinked
    "small": 4096,
    "inflight": 16,              # rbd bench --io-threads, S3 connections
    "victim": 5,                 # 16e: the OSD stopped
}
ACCESS_PGS = 32                  # osd pool create <name> 32 erasure
ACCESS_SEED = 42
# upstream's mon_osd_down_out_interval: the OSD stopped in 16e stays in
# the map while the phase reads around it (the mon's own 30 s would mark
# it out mid-phase, and the remap of every PG at once would starve this
# one loop's heartbeats)
ACCESS_DOWN_OUT_S = 600.0
# upstream's osd_heartbeat_grace: each map epoch makes every OSD on this
# one loop map all of the cluster's PGs through CRUSH, 1-12 s of the
# loop on the card's host, and the port's 3 s grace then marks live
# OSDs down, which makes more epochs
ACCESS_HB_GRACE_S = 20.0


def device_rows(text: str) -> dict:
    """The ceph_offload_device_batches rows of a /metrics text,
    {daemon: [device, ...]}."""
    import re
    rows: dict[str, list] = {}
    for daemon, dev in re.findall(
            r'^ceph_offload_device_batches\{ceph_daemon="(osd\.\d+)",'
            r'ceph_device="([^"]+)"\}', text, re.M):
        rows.setdefault(daemon, []).append(dev)
    return rows


async def http(addr, method: str, path: str, body: bytes = b"",
               headers: dict | None = None) -> tuple[int, dict, bytes]:
    """One HTTP/1.0 request to the gateway; (status, headers with
    lower-case names, body)."""
    import asyncio
    reader, writer = await asyncio.open_connection(*addr)
    try:
        head = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        writer.write(f"{method} {path} HTTP/1.0\r\nContent-Length: "
                     f"{len(body)}\r\n{head}\r\n".encode() + body)
        await writer.drain()
        blob = await reader.read()
    finally:
        writer.close()
    raw, _, out = blob.partition(b"\r\n\r\n")
    lines = raw.decode().split("\r\n")
    hdrs = {}
    for ln in lines[1:]:
        name, _, value = ln.partition(":")
        hdrs[name.strip().lower()] = value.strip()
    return int(lines[0].split()[1]), hdrs, out


class LoopWatch:
    """The running loop's stalls (how late a 50 ms sleep wakes), stamped,
    while it is entered; a stall over `loud_s` is logged as it ends.
    Every OSD of a one-loop cluster sends its heartbeats from this loop,
    and a stall past their grace marks OSDs down."""

    PERIOD_S = 0.05

    def __init__(self, loud_s: float = 2.0):
        self.loud_s = loud_s
        self.stalls: list[tuple[float, float]] = []

    async def _tick(self) -> None:
        import asyncio
        while True:
            t = time.perf_counter()
            await asyncio.sleep(self.PERIOD_S)
            now = time.perf_counter()
            late = now - t - self.PERIOD_S
            self.stalls.append((now, late))
            if late > self.loud_s:
                log(f"loop watch: the loop stalled {late:.2f} s")

    async def __aenter__(self):
        import asyncio
        self._task = asyncio.get_running_loop().create_task(self._tick())
        return self

    async def __aexit__(self, *exc):
        import asyncio
        self._task.cancel()
        try:
            await self._task
        except asyncio.CancelledError:
            pass
        return False

    def since(self, t0: float) -> dict:
        """The deepest stall that ended after `t0`."""
        return {"loop_stall_max_s": max((s for t, s in self.stalls if t > t0),
                                        default=0.0)}


class AccessPass:
    """Phase 16: a vstart cluster (one mon, `n_osds` OSDs on MemStore in
    this process, each its own host, a mgr, VCluster's own gateway
    rgw.0) with one EC profile (`mods.plugin`, k, m) shared by three EC
    data pools created as a user creates them (`osd pool create <name>
    <pg_num> erasure`: the mon derives 4 KiB chunks): `rbd_ec` beside a
    replicated `rbd` pool for the image headers, `fs_ec` beside a
    replicated `cephfs_metadata` under an MDSDaemon with the file
    layout's stripe, and `rgw_ec` under a second gateway `rgw.ec` whose
    bucket index is VCluster's `rgw_index`. The device crc is on
    (`ec_offload_crc_device`, through osd.0's config), the mgr's balancer
    is off, the failure detection takes upstream's defaults (a 20 s
    heartbeat grace; a down OSD marked out after 600 s), and background
    scrub waits past the run. Every step checks what it reads against
    models built from `seed`; every wait is a deadline that raises with
    the state it saw."""

    RBD_POOL, RBD_DATA = "rbd", "rbd_ec"
    FS_META, FS_DATA = "cephfs_metadata", "fs_ec"
    RGW_DATA, BUCKET = "rgw_ec", "b"
    EC_POOLS = (RBD_DATA, FS_DATA, RGW_DATA)
    TIMEOUT_S = 120.0

    def __init__(self, mods, root: str, device: str, k: int, m: int,
                 pg_num: int, sizes: dict, seed: int = ACCESS_SEED):
        import numpy as np
        self.mods, self.root, self.device = mods, root, device
        self.k, self.m, self.pg_num = k, m, pg_num
        self.n_osds = k + m
        self.sz = dict(sizes)
        obj, small = self.sz["obj"], self.sz["small"]
        rng = np.random.default_rng(seed)
        self.rbd_model = bytearray(rng.bytes(self.sz["rbd_objects"] * obj))
        blocks = len(self.rbd_model) // small
        self.rbd_over = [(int(b) * small, rng.bytes(small)) for b in
                         rng.choice(blocks, self.sz["rbd_overwrites"],
                                    replace=False)]
        self.s3 = {f"o{i:03d}": rng.bytes(obj)
                   for i in range(self.sz["s3_objects"])}
        self.parts = [rng.bytes(self.sz["s3_part"])
                      for _ in range(self.sz["s3_parts"])]
        self.fs_model = bytearray(rng.bytes(self.sz["fs_objects"] * obj))
        # overwrites at random offsets, one a slot of two small blocks,
        # so that none overlaps another in flight
        slots = len(self.fs_model) // (2 * small)
        self.fs_over = [(int(s) * 2 * small + int(rng.integers(0, small + 1)),
                         rng.bytes(small)) for s in
                        rng.choice(slots, self.sz["fs_overwrites"],
                                   replace=False)]
        self.purge_data = rng.bytes(self.sz["fs_purge_objects"] * obj)
        self.etags: dict = {}
        self.c = self.client = self.svc = self.watch = None
        self.img = self.mds = self.fs = self.gw = self._fs_ino = None

    # -- the cluster -----------------------------------------------------------

    async def boot(self) -> dict:
        t0 = time.perf_counter()
        self.c = self.mods.VCluster(
            self.root, n_mons=1, n_osds=self.n_osds, with_mgr=True,
            with_rgw=True, **self.mods.cluster_kwargs(self.device))
        await self.c.start()
        # `ceph balancer off`, which this mgr has no command for, so the
        # module leaves the list the mgr ticks: each pg-temp remap of the
        # balancer is a new map epoch, at which every OSD on this one
        # loop maps all of the cluster's PGs through CRUSH again; with
        # 120 PGs its remaps starved the heartbeats until every OSD was
        # "wrongly marked down", epoch after epoch
        self.c.mgr.modules = [mod for mod in self.c.mgr.modules
                              if mod.NAME != "balancer"]
        for mon in self.c.mons.values():
            mon.osdmon.DOWN_OUT_INTERVAL = ACCESS_DOWN_OUT_S
        for osd in self.c.osds.values():
            osd.config.set("osd_heartbeat_grace", ACCESS_HB_GRACE_S)
            # background scrub rounds wait past the run
            osd.config.set("osd_scrub_interval", 3600.0)
        boot_s = time.perf_counter() - t0
        cl = self.client = await self.c.client()
        await cl.command({
            "prefix": "osd erasure-code-profile set", "name": "accessprof",
            "profile": {"plugin": self.mods.plugin, "k": str(self.k),
                        "m": str(self.m),
                        **self.mods.profile_extra(self.device)}})
        # one pool at a time, each clean before the next (as an
        # operator waits for HEALTH_OK): the peering of 32 EC PGs on 11
        # OSDs is seconds of this one loop's time, and three pools'
        # peering at once starved the heartbeats past their grace, so
        # every OSD was "wrongly marked down" and peered again
        size = min(3, self.n_osds)
        clean_s = {}
        for name, kind in ((self.RBD_POOL, "replicated"),
                           (self.RBD_DATA, "erasure"),
                           (self.FS_META, "replicated"),
                           (self.FS_DATA, "erasure"),
                           (self.RGW_DATA, "erasure")):
            if kind == "erasure":
                await cl.pool_create(name, pg_num=self.pg_num,
                                     pool_type="erasure",
                                     erasure_code_profile="accessprof")
            else:
                await cl.pool_create(name, pg_num=8, size=size)
            clean_s[name] = await self.wait_clean()
        self.c.osds[0].config.set("ec_offload_crc_device", True)
        self.svc = self.mods.offload.get_service()
        if not self.svc.crc_device:
            raise AssertionError("ec_offload_crc_device did not reach the "
                                 "service")
        pool = cl.osdmap.get_pool(self.RBD_DATA)
        self.stripe_width = pool.stripe_width
        self.mds = self.mods.MDSDaemon(self.c.mon_addrs,
                                       metadata_pool=self.FS_META,
                                       data_pool=self.FS_DATA)
        self.mds.stripe_unit = self.sz["obj"]
        await self.mds.start()
        self.gw = self.mods.RGWGateway(
            cl.ioctx("rgw_index"), data_ioctx=cl.ioctx(self.RGW_DATA),
            name="rgw.ec")
        await self.gw.start()
        return {"boot_s": boot_s, "clean_s": clean_s,
                "stripe_width": self.stripe_width,
                "chunk": self.stripe_width // self.k}

    async def wait_clean(self) -> float:
        """Seconds until every PG of every pool is active on a full
        acting set with nothing left to recover."""
        import asyncio
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        while True:
            pools = self.client.osdmap.pools.values()
            prim = [pg for o in self.c.osds.values() for pg in o.pgs.values()
                    if pg.is_primary()]
            ok = [pg for pg in prim if pg.state == "active"
                  and not pg._pending_recovery and not pg._deferred_activate
                  and len([a for a in pg.acting if a in self.c.osds])
                  == pg.pool.size]
            want = sum(p.pg_num for p in pools)
            if len(prim) == want and len(ok) == want:
                return loop.time() - t0
            if loop.time() - t0 > self.TIMEOUT_S:
                raise TimeoutError(f"{len(ok)} of {want} PGs clean "
                                   f"({len(prim)} with a primary)")
            await asyncio.sleep(0.05)

    async def stop(self) -> None:
        import asyncio
        if self.img is not None:
            await asyncio.wait_for(self.img.close(), 30)
        if self.fs is not None:
            await asyncio.wait_for(self.fs.unmount(), 30)
        for daemon in (self.mds, self.gw):
            if daemon is not None:
                await asyncio.wait_for(daemon.stop(), 30)
        if self.c is not None:
            await self.c.stop()

    # -- accounting ------------------------------------------------------------

    def _counts(self) -> dict:
        return {**self.mods.counts(), "batches": self.svc.stats["batches"],
                "riders": self.svc.stats["batched_ops"],
                "fallback_ops": self.svc.stats["fallback_ops"]}

    async def _step(self, name: str, fn) -> dict:
        """Run `fn`, a coroutine function returning the client bytes it
        moved (and its ops); its seconds, what the service and the
        kernels did meanwhile, and `self.watch`'s reading of the loop
        over it. A progress line names the step as it ends. A batch that
        reached the host fallback fails the step."""
        before = self._counts()
        t0 = time.perf_counter()
        out = await fn() or {}
        out["seconds"] = time.perf_counter() - t0
        out.update(self.watch.since(t0))
        log(f"phase 16 {name}: {out['seconds']:.2f} s; the loop's deepest "
            f"stall {out['loop_stall_max_s']:.3f} s")
        after = self._counts()
        d = {k: after[k] - before[k] for k in after}
        out["launches"] = {k: d[k] for k in ("gf_bitmatrix", "crc32c_blocks",
                                             "gf_bitmatrix_csum")}
        out["batches"] = d["batches"]
        out["riders_per_batch"] = (d["riders"] / d["batches"]
                                   if d["batches"] else None)
        out["fallback_ops"] = d["fallback_ops"]
        # rates over the traffic's own time (`io_s`, where the step also
        # opened a profiler window), else over the step
        io_s = out.setdefault("io_s", out["seconds"])
        out["gb_s"] = out["bytes"] / io_s / 1e9
        if "ops" in out:
            out["iops"] = out["ops"] / io_s
        if d["fallback_ops"]:
            raise AssertionError(f"{d['fallback_ops']} ops reached the host "
                                 f"fallback")
        return out

    async def _gather(self, jobs) -> None:
        """Await the coroutine functions in `jobs`, `inflight` at once."""
        import asyncio
        sem = asyncio.Semaphore(self.sz["inflight"])

        async def one(job):
            async with sem:
                await job()
        await asyncio.gather(*[one(j) for j in jobs])

    def _pieces(self, total: int):
        obj = self.sz["obj"]
        return [(off, min(obj, total - off)) for off in range(0, total, obj)]

    # -- 16a: an RBD image with its data in rbd_ec -------------------------------

    async def rbd_write(self) -> dict:
        io = self.client.ioctx(self.RBD_POOL)
        await self.mods.RBD.create(io, "img", self.sz["image"],
                                   order=self.sz["obj"].bit_length() - 1,
                                   data_pool=self.RBD_DATA)
        self.img = await self.mods.Image.open(io, "img")
        model = bytes(self.rbd_model)

        def job(off, n):
            return lambda: self.img.write(off, model[off:off + n])
        await self._gather([job(o, n) for o, n in
                            self._pieces(len(model))])
        return {"bytes": len(model), "ops": len(model) // self.sz["obj"]}

    async def rbd_overwrite(self) -> dict:
        def job(off, blob):
            return lambda: self.img.write(off, blob)
        await self._gather([job(o, b) for o, b in self.rbd_over])
        for off, blob in self.rbd_over:
            self.rbd_model[off:off + len(blob)] = blob
        return {"bytes": len(self.rbd_over) * self.sz["small"],
                "ops": len(self.rbd_over)}

    async def rbd_read(self) -> dict:
        got = {}

        def job(off, n):
            async def read():
                got[off] = await self.img.read(off, n)
            return read
        pieces = self._pieces(len(self.rbd_model))
        await self._gather([job(o, n) for o, n in pieces])
        for off, n in pieces:
            if got[off] != self.rbd_model[off:off + n]:
                raise AssertionError(f"image bytes at {off} differ from "
                                     f"the model")
        return {"bytes": len(self.rbd_model), "ops": len(pieces)}

    # -- 16b: an S3 bucket with its data in rgw_ec ------------------------------

    def _crc(self, data: bytes) -> str:
        return f"{self.mods.ec_native.crc32c(data):08x}"

    async def s3_put(self) -> dict:
        status, _, body = await http(self.gw.addr, "PUT", f"/{self.BUCKET}")
        if status != 200:
            raise AssertionError(f"PUT bucket: {status} {body!r}")

        def job(key, data):
            async def put():
                st, hdrs, out = await http(self.gw.addr, "PUT",
                                           f"/{self.BUCKET}/{key}", data)
                if st != 200:
                    raise AssertionError(f"PUT {key}: {st} {out!r}")
                self.etags[key] = hdrs["etag"].strip('"')
            return put
        await self._gather([job(k, d) for k, d in self.s3.items()])
        for key, data in self.s3.items():
            if self.etags[key] != self._crc(data):
                raise AssertionError(f"PUT {key}: ETag {self.etags[key]} is "
                                     f"not the crc32c of its bytes")
        return {"bytes": sum(map(len, self.s3.values())),
                "ops": len(self.s3)}

    async def s3_multipart(self) -> dict:
        path = f"/{self.BUCKET}/mp"
        st, _, out = await http(self.gw.addr, "POST", path + "?uploads")
        if st != 200:
            raise AssertionError(f"initiate multipart: {st} {out!r}")
        uid = out.split(b"<UploadId>")[1].split(b"</UploadId>")[0].decode()

        def job(n, data):
            async def put():
                st, hdrs, out = await http(
                    self.gw.addr, "PUT",
                    f"{path}?partNumber={n}&uploadId={uid}", data)
                if st != 200 or hdrs["etag"].strip('"') != self._crc(data):
                    raise AssertionError(f"part {n}: {st} {hdrs} {out!r}")
            return put
        await self._gather([job(n, d) for n, d in
                            enumerate(self.parts, start=1)])
        st, _, out = await http(self.gw.addr, "POST",
                                f"{path}?uploadId={uid}")
        etag = out.split(b"<ETag>&quot;")[1].split(b"&quot;</ETag>")[0]
        whole = b"".join(self.parts)
        if st != 200 or etag.decode() != \
                f"{self._crc(whole)}-{len(self.parts)}":
            raise AssertionError(f"complete multipart: {st} {out!r}")
        self.s3["mp"] = whole
        self.etags["mp"] = etag.decode()
        return {"bytes": len(whole), "ops": len(self.parts)}

    async def s3_get(self) -> dict:
        def job(key, data):
            async def get():
                st, hdrs, out = await http(self.gw.addr, "GET",
                                           f"/{self.BUCKET}/{key}")
                if st != 200 or out != data:
                    raise AssertionError(f"GET {key}: {st}, "
                                         f"{len(out)} bytes differ")
                if hdrs["etag"].strip('"') != self._crc(data):
                    raise AssertionError(f"GET {key}: ETag {hdrs['etag']}")
            return get
        await self._gather([job(k, d) for k, d in self.s3.items()])
        key = sorted(self.s3)[0]
        lo, hi = 100, self.sz["obj"] // 2 + 99
        st, hdrs, out = await http(self.gw.addr, "GET",
                                   f"/{self.BUCKET}/{key}",
                                   headers={"Range": f"bytes={lo}-{hi}"})
        if st != 206 or out != self.s3[key][lo:hi + 1]:
            raise AssertionError(f"ranged GET {key}: {st}, {len(out)} bytes")
        return {"bytes": sum(map(len, self.s3.values())) + len(out),
                "ops": len(self.s3) + 1}

    # -- 16c: a CephFS file with its data in fs_ec ------------------------------

    async def fs_write(self) -> dict:
        self.fs = self.mods.CephFS(self.c.mon_addrs, self.mds.addr,
                                   data_pool=self.FS_DATA)
        await self.fs.mount()
        await self.fs.mkdir("/d")
        fh = await self.fs.open("/d/file", "w")
        model = bytes(self.fs_model)

        def job(off, n):
            return lambda: fh.write(model[off:off + n], off)
        await self._gather([job(o, n) for o, n in self._pieces(len(model))])
        await fh.close()
        return {"bytes": len(model), "ops": len(model) // self.sz["obj"]}

    async def fs_overwrite(self) -> dict:
        fh = await self.fs.open("/d/file", "a")

        def job(off, blob):
            return lambda: fh.write(blob, off)
        await self._gather([job(o, b) for o, b in self.fs_over])
        await fh.close()
        for off, blob in self.fs_over:
            self.fs_model[off:off + len(blob)] = blob
        return {"bytes": len(self.fs_over) * self.sz["small"],
                "ops": len(self.fs_over)}

    async def fs_read(self) -> dict:
        fh = await self.fs.open("/d/file", "r")
        if fh.size != len(self.fs_model):
            raise AssertionError(f"file size {fh.size}, model "
                                 f"{len(self.fs_model)}")
        got = {}

        def job(off, n):
            async def read():
                got[off] = await fh.read(n, off)
            return read
        pieces = self._pieces(len(self.fs_model))
        await self._gather([job(o, n) for o, n in pieces])
        for off, n in pieces:
            if got[off] != self.fs_model[off:off + n]:
                raise AssertionError(f"file bytes at {off} differ from the "
                                     f"model")
        return {"bytes": len(self.fs_model), "ops": len(pieces)}

    async def fs_purge(self) -> dict:
        """An 8 MiB second file written, unlinked, and waited on until
        its data objects are gone from fs_ec."""
        import asyncio
        await self.fs.write_file("/d/purge", self.purge_data)
        if await self.fs.read_file("/d/purge") != self.purge_data:
            raise AssertionError("/d/purge read back differs")
        prefix = f"{(await self.fs.stat('/d/purge'))['ino']:x}."
        data = self.client.ioctx(self.FS_DATA)
        held = [o for o in await data.list_objects() if o.startswith(prefix)]
        if len(held) != self.sz["fs_purge_objects"]:
            raise AssertionError(f"/d/purge holds {held}")
        t0 = time.perf_counter()
        await self.fs.unlink("/d/purge")
        while True:
            left = [o for o in await data.list_objects()
                    if o.startswith(prefix)]
            if not left:
                break
            if time.perf_counter() - t0 > self.TIMEOUT_S:
                raise TimeoutError(f"unlink left {left} in {self.FS_DATA}")
            await asyncio.sleep(0.1)
        return {"bytes": len(self.purge_data), "purged": len(held),
                "purge_s": time.perf_counter() - t0}

    # -- 16d: every shard against the host codec ---------------------------------

    def objects(self) -> dict:
        """Every EC data object the models hold: name -> bytes."""
        obj = self.sz["obj"]
        out = {}
        for off in range(0, len(self.rbd_model), obj):
            out[self.img._data_oid(off // obj)] = bytes(
                self.rbd_model[off:off + obj])
        ino = self._fs_ino
        for off in range(0, len(self.fs_model), obj):
            out[self.mods.fs_data_oid(ino, off // obj)] = bytes(
                self.fs_model[off:off + obj])
        for key, data in self.s3.items():
            out[self.mods.rgw_data_oid(self.BUCKET, key)] = data
        return out

    async def check_shards(self, np) -> dict:
        """Every shard on every OSD of the three EC pools equals the host
        codec's (native/ec_native.cc) encode of the object bytes the
        models hold, and no other shard object is left but the rollback
        generations (the purged file's and the multipart parts' are
        gone); returns {(osd, object, shard): crc32c of the shard} for
        the comparison across packages."""
        import asyncio

        from ceph_tpu_torch.ec import gf256
        self._fs_ino = (await self.fs.stat("/d/file"))["ino"]
        coding = gf256.reed_sol_van_matrix(self.k, self.m)
        sw, chunk = self.stripe_width, self.stripe_width // self.k
        want = {}
        for oid, data in self.objects().items():
            pad = -len(data) % sw
            d = np.frombuffer(data + bytes(pad), dtype=np.uint8).reshape(
                -1, self.k, chunk).transpose(1, 0, 2).reshape(self.k, -1)
            par = np.empty((self.m, d.shape[1]), dtype=np.uint8)
            self.mods.ec_native.encode(coding, d, par)
            want[oid] = np.concatenate([d, par])
            # the heartbeats share this loop: yield between objects
            await asyncio.sleep(0)
        seen = {}
        for i, osd in self.c.osds.items():
            st = osd.store
            for cid in st.list_collections():
                await asyncio.sleep(0)
                for gh in st.collection_list(cid):
                    attrs = st.getattrs(cid, gh)
                    if "shard" not in attrs:
                        continue
                    if gh.name.endswith("\x00prev"):
                        continue
                    if gh.name not in want:
                        raise AssertionError(f"osd.{i} holds a shard of "
                                             f"{gh.name!r}, which no model "
                                             f"holds")
                    s = int(attrs["shard"])
                    blob = st.read(cid, gh)
                    if blob != want[gh.name][s].tobytes():
                        raise AssertionError(f"osd.{i} shard {s} of "
                                             f"{gh.name} differs from the "
                                             f"host codec's")
                    seen[(i, gh.name, s)] = self.mods.ec_native.crc32c(blob)
        if len(seen) != self.n_osds * len(want):
            raise AssertionError(f"{len(seen)} shards found, expected "
                                 f"{self.n_osds * len(want)}")
        return seen

    # -- 16f: the mgr's view ----------------------------------------------------

    async def mgr_view(self) -> dict:
        """The daemon index holds osd, mon, mds and rgw; /metrics carries
        rows for the MDS and both gateways and a ceph_device row for
        every OSD; health through the mgr."""
        import asyncio
        import re
        want = {"osd", "mon", "mds", "rgw"}
        daemons = {self.mds.name, "rgw.0", self.gw.name}
        osds = {f"osd.{i}" for i in self.c.osds}
        t0 = time.perf_counter()
        while True:
            index = self.c.mgr.daemon_index.daemons
            services = {st.service for st in index.values()}
            _, _, blob = await http(self.c.mgr.exporter.addr, "GET",
                                    "/metrics")
            text = blob.decode()
            labelled = set(re.findall(r'ceph_daemon="([^"]+)"', text))
            rows = device_rows(text)
            if want <= services and daemons <= labelled \
                    and set(rows) == osds:
                break
            if time.perf_counter() - t0 > self.TIMEOUT_S:
                raise TimeoutError(
                    f"mgr: services {sorted(services)}, labelled "
                    f"{sorted(labelled & daemons)}, device rows "
                    f"{sorted(rows)}")
            await asyncio.sleep(0.25)
        health = await self.c.mgr.mon_command({"prefix": "health"})
        if not str(health.get("status", "")).startswith("HEALTH_"):
            raise AssertionError(f"health through the mgr: {health}")
        return {"services": sorted(services), "daemons": sorted(index),
                "device_rows": {d: sorted(v) for d, v in rows.items()},
                "health": health.get("status"),
                "checks": sorted(health.get("checks", {})),
                "converged_s": time.perf_counter() - t0}

    # -- 16e: one OSD down, everything read degraded ------------------------------

    async def degraded(self) -> dict:
        import asyncio
        victim = self.sz["victim"]
        t0 = time.perf_counter()
        await self.c.kill_osd(victim)
        while not all(victim in o.osdmap.osds and not o.osdmap.osds[victim].up
                      for o in self.c.osds.values()):
            if time.perf_counter() - t0 > self.TIMEOUT_S:
                raise TimeoutError(f"osd.{victim} never marked down")
            await asyncio.sleep(0.05)
        down_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        moved = (await self.rbd_read())["bytes"]
        moved += (await self.s3_get())["bytes"]
        moved += (await self.fs_read())["bytes"]
        return {"bytes": moved, "victim": victim, "down_s": down_s,
                "read_s": time.perf_counter() - t1}


async def drive_access(ap: AccessPass, np, window=None) -> dict:
    """16a-16f on `ap` (16f runs before 16e, while every OSD is up, so
    that /metrics holds a ceph_device row for each). `window`, a context
    manager, is entered around 16a's 4 MiB writes alone, on a thread of
    its own: starting the profiler takes seconds, and on the loop's
    thread it would stall every daemon's heartbeats at once."""
    async with LoopWatch() as ap.watch:
        return await _drive_access(ap, np, window)


async def _drive_access(ap: AccessPass, np, window) -> dict:
    import asyncio
    import concurrent.futures
    t0 = time.perf_counter()
    out = {"boot": await ap.boot()}
    out["boot"].update(ap.watch.since(t0))
    log(f"phase 16 boot: {time.perf_counter() - t0:.2f} s; the loop's "
        f"deepest stall {out['boot']['loop_stall_max_s']:.3f} s")
    side = concurrent.futures.ThreadPoolExecutor(1)
    loop = asyncio.get_running_loop()
    try:
        async def traced_write():
            if window is None:
                return await ap.rbd_write()
            t0 = time.perf_counter()
            await loop.run_in_executor(side, window.__enter__)
            enter_s = time.perf_counter() - t0
            try:
                t0 = time.perf_counter()
                res = await ap.rbd_write()
                res["io_s"] = time.perf_counter() - t0
            finally:
                t0 = time.perf_counter()
                await loop.run_in_executor(side, window.__exit__,
                                           None, None, None)
            res.update(window_enter_s=enter_s,
                       window_exit_s=time.perf_counter() - t0)
            return res
        out["a_write"] = await ap._step("a_write", traced_write)
        out["a_overwrite"] = await ap._step("a_overwrite", ap.rbd_overwrite)
        out["a_read"] = await ap._step("a_read", ap.rbd_read)
        out["b_put"] = await ap._step("b_put", ap.s3_put)
        out["b_multipart"] = await ap._step("b_multipart", ap.s3_multipart)
        out["b_get"] = await ap._step("b_get", ap.s3_get)
        out["c_write"] = await ap._step("c_write", ap.fs_write)
        out["c_overwrite"] = await ap._step("c_overwrite", ap.fs_overwrite)
        out["c_read"] = await ap._step("c_read", ap.fs_read)
        out["c_purge"] = await ap._step("c_purge", ap.fs_purge)
        shards = await ap.check_shards(np)
        out["d"] = {"shards": len(shards),
                    "objects": len(ap.objects())}
        out["f"] = await ap.mgr_view()
        out["e"] = await ap._step("e", ap.degraded)
        out["etags"] = dict(ap.etags)
        out["store"] = shards
        out["fallback_ops"] = ap.svc.stats["fallback_ops"]
    except BaseException:
        # the teardown below may fail too, and hide this
        import traceback
        log("phase 16: failed; the cluster stops next")
        traceback.print_exc()
        raise
    finally:
        side.shutdown()
        t0 = time.perf_counter()
        await ap.stop()
        log(f"phase 16: the cluster stopped in {time.perf_counter() - t0:.2f}"
            f" s")
    if out["fallback_ops"]:
        raise AssertionError(f"{out['fallback_ops']} ops reached the host "
                             f"fallback")
    return out


ACCESS_STEPS = ("a_write", "a_overwrite", "a_read", "b_put", "b_multipart",
                "b_get", "c_write", "c_overwrite", "c_read", "c_purge", "e")


def phase_stage_cluster(device: str, timeout_s: float = 300.0) -> dict:
    """16g: the port's bench_driver --stage cluster on `device` as a
    child process; its `health` must hold a status."""
    out = run_stage("16g", "cluster", device, timeout_s)
    health = out["record"]["health"]
    if not str(health.get("status", "")).startswith("HEALTH_"):
        raise AssertionError(f"--stage cluster health: {health}")
    return out


def phase_access(torch, np, dev, smi: str, window_cls=None,
                 sizes: dict = ACCESS_SIZES) -> dict:
    """Phase 16 on `dev`: AccessPass at the north star's code (plugin
    cuda, k=8 m=3) over `sizes`, in a temporary directory removed at the
    end; the card's idle share over 16a's writes (`window_cls`, default
    DeviceWindow); then 16g. K1 and K2 must launch in each of 16a, 16b
    and 16c, K1 in 16e."""
    import asyncio
    import shutil
    import tempfile
    mods = access_modules()
    root = tempfile.mkdtemp(prefix="chip_smoke_access_")
    t0 = time.perf_counter()
    try:
        ap = AccessPass(mods, root, str(dev), K, M, ACCESS_PGS, sizes)
        window = (window_cls or DeviceWindow)(torch)
        mods.reset()
        out = asyncio.run(asyncio.wait_for(drive_access(ap, np, window),
                                           600))
        out["launches"] = mods.counts()
        out["idle_share"] = window.idle_share
        out["busy_s"] = getattr(window, "busy_s", None)
        out["window_s"] = getattr(window, "window_s", None)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["sizes"] = dict(sizes)
    out["store"] = len(out["store"])
    out["drive_s"] = time.perf_counter() - t0
    if dev.type == "cuda":
        for group in ("a", "b", "c"):
            for kname in ("gf_bitmatrix", "crc32c_blocks"):
                n = sum(out[s]["launches"][kname] for s in ACCESS_STEPS
                        if s.startswith(group))
                if n <= 0:
                    raise AssertionError(f"16{group} never launched {kname}")
        if out["e"]["launches"]["gf_bitmatrix"] <= 0:
            raise AssertionError("16e's degraded reads never launched "
                                 "gf_bitmatrix")
    out["g"] = phase_stage_cluster("cuda" if dev.type == "cuda" else "cpu")
    out["card"] = smi
    return out


def log_access(r: dict, smi: str) -> None:
    b = r["boot"]
    sz = r["sizes"]
    log(f"phase 16 [{smi}]: vstart 1 mon + {K + M} OSDs + mgr + rgw.0 "
        f"booted in {b['boot_s']:.2f} s; pools rbd_ec, fs_ec, rgw_ec "
        f"pg_num {ACCESS_PGS} (plugin cuda k={K} m={M}, {b['chunk']}-byte "
        f"chunks, stripe {b['stripe_width']}), an MDS and gateway rgw.ec; "
        f"seconds to clean after each pool's create "
        f"{ {k: round(v, 2) for k, v in b['clean_s'].items()} }; "
        f"{sz['obj'] >> 20} MiB objects, {sz['inflight']} in flight")
    what = {
        "a_write": f"RBD {sz['rbd_objects']} object-aligned writes into a "
                   f"{sz['image'] >> 20} MiB image (data pool rbd_ec)",
        "a_overwrite": f"RBD {sz['rbd_overwrites']} random 4 KiB overwrites "
                       f"(EC read-modify-write)",
        "a_read": "RBD the written range read back, equal to the model",
        "b_put": f"S3 PUT of {sz['s3_objects']} objects over HTTP, ETag = "
                 f"crc32c",
        "b_multipart": f"S3 multipart upload of {sz['s3_parts']} parts of "
                       f"{sz['s3_part'] >> 20} MiB",
        "b_get": "S3 GET of every object and one ranged GET, equal, ETag = "
                 "crc32c",
        "c_write": f"CephFS one {sz['fs_objects'] * sz['obj'] >> 20} MiB "
                   f"file in {sz['obj'] >> 20} MiB writes (data pool fs_ec)",
        "c_overwrite": f"CephFS {sz['fs_overwrites']} random 4 KiB "
                       f"overwrites (EC read-modify-write)",
        "c_read": "CephFS the file read back, equal to the model",
        "c_purge": f"CephFS a {sz['fs_purge_objects'] * sz['obj'] >> 20} "
                   f"MiB file written, unlinked and purged from fs_ec",
        "e": f"osd.{sz['victim']} stopped, every image, S3 and file byte "
             f"read degraded, equal",
    }
    def line(step):
        s = r[step]
        rpb = s["riders_per_batch"]
        iops = f", {s['iops']:.0f} IOPS" if "iops" in s else ""
        extra = ""
        if "window_enter_s" in s:
            extra = (f" ({s['io_s']:.3f} s of traffic inside a profiler "
                     f"window entered in {s['window_enter_s']:.2f} s and "
                     f"left in {s['window_exit_s']:.2f} s)")
        if step == "e":
            extra = (f" (marked down in {s['down_s']:.2f} s, reads "
                     f"{s['read_s']:.3f} s)")
        if step == "c_purge":
            extra = f" (purged in {s['purge_s']:.2f} s)"
        log(f"phase 16{step[0]} [{smi}]: {what[step]}: {s['seconds']:.3f} s"
            f"{extra}, {s['gb_s']:.3f} GB/s of client bytes{iops} (host "
            f"clock); {s['batches']} device batches, "
            f"{'n/a' if rpb is None else f'{rpb:.2f}'} riders a batch; "
            f"launches K1 {s['launches']['gf_bitmatrix']}, K2 "
            f"{s['launches']['crc32c_blocks']}, K3 "
            f"{s['launches']['gf_bitmatrix_csum']}; fallback_ops "
            f"{s['fallback_ops']}; the loop's deepest stall "
            f"{s['loop_stall_max_s']:.3f} s")
        if step == "a_write":
            busy = "n/a" if r["busy_s"] is None \
                else f"{r['busy_s'] * 1e3:.1f} ms"
            log(f"phase 16a [{smi}]: card idle {share(r['idle_share'])} of "
                f"the 4 MiB writes ({busy} busy)")
    for step in ACCESS_STEPS[:-1]:
        line(step)
    log(f"phase 16d [{smi}]: every shard of {r['d']['objects']} objects on "
        f"every OSD ({r['d']['shards']} shards) equal to the host codec's; "
        f"no other shard object left but the rollback generations")
    f = r["f"]
    log(f"phase 16f [{smi}]: mgr services {f['services']}; /metrics labels "
        f"the MDS and both gateways and carries a ceph_device row for "
        f"{len(f['device_rows'])} OSDs; health {f['health']} "
        f"{f['checks']} (converged in {f['converged_s']:.2f} s)")
    line("e")
    log(f"phase 16 [{smi}]: launches {r['launches']}; fallback_ops "
        f"{r['fallback_ops']}; 16a-16f {r['drive_s']:.1f} s")


# -- phase 17: the failure storm and the interleave sweep ---------------------

#: each child's timeout: above the stage's own limits (the storm's phases
#: A-B 280 s, its flight-recorder drill 170 s and deadlock drill 140 s; the
#: sweep's 3 modes x 2 reps x 180 s), plus the boots
STORM_TIMEOUT_S = 280 + 170 + 140 + 90
SWEEP_TIMEOUT_S = 3 * 2 * 180 + 60
#: clay k=8 m=3 d=10's repair: d=10 helpers each send 1/q = 1/3 of a chunk,
#: against 8 whole chunks for a full-stripe decode
STORM_REPAIR_RATIO = round(10 / 3 / 8, 4)
SWEEP_SEEDS = 12 * 2 * 3          # seeds x reps x modes


def phase_storm(device: str) -> dict:
    """Phase 17 on `device`: 17a the bench driver's --stage failure_storm,
    17b its --stage interleave, each a child process (which exits 1 on a
    False flag, an `*_error` key or a client error). The storm must also
    repair at clay's ratio, read degraded and merge its drill's timeline
    across 2 processes; the sweep must run every seed. On a card K1 must
    launch in each child and no op may reach the host fallback there."""
    out = {"a": run_stage("17a", "failure_storm", device, STORM_TIMEOUT_S),
           "b": run_stage("17b", "interleave", device, SWEEP_TIMEOUT_S)}
    storm, sweep = out["a"]["record"], out["b"]["record"]
    if storm["failure_storm_repair_ratio"] != STORM_REPAIR_RATIO:
        raise AssertionError(f"17a: repair ratio "
                             f"{storm['failure_storm_repair_ratio']}")
    if storm["failure_storm_degraded_reads"] <= 0 \
            or storm["failure_storm_client_errors"] != 0:
        raise AssertionError(f"17a: degraded reads "
                             f"{storm['failure_storm_degraded_reads']}, "
                             f"client errors "
                             f"{storm['failure_storm_client_errors']}")
    if storm["failure_storm_drill_processes"] != 2:
        raise AssertionError(f"17a: the drill's timeline spans "
                             f"{storm['failure_storm_drill_processes']} "
                             f"processes")
    if sweep["interleave_seeds"] != SWEEP_SEEDS:
        raise AssertionError(f"17b: {sweep['interleave_seeds']} seeds")
    if device != "cpu":
        for label in ("a", "b"):
            n = out[label]["launches"]
            if n["gf_bitmatrix"] <= 0 or n["fallback_ops"] != 0:
                raise AssertionError(f"17{label}: launches in the child {n}")
    return out


def log_storm(r: dict, smi: str) -> None:
    a, b = r["a"]["record"], r["b"]["record"]
    log(f"phase 17a [{smi}]: --stage failure_storm {r['a']['wall_s']:.1f} s: "
        f"3 of 11 OSDs killed under load, marked down, revived and clean "
        f"in {a['failure_storm_time_to_clean_s']} s; "
        f"{a['failure_storm_degraded_reads']} degraded reads (p99 "
        f"{a['failure_storm_degraded_p99_ms']} ms), p99 during backfill "
        f"{a['failure_storm_backfill_p99_ms']} ms, write stalls "
        f"{a['failure_storm_write_stalls']}, read stalls "
        f"{a['failure_storm_read_stalls']}, client errors "
        f"{a['failure_storm_client_errors']}; clay repair ratio "
        f"{a['failure_storm_repair_ratio']} "
        f"({a['failure_storm_repair_fetched_mb']} of "
        f"{a['failure_storm_repair_full_equiv_mb']} MB), recovery "
        f"{a['failure_storm_recovery_mb_s']} MB/s (host clock)")
    log(f"phase 17a [{smi}]: flight-recorder drill: "
        f"{a['failure_storm_drill_events']} events across "
        f"{a['failure_storm_drill_processes']} processes in causal order; "
        f"deadlock drill: found in {a['deadlock_drill_detect_s']} s, raised, "
        f"cleared and replayed (digest {a['deadlock_drill_witness_digest']}"
        f"), lockdep overhead {a['lockdep_overhead_pct']}%")
    log(f"phase 17b [{smi}]: --stage interleave {r['b']['wall_s']:.1f} s: "
        f"{b['interleave_seeds']} seeds, {b['interleave_schedules_explored']}"
        f" schedules, {b['interleave_decisions']} decisions; plain "
        f"{b['interleave_plain_s']} s, sanitizer {b['interleave_sanitizer_s']}"
        f" s (+{b['interleave_sanitizer_overhead_pct']}%), recorder and mgr "
        f"{b['interleave_flight_s']} s (+{b['flight_history_overhead_pct']}%)"
        f" (host clock)")


# -- phase 18: the client fleet, the scrub storm and the swarm ----------------

#: each child's timeout: above the stage's own limit (the scrub storm's
#: body 520 s, the swarm's 280 s), plus the boots
SCRUB_TIMEOUT_S = 520 + 60
SWARM_TIMEOUT_S = 280 + 40
#: the rot objects the scrub storm injects before its loaded window
SCRUB_ROT_OBJECTS = 12
SWARM_CLIENTS = 200


def phase_swarm(device: str) -> dict:
    """Phase 18 on `device`: 18a the bench driver's --stage scrub_storm,
    18b its --stage swarm, each a child process (which exits 1 on a False
    flag, an `*_error` key or an error count above 0). The scrub storm
    must find and repair every rot object and batch the device round's
    digests through the offload service; the swarm must run its 200
    clients, each accounted by the OSDs. On a card K1 must launch in each
    child, K2 in the scrub storm's, and no op may reach the host
    fallback there."""
    out = {"a": run_stage("18a", "scrub_storm", device, SCRUB_TIMEOUT_S),
           "b": run_stage("18b", "swarm", device, SWARM_TIMEOUT_S)}
    scrub, swarm = out["a"]["record"], out["b"]["record"]
    if scrub["scrub_errors_found"] < SCRUB_ROT_OBJECTS \
            or scrub["scrub_errors_repaired"] != scrub["scrub_errors_found"]:
        raise AssertionError(f"18a: {scrub['scrub_errors_found']} found, "
                             f"{scrub['scrub_errors_repaired']} repaired of "
                             f"{SCRUB_ROT_OBJECTS} rot objects")
    if scrub["scrub_offload_batches"] <= 0 \
            or scrub["scrub_digest_batches"] <= 0:
        raise AssertionError(f"18a: the device round batched "
                             f"{scrub['scrub_offload_batches']} offload and "
                             f"{scrub['scrub_digest_batches']} digest "
                             f"batches")
    if swarm["swarm_clients"] != SWARM_CLIENTS \
            or swarm["swarm_osd_clients_tracked"] < SWARM_CLIENTS:
        raise AssertionError(f"18b: {swarm['swarm_clients']} clients, "
                             f"{swarm['swarm_osd_clients_tracked']} tracked")
    if device != "cpu":
        for label, kernels in (("a", ("gf_bitmatrix", "crc32c_blocks")),
                               ("b", ("gf_bitmatrix",))):
            n = out[label]["launches"]
            if any(n[k] <= 0 for k in kernels) or n["fallback_ops"] != 0:
                raise AssertionError(f"18{label}: launches in the child {n}")
    return out


def log_swarm(r: dict, smi: str) -> None:
    a, b = r["a"]["record"], r["b"]["record"]
    log(f"phase 18a [{smi}]: --stage scrub_storm {r['a']['wall_s']:.1f} s: "
        f"deep-scrub hashing host {a['scrub_hash_host_mb_s']} MB/s, device "
        f"crc {a['scrub_hash_device_mb_s']} MB/s (ratio "
        f"{a['scrub_device_vs_host_hash_ratio']}; "
        f"{a['scrub_offload_batches']} offload batches, "
        f"{a['scrub_digest_batches']} digest batches); victim p99 scrub "
        f"off {a['scrub_client_p99_off_ms']} ms, on "
        f"{a['scrub_client_p99_on_ms']} ms "
        f"({a['scrub_client_p99_interference_pct']}%, recorded, not gated: "
        f"interference_ok {a['scrub_interference_ok']}); "
        f"{a['scrub_errors_found']} found, {a['scrub_errors_repaired']} "
        f"repaired of {a['scrub_bitrot_injected']} rotted, detected in "
        f"{a.get('scrub_detect_latency_s')} s, "
        f"{a['scrub_repair_readback_bad']} read back bad; "
        f"{a['scrub_rounds_under_load']} rounds under load at "
        f"{a['scrub_under_load_mb_s']} MB/s; health raised "
        f"{a['scrub_health_raised']}, cleared {a['scrub_health_cleared']}; "
        f"client errors {a['scrub_storm_client_errors']} / "
        f"{a['scrub_baseline_errors']} (host clock)")
    log(f"phase 18b [{smi}]: --stage swarm {r['b']['wall_s']:.1f} s: "
        f"{b['swarm_clients']} clients, {b['swarm_mb_s']} MB/s "
        f"({b['swarm_read_mb_s']} read, {b['swarm_write_mb_s']} write), "
        f"{b['swarm_iops']} IOPS, client p99 median/max "
        f"{b['swarm_client_p99_median_ms']}/{b['swarm_client_p99_max_ms']} "
        f"ms, fairness {b['swarm_p99_fairness']}, errors "
        f"{b['swarm_errors']}; {b['swarm_osd_clients_tracked']} client rows "
        f"on the OSDs, SLO_VIOLATIONS fired {b['swarm_slo_fired']} and "
        f"muted {b['swarm_slo_muted']}, {b['swarm_client_families']} "
        f"ceph_client_* families, {b['swarm_client_series']} series "
        f"(host clock)")


# -- phase 19: the QoS storm ---------------------------------------------------

#: the child's timeout: above the stage's own limit (its body 520 s), plus
#: the boot
QOS_TIMEOUT_S = 520 + 60
QOS_CLIENTS = 1000
QOS_PROCS = 3
#: what the stage's process sets its fd limit to (rados_swarm's
#: raise_fd_limit, capped by the hard limit); its fleet workers inherit it
QOS_FD_WANT = 16384


def fd_limits() -> dict:
    """RLIMIT_NOFILE (soft, hard) of this process, of a child that raises
    it as the QoS stage does, and of a grandchild that raises it again as
    a fleet worker does (`rados_swarm --worker` inherits the stage's)."""
    import resource
    worker = ("import resource; "
              "from ceph_tpu_torch.tools.rados_swarm import raise_fd_limit; "
              "raise_fd_limit(); "
              "print(list(resource.getrlimit(resource.RLIMIT_NOFILE)))")
    stage = ("import json, resource, subprocess, sys; "
             "from ceph_tpu_torch.tools.rados_swarm import raise_fd_limit; "
             f"raise_fd_limit({QOS_FD_WANT}); "
             "w = subprocess.run([sys.executable, '-c', sys.argv[1]], "
             "capture_output=True, text=True, check=True).stdout; "
             "print(json.dumps([list(resource.getrlimit("
             "resource.RLIMIT_NOFILE)), json.loads(w)]))")
    res = subprocess.run([sys.executable, "-c", stage, worker], cwd=REPO,
                         capture_output=True, text=True, check=True,
                         timeout=60)
    child, grandchild = json.loads(res.stdout)
    return {"this_process": list(resource.getrlimit(resource.RLIMIT_NOFILE)),
            "stage": child, "fleet_worker": grandchild}


def phase_qos(device: str) -> dict:
    """Phase 19 on `device`: the bench driver's --stage qos_storm as a
    child process (which exits 1 on a False fairness grade, a client
    error, or a key that read 0 where 0 is no reading; the victims' SLO
    grade is recorded and logged, not gated). Its 1000 clients must run
    over 3 worker processes; recovery must push through the scheduler,
    the shed policy must shed and clients see throttles; the mgr must see
    tenants and the exporter serve ceph_qos_* families; on a card K1 must
    launch in the child and no op may reach the host fallback there."""
    limits = fd_limits()
    log(f"phase 19: RLIMIT_NOFILE (soft, hard): this process "
        f"{limits['this_process']}, the stage's process after "
        f"raise_fd_limit({QOS_FD_WANT}) {limits['stage']}, a fleet worker "
        f"{limits['fleet_worker']}")
    out = run_stage("19", "qos_storm", device, QOS_TIMEOUT_S)
    out["fd_limits"] = limits
    q = out["record"]
    if q["qos_storm_clients"] != QOS_CLIENTS \
            or q["qos_storm_procs"] != QOS_PROCS:
        raise AssertionError(f"19: {q['qos_storm_clients']} clients over "
                             f"{q['qos_storm_procs']} processes")
    for key in ("qos_recovery_pushes", "qos_shed_total", "qos_throttled_ops",
                "qos_mgr_tenants", "qos_exporter_families"):
        if not q[key] > 0:
            raise AssertionError(f"19: {key} {q[key]}")
    if q["qos_status_enabled"] is not True:
        raise AssertionError(f"19: the scheduler's status reads "
                             f"{q['qos_status_enabled']}")
    if device != "cpu":
        n = out["launches"]
        if n["gf_bitmatrix"] <= 0 or n["fallback_ops"] != 0:
            raise AssertionError(f"19: launches in the child {n}")
    return out


def log_qos(r: dict, smi: str) -> None:
    q = r["record"]
    log(f"phase 19 [{smi}]: --stage qos_storm {r['wall_s']:.1f} s "
        f"(stage {q['elapsed_s']} s, host clock)")
    log(f"phase 19 [{smi}]: baseline without the adversaries: "
        f"fairness {q['qos_baseline_fairness']}, victim p99 "
        f"{q['qos_victim_baseline_p99_ms']} ms -> SLO "
        f"{q['qos_victim_slo_ms']} ms, errors {q['qos_baseline_errors']}; "
        f"A scheduler off, {q['qos_storm_clients']} clients over "
        f"{q['qos_storm_procs']} processes: fairness "
        f"{q['qos_fairness_ratio_off']}, victim p99 "
        f"{q['qos_victim_p99_off_ms']} ms ({q['qos_victim_ops_off']} victim "
        f"ops), goodput {q['qos_goodput_off_mb_s']} MB/s of "
        f"{q['qos_mb_s_off']} MB/s, errors {q['qos_errors_off']}")
    log(f"phase 19 [{smi}]: B scheduler on, osd.3 killed and revived: "
        f"fairness {q['qos_fairness_ratio']} (ok {q['qos_fairness_ok']}), "
        f"victim p99 {q['qos_victim_p99_ms']} ms (SLO ok "
        f"{q['qos_victim_slo_ok']}; {q['qos_victim_ops']} victim ops), "
        f"goodput {q['qos_goodput_mb_s']} MB/s of {q['qos_mb_s_on']} MB/s, "
        f"{q['qos_recovery_pushes']} recovery pushes, "
        f"{q['qos_deferred_waits']} deferred waits, "
        f"{q['qos_status_entities']} scheduler entities, errors "
        f"{q['qos_errors_on']}; C shed at queue depth 8: "
        f"{q['qos_shed_total']} shed, {q['qos_throttled_ops']} "
        f"client-visible throttles, admitted p99 {q['qos_admitted_p99_ms']} "
        f"ms, {q['qos_shed_crumbs']} shed and "
        f"{q['qos_backpressure_crumbs']} backpressure crumbs, errors "
        f"{q['qos_shed_errors']}; the mgr saw {q['qos_mgr_tenants']} "
        f"tenants, the exporter {q['qos_exporter_families']} ceph_qos_* "
        f"families over {q['qos_tenant_series']} tenant series (host clock)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="also write all measurements here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from ceph_tpu_torch.ec import gf256
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
    from ceph_tpu_torch.native import ec_native, load as load_native
    from ceph_tpu_torch.ops import _build, crc32c, rs_codec
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.tools import ec_benchmark
    from ceph_tpu_torch.utils.checksummer import Checksummer

    t_start = time.perf_counter()
    report: dict = {}

    # -- phase 0: card and build ---------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    rates = card_rates(name)
    log(f"card: {smi} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s); bound rates "
        f"{rates[0] / 1e12:.2f} TB/s, {rates[1] / 1e12:.0f} int8 TOP/s)")
    report["card"] = smi
    t0 = time.perf_counter()
    native_thread = threading.Thread(target=load_native)
    native_thread.start()
    _build.build()
    native_thread.join()
    if not ec_native.available():
        raise RuntimeError("native host codec did not build")
    report["build_s"] = time.perf_counter() - t0
    log(f"phase 0: built {', '.join(_build.KERNELS)} and the native codec "
        f"in {report['build_s']:.1f} s")
    for kname in _build.KERNELS:
        with open(_build.log_path(kname)) as f:
            for line in f:
                if "registers" in line or "Compiling entry" in line:
                    log(f"  ptxas {kname}: {line.strip()}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(20260)

    def rand_bytes(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)

    # -- phase 1: K1 against its plain version -------------------------------
    t0 = time.perf_counter()
    k1_err = 0
    k1_checks = 0
    full = rand_bytes(BATCH, K, CHUNK)
    for tech, Mx in (("reed_sol_van", gf256.reed_sol_van_matrix(K, M)),
                     ("cauchy_good", gf256.cauchy_good_matrix(K, M))):
        codec = rs_codec.MatrixCodec.get(Mx)
        packed, bitm = codec._bitmatrix_for(dev)
        parity = codec.apply_batch_device(full)
        plain = rs_codec.apply_bitmatrix_plain(bitm, full)
        err = max_abs_err(parity, plain)
        k1_err = max(k1_err, err)
        k1_checks += 1
        if err:
            raise AssertionError(f"K1 {tech} encode differs from plain: {err}")
        words = torch.cat([full, parity], dim=1)          # (16, 11, N)
        for pattern in ((0, 1, 2), (3, 8, 10), (5, 9, 10)):
            avail = tuple(i for i in range(K + M) if i not in pattern)[:K]
            R = rs_codec.recovery_matrix(Mx, avail, pattern)
            dcodec = rs_codec.MatrixCodec.get(R)
            src = words[:, list(avail)].contiguous()
            rec = dcodec.apply_batch_device(src)
            plain = rs_codec.apply_bitmatrix_plain(
                dcodec._bitmatrix_for(dev)[1], src)
            err = max(max_abs_err(rec, plain),
                      max_abs_err(rec, words[:, list(pattern)]))
            k1_err = max(k1_err, err)
            k1_checks += 1
            if err:
                raise AssertionError(f"K1 {tech} decode {pattern} wrong: {err}")
    for k, m, n, b in itertools.product((2, 12, 16), (1, 4),
                                        (1, 4097, CHUNK + 3), (1, 3)):
        Mx = gf256.reed_sol_van_matrix(k, m)
        codec = rs_codec.MatrixCodec.get(Mx)
        x = rand_bytes(b, k, n)
        err = max_abs_err(codec.apply_batch_device(x),
                          rs_codec.apply_bitmatrix_plain(
                              codec._bitmatrix_for(dev)[1], x))
        k1_err = max(k1_err, err)
        k1_checks += 1
        if err:
            raise AssertionError(f"K1 k={k} m={m} N={n} b={b} differs: {err}")
    # the plugins' shapes (phase 9): one stripe batch, r = 1-4 rows from
    # k = 3 (lrc's local layers), 6, 8 (clay's inner code) and 12 (shec),
    # N = clay's plane batches of nz x 16 KiB and a ragged 1 MiB
    mrng = np.random.default_rng(51)
    for k, r, n in itertools.product((3, 6, 8, 12), (1, 2, 3, 4),
                                     PLUGIN_WIDTHS):
        codec = rs_codec.MatrixCodec.get(
            mrng.integers(0, 256, (r, k), dtype=np.uint8))
        x = rand_bytes(1, k, n)
        err = max_abs_err(codec.apply_batch_device(x),
                          rs_codec.apply_bitmatrix_plain(
                              codec._bitmatrix_for(dev)[1], x))
        k1_err = max(k1_err, err)
        k1_checks += 1
        if err:
            raise AssertionError(f"K1 (1,{k},{n}) -> r={r} differs: {err}")
    # a base pointer off 16-byte alignment takes the byte path at any N
    Mx = gf256.cauchy_good_matrix(K, M)
    codec = rs_codec.MatrixCodec.get(Mx)
    x = rand_bytes(3 * K * 4096 + 1)[1:].view(3, K, 4096)
    err = max_abs_err(codec.apply_batch_device(x),
                      rs_codec.apply_bitmatrix_plain(codec._bitmatrix_for(dev)[1], x))
    k1_err = max(k1_err, err)
    k1_checks += 1
    if err:
        raise AssertionError(f"K1 on an unaligned base pointer differs: {err}")
    torch.cuda.synchronize()
    del full, words, src, rec, plain, parity
    log(f"phase 1: K1 equal to its plain version in {k1_checks} cases "
        f"(full width 16x8x1MiB encode and 3-erasure decodes for "
        f"reed_sol_van and cauchy_good; ragged k/m/N/batch; the plugins' "
        f"(1,k,N) -> r for k 3/6/8/12, r 1-4, N "
        f"{', '.join(map(str, PLUGIN_WIDTHS))}; unaligned "
        f"base), max_abs_err {k1_err} (tolerance 0: integer outputs must "
        f"be equal), {time.perf_counter() - t0:.1f} s")

    # -- phase 2: K2 against its plain version -------------------------------
    t0 = time.perf_counter()
    k2_err = 0
    k2_checks = 0
    rand_seed = int(torch.randint(0, 1 << 32, (1,), generator=gen,
                                  device=dev).item())
    for bs in (512, 4096, 65536):
        blocks = rand_bytes(4096, bs)
        for seed in (0xFFFFFFFF, 0, rand_seed):
            crc = crc32c.get_device_crc(bs, seed, dev)
            got = crc.blocks(blocks)
            plain = crc32c.crc32c_blocks_plain(blocks, seed)
            err = max_abs_err(got, plain)
            k2_err = max(k2_err, err)
            k2_checks += 1
            if err:
                raise AssertionError(f"K2 bs={bs} seed={seed:#x} differs: {err}")
    del blocks, got, plain
    crc_full = crc32c.get_device_crc(CSUM_BLOCK, 0xFFFFFFFF, dev)
    big = rand_bytes(CRC_BATCH, CSUM_BLOCK)
    cases = [(f"B={nb}", crc_full, big[:nb]) for nb in K2_BLOCKS]
    ragged = rand_bytes(1000, 4100)
    crc_ragged = crc32c.get_device_crc(4100, 0xFFFFFFFF, dev)
    # a view 4 bytes past a 16-byte boundary: contiguous, sliced from a
    # larger buffer, so the kernel takes its byte path
    raw = rand_bytes(1024 * CSUM_BLOCK + 4)
    offset = raw[4:].view(1024, CSUM_BLOCK)
    if offset.data_ptr() % 16 != 4:
        raise AssertionError("the offset view is not 4 bytes past 16")
    cases.append(("bs=4100 B=1000", crc_ragged, ragged))
    cases.append(("base+4 B=1024", crc_full, offset))
    for label, crc, blocks in cases:
        got = crc.blocks(blocks)
        err = max_abs_err(got, crc32c.crc32c_blocks_plain(blocks, crc.seed))
        k2_err = max(k2_err, err)
        k2_checks += 1
        if err:
            raise AssertionError(f"K2 {label} differs from plain: {err}")
    empty = crc_full.blocks(big[:0])
    if tuple(empty.shape) != (0,):
        raise AssertionError(f"K2 at B=0 returned shape {tuple(empty.shape)}")
    k2_checks += 1
    del ragged, raw, offset, got
    got = crc_full.blocks(big)
    idx = torch.randperm(CRC_BATCH, generator=gen, device=dev)[:1024]
    sample = big[idx].cpu().numpy()
    want = ec_native.crc32c_blocks(sample, CSUM_BLOCK)
    if not np.array_equal(got[idx].cpu().numpy().astype(np.uint32), want):
        raise AssertionError("K2 at 2^16 x 4 KiB differs from the host crc")
    # a small buffer already on the card is checksummed there, by K2, with
    # the Checksummer's default routing
    small = big[:16]
    before = crc32c.launches
    got = Checksummer("crc32c", CSUM_BLOCK).calculate(small)
    if crc32c.launches != before + 1:
        raise AssertionError("a 16-block card tensor did not launch K2")
    if not np.array_equal(got, ec_native.crc32c_blocks(small.cpu().numpy(),
                                                       CSUM_BLOCK)):
        raise AssertionError("Checksummer on a card tensor differs from host")
    log(f"phase 2: K2 equal to its plain version in {k2_checks} cases "
        f"(4096 blocks x bs 512/4096/65536, seeds -1/0/{rand_seed:#x}; "
        f"4 KiB blocks at B = {', '.join(map(str, K2_BLOCKS))}; bs 4100 "
        f"and a base 4 bytes past a 16-byte boundary; B = 0), "
        f"max_abs_err {k2_err} (tolerance 0); 2^16 x 4 KiB sample of "
        f"1024 equal to the host native crc; a 16-block card tensor "
        f"checksummed by K2 under default routing; "
        f"{time.perf_counter() - t0:.1f} s")

    # -- phase 3: the main path: ECUtil with the cuda plugin ------------------
    t0 = time.perf_counter()
    code = ErasureCodePluginRegistry.instance().factory(
        "cuda", {"plugin": "cuda", "k": str(K), "m": str(M), "device": str(dev)})
    sinfo = ec_util.StripeInfo(K, K * CHUNK)
    checksummer = Checksummer("crc32c", CSUM_BLOCK, use_device=True,
                              device=dev)
    hinfo = ec_util.HashInfo(K + M)
    rng = np.random.default_rng(7)
    writes = []
    rs_codec.launches = 0
    crc32c.launches = 0
    for w in range(8):
        data = rng.integers(0, 256, 4 * sinfo.stripe_width,
                            dtype=np.uint8).tobytes()       # 4 stripes, 32 MiB
        shards = {i: bytes(v) for i, v in ec_util.encode(sinfo, code, data).items()}
        csums = {i: checksummer.calculate(shards[i]) for i in shards}
        hinfo.append(w * 4 * CHUNK, shards)
        writes.append((data, shards, csums))
    patterns = ((0, 1, 2), (4, 8, 10), (7, 9, 10))
    for data, shards, csums in writes:
        for pattern in patterns:
            have = {i: b for i, b in shards.items() if i not in pattern}
            if ec_util.decode_concat(sinfo, code, have) != data:
                raise AssertionError(f"decode_concat {pattern} lost bytes")
            rebuilt = ec_util.decode_shards(sinfo, code, have, pattern)
            for i in pattern:
                if rebuilt[i] != shards[i]:
                    raise AssertionError(f"decode_shards {pattern}: shard {i}")
                if not np.array_equal(checksummer.calculate(rebuilt[i]), csums[i]):
                    raise AssertionError(f"rebuilt shard {i} checksums differ")
    torch.cuda.synchronize()
    main_launches = {"gf_bitmatrix": rs_codec.launches,
                     "crc32c_blocks": crc32c.launches}
    path_s = time.perf_counter() - t0
    # what came out, held against the host codec and the host crc
    host_cs = Checksummer("crc32c", CSUM_BLOCK, use_device=False)
    for data, shards, csums in writes:
        stripes = np.frombuffer(data, dtype=np.uint8).reshape(4, K, CHUNK)
        for s in range(4):
            want = np.empty((M, CHUNK), dtype=np.uint8)
            ec_native.encode(code.coding_matrix, stripes[s], want)
            for j in range(M):
                got = np.frombuffer(shards[K + j], dtype=np.uint8)[
                    s * CHUNK:(s + 1) * CHUNK]
                if not np.array_equal(got, want[j]):
                    raise AssertionError("parity differs from the host codec")
        for i, buf in shards.items():
            if not np.array_equal(csums[i], host_cs.calculate(buf)):
                raise AssertionError(f"shard {i} checksums differ from host")
    for i in range(K + M):
        whole = b"".join(w[1][i] for w in writes)
        if hinfo.get_chunk_hash(i) != ec_native.crc32c(whole):
            raise AssertionError(f"HashInfo shard {i} differs")
    log(f"phase 3: ECUtil path, plugin cuda k={K} m={M} 1 MiB chunks: 8 "
        f"writes x 4 stripes (32 MiB each) encoded, 11 shard checksums "
        f"each on the card, HashInfo appended; decode_concat and "
        f"decode_shards for erasures {list(patterns)} bit-identical with "
        f"matching checksums; parity and checksums equal to the host codec "
        f"and crc; {path_s:.1f} s; launches in this phase: K1 "
        f"{main_launches['gf_bitmatrix']}, K2 {main_launches['crc32c_blocks']}")
    for kname, n in main_launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched {kname}")
    report["main_path_launches"] = main_launches
    report["main_path_s"] = path_s

    # -- phase 4: the benchmark and the kernels' times -------------------------
    bench = {}

    def run_bench(label, mode, workload, iters, **profile):
        cfg = ec_benchmark.BenchConfig(
            plugin="cuda", workload=workload, size=K * CHUNK,
            iterations=iters, erasures=M, seed=42,
            parameters={"k": str(K), "m": str(M), **profile}, mode=mode,
            batch=BATCH if "batched" in mode else 1, warmup=2,
            device=str(dev))
        res = ec_benchmark.run_bench(cfg)
        bench.setdefault(label, []).append(
            {"seconds": res.seconds, "kib": res.kib, "gb_per_s": res.gb_per_s})
        opts = "".join(f" -P {k}={v}" for k, v in profile.items())
        log(f"phase 4: ec_benchmark -p cuda -w {workload} --mode {mode} "
            f"-s {K * CHUNK} --batch {cfg.batch} -i {iters}{opts}: "
            f"{res.seconds:.6f}\t{res.kib:.0f}  -> {res.gb_per_s:.3f} GB/s")

    run_bench("encode batched", "batched", "encode", 40)
    run_bench("decode batched", "batched", "decode", 40)
    # the host-buffer path without overlap (depth 1) and with the default
    # depth 4, interleaved 1, 4, 4, 1 so that drift in the shared host's
    # speed falls on both
    for depth in (1, 4, 4, 1):
        run_bench(f"encode batched-host depth {depth}", "batched-host",
                  "encode", 10, **{"pipeline-depth": str(depth)})
    run_bench("encode native", "native", "encode", 10)
    run_bench("decode native", "native", "decode", 10)
    report["bench"] = bench

    codec = rs_codec.MatrixCodec.get(gf256.reed_sol_van_matrix(K, M))
    packed, bitm = codec._bitmatrix_for(dev)

    # where the host-buffer path's time goes, one 16-stripe batch, one
    # stage at a time
    host = np.full((BATCH, K, CHUNK), ord("X"), dtype=np.uint8)
    staging = torch.empty(host.shape, dtype=torch.uint8, pin_memory=True)
    copies = []
    for _ in range(5):
        t0 = time.perf_counter()
        np.copyto(staging.numpy(), host)
        copies.append((time.perf_counter() - t0) * 1e3)
    on_card = staging.to(dev)
    parity = codec.apply_batch_device(on_card)
    back = torch.empty(parity.shape, dtype=torch.uint8, pin_memory=True)
    split = {
        "host_copy_ms": statistics.median(copies),
        "h2d_ms": time_ms(
            torch, lambda: on_card.copy_(staging, non_blocking=True), 10),
        "kernel_ms": time_ms(
            torch, lambda: codec.apply_batch_device(on_card), 10),
        "d2h_ms": time_ms(
            torch, lambda: back.copy_(parity, non_blocking=True), 10)}
    for depth in (1, 4):
        runs = bench[f"encode batched-host depth {depth}"]
        split[f"plugin_ms_depth{depth}"] = statistics.mean(
            r["seconds"] for r in runs) / 10 * 1e3
    report["host_path_split"] = split
    log(f"phase 4: batched-host split per {BATCH}x{K}x1MiB batch: host copy "
        f"into pinned staging {split['host_copy_ms']:.3f} ms, H2D "
        f"{split['h2d_ms']:.3f} ms ({host.nbytes / split['h2d_ms'] / 1e6:.1f} "
        f"GB/s), K1 {split['kernel_ms']:.3f} ms, D2H {split['d2h_ms']:.3f} ms "
        f"({parity.numel() / split['d2h_ms'] / 1e6:.1f} GB/s); the plugin "
        f"call took {split['plugin_ms_depth1']:.3f} ms at pipeline depth 1, "
        f"{split['plugin_ms_depth4']:.3f} ms at depth 4 (mean of 2 x 10 "
        f"calls each)")
    del host, staging, on_card, parity, back
    data = ec_benchmark.device_test_data(BATCH, K, CHUNK, dev)
    k1_ms = time_ms(torch, lambda: codec.apply_batch_device(data), 30)
    k1_iso_ms = time_isolated_ms(
        torch, lambda: codec.apply_batch_device(data), 30)
    k1_plain_ms = time_ms(
        torch, lambda: rs_codec.apply_bitmatrix_plain(bitm, data), 3, 1)
    k1_bytes = BATCH * (K + M) * CHUNK
    k1_bound, k1_by = bound_ms(
        k1_bytes, 2 * (8 * M) * (8 * K) * CHUNK * BATCH, rates)
    del data
    blocks = rand_bytes(CRC_BATCH, CSUM_BLOCK)
    k2_shapes = []
    for nb in K2_TIMED:
        x = blocks[:nb]
        nbytes = nb * CSUM_BLOCK + 8 * nb
        bound, by = bound_ms(nbytes, 2 * (8 * CSUM_BLOCK) * 32 * nb, rates)
        ms = time_ms(torch, lambda: crc_full.blocks(x), 30)
        iso = time_isolated_ms(torch, lambda: crc_full.blocks(x), 30)
        dev_ms = profiled_ms(torch, lambda: crc_full.blocks(x),
                             "crc32c_blocks_kernel")
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        for _ in range(200):
            crc_full.blocks(x)
        host_us = (time.perf_counter() - h0) / 200 * 1e6
        torch.cuda.synchronize()
        k2_shapes.append({
            "blocks": nb,
            "ms": ms, "isolated_ms": iso, "profiled_ms": dev_ms,
            "host_us_per_call": host_us,
            "bound_ms": bound, "bound_by": by,
            "share_of_bound": bound / ms, "gb_per_s": nbytes / ms / 1e6})
        on_card = ("not measured (no launch in the profiler's trace)"
                   if dev_ms is None else
                   f"{dev_ms:.4f} ms ({bound / dev_ms * 100:.1f}% of the bound)")
        log(f"phase 4: K2 {nb} x 4 KiB: "
            f"{ms:.4f} ms back to back, {iso:.4f} ms alone; bound "
            f"{bound:.4f} ms by {by}, {bound / ms * 100:.1f}% of it back to "
            f"back, {bound / iso * 100:.1f}% alone; {nbytes / ms / 1e6:.1f} "
            f"GB/s; one launch on the card (profiler, mean of 20): "
            f"{on_card}; host time per wrapper call {host_us:.1f} us (200 "
            f"calls queued, host clock)")
    k2_ms, k2_iso_ms = k2_shapes[-1]["ms"], k2_shapes[-1]["isolated_ms"]
    k2_bound, k2_by = k2_shapes[-1]["bound_ms"], k2_shapes[-1]["bound_by"]
    k2_bytes = CRC_BATCH * CSUM_BLOCK + 8 * CRC_BATCH
    words = blocks.view(torch.int64)
    read_ms = time_ms(torch, lambda: words.sum(), 30)
    report["read_yardstick"] = {"bytes": blocks.numel(), "ms": read_ms,
                                "gb_per_s": blocks.numel() / read_ms / 1e6}
    log(f"phase 4: read yardstick: one torch sum over the same "
        f"{blocks.numel() / 2**20:.0f} MiB viewed as int64, {read_ms:.4f} "
        f"ms back to back = {blocks.numel() / read_ms / 1e6:.1f} GB/s "
        f"({blocks.numel() / rates[0] * 1e3 / read_ms * 100:.1f}% of the "
        f"HBM rate; not the same "
        f"function as K2, so not its library_ms)")
    k2_plain_ms = time_ms(
        torch, lambda: crc32c.crc32c_blocks_plain(blocks), 3, 1)
    del words
    # -- phase 5: K3 against its plain version --------------------------------
    t0 = time.perf_counter()
    k3_err, k3_checks = phase_k3(torch, np, dev, rand_bytes)
    log(f"phase 5: K3 (gf_bitmatrix_csum_run) equal to its plain version, "
        f"parity and checksum, in {k3_checks} cases, each launched twice "
        f"back to back (full width {BATCH}x{K}x1MiB with all {M} rows and "
        f"with a recovery matrix; every row slice of the padded matrix at "
        f"shard 2 and 3; N = 1, 4097, 1 MiB + 3 at shard 1 and 2; r = 1, "
        f"2, 4, 5; k = 1, 3, 20; b = 1; a base 1 byte past alignment; an "
        f"all-zero slice, checksum 0), max_abs_err {k3_err} (tolerance 0), "
        f"{time.perf_counter() - t0:.1f} s")

    # -- phase 6: the mesh path ------------------------------------------------
    t0 = time.perf_counter()
    rs_codec.encode_local_launches = 0
    layouts = phase_mesh(torch, np, dev, rand_bytes)
    torch.cuda.synchronize()
    mesh_launches = rs_codec.encode_local_launches
    log(f"phase 6: mesh layouts {layouts}, K3 launches {mesh_launches}, "
        f"{time.perf_counter() - t0:.1f} s")
    if mesh_launches <= 0:
        raise AssertionError("the mesh path never launched K3")
    report["mesh_launches"] = mesh_launches

    # -- phase 7: the offload service (the slice's main path) ------------------
    passes = [
        ("default settings", [dev], {}),
        ("max_batch_bytes 128 MiB, crc_device on", [dev],
         {"max_batch_bytes": BATCH * K * CHUNK, "crc_device": True}),
        ("slots [cuda:0, cuda:0], device_shard_bytes 64 MiB, "
         "max_batch_bytes 128 MiB, crc_device on", [dev, dev],
         {"max_batch_bytes": BATCH * K * CHUNK, "crc_device": True,
          "device_shard_bytes": BATCH * K * CHUNK // 2}),
    ]
    service = {}
    for label, devices, settings in passes:
        res = phase_service(torch, np, devices, **settings)
        service[label] = res
        st = res["stats"]
        log(f"phase 7: service, {label}: {st['jobs']} jobs in "
            f"{st['batches']} batches ({st['coalesced_ops']} coalesced, "
            f"{st['mesh_batches']} through the mesh, fallback_ops "
            f"{st['fallback_ops']}, breaker_trips {st['breaker_trips']}), "
            f"batches and executor seconds (staged copy in, kernel, copy "
            f"back) by slot {res['devices']}; {res['wall_s'] * 1e3:.1f} ms "
            f"for {res['bytes'] / 2**20:.0f} MiB in: "
            f"{res['ms_per_batch']:.3f} ms per batch, "
            f"{res['gb_per_s']:.3f} GB/s (host clock); launches "
            f"{res['launches']}; results byte-equal to the synchronous path")
    need = [("default settings", "gf_bitmatrix"),
            ("max_batch_bytes 128 MiB, crc_device on", "gf_bitmatrix"),
            ("max_batch_bytes 128 MiB, crc_device on", "crc32c_blocks")]
    last = passes[-1][0]
    need.append((last, "gf_bitmatrix_csum"))
    for label, kname in need:
        if service[label]["launches"][kname] <= 0:
            raise AssertionError(f"service pass {label!r} never launched "
                                 f"{kname}")
    if service[last]["stats"]["mesh_batches"] < 1:
        raise AssertionError("no service batch went through the mesh")
    report["service"] = service
    split = service_split(torch, np, dev)
    report["service_split"] = split
    log(f"phase 7: one staged device call of an 8 MiB encode batch, pieces "
        f"timed alone (median of 10, host clock): stacking copy into the "
        f"pinned page {split['stack_ms']:.3f} ms, a fresh pinned result "
        f"buffer {split['pinned_result_alloc_ms']:.3f} ms, upload + K1 + "
        f"download into pageable memory {split['h2d_k1_d2h_pageable_ms']:.3f}"
        f" ms, the whole staged call (_run_on_slot) "
        f"{split['staged_call_ms']:.3f} ms")
    svc_launches = {kname: sum(r["launches"][kname]
                               for r in service.values())
                    for kname in ("gf_bitmatrix", "crc32c_blocks",
                                  "gf_bitmatrix_csum")}

    # -- phase 8: K3's time --------------------------------------------------
    from ceph_tpu_torch.parallel.mesh import shard_operands
    coding = gf256.reed_sol_van_matrix(K, M)
    k3_shapes = []
    # the 1x1 mesh's call, and the 2x2 mesh's per-device call: half the
    # stripes, one of two shard columns (rows 0-1 of the padded 4)
    for b, n_shard in ((BATCH, 1), (BATCH // 2, 2)):
        data = ec_benchmark.device_test_data(b, K, CHUNK, dev)
        packed, bitm = shard_operands(coding, n_shard, dev)[0]
        r = packed.shape[0]

        def call():
            return rs_codec.encode_local(packed, bitm, data)
        ms = time_ms(torch, call, 30)
        iso = time_isolated_ms(torch, call, 30)
        dev_ms = profiled_ms(torch, call, "gf_bitmatrix_csum_kernel")
        per_call, names = device_ops_per_call(torch, call)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        for _ in range(200):
            call()
        host_us = (time.perf_counter() - h0) / 200 * 1e6
        torch.cuda.synchronize()
        if per_call != 1:
            raise AssertionError(f"one encode_local call ran {per_call} "
                                 f"device operations: {names}")
        nbytes = b * (K + r) * CHUNK + 8
        bound, by = bound_ms(nbytes, 2 * (8 * r) * (8 * K) * CHUNK * b, rates)
        k3_shapes.append({
            "shape": f"({b},{K},{CHUNK}) -> ({b},{r},{CHUNK})",
            "ms": ms, "isolated_ms": iso, "profiled_ms": dev_ms,
            "device_ops_per_call": per_call, "host_us_per_call": host_us,
            "bound_ms": bound,
            "bound_by": by, "share_of_bound": bound / ms,
            "gb_per_s": nbytes / ms / 1e6})
        on_card = ("not measured (no launch in the profiler's trace)"
                   if dev_ms is None else
                   f"{dev_ms:.4f} ms ({bound / dev_ms * 100:.1f}% of the "
                   f"bound)")
        log(f"phase 8: K3 {k3_shapes[-1]['shape']}: {ms:.4f} ms back to "
            f"back through the wrapper ({bound / ms * 100:.1f}% of the "
            f"{bound:.4f} ms bound by {by}), {iso:.4f} ms alone; one launch "
            f"on the card (profiler, mean of 20): {on_card}; device "
            f"operations per call {per_call:g} ({', '.join(names)}); host "
            f"time per wrapper call {host_us:.1f} us (200 calls queued, "
            f"host clock)")
        del data
    k3_ms, k3_iso_ms = k3_shapes[0]["ms"], k3_shapes[0]["isolated_ms"]
    k3_bound, k3_by = k3_shapes[0]["bound_ms"], k3_shapes[0]["bound_by"]
    k3_bytes = BATCH * (K + M) * CHUNK + 8
    data = ec_benchmark.device_test_data(BATCH, K, CHUNK, dev)
    k3_packed, k3_bitm = shard_operands(coding, 1, dev)[0]
    k3_plain_ms = time_ms(
        torch, lambda: rs_codec.encode_local_plain(k3_bitm, data), 3, 1)
    del data

    # -- phase 9: every plugin on the card ----------------------------------
    t0 = time.perf_counter()
    # each plugin runs in a trace of the card: phase 10 reads the idle
    # shares (the profiler adds a few percent of host time)
    plugin_windows: dict = {}

    def plugin_window(pname):
        plugin_windows[pname] = DeviceWindow(torch)
        return plugin_windows[pname]
    plugins = phase_plugins(torch, np, dev, window=plugin_window)
    corpus = plugins["corpus"]
    log(f"phase 9: ec_non_regression check_all over {corpus['entries']} "
        f"corpus entries with device={dev}: every archived chunk "
        f"byte-equal, K1 launches {corpus['launches']['gf_bitmatrix']}, "
        f"{corpus['seconds']:.1f} s")
    if corpus["launches"]["gf_bitmatrix"] <= 0:
        raise AssertionError("the corpus check never launched K1")
    for pname, _ in PLUGINS:
        res = plugins[pname]
        prof = ",".join(f"{k}={v}" for k, v in res["profile"].items())
        extra = ""
        if res["repair"]:
            rp = res["repair"]
            extra = (f"; MSR repair of chunk {rp['lost']} from {rp['helpers']}"
                     f" helpers read {rp['read_bytes']} bytes "
                     f"({rp['read_share_of_chunk']:.4f} of each chunk), "
                     f"bytes equal, and ECUtil's fragment rebuild of the "
                     f"whole shard equal")
        log(f"phase 9: {pname} {prof}, {res['chunk']}-byte chunks, "
            f"{res['stripes']} stripes through ECUtil on {dev}: shards "
            f"equal to device=cpu, K2 checksums equal to the host crc, "
            f"decode_concat and decode_shards of the object bit-identical "
            f"under {len(res['patterns'])} patterns {res['patterns']}, "
            f"scalar encode and decode of one stripe equal{extra}; "
            f"{res['seconds']:.2f} s; launches "
            f"{res['launches']}")
        k1 = res["launches"]["gf_bitmatrix"]
        if (pname == "jerasure") != (k1 == 0):
            raise AssertionError(
                f"{pname}: K1 launched {k1} times; the bitmatrix technique "
                f"must launch none (its codec runs on the host), every "
                f"other plugin some")
        if res["launches"]["crc32c_blocks"] <= 0:
            raise AssertionError(f"{pname}: the shards' checksums never "
                                 f"launched K2")
    report["plugins"] = plugins
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")

    # -- phase 9b: the plugins' scalar timings -------------------------------
    t0 = time.perf_counter()
    pbench = phase_plugin_bench(torch, np, dev, rates)
    for label, res in pbench["bench"].items():
        pname, workload = label.split()
        log(f"phase 9b: ec_benchmark -p {pname} -w {workload} --mode scalar "
            f"-s {int(dict(PLUGINS)[pname]['k']) * CHUNK} -i 4 (1 MiB "
            f"chunks): {res['seconds']:.6f}\t{res['kib']:.0f} -> "
            f"{res['gb_per_s']:.3f} GB/s on {smi}")
    cb = pbench["clay_batch"]
    on_card = ("not measured (no launch in the profiler's trace)"
               if cb["profiled_ms"] is None else
               f"{cb['profiled_ms']:.4f} ms "
               f"({cb['bound_ms'] / cb['profiled_ms'] * 100:.1f}% of the "
               f"bound)")
    log(f"phase 9b: K1 at clay's largest plane batch {cb['shape']}: "
        f"{cb['ms']:.4f} ms back to back ({cb['bound_ms'] / cb['ms'] * 100:.1f}"
        f"% of the {cb['bound_ms']:.5f} ms bound by {cb['bound_by']}); one "
        f"launch on the card (profiler, mean of 20): {on_card}; clay's "
        f"host apply (upload, K1, download) {cb['host_apply_ms']:.3f} ms "
        f"(median of 10, host clock); {time.perf_counter() - t0:.1f} s")
    report["plugin_bench"] = pbench

    # -- phase 10: the traced device path -------------------------------------
    t0 = time.perf_counter()
    obs = phase_traced(torch, np, dev)
    log_traced(obs)
    obs["plugins_idle"] = plugins_idle(plugin_windows)
    report["traced"] = obs
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")

    # -- phase 11: the port's bench_driver ------------------------------------
    t0 = time.perf_counter()
    report["bench_driver"] = phase_bench_driver(
        dev, report["read_yardstick"]["gb_per_s"])
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")

    # -- phase 12: the sharded service on the card ---------------------------
    # last, so that no earlier number is taken while a multi-shard pool
    # holds the GIL switch interval at 0.5 ms
    t0 = time.perf_counter()
    rx = phase_reactor(torch, np, dev)
    log_reactor(rx, smi)
    for kname in ("gf_bitmatrix", "crc32c_blocks"):
        if rx["launches"][kname] <= 0:
            raise AssertionError(f"the reactor path never launched {kname}")
    report["reactor"] = rx
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")

    # -- phase 13: an EC object through placement, the wire and the stores --
    t0 = time.perf_counter()
    st = phase_store_path(torch, np, dev, smi, rates)
    log_store_path(st, smi)
    if st["launches"]["gf_bitmatrix"] <= 0:
        raise AssertionError("the store path never launched gf_bitmatrix")
    report["store_path"] = st
    log(f"phase 13: {time.perf_counter() - t0:.1f} s")

    # -- phase 14: an EC pool on a booted cluster ------------------------------
    t0 = time.perf_counter()
    cl = phase_cluster(torch, np, dev, smi)
    log_cluster(cl, smi)
    for kname in ("gf_bitmatrix", "crc32c_blocks"):
        if cl["launches"][kname] <= 0:
            raise AssertionError(f"the cluster never launched {kname}")
    report["cluster"] = cl
    log(f"phase 14: {time.perf_counter() - t0:.1f} s")

    # -- phase 15: the pool's OSDs in worker processes, the mgr, the stages --
    t0 = time.perf_counter()
    pr = phase_procs(torch, np, dev, smi)
    report["procs"] = pr
    log(f"phase 15 [{smi}]: launches summed over every process of 15a and "
        f"15d's degraded reads: {pr['launches']}; {time.perf_counter() - t0:.1f}"
        f" s")

    # -- phase 16: the access layers with their data in EC pools ---------------
    t0 = time.perf_counter()
    ac = phase_access(torch, np, dev, smi)
    log_access(ac, smi)
    report["access"] = ac
    ac["phase_s"] = time.perf_counter() - t0
    log(f"phase 16 [{smi}]: {ac['phase_s']:.1f} s (16g "
        f"{ac['g']['wall_s']:.1f} s)")

    # -- phase 17: the failure storm and the interleave sweep ----------------
    t0 = time.perf_counter()
    sr = phase_storm("cuda")
    log_storm(sr, smi)
    report["stages17"] = sr
    sr["phase_s"] = time.perf_counter() - t0
    log(f"phase 17 [{smi}]: {sr['phase_s']:.1f} s")

    # -- phase 18: the client fleet, the scrub storm and the swarm ------------
    t0 = time.perf_counter()
    fr = phase_swarm("cuda")
    log_swarm(fr, smi)
    report["stages18"] = fr
    fr["phase_s"] = time.perf_counter() - t0
    log(f"phase 18 [{smi}]: {fr['phase_s']:.1f} s")

    # -- phase 19: the QoS storm ----------------------------------------------
    t0 = time.perf_counter()
    qr = phase_qos("cuda")
    log_qos(qr, smi)
    report["stages19"] = qr
    qr["phase_s"] = time.perf_counter() - t0
    log(f"phase 19 [{smi}]: {qr['phase_s']:.1f} s")
    # K2 and K3 read 0 on the QoS storm's path: it leaves the device crc
    # off (shard csums on the host crc, as the reference's stage does),
    # and no batch of its 16 KiB objects reaches device_shard_bytes
    storm_launches = {kname: {"failure_storm": sr["a"]["launches"][kname],
                              "interleave": sr["b"]["launches"][kname],
                              "scrub_storm": fr["a"]["launches"][kname],
                              "swarm": fr["b"]["launches"][kname],
                              "qos_storm": qr["launches"][kname]}
                      for kname in ("gf_bitmatrix", "crc32c_blocks",
                                    "gf_bitmatrix_csum")}
    plugin_launches = {kname: sum(plugins[pname]["launches"][kname]
                                  for pname, _ in PLUGINS)
                       for kname in ("gf_bitmatrix", "crc32c_blocks")}
    plugin_launches["gf_bitmatrix"] += corpus["launches"]["gf_bitmatrix"]

    kernels = [
        {"name": "gf_bitmatrix", "route": "cuda",
         "source": "ceph_tpu_torch/ops/csrc/gf_bitmatrix.cu",
         "replaces": "ceph_tpu/ops/rs_codec.py:74",
         "also_replaces": "ceph_tpu/ops/rs_codec.py:55",
         "shape": f"({BATCH},{K},{CHUNK}) -> ({BATCH},{M},{CHUNK}) uint8",
         "matched": k1_err == 0,
         "launches": svc_launches["gf_bitmatrix"]
         + plugin_launches["gf_bitmatrix"] + rx["launches"]["gf_bitmatrix"]
         + st["launches"]["gf_bitmatrix"] + cl["launches"]["gf_bitmatrix"]
         + pr["launches"]["gf_bitmatrix"] + ac["launches"]["gf_bitmatrix"]
         + sum(storm_launches["gf_bitmatrix"].values()),
         "launches_by_path": {"service": svc_launches["gf_bitmatrix"],
                              "plugins": plugin_launches["gf_bitmatrix"],
                              "reactor": rx["launches"]["gf_bitmatrix"],
                              "store_path": st["launches"]["gf_bitmatrix"],
                              "cluster": cl["launches"]["gf_bitmatrix"],
                              "procs": pr["launches"]["gf_bitmatrix"],
                              "access": ac["launches"]["gf_bitmatrix"],
                              **storm_launches["gf_bitmatrix"]},
         "max_abs_err": k1_err, "tolerance": 0, "ms": k1_ms, "kernel_ms": k1_ms,
         "isolated_ms": k1_iso_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None, "shapes": [{**cb, "path": "clay plane batch"}]},
        {"name": "crc32c_blocks", "route": "cuda",
         "source": "ceph_tpu_torch/ops/csrc/crc32c_blocks.cu",
         "replaces": "ceph_tpu/ops/crc32c.py:95",
         "shape": f"({CRC_BATCH},{CSUM_BLOCK}) uint8 -> ({CRC_BATCH},) crc",
         "matched": k2_err == 0,
         "launches": svc_launches["crc32c_blocks"]
         + plugin_launches["crc32c_blocks"] + rx["launches"]["crc32c_blocks"]
         + st["launches"]["crc32c_blocks"] + cl["launches"]["crc32c_blocks"]
         + pr["launches"]["crc32c_blocks"] + ac["launches"]["crc32c_blocks"]
         + sum(storm_launches["crc32c_blocks"].values()),
         "launches_by_path": {"service": svc_launches["crc32c_blocks"],
                              "plugins": plugin_launches["crc32c_blocks"],
                              "reactor": rx["launches"]["crc32c_blocks"],
                              "store_path": st["launches"]["crc32c_blocks"],
                              "cluster": cl["launches"]["crc32c_blocks"],
                              "procs": pr["launches"]["crc32c_blocks"],
                              "access": ac["launches"]["crc32c_blocks"],
                              **storm_launches["crc32c_blocks"]},
         "store_path_compare": st["k2_compare"],
         "max_abs_err": k2_err, "tolerance": 0, "ms": k2_ms, "kernel_ms": k2_ms,
         "isolated_ms": k2_iso_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": None, "shapes": k2_shapes},
        {"name": "gf_bitmatrix_csum", "route": "cuda",
         "source": "ceph_tpu_torch/ops/csrc/gf_bitmatrix_csum.cu",
         "replaces": "ceph_tpu/parallel/mesh.py:54",
         "also_replaces": "ceph_tpu/parallel/mesh.py:96",
         "shape": f"({BATCH},{K},{CHUNK}) -> ({BATCH},{M},{CHUNK}) uint8 "
                  f"+ int64 checksum",
         "matched": k3_err == 0,
         "launches": svc_launches["gf_bitmatrix_csum"]
         + rx["launches"]["gf_bitmatrix_csum"]
         + cl["launches"]["gf_bitmatrix_csum"]
         + pr["launches"]["gf_bitmatrix_csum"]
         + ac["launches"]["gf_bitmatrix_csum"]
         + sum(storm_launches["gf_bitmatrix_csum"].values()),
         "launches_by_path": {
             "service": svc_launches["gf_bitmatrix_csum"],
             "reactor": rx["launches"]["gf_bitmatrix_csum"],
             "cluster": cl["launches"]["gf_bitmatrix_csum"],
             "procs": pr["launches"]["gf_bitmatrix_csum"],
             "access": ac["launches"]["gf_bitmatrix_csum"],
             **storm_launches["gf_bitmatrix_csum"]},
         "max_abs_err": k3_err, "tolerance": 0, "ms": k3_ms, "kernel_ms": k3_ms,
         "isolated_ms": k3_iso_ms,
         "plain_ms": k3_plain_ms, "bound_ms": k3_bound, "bound_by": k3_by,
         "library_ms": None, "shapes": k3_shapes},
    ]
    for kr, nbytes in zip(kernels, (k1_bytes, k2_bytes, k3_bytes)):
        kr["share_of_bound"] = kr["bound_ms"] / kr["ms"]
        log(f"phase 4/8: {kr['name']} {kr['shape']}: kernel {kr['ms']:.4f} ms "
            f"back to back ({nbytes / kr['ms'] / 1e6:.1f} GB/s; one launch "
            f"alone on an idle stream {kr['isolated_ms']:.4f} ms), bound {kr['bound_ms']:.4f} "
            f"ms by {kr['bound_by']} ({kr['bound_ms'] / kr['ms'] * 100:.1f}% "
            f"of it), plain {kr['plain_ms']:.3f} ms, launches on the main "
            f"paths (phases 7, 9, 12-19) {kr['launches']}; no single "
            f"PyTorch call "
            f"computes this function, so library_ms is null")
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_start
    log(f"total {report['total_s']:.1f} s on {smi}")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
