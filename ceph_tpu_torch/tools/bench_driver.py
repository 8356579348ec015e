"""Measurement stages of the port's benchmark, one JSON line each.

The device stages of ceph_tpu/tools/bench_driver.py on PyTorch:

    python -m ceph_tpu_torch.tools.bench_driver --stage X [--device D]

Stages:

  cpu           host baselines, on the host whatever --device says:
                  cpu_native_encode   the repo's C++ codec (isa stand-in)
                  cpu_native_decode   same kernel, 3-erasure recovery
                  cpu_numpy_encode    the numpy GF(2^8) matrix apply
                  cpu_crc32c          the C++ crc32c over 4 KiB blocks
                  msgr_frames_per_s_native / _python and
                      msgr_frame_native_speedup  whole-frame encode +
                      decode round trips, native codec vs Python
                  msgr_saturated_frames_per_write / _msgs_per_s  a
                      saturated messenger pair's per-peer batching
  probe         the device and nothing else: platform, device_count,
                init_s.
  device        the device benches:
                  tpu_encode / tpu_decode  batched device-resident
                      encode_stripes / decode_stripes, plugin `cuda`
                  device_peak_gbps  an out-of-place x + 1.0 over a
                      float32 buffer (read + write), median of 10;
                      tpu_encode_roofline_pct is tpu_encode against it
                  tpu_crc32c        K2 over 4 KiB blocks on the device
                  link_h2d_gbps / link_h2d_cold_gbps  host-to-device
                      copies out of one reused pinned staging buffer (as
                      the offload service stages) / out of a fresh one
                  tpu_encode_host   batched encode from host buffers
                      (transfers included); host_encode_link_efficiency
                      is it over link_h2d_gbps
                  scalar_encode     per-stripe plugin-contract encode()
  mesh_scaling  the sharded stripe encode (the service's oversized-batch
                path) over meshes of 1, 2 and 4 slots of one device,
                plus bit-identity of the widest against one slot.
  cluster       the `rados bench` analog: a replicated pool and a
                jerasure k=2 m=2 pool (on --device) of 4 OSDs, 8 writers
                then 8 readers of 256 KiB objects for 4 s each
                (cluster_rep_* / cluster_ec_* MB/s and p99 ms), then a
                fresh vstart cluster of 3 OSDs with a mgr, an MDS and a
                gateway whose report fan-in is read back (`health`: the
                mon's status and checks, the report ages, the daemons
                that /metrics labels).
  cluster_tpu   an EC pool (plugin cuda k=8 m=3 on --device) in a booted
                cluster of 11 OSDs: inline vs offloaded one-stripe
                writes (cluster_ec_tpu_*), the messenger's frames per
                write, the EC data path alone, the PG pipeline depth
                sweep, the thread-shard curve (CEPH_TPU_REACTOR_SHARDS
                caps it), the process curve with the OSDs in worker
                processes that each open the device
                (CEPH_TPU_REACTOR_PROCS caps it) and the mesh curve.
  attribution   the write waterfall (queue wait, copy, h2d, kernel, d2h,
                commit) of an EC pool on 2 thread shards from the
                tracer's spans, the copy amplification, the loops' busy
                shares, the per-device busy share and skew, and the
                tracing overhead A/B.
  failure_storm 11 OSDs with a clay k=8 m=3 d=10 pool (its jerasure MDS
                code on --device): three OSDs killed under mixed load
                and revived (time to clean, recovery MB/s, p99 during
                backfill, degraded reads), one OSD's shards rebuilt
                through clay's sub-chunk plan (the repair ratio, 10/3
                helper fragments against 8 chunks), the flight-recorder
                drill (6 OSDs over 2 worker processes: one SIGKILLed, a
                device fault tripping a survivor's breaker, a causal
                timeline across processes) and the deadlock drill
                (crossed scrub reservations found, raised and cleared).
  interleave    the schedule explorer's seed sweep over an EC pool of
                plugin cuda k=2 m=1 on --device (the reference's is
                jerasure, whose cluster path runs the host codec and
                never the card): bare, with the sanitizer armed,
                and with the flight recorder and a mgr (seeds,
                schedules, both overheads).
  swarm         200 librados clients (tools/rados_swarm.py: mixed sizes,
                zipfian hot keys, 16 slow readers) for 6 s against a
                vstart cluster of 4 OSDs and a mgr, pool plugin cuda k=2
                m=1 on --device (the reference's is jerasure): MB/s,
                IOPS, client p99 spread and fairness, errors, the OSDs'
                per-client tables, SLO_VIOLATIONS fired and muted, the
                exporter's ceph_client_* families and series cap, the
                mgr history's op-rate curves.
  scrub_storm   11 OSDs and a mgr with a clay k=8 m=3 d=10 pool (its MDS
                code cuda on --device): a deep-scrub round hashed on the
                host, one with the device crc on (K2), a paced fleet of
                200 clients over 2 worker processes with scrub off and
                then churning over 12 bit-rotted objects (found,
                repaired, read back), and 3 more rotted objects raising
                and clearing PG_DAMAGED and OSD_SCRUB_ERRORS.
  qos_storm     the dmclock scheduler under 1000 clients over 3 worker
                processes (24 bullies, 24 streamers, 24 spammers, 64
                paced victims, the rest paced) on a vstart cluster of 4
                OSDs and a mgr, pool plugin cuda k=2 m=2 on --device (the
                reference's is jerasure): a polite baseline, the storm
                with the scheduler off, on with per-tenant profiles while
                an OSD is killed and revived under 200 degraded writes,
                and under the shed policy at queue depth 8 (fairness,
                victim p99 and its SLO, goodput, recovery pushes, sheds,
                client-visible throttles, the mgr's tenants and the
                exporter's ceph_qos_* families).

The north-star geometry throughout: k=8, m=3, 1 MiB chunks, 16 stripes
a batch (reference `ceph_erasure_code_benchmark -P k=8 -P m=3 -s 8M`;
GB/s = KiB / 2^20 / seconds). On the card the device stage runs at those
shapes; on the CPU (tests, rehearsals) at small ones, as the reference
shrinks off the TPU. Device times are CUDA events on a card and the host
clock on the CPU.

A measurement that fails raises, and `main` exits non-zero naming every
key that read zero (but for the counts, clamped shares, skews and signed
overheads whose zero is a reading, ZERO_IS_A_READING), every flag that
reads False (FLAG_KEYS: bytes that differ across a curve's runs, a
failure-storm drill that did not happen), every `*_error` key (a drill
that raised, recorded as the reference records it) and every count of
wrong results above 0: no stage records 0.0 and carries on. On a device
run `main` also prints, on one stderr line (LAUNCH_LINE), the kernel
launches and host fallbacks of its own process. The reference's
round-over-round trend guard reads its own TPU records and is not
ported.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from ceph_tpu_torch import device as _device

K, M = 8, 3
CHUNK = 1 << 20                    # 1 MiB chunk
SIZE = K * CHUNK                   # 8 MiB stripe buffer
PARAMS = {"k": str(K), "m": str(M)}
SCALING_COUNTS = (1, 2, 4)

#: the device stage's shapes by device type: the card's are the north
#: star's; the CPU's keep a run within seconds
DEVICE_SHAPES = {
    "cuda": {"chunk": CHUNK, "batch": 16, "iters": 40,
             "peak_bytes": 256 << 20, "crc_blocks": 1 << 16,
             "crc_iters": 16, "link_mb": 32, "link_iters": 5,
             "host_iters": 2},
    "cpu": {"chunk": 16 << 10, "batch": 4, "iters": 2,
            "peak_bytes": 8 << 20, "crc_blocks": 1 << 8, "crc_iters": 2,
            "link_mb": 8, "link_iters": 3, "host_iters": 1},
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _bench_into(results: dict, name: str, chunk: int = CHUNK,
                **kw) -> float:
    from ceph_tpu_torch.tools.ec_benchmark import BenchConfig, run_bench
    cfg = BenchConfig(parameters=dict(PARAMS), size=K * chunk,
                      erasures=M, seed=42, **kw)
    r = run_bench(cfg)
    results[name] = round(r.gb_per_s, 4)
    log(f"{name}: {r.gb_per_s:.3f} GB/s ({r.seconds:.3f}s)")
    return r.gb_per_s


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _median_s(fn, reps: int, dev: torch.device) -> float:
    """Median seconds of one call of fn after one untimed call: CUDA
    events around each call on a card, the host clock on the CPU."""
    fn()
    _sync(dev)
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def stage_cpu() -> dict:
    from ceph_tpu_torch.ec import gf256
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.native import ec_native
    from ceph_tpu_torch.tools.ec_benchmark import _time_host_loop
    results: dict[str, float] = {}
    _bench_into(results, "cpu_native_encode", plugin="isa", mode="native",
                workload="encode", iterations=40, warmup=3, device="cpu")
    _bench_into(results, "cpu_native_decode", plugin="isa", mode="native",
                workload="decode", iterations=40, warmup=3, device="cpu")
    coding = factory("isa", {**PARAMS, "device": "cpu"}).coding_matrix
    data = np.full((K, CHUNK), ord("X"), dtype=np.uint8)
    iters = 3
    dt = _time_host_loop(lambda: gf256.mat_vec_apply(coding, data), iters, 1)
    results["cpu_numpy_encode"] = round(iters * SIZE / 1024 / (1 << 20)
                                        / dt, 4)
    log(f"cpu_numpy_encode: {results['cpu_numpy_encode']} GB/s")
    # crc32c host baseline over BlueStore's 4 KiB csum blocks
    nblocks = 1 << 14
    gib = nblocks * 4096 / (1 << 30)
    blocks = np.random.default_rng(0).integers(
        0, 256, (nblocks, 4096), dtype=np.uint8)
    iters = 8
    dt = _time_host_loop(lambda: ec_native.crc32c_blocks(blocks, 4096),
                         iters, 1)
    results["cpu_crc32c"] = round(iters * gib / dt, 4)
    log(f"cpu_crc32c: {results['cpu_crc32c']} GB/s")
    results.update(_msgr_frame_microbench())
    return results


def stage_probe(device: str | None = None) -> dict:
    t0 = time.perf_counter()
    dev = _device.resolve(device)
    torch.zeros(1, device=dev)
    _sync(dev)
    return {"platform": "gpu" if dev.type == "cuda" else "cpu",
            "device_count": torch.cuda.device_count()
            if dev.type == "cuda" else 1,
            # to the microsecond: a CPU already in use answers in tens
            # of microseconds, which four places would read as 0
            "init_s": round(time.perf_counter() - t0, 6)}


def stage_device(device: str | None = None) -> dict:
    from ceph_tpu_torch.ops import crc32c
    from ceph_tpu_torch.tools import ec_benchmark
    t0 = time.perf_counter()
    dev = _device.resolve(device)
    torch.zeros(1, device=dev)
    _sync(dev)
    init_s = round(time.perf_counter() - t0, 6)      # as stage_probe's
    shapes = DEVICE_SHAPES[dev.type]
    log(f"device up: {dev} ({init_s}s)")
    results: dict = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                     "backend_init_s": init_s}
    batched = {"plugin": "cuda", "mode": "batched", "batch": shapes["batch"],
               "iterations": shapes["iters"], "warmup": 2,
               "chunk": shapes["chunk"], "device": str(dev)}
    _bench_into(results, "tpu_encode", workload="encode", **batched)
    _bench_into(results, "tpu_decode", workload="decode", **batched)

    # the memory rate every codec GB/s is judged against: x + 1.0 out of
    # place reads and writes the buffer once (sweep_f)
    nbytes = shapes["peak_bytes"]
    arr = torch.zeros(nbytes // 4, dtype=torch.float32, device=dev)
    t = _median_s(lambda: arr + 1.0, 10, dev)
    peak = round(2 * nbytes / t / 1e9, 2)
    results["device_peak_gbps"] = peak
    results["tpu_encode_roofline_pct"] = round(
        100.0 * results["tpu_encode"] / peak, 4)
    log(f"device_peak: {peak} GB/s (x + 1.0 over {nbytes >> 20} MiB, "
        f"median of 10); tpu_encode at "
        f"{results['tpu_encode_roofline_pct']}% of it")
    del arr

    nblocks = shapes["crc_blocks"]
    gib = nblocks * 4096 / (1 << 30)
    dev_crc = crc32c.get_device_crc(4096, device=dev)
    dev_blocks = ec_benchmark.device_test_data(nblocks, 1, 4096,
                                               dev).reshape(nblocks, 4096)
    iters = shapes["crc_iters"]
    dt = ec_benchmark.time_device_loop(lambda: dev_crc.blocks(dev_blocks),
                                       iters, 2, dev)
    results["tpu_crc32c"] = round(iters * gib / dt, 4)
    log(f"tpu_crc32c: {results['tpu_crc32c']} GB/s ({iters} x {nblocks} "
        f"blocks)")
    del dev_blocks

    # the link: host-to-device copies out of one reused pinned staging
    # buffer (the service's steady state), and out of a fresh buffer into
    # a fresh allocation (first touch and allocator work included)
    mb = shapes["link_mb"]
    pinned = dev.type == "cuda"
    buf = torch.zeros(mb << 20, dtype=torch.uint8, pin_memory=pinned)
    dst = torch.empty(mb << 20, dtype=torch.uint8, device=dev)
    dst[:1024].copy_(buf[:1024])
    _sync(dev)
    t1 = time.perf_counter()
    fresh = torch.ones(mb << 20, dtype=torch.uint8,
                       pin_memory=pinned).to(dev)
    _sync(dev)
    results["link_h2d_cold_gbps"] = round(
        (mb / 1024) / (time.perf_counter() - t1), 4)
    del fresh
    t = _median_s(lambda: dst.copy_(buf, non_blocking=True),
                  shapes["link_iters"], dev)
    results["link_h2d_gbps"] = round((mb / 1024) / t, 4)
    log(f"link_h2d: {results['link_h2d_gbps']} GB/s steady (reused pinned "
        f"buffer, median of {shapes['link_iters']}), "
        f"{results['link_h2d_cold_gbps']} GB/s cold ({mb} MiB)")
    del buf, dst

    _bench_into(results, "tpu_encode_host", plugin="cuda",
                mode="batched-host", workload="encode",
                batch=shapes["batch"], iterations=shapes["host_iters"],
                warmup=1, chunk=shapes["chunk"], device=str(dev))
    results["host_encode_link_efficiency"] = round(
        results["tpu_encode_host"] / results["link_h2d_gbps"], 4)
    _bench_into(results, "scalar_encode", plugin="cuda", mode="scalar",
                workload="encode", iterations=2, warmup=1,
                chunk=shapes["chunk"], device=str(dev))
    results["elapsed_s"] = round(time.perf_counter() - t0, 2)
    return results


def _mesh_scaling_body(device: str | None = None,
                       chunk: int = 1 << 16) -> dict:
    """The SAME fixed batch through the sharded stripe encode over
    stripe-only meshes of 1, 2 and 4 slots of one device (the offload
    service's serving mesh, named the device several times), median of
    3 host-clock calls each (host buffers in and out, as the service
    calls it), plus bit-identity of the widest against one slot. The
    slots share one card, so the ideal parallelism is 1 and
    scaling_efficiency is the widest mesh's GB/s over one slot's."""
    from ceph_tpu_torch.ec import gf256
    from ceph_tpu_torch.parallel import mesh as mesh_lib
    dev = _device.resolve(device)
    B = max(8, SCALING_COUNTS[-1])           # fixed total work
    data = np.random.default_rng(7).integers(0, 256, (B, K, chunk),
                                             dtype=np.uint8)
    coding = gf256.reed_sol_van_matrix(K, M)
    curve: dict[str, float] = {}
    outputs: dict[int, np.ndarray] = {}
    for n in SCALING_COUNTS:
        mesh = mesh_lib.make_mesh(devices=[dev] * n, stripe=n, shard_max=1)
        fn = mesh_lib.sharded_apply_fn(mesh, coding)
        outputs[n] = fn(data)                        # warm
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn(data)
            times.append(time.perf_counter() - t0)
        curve[str(n)] = round(B * K * chunk / statistics.median(times)
                              / 1e9, 4)
        log(f"mesh_scaling: {n} slot(s) {mesh.shape} -> {curve[str(n)]} "
            f"GB/s")
    n_max = SCALING_COUNTS[-1]
    g1, gn = curve[str(SCALING_COUNTS[0])], curve[str(n_max)]
    out = {
        "device_scaling_gb_s": curve,
        "scaling_devices": n_max,
        "scaling_platform": "gpu" if dev.type == "cuda" else "cpu",
        "scaling_virtual_devices": True,
        "scaling_ideal_parallelism": 1,
        "scaling_bit_identical": bool(np.array_equal(
            outputs[n_max], outputs[SCALING_COUNTS[0]])),
        "scaling_efficiency_raw": round(gn / (n_max * g1), 4),
        "scaling_efficiency": round(gn / g1, 4),
    }
    log(f"mesh_scaling: efficiency {out['scaling_efficiency']} (raw "
        f"{out['scaling_efficiency_raw']} over {n_max} slots of {dev}), "
        f"bit_identical={out['scaling_bit_identical']}")
    return out


# -- attribution: where an op's time goes --------------------------------------

#: waterfall buckets in pipeline order; "other" is the residual the
#: instruments cannot yet name (python messaging, scheduling)
ATTRIBUTION_BUCKETS = ("queue_wait", "copy", "h2d", "kernel", "d2h",
                       "commit", "other")


def attribution_from_spans(spans: list[dict]) -> dict:
    """Decompose EC write latency into the waterfall buckets from span
    data (the tracer's spans with their copy/h2d/kernel/d2h tags).
    Aggregation is per trace: only traces carrying an `osd_op` root
    contribute, `op_total` is shard-queue wait + osd_op execution wall
    (the osd_op span opens AFTER dequeue, so its queue_wait_us tag is
    time the span does not cover), and a trace's commit bucket is its
    SLOWEST store_commit (parallel shard commits gate the op on the max,
    not the sum). Shared offload batches land in one member trace's
    waterfall; aggregated over the run the totals amortize correctly.
    Returns per-op mean µs per bucket plus percentages; buckets (with
    the explicit `other` residual) sum to op_total by construction
    unless shared-batch overcounting pushes them past it —
    `attributed_fraction` records how much of op_total the named buckets
    explain."""
    by_trace: dict[str, list[dict]] = {}
    for s in spans:
        by_trace.setdefault(s["trace_id"], []).append(s)
    n_ops = 0
    total_us = 0.0
    buckets = dict.fromkeys(ATTRIBUTION_BUCKETS, 0.0)
    for ss in by_trace.values():
        roots = [s for s in ss if s["name"] == "osd_op"]
        if not roots:
            continue                    # orphan batch/flush trace
        n_ops += len(roots)
        total_us += sum(
            s["duration_us"]
            + float((s.get("tags") or {}).get("queue_wait_us") or 0.0)
            for s in roots)
        for s in ss:
            tags = s.get("tags") or {}
            name = s["name"]
            if name == "osd_op":
                buckets["queue_wait"] += float(
                    tags.get("queue_wait_us") or 0.0)
            elif name == "offload_queue_wait":
                buckets["queue_wait"] += s["duration_us"]
            elif name in ("ec_encode", "ec_decode", "offload_batch"):
                buckets["copy"] += float(tags.get("copy_us") or 0.0)
            # offload_batch carries the h2d/kernel/d2h splits when the
            # service staged the dispatch itself (the plugin then gets a
            # device tensor and its span has no timing tags), so the two
            # sources never double-count
            if name in ("tpu_encode_dispatch", "tpu_decode_dispatch",
                        "offload_batch"):
                buckets["h2d"] += float(tags.get("h2d_us") or 0.0)
                buckets["kernel"] += float(tags.get("kernel_us") or 0.0)
                buckets["d2h"] += float(tags.get("d2h_us") or 0.0)
        commits = [s["duration_us"] for s in ss
                   if s["name"] == "store_commit"]
        if commits:
            buckets["commit"] += max(commits)
    known = sum(v for b, v in buckets.items() if b != "other")
    buckets["other"] = max(0.0, total_us - known)
    return {
        "ops": n_ops,
        "op_total_us": round(total_us / n_ops, 1) if n_ops else 0.0,
        "buckets_us": {b: round(v / n_ops, 1) if n_ops else 0.0
                       for b, v in buckets.items()},
        "bucket_pct": {b: round(100.0 * v / total_us, 1) if total_us
                       else 0.0 for b, v in buckets.items()},
        "attributed_fraction": round(known / total_us, 4) if total_us
        else 0.0,
    }


# -- the messenger microbenches (stage_cpu) ------------------------------------

def _msgr_frame_microbench() -> dict:
    """Messenger frame-codec microbench: whole-frame encode+decode
    round trips per second, native C codec vs the pure-Python fallback,
    over a data-plane-shaped frame (two small JSON segments + one 32
    KiB data segment — the k=8 sub-op shape): the per-frame Python the
    native codec removes is the delta between these two rates."""
    from ceph_tpu_torch.msg import frames
    from ceph_tpu_torch.msg.frames import Frame, Tag
    out: dict = {}
    seg = bytes(range(256)) * 128          # 32 KiB
    frame = Frame(Tag.MESSAGE,
                  [b'{"type":112,"seq":123}', b'{"sub":"x"}' * 8, seg])
    was = frames.native_active()
    try:
        for label, use_native in (("native", True), ("python", False)):
            if use_native and not frames.set_native(True):
                raise RuntimeError("the native frame codec did not load")
            frames.set_native(use_native)
            blob = frame.encode()
            n = 4000
            t0 = time.perf_counter()
            for _ in range(n):
                frame.encode_parts()
                Frame.decode(blob)
            out[f"msgr_frames_per_s_{label}"] = round(
                n / (time.perf_counter() - t0), 1)
    finally:
        frames.set_native(was)
    out["msgr_frame_native_speedup"] = round(
        out["msgr_frames_per_s_native"] / out["msgr_frames_per_s_python"], 3)
    log(f"msgr_frames: native {out['msgr_frames_per_s_native']}/s python "
        f"{out['msgr_frames_per_s_python']}/s "
        f"(x{out['msgr_frame_native_speedup']})")
    out.update(_msgr_saturated_batching())
    return out


def _msgr_saturated_batching() -> dict:
    """Per-peer batching at connection saturation: a real messenger
    pair over localhost, the sender enqueuing one client EC write's
    worth of data-plane traffic (k=8,m=3: 11 sub-op-sized messages one
    way) faster than the wire drains. Reports frames per 11-message
    write-equivalent — the asymptote the in-situ number approaches as
    per-connection queue depth grows."""
    import asyncio

    from ceph_tpu_torch.msg import messages as Msgs
    from ceph_tpu_torch.msg import messenger as msgr_mod
    from ceph_tpu_torch.msg.messenger import (Dispatcher, Messenger, Policy,
                                              msgr_perf)

    WRITES, PER_WRITE = 200, 11

    async def body() -> dict:
        got = [0]
        done = asyncio.Event()

        class Sink(Dispatcher):
            async def ms_dispatch(self, conn, msg):
                if isinstance(msg, Msgs.MOSDECSubOpWrite):
                    got[0] += 1
                    if got[0] >= WRITES * PER_WRITE:
                        done.set()
                    return True
                return False

        srv = Messenger("bench-msgr-srv")
        srv.add_dispatcher(Sink())
        addr = await srv.bind("127.0.0.1", 0)
        cli = Messenger("bench-msgr-cli")
        conn = await cli.connect(addr, Policy.lossless_peer())
        pc = msgr_perf()
        base = dict(pc.dump())
        payload = bytes(4096)
        t0 = time.perf_counter()
        for w in range(WRITES):
            for s in range(PER_WRITE):
                conn.send_message(Msgs.MOSDECSubOpWrite(
                    {"tid": w, "shard": s}, payload))
            if w % 8 == 0:
                await asyncio.sleep(0)      # let the write loop drain
        await asyncio.wait_for(done.wait(), 30)
        dt = time.perf_counter() - t0
        d = {k: v - base[k] for k, v in pc.dump().items()
             if isinstance(v, int) and k in base}
        await cli.shutdown()
        await srv.shutdown()
        return {
            "msgr_saturated_frames_per_write": round(
                d["data_frames_tx"] / WRITES, 2),
            "msgr_saturated_msgs_per_s": round(WRITES * PER_WRITE / dt, 1),
        }

    enabled = msgr_mod._BATCH_DEFAULTS["enabled"]
    try:
        msgr_mod._BATCH_DEFAULTS["enabled"] = True
        out = asyncio.run(body())
    finally:
        msgr_mod._BATCH_DEFAULTS["enabled"] = enabled
    log(f"msgr_saturated: {out['msgr_saturated_frames_per_write']} frames "
        f"per 11-msg write-equivalent at {out['msgr_saturated_msgs_per_s']} "
        f"msgs/s")
    return out


# -- the cluster stages --------------------------------------------------------

#: reactor shard counts the cluster_tpu stage sweeps (capped by the
#: CEPH_TPU_REACTOR_SHARDS knob and the core count)
REACTOR_SHARD_COUNTS = (1, 2, 4)

#: process-backed reactor worker counts the cluster_tpu stage sweeps
#: (capped by the CEPH_TPU_REACTOR_PROCS knob and the core count)
REACTOR_PROC_COUNTS = (1, 2)

#: keys of the cluster stages whose zero is a reading, not a measurement
#: that did not happen: event counts (no batch reached the host
#: fallback, none coalesced), shares clamped at 0 (tracing overhead, a
#: window stall fraction) and skews (0 is balanced, and one card's
#: device skew is 0 by definition)
ZERO_IS_A_READING = frozenset({
    "offload_fallback_ops", "offload_coalesced_ops",
    "pg_pipeline_stall_fraction", "shard_busy_skew",
    "shard_busy_skew_procs", "device_busy_skew", "tracing_overhead_pct",
    "tracing_overhead_full_pct",
    # no read or write returned wrong bytes (above 0 fails the run)
    "failure_storm_client_errors",
    # every read of the storm answered within its timeout
    "failure_storm_read_stalls",
    # no write stalled below min_size while three OSDs were down
    "failure_storm_write_stalls",
    # the sanitizer's overhead, clamped at 0: the armed sweep was as fast
    "interleave_sanitizer_overhead_pct",
    # the recorder's and mgr's overhead, clamped at 0 the same way
    "flight_history_overhead_pct",
    # lockdep's signed overhead on the client writes: at or below 0 the
    # armed burst was as fast as the disarmed one, within the noise
    "lockdep_overhead_pct",
    # no op of the swarm's 200 clients failed (above 0 fails the run)
    "swarm_errors",
    # no op of the fleet failed while scrub churned (above 0 fails)
    "scrub_storm_client_errors",
    # no op of the fleet failed in the scrub-off baseline (above 0 fails)
    "scrub_baseline_errors",
    # every repaired rot object read back equal to its payload (above 0
    # fails)
    "scrub_repair_readback_bad",
    # no op of the QoS storm's fleets failed: the polite baseline, the
    # storm with the scheduler off, on, and under the shed policy
    # (above 0 fails the run)
    "qos_baseline_errors", "qos_errors_off", "qos_errors_on",
    "qos_shed_errors",
    # no shard of the dmclock queue deferred: a shard defers only when
    # every op queued on it belongs to a tenant past its limit, and how
    # often that happens depends on how fast the host drains the
    # polite tenants' ops, not on whether the scheduler ran
    "qos_deferred_waits",
    # the flight recorder's mark of such a deferral (at most one each
    # 0.5 s a queue): its zero is qos_deferred_waits' zero
    "qos_backpressure_crumbs"})


def _reactor_shards_knob(default: int = 4) -> int:
    """The bench's reactor_shards knob (CEPH_TPU_REACTOR_SHARDS)."""
    try:
        return max(1, int(os.environ.get("CEPH_TPU_REACTOR_SHARDS",
                                         str(default))))
    except ValueError:
        return default


def _reactor_procs_knob(default: int = 2) -> int:
    """The bench's reactor_procs knob (CEPH_TPU_REACTOR_PROCS)."""
    try:
        return max(1, int(os.environ.get("CEPH_TPU_REACTOR_PROCS",
                                         str(default))))
    except ValueError:
        return default


def _cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def _cluster_device(device: str | None) -> tuple[str, dict]:
    """The OSDs' device for a cluster stage (checked to exist, its
    context opened) and the stage's platform key."""
    device = device or _device.DEFAULT_DEVICE
    dev = _device.resolve(device)
    torch.zeros(1, device=dev)
    _sync(dev)
    return device, "gpu" if dev.type == "cuda" else "cpu"


async def _ec_pool(client, name: str, pg_num: int, k: int, m: int,
                   device: str, profile: str = "tpuprof"):
    """An EC pool with plugin `cuda` on `device` (the reference's
    plugin `tpu`), as the reference's stages create theirs."""
    await client.command({
        "prefix": "osd erasure-code-profile set", "name": profile,
        "profile": {"plugin": "cuda", "k": str(k), "m": str(m),
                    "device": device}})
    await client.pool_create(name, pg_num=pg_num, pool_type="erasure",
                             erasure_code_profile=profile)
    return client.ioctx(name)


def stage_cluster(device: str | None = None) -> dict:
    """In-situ cluster throughput (the `rados bench` analog): N
    concurrent writers/readers through the full client->mon->osd->PG->
    backend stack on localhost sockets, replicated AND EC pools, the
    OSDs and the EC profile on `device`; then one observability pass
    over a fresh vstart cluster with a mgr, an MDS and a gateway. A
    failed probe raises. The record keeps the reference's key names."""
    import asyncio

    device, _platform = _cluster_device(device)
    results: dict = {}

    async def body():
        import argparse
        from ceph_tpu_torch.tools.rados_bench import _main
        for pool_type, k, m in (("replicated", 0, 0), ("erasure", 2, 2)):
            args = argparse.Namespace(
                seconds=4.0, concurrency=8, object_size=256 * 1024,
                pool_type=pool_type, plugin="jerasure", k=k, m=m,
                osds=4, backend="memstore", device=device)
            out = await _main(args)
            key = "cluster_rep" if pool_type == "replicated" \
                else "cluster_ec"
            results[f"{key}_write_mb_s"] = out["write"]["mb_per_s"]
            results[f"{key}_read_mb_s"] = out["read"]["mb_per_s"]
            results[f"{key}_write_p99_ms"] = out["write"]["lat_p99_ms"]
            results[f"{key}_read_p99_ms"] = out["read"]["lat_p99_ms"]
            log(f"{key}: write {out['write']['mb_per_s']} MB/s "
                f"read {out['read']['mb_per_s']} MB/s")

    async def probe_health():
        """One observability pass: boot a full cluster (mgr + mds +
        rgw), let the report fan-in converge, then record the mon
        health and the exporter's per-daemon labels."""
        import re
        import tempfile

        from ceph_tpu_torch.tools.vstart import VCluster
        with tempfile.TemporaryDirectory(prefix="bench-health-") as base:
            c = VCluster(base, n_mons=1, n_osds=3, with_mgr=True,
                         with_mds=True, with_rgw=True, device=device)
            try:
                await c.start()
                loop = asyncio.get_running_loop()
                deadline = loop.time() + 30
                want = {"osd", "mon", "mds", "rgw"}
                while want - {st.service for st in
                              c.mgr.daemon_index.daemons.values()}:
                    if loop.time() > deadline:
                        break
                    await asyncio.sleep(0.25)
                health = await c.mgr.mon_command({"prefix": "health"})
                reader, writer = await asyncio.open_connection(
                    *c.mgr.exporter.addr)
                writer.write(b"GET /metrics HTTP/1.0\r\n\r\n")
                await writer.drain()
                blob = await reader.read()
                writer.close()
                text = blob.split(b"\r\n\r\n", 1)[1].decode()
                results["health"] = {
                    # the probe boots its own full cluster (rados_bench
                    # tears its benchmark cluster down internally): this
                    # records the observability plane converging, not
                    # the bench cluster's load response
                    "scope": "post-bench observability probe "
                             "(fresh 3-osd + mgr/mds/rgw cluster)",
                    "status": health.get("status"),
                    "checks": sorted(health.get("checks", {})),
                    "daemon_report_ages":
                        c.mgr.daemon_index.report_ages(),
                    "metric_daemons": sorted(
                        set(re.findall(r'ceph_daemon="([^"]+)"', text))),
                    "metric_lines": sum(
                        1 for ln in text.splitlines()
                        if ln.startswith("ceph_")),
                }
                log(f"health: {results['health']['status']} "
                    f"checks={results['health']['checks']} "
                    f"daemons={results['health']['metric_daemons']}")
            finally:
                await c.stop()
    asyncio.run(asyncio.wait_for(body(), 300))
    asyncio.run(asyncio.wait_for(probe_health(), 120))
    return results


def stage_cluster_tpu(device: str | None = None) -> dict:
    """The EC pool's device plugin in the cluster's data path: a real
    mon + 11 OSDs, an EC pool plugin=cuda k=8 m=3 (the north-star
    profile) on `device`, small one-stripe objects so every PG op is the
    tiny per-op encode. Two timed passes over the same stack:

      inline   ec_offload_enabled=false — each op dispatches its own
               synchronous device encode;
      offload  the offload service coalesces concurrent PG ops into
               staged device batches.

    Then the messenger's frames per EC write, the EC data path alone
    (inline and batched), the PG pipeline depth sweep, the thread-shard
    curve, the process curve (OSDs in 1 and 2 worker processes, each
    opening the device) and the mesh scaling curve over slots of the
    device. The record keeps the reference's key names."""
    import asyncio

    t0 = time.perf_counter()
    device, platform = _cluster_device(device)
    log(f"cluster_tpu: device {device} ({time.perf_counter() - t0:.1f}s "
        f"init)")
    results: dict = {"cluster_ec_tpu_platform": platform}
    K8, M3 = 8, 3
    OBJ = K8 * 4096              # one stripe: the worst-case tiny op
    SECONDS, CONC = 3.0, 16

    async def body():
        from ceph_tpu_torch import offload
        from ceph_tpu_torch.msg.messenger import msgr_perf
        from ceph_tpu_torch.tools.cluster_boot import ephemeral_cluster
        from ceph_tpu_torch.tools.rados_bench import _phase

        async with ephemeral_cluster(K8 + M3, prefix="bench-tpu-",
                                     device=device) \
                as (client, osds, _mon):
            try:
                io = await _ec_pool(client, "benchtpu", 8, K8, M3, device)
                svc = offload.get_service()
                # warm both paths: the kernels, staging pages and batch
                # buckets come up outside the timed windows
                payload = bytes(OBJ)
                for enabled in (True, False):
                    offload.set_enabled(enabled)
                    await asyncio.gather(*[io.write_full(
                        f"warm-{enabled}-{i}", payload) for i in range(4)])
                phases = {}
                for name, enabled in (("inline", False), ("offload", True)):
                    offload.set_enabled(enabled)
                    base = dict(svc.stats)
                    counts: dict = {}
                    w = await _phase(io, "write", CONC, SECONDS, OBJ, counts)
                    r = await _phase(io, "read", CONC, SECONDS, OBJ, counts)
                    d = {k: svc.stats[k] - base[k] for k in base}
                    phases[name] = (w, r, d)
                    log(f"cluster_ec_tpu[{name}]: write {w['mb_per_s']} "
                        f"MB/s read {r['mb_per_s']} MB/s "
                        f"batches={d['batches']} "
                        f"coalesced={d['coalesced_ops']} "
                        f"fallbacks={d['fallback_ops']}")
                wo, ro, do = phases["offload"]
                wi, _ri, _di = phases["inline"]
                results["cluster_ec_tpu_write_mb_s"] = wo["mb_per_s"]
                results["cluster_ec_tpu_read_mb_s"] = ro["mb_per_s"]
                results["cluster_ec_tpu_write_p99_ms"] = wo["lat_p99_ms"]
                results["cluster_ec_tpu_inline_write_mb_s"] = wi["mb_per_s"]
                results["cluster_ec_tpu_offload_vs_inline"] = round(
                    wo["mb_per_s"] / wi["mb_per_s"], 3)
                results["offload_batches"] = do["batches"]
                results["offload_mean_batch_ops"] = round(
                    do["batched_ops"] / do["batches"], 3)
                results["offload_coalesced_ops"] = do["coalesced_ops"]
                results["offload_fallback_ops"] = do["fallback_ops"]
                results["offload_status"] = osds[0]._offload_admin("status")

                # frames per client EC write (k=8,m=3), from the msgr
                # perf counters: many PGs + deep client concurrency so
                # per-OSD fan-outs overlap and coalesce per peer conn
                # (22 frames a write unbatched: 1 op + 10 sub-ops + 10
                # replies + 1 reply). data_frames counts only the data
                # plane, so heartbeats and mgr reports stay out of it.
                iom = await _ec_pool(client, "msgrbench", 32, K8, M3,
                                     device)
                await asyncio.gather(*[iom.write_full(f"w{i}", payload)
                                       for i in range(8)])
                pc = msgr_perf()
                base_m = dict(pc.dump())
                wm = await _phase(iom, "write", 128, 2.0, OBJ, {})
                dm = {k: v - base_m[k] for k, v in pc.dump().items()
                      if isinstance(v, int) and k in base_m}
                ops = max(1, wm["ops"])
                results["msgr_frames_per_ec_write"] = round(
                    dm.get("data_frames_tx", 0) / ops, 2)
                results["msgr_batches"] = dm.get("batches_tx", 0)
                results["msgr_batched_msgs"] = dm.get("batched_msgs", 0)
                results["msgr_batch_write_mb_s"] = wm["mb_per_s"]
                results["msgr_mean_batch_msgs"] = round(
                    dm.get("batched_msgs", 0) / dm["batches_tx"], 2) \
                    if dm.get("batches_tx") else 0.0
                log(f"msgr_batch: {results['msgr_frames_per_ec_write']} "
                    f"data frames/write over {ops} deep-queue writes "
                    f"({results['msgr_batch_write_mb_s']} MB/s, mean "
                    f"batch {results['msgr_mean_batch_msgs']} msgs)")
            finally:
                offload.set_enabled(True)

    async def datapath():
        # the EC write DATA PATH in isolation (the encode dispatch the
        # service batches), under cluster-shaped concurrency but in a
        # clean loop: with live daemons on the loop their heartbeats
        # starve. Per-op dispatch overhead lives here, undiluted by the
        # messaging stack: the inline path pays launch + H2D per tiny
        # op, batching amortizes both.
        from ceph_tpu_torch import offload
        from ceph_tpu_torch.ec import registry as _ecreg
        from ceph_tpu_torch.osd import ec_util as _ecu
        impl = _ecreg.factory("cuda", {"k": str(K8), "m": str(M3),
                                       "device": device})
        sinfo = _ecu.StripeInfo(K8, OBJ)
        svc = offload.get_service(_device.service_devices(device))
        svc.linger_ms = 1.0
        dp_payload = bytes(range(256)) * (OBJ // 256)

        async def dp_phase(enabled, seconds=2.5, conc=32):
            offload.set_enabled(enabled)
            for _ in range(3):          # warm outside the window
                await _ecu.encode_async(sinfo, impl, dp_payload,
                                        service=svc)
            done = [0]
            loop = asyncio.get_running_loop()
            stop = loop.time() + seconds
            t0 = loop.time()

            async def worker():
                while loop.time() < stop:
                    await _ecu.encode_async(sinfo, impl, dp_payload,
                                            service=svc)
                    done[0] += 1
            await asyncio.gather(*[worker() for _ in range(conc)])
            return round(done[0] * OBJ / (loop.time() - t0) / 1e6, 2)

        try:
            dp_inline = await dp_phase(False)
            dp_off = await dp_phase(True)
        finally:
            offload.set_enabled(True)
        results["ec_datapath_inline_mb_s"] = dp_inline
        results["ec_datapath_offload_mb_s"] = dp_off
        results["ec_datapath_offload_vs_inline"] = round(
            dp_off / dp_inline, 3)
        log(f"ec_datapath: inline {dp_inline} MB/s, offload {dp_off} MB/s "
            f"({results['ec_datapath_offload_vs_inline']}x)")

    async def pipeline_sweep():
        """osd_pg_pipeline_depth sweep over the SAME deep-queue workload
        (pg=8, conc=128, one-stripe objects): depth=1 is the serial
        per-PG pipeline, and each step up lets one PG run that many
        client ops to distinct objects concurrently. Records write MB/s,
        data frames per EC write, the offload batcher's mean batch size
        and the window-full stall fraction; a known object is read back
        at every depth."""
        from ceph_tpu_torch import offload
        from ceph_tpu_torch.msg.messenger import msgr_perf
        from ceph_tpu_torch.tools.cluster_boot import ephemeral_cluster
        from ceph_tpu_torch.tools.rados_bench import _phase

        DEPTHS = (1, 2, 4, 8)
        CONC_DEEP = 128
        sweep: dict[str, float] = {}
        frames: dict[str, float] = {}
        batch: dict[str, float] = {}
        stalls: dict[str, float] = {}
        readbacks: dict[int, bytes] = {}
        payload = bytes(range(256)) * (OBJ // 256)
        offload.set_enabled(True)
        for depth in DEPTHS:
            # a FRESH cluster per depth: one shared cluster ages across
            # the sweep (log windows fill, stores grow), handicapping
            # whichever depth runs last
            async with ephemeral_cluster(
                    K8 + M3, prefix=f"bench-pipe{depth}-", device=device) \
                    as (client, osds, _mon):
                io = await _ec_pool(client, "pipebench", 8, K8, M3, device)
                svc = offload.get_service()
                pc = msgr_perf()
                for o in osds:
                    o.config.set("osd_pg_pipeline_depth", depth)
                await asyncio.gather(*[io.write_full(f"warm-{i}", payload)
                                       for i in range(4)])
                base_m = dict(pc.dump())
                base_s = dict(svc.stats)
                base_stalls = sum(o.op_queue.window_stalls for o in osds)
                w = await _phase(io, "write", CONC_DEEP, 2.0, OBJ, {})
                dm = {k: v - base_m[k] for k, v in pc.dump().items()
                      if isinstance(v, int) and k in base_m}
                ds = {k: svc.stats[k] - base_s[k] for k in base_s}
                ops = max(1, w["ops"])
                d = str(depth)
                sweep[d] = w["mb_per_s"]
                frames[d] = round(dm.get("data_frames_tx", 0) / ops, 2)
                batch[d] = round(ds["batched_ops"] / ds["batches"], 3) \
                    if ds.get("batches") else 0.0
                stalls[d] = round(
                    (sum(o.op_queue.window_stalls for o in osds)
                     - base_stalls) / ops, 4)
                await io.write_full("bitcheck", payload)
                readbacks[depth] = bytes(await io.read("bitcheck"))
                log(f"pipeline_depth={depth}: write {w['mb_per_s']} MB/s, "
                    f"{frames[d]} frames/write, mean offload batch "
                    f"{batch[d]}, stall fraction {stalls[d]}")
        identical = all(rb == readbacks[DEPTHS[0]] == payload
                        for rb in readbacks.values())
        results["pipeline_depth_sweep_mb_s"] = sweep
        results["pipeline_msgr_frames_per_ec_write"] = frames
        results["pipeline_offload_mean_batch_ops"] = batch
        results["pipeline_stall_fraction_by_depth"] = stalls
        results["pipeline_bit_identical"] = identical
        results["pipeline_speedup_4v1"] = round(sweep["4"] / sweep["1"], 3)
        # taken at the DEFAULT depth (4): a rising stall fraction means
        # the window, not the wire, is the ceiling
        results["pg_pipeline_stall_fraction"] = stalls["4"]
        log(f"pipeline_sweep: {sweep} (4v1 "
            f"x{results['pipeline_speedup_4v1']}, "
            f"bit_identical={identical})")

    async def shard_curve():
        """Reactor shard scaling: the SAME offload-batched EC write
        workload over 1/2/4-shard thread reactors (utils/reactor.py),
        capped at the knob and the core count (oversubscribed loop
        threads measure interpreter-lock convoying, not shards); a known
        object is read back under every shard count."""
        from ceph_tpu_torch import offload
        from ceph_tpu_torch.tools.cluster_boot import ephemeral_cluster
        from ceph_tpu_torch.tools.rados_bench import _phase

        max_shards = _reactor_shards_knob()
        cores = _cores()
        shard_counts = [n for n in REACTOR_SHARD_COUNTS
                        if n <= max_shards and n <= max(cores, 1)] or [1]
        results["reactor_shard_cores"] = cores
        curve: dict[str, float] = {}
        identical = True
        payload = bytes(range(256)) * (OBJ // 256)
        offload.set_enabled(True)
        for n in shard_counts:
            async with ephemeral_cluster(
                    K8 + M3, prefix=f"bench-shard{n}-", reactor_shards=n,
                    device=device) as (client, _osds, _mon):
                io = await _ec_pool(client, "shardbench", 8, K8, M3, device)
                await asyncio.gather(*[io.write_full(f"warm-{i}", payload)
                                       for i in range(4)])
                w = await _phase(io, "write", CONC, 2.5, OBJ, {})
                curve[str(n)] = w["mb_per_s"]
                got = await io.read("warm-0")
                identical = identical and got == payload
                log(f"reactor_shards={n}: write {w['mb_per_s']} MB/s "
                    f"(bit_identical={got == payload})")
        results["reactor_shard_scaling_mb_s"] = curve
        results["reactor_shard_bit_identical"] = identical
        results["reactor_shards"] = shard_counts[-1]
        results["reactor_shard_speedup"] = round(
            curve[str(shard_counts[-1])] / curve["1"], 3)
        results["cluster_ec_tpu_write_mb_s_sharded"] = \
            curve[str(shard_counts[-1])]
        log(f"reactor_shard_scaling: {curve} "
            f"(speedup x{results['reactor_shard_speedup']}, "
            f"bit_identical={identical})")

    async def procs_curve():
        """Process-backed reactor scaling: the SAME offload-batched EC
        write workload with the OSDs in 1/2 WORKER PROCESSES (mon and
        client stay in this process on shard 0), each worker with its
        own interpreter, loop and offload front end, and its own context
        on the device. Capped like the shard curve; a known object is
        read back under every count. The widest run arms the loop
        profiler in EVERY process (config propagation over the control
        channel) and records the cross-process shard_busy_skew."""
        from ceph_tpu_torch import offload
        from ceph_tpu_torch.tools.cluster_boot import ephemeral_cluster
        from ceph_tpu_torch.tools.rados_bench import _phase
        from ceph_tpu_torch.utils import loopprof

        max_procs = _reactor_procs_knob()
        cores = _cores()
        proc_counts = [n for n in REACTOR_PROC_COUNTS
                       if n <= max_procs and n <= max(cores, 1)] or [1]
        curve: dict[str, float] = {}
        identical = True
        payload = bytes(range(256)) * (OBJ // 256)
        offload.set_enabled(True)
        for n in proc_counts:
            async with ephemeral_cluster(
                    K8 + M3, prefix=f"bench-proc{n}-", reactor_procs=n,
                    device=device) as (client, osds, _mon):
                io = await _ec_pool(client, "procbench", 8, K8, M3, device)
                await asyncio.gather(*[io.write_full(f"warm-{i}", payload)
                                       for i in range(4)])
                pool = osds[0].pool
                profiled = n == proc_counts[-1]
                try:
                    if profiled:
                        loopprof.install()      # parent shard 0
                        await pool.config_set("profiler_enabled", True)
                    w = await _phase(io, "write", CONC, 2.5, OBJ, {})
                    if profiled:
                        prof = await pool.profile_stats()
                        results["reactor_proc_per_shard"] = prof["shards"]
                        results["shard_busy_skew_procs"] = \
                            prof["shard_busy_skew"]
                finally:
                    if profiled:
                        # unarm even on a failed iteration: a sampler
                        # left installed would tax every later stage
                        try:
                            await pool.config_set("profiler_enabled",
                                                  False)
                        finally:
                            loopprof.uninstall()
                curve[str(n)] = w["mb_per_s"]
                got = await io.read("warm-0")
                identical = identical and got == payload
                log(f"reactor_procs={n}: write {w['mb_per_s']} MB/s "
                    f"(bit_identical={got == payload})")
        results["reactor_proc_scaling_mb_s"] = curve
        results["reactor_proc_bit_identical"] = identical
        results["reactor_procs"] = proc_counts[-1]
        results["reactor_proc_cores"] = cores
        results["reactor_proc_speedup"] = round(
            curve[str(proc_counts[-1])] / curve["1"], 3)
        # EC write MB/s with the widest process fan-out
        results["cluster_ec_write_mb_s_procs"] = curve[str(proc_counts[-1])]
        log(f"reactor_proc_scaling: {curve} "
            f"(speedup x{results['reactor_proc_speedup']}, "
            f"skew={results.get('shard_busy_skew_procs')}, "
            f"bit_identical={identical})")

    asyncio.run(asyncio.wait_for(body(), 240))
    asyncio.run(asyncio.wait_for(datapath(), 120))
    asyncio.run(asyncio.wait_for(pipeline_sweep(), 180))
    asyncio.run(asyncio.wait_for(shard_curve(), 180))
    asyncio.run(asyncio.wait_for(procs_curve(), 240))
    # the mesh fan-out's scaling curve over slots of the device (the
    # reference spawns an 8-virtual-device child for it)
    results.update(_mesh_scaling_body(device))
    results["elapsed_s"] = round(time.perf_counter() - t0, 1)
    return results


def stage_attribution(device: str | None = None) -> dict:
    """The data-path attribution profiler, end to end on a live
    cluster: tracer + copy ledger + loop profiler armed around a timed
    EC write window (plugin=cuda on `device`, 2 thread shards), then
    the span stream decomposed into the queue-wait/copy/H2D/kernel/D2H/
    commit waterfall, with copy amplification (bytes copied / bytes
    written), the loops' busy shares and the per-device offload
    utilization (busy share of the window and skew across the cards
    that saw traffic) riding the same record; then the tracing A/B
    (off / sampled with tail retention / full)."""
    import asyncio

    t0 = time.perf_counter()
    device, platform = _cluster_device(device)
    log(f"attribution: device {device} ({time.perf_counter() - t0:.1f}s "
        f"init)")
    results: dict = {"attribution_platform": platform}
    KA, MA = 2, 1
    OBJ = KA * 4096
    SECONDS, CONC = 2.0, 8

    async def body():
        from ceph_tpu_torch import offload
        from ceph_tpu_torch.tools.cluster_boot import ephemeral_cluster
        from ceph_tpu_torch.tools.rados_bench import _phase
        from ceph_tpu_torch.utils import copytrack, loopprof, reactor, tracer

        # profile the SHARDED runtime (capped by the bench knob): the
        # stage then reports loop_busy_fraction per reactor shard plus
        # the busy skew
        n_shards = min(2, _reactor_shards_knob())
        async with ephemeral_cluster(KA + MA, prefix="bench-attr-",
                                     reactor_shards=n_shards,
                                     device=device) \
                as (client, osds, _mon):
            pool = reactor.current_pool()
            try:
                io = await _ec_pool(client, "attr", 4, KA, MA, device,
                                    profile="attrprof")
                svc = offload.get_service()
                payload = bytes(OBJ)
                # warm: kernels, staging and sessions come up outside
                # the window
                await asyncio.gather(*[io.write_full(f"warm-{i}", payload)
                                       for i in range(4)])
                # arm every instrument, zeroed, for the measured window
                # (profile_dispatch serializes traced device dispatches
                # so spans carry real h2d/kernel/d2h splits —
                # attribution-only, never plain tracer_enabled)
                tracer.enable(max_spans=65536)
                tracer.set_profile_dispatch(True)
                tracer.reset()
                copytrack.reset()
                if pool is not None:
                    # arm the sampler ON every reactor shard (install
                    # reads the loop thread's ident on that thread)
                    await pool.run_on_each(
                        lambda: loopprof.install(sample_hz=200))
                else:
                    loopprof.install(sample_hz=200)
                loopprof.reset()
                dev_base = svc.device_snapshot()
                t_win = time.perf_counter()
                w = await _phase(io, "write", CONC, SECONDS, OBJ, {})
                await svc.drain()
                window_s = time.perf_counter() - t_win
                tracer.disable()
                prof = loopprof.dump()
                if pool is not None:
                    await pool.run_on_each(loopprof.uninstall)
                else:
                    loopprof.uninstall()
                bytes_written = w["ops"] * OBJ
                att = attribution_from_spans(tracer.collector().spans())
                att["copy_amplification"] = \
                    copytrack.amplification(bytes_written)
                att["bytes_written"] = bytes_written
                snap = copytrack.snapshot()
                att["copy_ledger"] = {
                    s: {"copied_mb": round(d["copied_bytes"] / 1e6, 3),
                        "referenced_mb": round(
                            d["referenced_bytes"] / 1e6, 3)}
                    for s, d in snap["stages"].items()}
                att["loop_busy_fraction"] = prof["loop_busy_fraction"]
                # per-reactor-shard busy fractions + skew ((max-min)/max;
                # a placement or affinity regression rises here first)
                att["reactor_shards"] = n_shards
                att["per_shard"] = prof.get("shards", {})
                att["shard_busy_skew"] = prof.get("shard_busy_skew", 0.0)
                results["shard_busy_skew"] = att["shard_busy_skew"]
                att["executor_queue_depth"] = prof["executor_queue_depth"]
                att["top_stalls"] = prof["top_stalls"][:5]
                att["per_device"] = {}
                for dev, d in svc.device_snapshot().items():
                    base = dev_base.get(dev, {})
                    busy = d["busy_s"] - base.get("busy_s", 0.0)
                    att["per_device"][dev] = {
                        "busy_fraction": round(busy / window_s, 4),
                        "bytes": d["bytes"] - base.get("bytes", 0),
                        "batches": d["batches"] - base.get("batches", 0),
                        "ops": d["ops"] - base.get("ops", 0),
                    }
                # fan-out balance: busy-fraction skew across the device
                # slots that saw traffic this window ((max-min)/max; 0 is
                # balanced, and one card alone reads 0)
                active = [d["busy_fraction"]
                          for dev, d in att["per_device"].items()
                          if dev != "host" and d["busy_fraction"] > 0]
                att["device_busy_skew"] = round(
                    (max(active) - min(active)) / max(active), 4) \
                    if len(active) >= 2 else 0.0
                results["device_busy_skew"] = att["device_busy_skew"]
                bk = att["buckets_us"]
                # Python per op: what is left of op_total after the
                # device legs, the metered copies and the store commit
                # (messaging, dispatch, scheduling)
                att["python_us_per_op"] = round(max(0.0, (
                    att["op_total_us"] - bk["h2d"] - bk["kernel"]
                    - bk["d2h"] - bk["copy"] - bk["commit"])), 1)
                results["python_us_per_op"] = att["python_us_per_op"]
                results["attribution"] = att
                results["copy_amplification"] = att["copy_amplification"]
                results["loop_busy_fraction"] = att["loop_busy_fraction"]
                results["attribution_write_mb_s"] = w["mb_per_s"]
                log(f"attribution: op_total {att['op_total_us']}us over "
                    f"{att['ops']} ops | " + " ".join(
                        f"{b}={bk[b]}" for b in ATTRIBUTION_BUCKETS)
                    + f" | copy_amp {att['copy_amplification']} "
                    f"loop_busy {att['loop_busy_fraction']} "
                    f"shards={att['per_shard']} "
                    f"skew={att['shard_busy_skew']} "
                    f"per_device={att['per_device']}")
                # tracing-overhead A/B: off vs the always-on production
                # config (sample_rate=0.01 + tail retention) vs full
                # tracing, same cluster, same write phase. Each mode
                # window is SANDWICHED between off windows and scored
                # against their mean: the shared cluster ages
                # monotonically across windows (pg log windows fill,
                # object count grows), so comparing windows far apart
                # in time books aging as tracer cost. A discarded
                # warmup window absorbs first-window effects, and
                # best-of-reps on the ratio drops one-off stall windows.
                # profile_dispatch is OFF for both modes: sampling must
                # never imply the serialized attribution mode.
                tracer.set_profile_dispatch(False)
                AB_SECONDS, AB_REPS = 1.5, 3

                def _arm_off() -> None:
                    tracer.disable()
                    tracer.set_sampling(rate=0.0, tail_slow_ms=0.0)

                def _arm_sampled() -> None:
                    tracer.disable()
                    tracer.set_sampling(rate=0.01, tail_slow_ms=250.0)

                def _arm_full() -> None:
                    tracer.set_sampling(rate=0.0, tail_slow_ms=0.0)
                    tracer.enable(max_spans=65536)

                async def _ab_window() -> float:
                    tracer.reset()
                    r = await _phase(io, "write", CONC, AB_SECONDS, OBJ, {})
                    await svc.drain()
                    return r["mb_per_s"]

                ab_modes = [("sampled_tail", _arm_sampled),
                            ("full", _arm_full)]
                ab_ratio = {name: 0.0 for name, _ in ab_modes}
                ab_rate = {name: 0.0 for name, _ in ab_modes}
                ab_off = 0.0
                _arm_off()
                await _ab_window()          # warmup, discarded
                for _rep in range(AB_REPS):
                    # chain: off, sampled, off, full, off — each mode
                    # window scored vs the mean of its two neighbours
                    _arm_off()
                    off_prev = await _ab_window()
                    for name, arm in ab_modes:
                        arm()
                        rate = await _ab_window()
                        _arm_off()
                        off_next = await _ab_window()
                        base = (off_prev + off_next) / 2.0
                        ab_off = max(ab_off, base)
                        ab_rate[name] = max(ab_rate[name], rate)
                        ab_ratio[name] = max(ab_ratio[name], rate / base)
                        off_prev = off_next
                tracer.disable()
                tracer.reset()

                def _overhead(ratio: float) -> float:
                    return round(max(0.0, (1.0 - ratio) * 100.0), 2)
                results["tracing_ab_mb_s"] = {
                    "off": round(ab_off, 2),
                    "sampled_tail": round(ab_rate["sampled_tail"], 2),
                    "full": round(ab_rate["full"], 2)}
                results["tracing_overhead_pct"] = \
                    _overhead(ab_ratio["sampled_tail"])
                results["tracing_overhead_full_pct"] = \
                    _overhead(ab_ratio["full"])
                log(f"attribution: tracing A/B off={ab_off:.1f} "
                    f"sampled+tail={ab_rate['sampled_tail']:.1f} "
                    f"full={ab_rate['full']:.1f} MB/s -> overhead "
                    f"{results['tracing_overhead_pct']}% "
                    f"(full {results['tracing_overhead_full_pct']}%)")
            finally:
                tracer.disable()
                tracer.set_sampling(rate=0.0, tail_slow_ms=0.0)
                tracer.set_profile_dispatch(False)
                if pool is not None:
                    await pool.run_on_each(loopprof.uninstall)
                loopprof.uninstall()

    asyncio.run(asyncio.wait_for(body(), 150))
    results["elapsed_s"] = round(time.perf_counter() - t0, 1)
    return results


# -- failure storm: degraded operation + bandwidth-optimal recovery -----------

def stage_failure_storm(device: str | None = None) -> dict:
    """The degraded-operation story a production store is judged on,
    measured end to end on a live cluster whose OSDs run on `device`:

    Phase A (storm): 11 OSDs, EC pool plugin=clay k=8 m=3 d=10
    (regenerating code; min_size=k+1) over a jerasure MDS code. Under
    sustained mixed client load, m=3 OSDs die mid-window. Degraded reads
    must keep succeeding bit-identically the whole time (writes drop
    below min_size and stall — counted, not errors). The three revive
    with their stores; the stage reports time-to-clean, recovery MB/s
    (from the recovery_bytes_pushed counters), and client p99 during
    backfill.

    Phase B (single-shard repair): one OSD dies, fresh objects are
    written degraded, the OSD revives, and log-driven recovery rebuilds
    its shards through the CLAY sub-chunk repair plan — the
    repair-bytes ratio vs the full-stripe baseline (d/q helper
    fragments vs k whole chunks: 10/3 vs 8 chunks, ~0.42) is THE
    regenerating-code acceptance number.

    Phase C (flight-recorder drill) and phase D (deadlock drill) follow
    below. A drill that fails is recorded under `*_error`; `main` exits
    non-zero on it, on a client error and on any False flag.
    """
    import asyncio

    device, _platform = _cluster_device(device)
    KS, MS, DS = 8, 3, 10
    N_OSDS = KS + MS
    results: dict = {}

    async def wait_clean(osds, pool_name, timeout=90.0):
        from ceph_tpu_torch.crush.crush import CRUSH_NONE
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while True:
            clean = True
            for osd in osds:
                for pg in osd.pgs.values():
                    if pg.pool.name != pool_name:
                        continue
                    if len(pg.acting) != N_OSDS or \
                            CRUSH_NONE in pg.acting:
                        clean = False
                    elif pg.is_primary():
                        if pg.state != "active" or pg._pending_recovery:
                            clean = False
                    elif pg.state not in ("active", "replica"):
                        clean = False
            # every PG must be hosted: primaries cover all of pg_num
            prim = {(pg.pgid.pool, pg.pgid.ps)
                    for osd in osds for pg in osd.pgs.values()
                    if pg.pool.name == pool_name and pg.is_primary()
                    and pg.state == "active"}
            if clean and len(prim) == 8:
                return loop.time()
            if loop.time() > deadline:
                return None
            await asyncio.sleep(0.25)

    async def wait_down(osds, dead, timeout=30.0):
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while loop.time() < deadline:
            maps = [o.osdmap for o in osds if o.whoami not in dead]
            if maps and all(
                    all(i in m.osds and not m.osds[i].up for i in dead)
                    for m in maps):
                return True
            await asyncio.sleep(0.2)
        return False

    def pattern(oid: str, gen: int, size: int) -> bytes:
        import hashlib
        seed = hashlib.sha256(f"{oid}:{gen}".encode()).digest()
        return (seed * (size // len(seed) + 1))[:size]

    def repair_totals(osds):
        fetched = full = 0
        for osd in osds:
            for pg in osd.pgs.values():
                b = pg.backend
                fetched += getattr(b, "repair_bytes_fetched", 0)
                full += getattr(b, "repair_bytes_full", 0)
        return fetched, full

    def pushed_total(osds):
        return sum(o.perf.dump().get("recovery_bytes_pushed", 0)
                   for o in osds)

    async def body():
        from ceph_tpu_torch.objectstore.memstore import MemStore
        from ceph_tpu_torch.osd.daemon import OSD
        from ceph_tpu_torch.tools.cluster_boot import ephemeral_cluster

        stores: dict[int, MemStore] = {}

        def store_factory(tmp, i):
            stores[i] = MemStore(f"osd{i}")
            return stores[i]

        async with ephemeral_cluster(N_OSDS, prefix="bench-storm-",
                                     store_factory=store_factory,
                                     device=device) \
                as (client, osds, mon):
            mon_addrs = list(mon.monmap.mons.values())
            await client.command({
                "prefix": "osd erasure-code-profile set",
                "name": "stormprof",
                "profile": {"plugin": "clay", "k": str(KS),
                            "m": str(MS), "d": str(DS),
                            "scalar_mds": "jerasure",
                            "device": device}})
            await client.pool_create("storm", pg_num=8,
                                     pool_type="erasure",
                                     erasure_code_profile="stormprof")
            io = client.ioctx("storm")
            pool = client.osdmap.get_pool("storm")
            obj = pool.stripe_width          # one full stripe per object
            results["failure_storm_object_bytes"] = obj

            # seed: immutable read-verified set + mutable churn set
            imm = {f"s{i:03d}": pattern(f"s{i:03d}", 0, obj)
                   for i in range(24)}
            for oid, data in imm.items():
                await io.write_full(oid, data)
            mut_gen = {f"w{i:02d}": 0 for i in range(8)}
            for oid in mut_gen:
                await io.write_full(oid, pattern(oid, 0, obj))

            import random as _random
            rng = _random.Random(42)
            lat: list[tuple[float, float, str]] = []
            stats = {"reads": 0, "writes": 0, "errors": 0, "stalls": 0,
                     "read_stalls": 0, "degraded_reads": 0}
            # oids with an outcome-unknown (timed-out) write: RADOS
            # semantics let the abandoned op land later, so their final
            # content is "any written generation", never garbage
            uncertain: set = set()
            stop_flag = [False]
            window = {"t_kill": None, "t_revive": None}
            loop = asyncio.get_running_loop()

            async def reader():
                oids = sorted(imm)
                while not stop_flag[0]:
                    oid = rng.choice(oids)
                    t0 = loop.time()
                    try:
                        got = await io.read(oid)
                    except Exception:
                        # a slow/timed-out read is degraded
                        # AVAILABILITY; only wrong bytes are a data
                        # error
                        stats["read_stalls"] += 1
                        continue
                    if got != imm[oid]:
                        stats["errors"] += 1
                        continue
                    now = loop.time()
                    lat.append((now, (now - t0) * 1e3, "read"))
                    stats["reads"] += 1
                    if window["t_kill"] is not None and \
                            window["t_revive"] is None:
                        stats["degraded_reads"] += 1
                    await asyncio.sleep(0.01)

            async def writer():
                oids = sorted(mut_gen)
                while not stop_flag[0]:
                    oid = rng.choice(oids)
                    gen = mut_gen[oid] + 1
                    t0 = loop.time()
                    try:
                        await client.submit(
                            "storm", oid,
                            [{"op": "write_full", "oid": oid}],
                            pattern(oid, gen, obj), timeout=4.0)
                        mut_gen[oid] = gen
                        now = loop.time()
                        lat.append((now, (now - t0) * 1e3, "write"))
                        stats["writes"] += 1
                    except Exception:
                        # below min_size the pool rejects writes: a
                        # stall with UNKNOWN outcome, not a data error
                        stats["stalls"] += 1
                        uncertain.add(oid)
                    await asyncio.sleep(0.02)

            load = [loop.create_task(reader()) for _ in range(3)] + \
                   [loop.create_task(writer()) for _ in range(2)]
            try:
                await asyncio.sleep(2.0)            # baseline window
                dead = [N_OSDS - 3, N_OSDS - 2, N_OSDS - 1]
                window["t_kill"] = loop.time()
                for i in dead:
                    await osds[i].stop()
                down_ok = await wait_down(osds, dead)
                results["failure_storm_marked_down"] = down_ok
                await asyncio.sleep(4.0)            # degraded window
                pushed0 = pushed_total(
                    [o for o in osds if o.whoami not in dead])
                window["t_revive"] = loop.time()
                for i in dead:
                    osd = OSD(i, mon_addrs, store=stores[i], device=device)
                    await osd.start()
                    osds[i] = osd
                t_clean = await wait_clean(osds, "storm")
                t_rec = (t_clean - window["t_revive"]) if t_clean \
                    else None
                await asyncio.sleep(0.5)
            finally:
                stop_flag[0] = True
                for t in load:
                    t.cancel()
                await asyncio.gather(*load, return_exceptions=True)

            pushed = pushed_total(osds) - pushed0
            results["failure_storm_reached_clean"] = t_rec is not None
            if t_rec is not None:
                # only recorded when clean was reached: a sentinel like
                # -1.0 would read as a fast recovery exactly when the
                # cluster stopped converging (failure_storm_reached_clean
                # says it did not, and fails the run)
                results["failure_storm_time_to_clean_s"] = round(
                    t_rec, 2)
            # phase A recovery volume is whatever client writes landed
            # before the kill (informational: writes stall below
            # min_size, so the storm itself adds little to repair);
            # the guarded recovery-rate metric comes from phase B's
            # deterministic degraded-write workload
            results["failure_storm_storm_recovery_bytes"] = pushed
            backfill = [ms for t, ms, _ in lat
                        if window["t_revive"] is not None
                        and t >= window["t_revive"]]
            backfill.sort()
            results["failure_storm_backfill_p99_ms"] = round(
                backfill[int(0.99 * (len(backfill) - 1))], 1) \
                if backfill else 0.0
            degraded = [ms for t, ms, k in lat
                        if k == "read" and window["t_kill"] is not None
                        and window["t_kill"] <= t <
                        (window["t_revive"] or 1e18)]
            degraded.sort()
            results["failure_storm_degraded_p99_ms"] = round(
                degraded[int(0.99 * (len(degraded) - 1))], 1) \
                if degraded else 0.0
            results["failure_storm_degraded_reads"] = \
                stats["degraded_reads"]
            results["failure_storm_write_stalls"] = stats["stalls"]

            # time-resolved storm curve: per-second write MB/s and
            # client p99 across baseline -> kill -> degraded ->
            # backfill. The record carries the whole series (the curve
            # a flight-recorder timeline is read against) and its p99
            # area, which a latency regression ANYWHERE in the storm
            # inflates even when the end-state numbers recover
            if lat:
                t0x = lat[0][0]
                per_sec: dict[int, list] = {}
                for t, ms, kind in lat:
                    per_sec.setdefault(int(t - t0x), []).append((ms, kind))
                timeline = []
                for sec in sorted(per_sec):
                    sam = per_sec[sec]
                    mss = sorted(ms for ms, _ in sam)
                    writes = sum(1 for _, k in sam if k == "write")
                    timeline.append(
                        {"t": sec,
                         "write_mb_s": round(writes * obj / 1e6, 3),
                         "p99_ms": round(
                             mss[int(0.99 * (len(mss) - 1))], 2),
                         "reads": len(sam) - writes,
                         "writes": writes})
                results["failure_storm_timeline"] = timeline
                results["failure_storm_p99_area_ms_s"] = round(
                    sum(p["p99_ms"] for p in timeline), 1)
                if window["t_kill"] is not None:
                    results["failure_storm_kill_at_s"] = round(
                        window["t_kill"] - t0x, 2)
                if window["t_revive"] is not None:
                    results["failure_storm_revive_at_s"] = round(
                        window["t_revive"] - t0x, 2)

            # final verification: every object byte-identical to A
            # written generation — an uncertain (timed-out) write may
            # have landed late, but the bytes must never be garbage
            errors = stats["errors"]
            for oid, data in imm.items():
                if await io.read(oid) != data:
                    errors += 1
            for oid, gen in mut_gen.items():
                got = await io.read(oid)
                accept = range(gen + 3) if oid in uncertain \
                    else (gen, gen + 1)
                if not any(got == pattern(oid, g, obj) for g in accept):
                    errors += 1
            results["failure_storm_client_errors"] = errors
            results["failure_storm_read_stalls"] = stats["read_stalls"]
            log(f"failure_storm: clean={t_rec and round(t_rec, 1)}s "
                f"degraded_reads={stats['degraded_reads']} "
                f"errors={errors}")

            # -- phase B: single-shard repair-bytes ratio + recovery
            # rate over a DETERMINISTIC degraded-write workload.
            # Baselines exclude osd.0: it is about to be REPLACED by a
            # fresh instance whose counters start at zero, so including
            # its phase-A accumulation in f0 would subtract bytes that
            # no longer exist in f1 (skewing the ratio, possibly
            # negative) ------------------------------------------------
            f0, full0 = repair_totals(osds[1:])
            window["t_kill"] = window["t_revive"] = None
            await osds[0].stop()
            await wait_down(osds, [0])
            for i in range(16):
                oid = f"b{i:03d}"
                await io.write_full(oid, pattern(oid, 0, obj))
            pushed_b0 = pushed_total(osds[1:])
            osd = OSD(0, mon_addrs, store=stores[0], device=device)
            await osd.start()
            osds[0] = osd
            t_revive_b = loop.time()
            t_clean_b = await wait_clean(osds, "storm")
            pushed_b = pushed_total(osds) - pushed_b0
            rec_s = (t_clean_b - t_revive_b) if t_clean_b else None
            results["failure_storm_recovery_mb_s"] = round(
                pushed_b / rec_s / 1e6, 3) if rec_s else 0.0
            results["failure_storm_recovery_bytes"] = pushed_b
            f1, full1 = repair_totals(osds)
            fetched_b, full_b = f1 - f0, full1 - full0
            ratio = round(fetched_b / full_b, 4) if full_b else 1.0
            results["failure_storm_repair_ratio"] = ratio
            results["failure_storm_repair_fetched_mb"] = round(
                fetched_b / 1e6, 3)
            results["failure_storm_repair_full_equiv_mb"] = round(
                full_b / 1e6, 3)
            results["failure_storm_repair_clean"] = t_clean_b is not None
            for i in range(16):
                oid = f"b{i:03d}"
                if await io.read(oid) != pattern(oid, 0, obj):
                    results["failure_storm_client_errors"] += 1
            log(f"failure_storm: repair ratio {ratio} "
                f"({fetched_b} of {full_b} full-gather bytes)")

    asyncio.run(asyncio.wait_for(body(), 280))

    # -- phase C: flight-recorder drill — 3 OSDs killed AS A PROCESS.
    # A 6-OSD cluster over 2 worker processes (parent keeps mon +
    # client), worker shard1 (osds 0/2/4) SIGKILLed via the control
    # channel, a device fault armed on a survivor so the offload
    # breaker trips in worker shard2, then respawn and recover. The
    # merged `timeline dump` must tell the story in causal order
    # across >= 2 OS processes: injection -> mark-downs -> breaker
    # trip -> recovery-complete (OSD_DOWN health clear).
    async def drill():
        from ceph_tpu_torch import convert
        from ceph_tpu_torch.mgr.daemon import MgrDaemon
        from ceph_tpu_torch.tools.cluster_boot import ephemeral_cluster
        from ceph_tpu_torch.utils import flight

        flight.reset()              # focus the ring on this drill
        loop = asyncio.get_running_loop()

        async def wait_flight(etype, entity_sub="", timeout=60.0):
            deadline = loop.time() + timeout
            while loop.time() < deadline:
                for e in flight.dump(etype)["events"]:
                    if entity_sub in e["entity"]:
                        return True
                await asyncio.sleep(0.25)
            return False

        async with ephemeral_cluster(6, prefix="bench-drill-",
                                     reactor_procs=2, device=device) \
                as (client, osds, mon):
            mon_addrs = list(mon.monmap.mons.values())
            mgr = MgrDaemon(mon_addrs, modules=[], exporter_port=None)
            await mgr.start()
            try:
                await client.command({
                    "prefix": "osd erasure-code-profile set",
                    "name": "drillprof",
                    "profile": {**convert.port_profile(
                        {"plugin": "tpu", "k": "2", "m": "1"}),
                        "device": device}})
                await client.pool_create(
                    "drill", pg_num=4, pool_type="erasure",
                    erasure_code_profile="drillprof")
                io = client.ioctx("drill")
                obj = client.osdmap.get_pool("drill").stripe_width
                for i in range(6):
                    await io.write_full(f"d{i:02d}", bytes([i]) * obj)

                # kill worker shard1 = osds 0/2/4 (place = 1 + seq%2)
                pool_h = osds[0].pool
                dead = [0, 2, 4]
                await pool_h.inject_crash(1)
                deadline = loop.time() + 40.0
                down_ok = False
                while loop.time() < deadline and not down_ok:
                    m = mon.osdmon.osdmap
                    down_ok = all(i in m.osds and not m.osds[i].up
                                  for i in dead)
                    await asyncio.sleep(0.25)
                results["failure_storm_drill_marked_down"] = down_ok

                # breaker trip in the SURVIVING worker: threshold 1 +
                # armed device fault, then degraded writes until the
                # trip shows in shard2's ring
                surv = osds[1]                      # shard 2
                await surv.config_set(
                    "ec_offload_breaker_threshold", 1)
                await surv.admin({"prefix": "inject", "what": "device",
                                  "count": 2, "whoami": surv.whoami})
                tripped = False
                for i in range(40):
                    try:
                        await client.submit(
                            "drill", f"w{i:02d}",
                            [{"op": "write_full", "oid": f"w{i:02d}"}],
                            bytes([i]) * obj, timeout=4.0)
                    except Exception:
                        pass                # peering/remap in progress
                    try:
                        ring = await surv.admin(
                            {"prefix": "events dump",
                             "type": "breaker_trip"}, timeout=5.0)
                        tripped = bool(ring["events"])
                    except Exception:
                        tripped = False
                    if tripped:
                        break
                    await asyncio.sleep(0.25)
                results["failure_storm_drill_breaker_tripped"] = tripped

                # respawn the dead worker; recovery-complete = the
                # mon's OSD_DOWN health check clearing (a flight event
                # in the parent ring)
                await pool_h.respawn(1)
                recovered = await wait_flight("health_clear",
                                              "OSD_DOWN", timeout=60.0)
                results["failure_storm_drill_recovered"] = recovered

                # merge: every worker's ring over the control channel +
                # the parent ring + whatever the mgr's report fan-in
                # already collected (dedup by (boot, seq) makes the
                # overlap harmless)
                extra = []
                for ref in (osds[0], osds[1]):
                    try:
                        extra.append(await ref.admin("events dump",
                                                     timeout=5.0))
                    except Exception:
                        pass
                tl = mgr.timeline_dump(extra_rings=extra)
                ev = tl["events"]

                def first(etype, sub=""):
                    for i, e in enumerate(ev):
                        if e["type"] == etype and sub in e["entity"]:
                            return i
                    return None
                i_inj = first("inject_crash")
                i_down = first("osd_markdown")
                i_trip = first("breaker_trip")
                i_rec = first("health_clear", "OSD_DOWN")
                order = [i_inj, i_down, i_trip, i_rec]
                results["failure_storm_drill_causal_ok"] = (
                    None not in order and order == sorted(order))
                results["failure_storm_drill_events"] = len(ev)
                results["failure_storm_drill_processes"] = len(
                    tl["processes"])
                log(f"failure_storm drill: events={len(ev)} "
                    f"processes={tl['processes']} "
                    f"order={order} causal_ok="
                    f"{results['failure_storm_drill_causal_ok']}")
            finally:
                await mgr.stop()

    try:
        asyncio.run(asyncio.wait_for(drill(), 170))
    except Exception as e:
        # the drill is an observability demonstration: a flaky respawn
        # or health wait must not discard phase A/B's guarded numbers
        results["failure_storm_drill_error"] = \
            f"{type(e).__name__}: {e}"
        log(f"failure_storm drill failed: {type(e).__name__}: {e}")

    # -- phase D: asynclockdep drill — two primaries cross their scrub
    # reservations (each holds its own osd_max_scrubs slot while
    # reserving the other's). The in-process watchdog must see the
    # wait-for cycle while it is LIVE, the mgr must raise
    # DEADLOCK_SUSPECTED from the shipped wait annotations and clear it
    # once the reservation-timeout abort breaks the cross, and a replay
    # must reproduce a bit-identical witness digest. Lockdep's client
    # cost is A/B'd on the same write workload.
    async def deadlock_drill():
        from ceph_tpu_torch.mgr.daemon import MgrDaemon
        from ceph_tpu_torch.tools.cluster_boot import ephemeral_cluster
        from ceph_tpu_torch.utils import sanitizer

        loop = asyncio.get_running_loop()
        ring = {"osd.0:scrub_reservations", "osd.1:scrub_reservations"}

        def scrub_pgs(osds):
            out = {}
            for who in (0, 1):
                for pg in osds[who].pgs.values():
                    if pg.pool.name == "dl" and pg.is_primary() \
                            and pg.acting_peers():
                        out[who] = pg
                        break
            return out[0], out[1]

        async def crossed_round(osds, mgr):
            """One crossed-reservation deadlock: returns (in-process
            detect latency, observed witness digest, suspected-at-mgr
            flag, both rounds' results)."""
            pg0, pg1 = scrub_pgs(osds)
            t0 = loop.time()
            s0 = asyncio.ensure_future(pg0.scrub())
            s1 = asyncio.ensure_future(pg1.scrub())
            detect = digest = None
            suspected = False
            while loop.time() - t0 < 12.0 and not (detect and suspected):
                if detect is None:
                    scan = sanitizer.deadlock_scan(stuck_s=0.0)
                    for cyc in scan["cycles"]:
                        if set(cyc["resources"]) == ring:
                            detect = loop.time() - t0
                            digest = cyc["digest"]
                if not suspected:
                    try:
                        suspected = "DEADLOCK_SUSPECTED" in \
                            mgr._build_digest()["checks"] \
                            and mgr.deadlock_status()["suspected"]
                    except Exception:
                        suspected = False
                await asyncio.sleep(0.05)
            r0, r1 = await asyncio.gather(s0, s1)
            return detect, digest, suspected, r0, r1

        async with ephemeral_cluster(2, prefix="bench-dl-",
                                     device=device) \
                as (client, osds, mon):
            mgr = MgrDaemon(list(mon.monmap.mons.values()),
                            modules=[], exporter_port=None)
            await mgr.start()
            try:
                await client.pool_create("dl", pg_num=8, size=2)
                io = client.ioctx("dl")
                for i in range(8):
                    await io.write_full(f"d{i}", b"x" * 4096)

                async def client_burst(n=150, size=64 * 1024):
                    blob = b"y" * size
                    t = time.perf_counter()
                    for i in range(n):
                        await io.write_full(f"w{i % 32:02d}", blob)
                    return time.perf_counter() - t

                await client_burst(n=30)            # warm the path
                t_off = await client_burst()        # lockdep disarmed
                for o in osds:                      # arm via the knob
                    o.config.set("sanitizer_stuck_wait_s", 0.4)
                    o.config.set("sanitizer_lockdep", True)
                t_on = await client_burst()
                results["lockdep_overhead_pct"] = round(
                    (t_on - t_off) / t_off * 100.0, 2)

                # osd.0's shorter timeout makes it the deadlock breaker
                osds[0].config.set("osd_scrub_reserve_timeout", 3.0)
                osds[1].config.set("osd_scrub_reserve_timeout", 9.0)
                detect, digest, suspected, r0, r1 = \
                    await crossed_round(osds, mgr)
                results["deadlock_drill_detect_s"] = \
                    round(detect, 3) if detect is not None else None
                results["deadlock_drill_detected"] = (
                    detect is not None and detect < 2.0)
                results["deadlock_drill_witness_digest"] = digest
                results["deadlock_drill_suspected_raised"] = suspected
                # the abort path broke the cross: the breaker bailed,
                # the survivor's round ran to completion
                results["deadlock_drill_broken"] = (
                    bool(r0.get("reserve_failed"))
                    and not r1.get("reserve_failed")
                    and r1.get("errors") == 0)
                # ...and the health check clears once fresh reports
                # carry no annotations
                cleared = False
                deadline = loop.time() + 10.0
                while loop.time() < deadline and not cleared:
                    try:
                        cleared = "DEADLOCK_SUSPECTED" not in \
                            mgr._build_digest()["checks"]
                    except Exception:
                        cleared = False
                    await asyncio.sleep(0.25)
                results["deadlock_drill_suspected_cleared"] = cleared

                # replay: the witness digest fingerprints the resource
                # ring, not schedules or task names — a second crossed
                # round must reproduce it bit for bit
                detect2, digest2, _, _, _ = await crossed_round(osds,
                                                                mgr)
                results["deadlock_drill_replay_identical"] = (
                    digest is not None and digest == digest2)
                log(f"deadlock_drill: detect={detect and round(detect, 3)}s "
                    f"suspected={suspected} cleared={cleared} "
                    f"replay_ok={digest == digest2} "
                    f"lockdep_overhead={results['lockdep_overhead_pct']}%")
            finally:
                for o in osds:
                    try:
                        o.config.set("sanitizer_lockdep", False)
                    except Exception:
                        pass
                await mgr.stop()

    try:
        asyncio.run(asyncio.wait_for(deadlock_drill(), 140))
    except Exception as e:
        results["deadlock_drill_error"] = f"{type(e).__name__}: {e}"
        log(f"deadlock_drill failed: {type(e).__name__}: {e}")
    return results


def stage_interleave(device: str | None = None) -> dict:
    """The interlock qa sweep as a bench stage: seed-swept schedule
    exploration over a pipelined EC cluster (plugin cuda k=2 m=1 on
    `device`, where the reference's pool is jerasure), run three ways —
    explorer only (flight recorder off), explorer + full sanitizer
    (generation guards, lockset recorder, debug mode), and explorer +
    the full observability plane (flight recorder on + a live mgr
    sampling metrics history from every daemon's reports) — so the JSON
    line carries seeds run, distinct schedules explored, and BOTH
    overheads (a creeping guard or recorder cost would quietly price the
    qa tier out of CI)."""
    import asyncio

    t0 = time.perf_counter()
    device, platform = _cluster_device(device)
    SEEDS, N_OBJECTS, REPS = 12, 8, 2
    KI, MI = 2, 1
    OBJ = KI * 4096

    async def sweep(armed: bool,
                    recorder: bool = False) -> tuple[float, set, int]:
        from ceph_tpu_torch.qa import interleave
        from ceph_tpu_torch.tools.cluster_boot import ephemeral_cluster
        from ceph_tpu_torch.utils import flight, sanitizer
        digests: set = set()
        decisions = 0
        async with ephemeral_cluster(KI + MI, prefix="bench-ilv-",
                                     device=device) \
                as (client, osds, _mon):
            # the device plugin on `device`: a jerasure pool's stripes
            # go through its batched API on host arrays, which runs the
            # host codec (as in the reference) and never reaches the card
            await client.command({
                "prefix": "osd erasure-code-profile set",
                "name": "ilvprof",
                "profile": {"plugin": "cuda", "k": str(KI),
                            "m": str(MI), "device": device}})
            await client.pool_create("ilv", pg_num=1,
                                     pool_type="erasure",
                                     erasure_code_profile="ilvprof")
            io = client.ioctx("ilv")
            for o in osds:
                o.config.set("osd_pg_pipeline_depth", 4)
            loop = asyncio.get_running_loop()
            # the recorder mode measures the WHOLE observability plane:
            # flight ring armed + a live mgr whose report fan-in feeds
            # the metrics-history sampler; the other modes run with the
            # ring off so the baseline stays un-instrumented
            flight.configure(enabled=recorder)
            mgr = None
            if recorder:
                from ceph_tpu_torch.mgr.daemon import MgrDaemon
                mgr = MgrDaemon(list(_mon.monmap.mons.values()),
                                modules=[], exporter_port=None)
                await mgr.start()
            if armed:
                sanitizer.install(loop, slow_callback_s=5.0)
            try:
                # warm round outside the timed window
                await asyncio.gather(*[io.write_full(f"w{i}", bytes(OBJ))
                                       for i in range(4)])
                t1 = time.perf_counter()
                for seed in range(SEEDS):
                    async with interleave.explore(seed) as ex:
                        payloads = {
                            f"s{seed}-{i}":
                                bytes([32 + (seed * 7 + i) % 90]) * OBJ
                            for i in range(N_OBJECTS)}
                        await asyncio.gather(*[io.write_full(k, v)
                                               for k, v in
                                               payloads.items()])
                        for k, v in payloads.items():
                            assert await io.read(k) == v
                        digests.add(ex.digest())
                        decisions += ex.decisions
                elapsed = time.perf_counter() - t1
                if armed and sanitizer.lockset_conflicts():
                    raise AssertionError(
                        f"lockset conflicts under sweep: "
                        f"{sanitizer.lockset_conflicts()[:3]}")
            finally:
                if armed:
                    sanitizer.uninstall(loop)
                    sanitizer.clear_lockset_conflicts()
                if mgr is not None:
                    await mgr.stop()
                flight.configure(enabled=True)
        return elapsed, digests, decisions

    # alternate A/B/C and take per-mode minima: a shared host is noisy,
    # and min-of-reps is the steadier overhead estimator
    plain_s, armed_s, flight_s = [], [], []
    schedules: set = set()
    decisions = 0
    for _ in range(REPS):
        el, dg, dc = asyncio.run(asyncio.wait_for(sweep(False), 180))
        plain_s.append(el)
        schedules |= dg
        decisions += dc
        el, dg, dc = asyncio.run(asyncio.wait_for(sweep(True), 180))
        armed_s.append(el)
        schedules |= dg
        decisions += dc
        el, dg, dc = asyncio.run(asyncio.wait_for(
            sweep(False, recorder=True), 180))
        flight_s.append(el)
        schedules |= dg
        decisions += dc
    base, guarded, rec = min(plain_s), min(armed_s), min(flight_s)
    overhead = max(0.0, (guarded - base) / base * 100.0) if base else 0.0
    rec_overhead = max(0.0, (rec - base) / base * 100.0) if base else 0.0
    log(f"interleave: {SEEDS} seeds x {REPS} reps, "
        f"{len(schedules)} schedules, plain {base:.2f}s vs "
        f"sanitizer {guarded:.2f}s (+{overhead:.0f}%) vs "
        f"recorder+history {rec:.2f}s (+{rec_overhead:.0f}%)")
    return {
        "platform": platform,
        "interleave_seeds": SEEDS * REPS * 3,
        "interleave_schedules_explored": len(schedules),
        "interleave_decisions": decisions,
        "interleave_plain_s": round(base, 3),
        "interleave_sanitizer_s": round(guarded, 3),
        "interleave_sanitizer_overhead_pct": round(overhead, 1),
        "interleave_flight_s": round(rec, 3),
        "flight_history_overhead_pct": round(rec_overhead, 1),
        "elapsed_s": round(time.perf_counter() - t0, 1),
    }


# -- swarm: many-client fairness + per-client SLO observability ---------------

def stage_swarm(device: str | None = None) -> dict:
    """The multi-tenant lens, end to end on a live cluster (ROADMAP
    production-traffic item): >= 200 concurrent librados clients (mixed
    op sizes, zipfian hot keys, an injected slow-reader band) against
    an EC pool, with per-client SLO accounting armed on every OSD.
    Reports aggregate MB/s, the per-client p99 spread, and the
    fairness ratio max/median client p99 — the number an mClock-style
    QoS scheduler will be graded on — then verifies the observability
    pipeline under load: `ceph_client_*` families in a live exporter
    scrape, and the SLO_VIOLATIONS health check firing (and muting)
    under the slow-reader overload.

    The OSDs and the pool (plugin cuda k=2 m=1, where the reference's is
    jerasure) on `device`; the clients never open it."""
    import asyncio
    import re as _re

    t0 = time.perf_counter()
    # the stage's device, checked to exist, its context opened
    device, _platform = _cluster_device(device)
    results: dict = {}
    N_CLIENTS, SECONDS, N_OSDS = 200, 6.0, 4
    SLO_READ_MS, SLO_WRITE_MS = 250.0, 500.0

    async def _http_get(addr, path: str) -> str:
        reader, writer = await asyncio.open_connection(*addr)
        writer.write(f"GET {path} HTTP/1.0\r\n\r\n".encode())
        await writer.drain()
        blob = await reader.read()
        writer.close()
        return blob.split(b"\r\n\r\n", 1)[1].decode()

    async def _poll_health(client, want_check: str, present: bool,
                           timeout: float = 25.0) -> dict:
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        h: dict = {}
        while loop.time() < deadline:
            h = await client.command({"prefix": "health"})
            if (want_check in h.get("checks", {})) == present:
                return h
            await asyncio.sleep(0.5)
        return h

    async def body():
        import tempfile

        from ceph_tpu_torch.tools.rados_swarm import raise_fd_limit, run_swarm
        from ceph_tpu_torch.tools.vstart import VCluster

        raise_fd_limit()
        with tempfile.TemporaryDirectory(prefix="bench-swarm-") as base:
            c = VCluster(base, n_mons=1, n_osds=N_OSDS, with_mgr=True,
                         device=device)
            try:
                await c.start()
                cl = await c.client()
                await cl.command({
                    "prefix": "osd erasure-code-profile set",
                    "name": "swarmprof",
                    # the device plugin: a jerasure pool's batched
                    # stripes run the host codec, in both packages, and
                    # would never reach the card
                    "profile": {"plugin": "cuda", "k": "2", "m": "1",
                                "device": device}})
                await cl.pool_create("swarm", pg_num=8,
                                     pool_type="erasure",
                                     erasure_code_profile="swarmprof")
                # arm the SLO engine hot on every OSD (the observer
                # pushes straight into the live ClientTable)
                for osd in c.osds.values():
                    osd.config.set("slo_read_ms", SLO_READ_MS)
                    osd.config.set("slo_write_ms", SLO_WRITE_MS)
                # the clients wait 60 s an attempt and an op, as the
                # reference's scrub and QoS storm fleets do: at the
                # default 5 s attempt a write queued past it is resent,
                # superseded on its hot object and answered EIO
                # ("outcome unknowable"; ROADMAP §3)
                out = await run_swarm(
                    c.mon_addrs, "swarm", clients=N_CLIENTS,
                    seconds=SECONDS, objects=128, slow_readers=16,
                    connect_batch=40, op_timeout=60.0)
                out.pop("per_client", None)
                results["swarm_clients"] = out["clients"]
                results["swarm_mb_s"] = out["mb_s"]
                results["swarm_read_mb_s"] = out["read_mb_s"]
                results["swarm_write_mb_s"] = out["write_mb_s"]
                results["swarm_iops"] = out["iops"]
                results["swarm_errors"] = out["errors"]
                results["swarm_connect_s"] = out["connect_s"]
                results["swarm_client_p99_median_ms"] = \
                    out["median_p99_ms"]
                results["swarm_client_p99_max_ms"] = out["max_p99_ms"]
                results["swarm_p99_fairness"] = out["p99_fairness"]
                log(f"swarm: {out['clients']} clients {out['mb_s']} "
                    f"MB/s p99 med/max {out['median_p99_ms']}/"
                    f"{out['max_p99_ms']}ms fairness "
                    f"{out['p99_fairness']} errors={out['errors']}")

                # per-client accounting really landed on the OSDs
                tables = [o.optracker.clients.dump_clients(limit=1)
                          for o in c.osds.values()]
                results["swarm_osd_clients_tracked"] = sum(
                    t["num_clients"] for t in tables)

                # SLO_VIOLATIONS must FIRE under the overload...
                h = await _poll_health(cl, "SLO_VIOLATIONS", True)
                results["swarm_slo_fired"] = \
                    "SLO_VIOLATIONS" in h.get("checks", {})
                # ...the exporter must carry ceph_client_* families...
                text = await _http_get(c.mgr.exporter.addr, "/metrics")
                fams = sorted(set(_re.findall(
                    r"# TYPE (ceph_client_[a-z0-9_]+)", text)))
                series = sorted(set(_re.findall(
                    r'ceph_client="([^"]+)"', text)))
                results["swarm_client_families"] = len(fams)
                results["swarm_client_series"] = len(series)
                results["swarm_client_series_capped"] = \
                    len(series) <= 64
                log(f"swarm: exporter {len(fams)} ceph_client_* "
                    f"families, {len(series)} client series "
                    f"(fired={results['swarm_slo_fired']})")
                # ...and the check must MUTE on request
                await cl.command({"prefix": "health mute",
                                  "code": "SLO_VIOLATIONS", "ttl": 120})
                h = await _poll_health(cl, "SLO_VIOLATIONS", False,
                                       timeout=10.0)
                results["swarm_slo_muted"] = (
                    "SLO_VIOLATIONS" not in h.get("checks", {})
                    and "SLO_VIOLATIONS" in h.get("muted", {}))
                log(f"swarm: SLO_VIOLATIONS muted="
                    f"{results['swarm_slo_muted']}")
                # time-resolved leg: the mgr's metrics history sampled
                # the whole storm through the MMgrReport fan-in — emit
                # each OSD's per-second op-rate curve (the SHAPE the
                # QoS work will be graded on) plus the windowed p99
                # the history math recomputes from the bucket deltas
                hist = c.mgr.daemon_index.history
                curves = {}
                for daemon, samples in hist.series("op").items():
                    curves[daemon] = [
                        round((b - a) / max(tb - ta, 1e-9), 1)
                        for (ta, a), (tb, b) in zip(samples,
                                                    samples[1:])][-12:]
                results["swarm_op_rate_series"] = curves
                q = hist.query("op_total_us", window_s=SECONDS + 30)
                results["swarm_history_p99_ms"] = {
                    d: e.get("p99_ms")
                    for d, e in q["daemons"].items()}
                hst = hist.status()
                results["swarm_history_series"] = hst["series"]
                log(f"swarm: mgr history {hst['series']} series over "
                    f"{hst['daemons']} daemons, per-second op curves "
                    f"for {len(curves)} OSD(s)")
            finally:
                await c.stop()

    asyncio.run(asyncio.wait_for(body(), 280))
    results["elapsed_s"] = round(time.perf_counter() - t0, 1)
    return results


def stage_qos_storm(device: str | None = None) -> dict:
    """The dmclock QoS scheduler graded under a 1000-client storm with
    three adversarial tenants (hot-keyed bully, byte-heavy streamer,
    metadata-spammer) and a paced victim band, A/B against the legacy
    WRR path:

      0. polite-fleet baseline: the same paced majority + victim band
         with NO adversaries — the same-scale control that anchors the
         victim SLO and the fairness floor;
      A. scheduler OFF: the adversaries hog, the victim's p99 and the
         well-behaved fairness spread are the documented "worse" side;
      B. hot-toggle `osd_mclock_enabled` + per-tenant profiles (victim
         reservation, adversary limits) ON — same storm, plus an OSD
         kill/revive so RECOVERY must make progress through its
         reserved share while the storm rages;
      C. overload/shed: policy flipped to `shed` with a tight queue
         depth — adversary backlogs past the cap must be refused with
         MOSDOpThrottle (client-visible `throttled_ops`), every shed
         visible as a flight-recorder crumb and a per-tenant counter,
         and the admitted ops' p99 stays bounded.

    Also verifies the observability leg live: per-tenant `ceph_qos_*`
    families in an exporter scrape and nonzero mgr-side aggregation.

    The OSDs and the pool (plugin cuda k=2 m=2, where the reference's is
    jerasure) on `device`; the clients never open it."""
    import asyncio
    import re as _re

    t0 = time.perf_counter()
    # the stage's device, checked to exist, its context opened
    device, _platform = _cluster_device(device)
    results: dict = {}
    N_CLIENTS, N_PROCS, SECONDS, N_OSDS = 1000, 3, 8.0, 4
    N_BULLY, N_STREAM, N_SPAM, N_VICTIM = 24, 24, 24, 64
    VICTIM_SLO_MS = 600.0
    # per-tenant profiles the ON phases run with: the victim band gets
    # a guaranteed reservation slice, the adversaries get hard limits
    # (cost-units/sec per OSD; a 4k op costs ~1.06 units). The
    # well-behaved majority is PACED (dmclock's evaluation shape:
    # constrained clients vs unconstrained hogs) — an unpaced majority
    # is its own DDoS and drowns the adversaries it is supposed to be
    # protected from. Limits are sized so polite demand + admitted
    # adversary throughput fits the box's measured service capacity:
    # dmclock arbitrates the queue, and a queue only forms around
    # capacity that exists.
    PROFILES = {"victim": {"reservation": 40.0, "weight": 4.0},
                "bully": {"limit": 4.0, "weight": 0.25},
                "streamer": {"limit": 4.0, "weight": 0.25},
                "spammer": {"limit": 6.0, "weight": 0.25}}

    async def _http_get(addr, path: str) -> str:
        reader, writer = await asyncio.open_connection(*addr)
        writer.write(f"GET {path} HTTP/1.0\r\n\r\n".encode())
        await writer.drain()
        blob = await reader.read()
        writer.close()
        return blob.split(b"\r\n\r\n", 1)[1].decode()

    async def body():
        import tempfile

        from ceph_tpu_torch.tools.rados_swarm import raise_fd_limit, run_swarm
        from ceph_tpu_torch.tools.vstart import VCluster
        from ceph_tpu_torch.utils import flight

        raise_fd_limit(16384)
        storm_kw = dict(
            clients=N_CLIENTS, seconds=SECONDS, objects=128,
            slow_readers=0, bullies=N_BULLY, streamers=N_STREAM,
            spammers=N_SPAM, victims=N_VICTIM, victim_iops=0.5,
            normal_iops=0.1, adversary_depth=5, procs=N_PROCS,
            connect_batch=16, op_timeout=150.0, settle_s=3.0)
        with tempfile.TemporaryDirectory(prefix="bench-qos-") as base:
            c = VCluster(base, n_mons=1, n_osds=N_OSDS, with_mgr=True,
                         device=device)
            try:
                await c.start()
                cl = await c.client()
                cl.OP_TIMEOUT = 60.0   # degraded writes ride peering
                # k=2,m=2 (size 4, min_size 3): one OSD down still
                # leaves min_size live shards, so the phase-B degraded
                # writes proceed instead of blocking on the interval.
                # The device plugin: a jerasure pool's batched stripes
                # run the host codec, in both packages, and would never
                # reach the card
                await cl.command({
                    "prefix": "osd erasure-code-profile set",
                    "name": "swarmprof",
                    "profile": {"plugin": "cuda", "k": "2",
                                "m": "2", "device": device}})
                await cl.pool_create("swarm", pg_num=8,
                                     pool_type="erasure",
                                     erasure_code_profile="swarmprof")

                # -- phase 0: polite-fleet baseline -------------------
                # the no-adversary control at the SAME connection
                # scale: the whole paced majority + victim band, no
                # hogs. Its victim p99 anchors the SLO and its
                # demand-fairness is the platform floor — the grades
                # below measure adversary-caused degradation, not the
                # absolute speed of whatever core-count this
                # container happens to have (a victims-only baseline
                # would hide the 1000-connection event-loop floor and
                # bill it to the adversaries).
                n_adv = N_BULLY + N_STREAM + N_SPAM
                pb = await run_swarm(
                    c.mon_addrs, "swarm",
                    **dict(storm_kw, clients=N_CLIENTS - n_adv,
                           bullies=0, streamers=0, spammers=0),
                    client_prefix="qz")
                slo_ms = max(VICTIM_SLO_MS,
                             2.0 * pb["victim_p99_ms"])
                results["qos_victim_baseline_p99_ms"] = \
                    pb["victim_p99_ms"]
                results["qos_baseline_fairness"] = \
                    pb["demand_fairness"]
                results["qos_baseline_errors"] = pb["errors"]
                log(f"qos baseline: {pb['clients']} polite clients "
                    f"fairness {pb['demand_fairness']} victim p99 "
                    f"{pb['victim_p99_ms']}ms -> SLO {slo_ms}ms")

                # -- phase A: scheduler OFF (legacy WRR) --------------
                off = await run_swarm(c.mon_addrs, "swarm",
                                      client_prefix="qa", **storm_kw)
                results["qos_storm_clients"] = off["clients"]
                results["qos_storm_procs"] = off["procs"]
                results["qos_errors_off"] = off["errors"]
                results["qos_fairness_ratio_off"] = \
                    off["demand_fairness"]
                results["qos_victim_isolation_off"] = \
                    off["victim_isolation"]
                results["qos_client_spread_off"] = off["good_fairness"]
                results["qos_victim_p99_off_ms"] = off["victim_p99_ms"]
                results["qos_victim_ops_off"] = \
                    off["per_tenant"].get("victim", {}).get("ops", 0)
                results["qos_goodput_off_mb_s"] = off["goodput_mb_s"]
                results["qos_mb_s_off"] = off["mb_s"]
                log(f"qos OFF: {off['clients']} clients fairness "
                    f"{off['demand_fairness']} victim p99 "
                    f"{off['victim_p99_ms']}ms goodput "
                    f"{off['goodput_mb_s']} MB/s errors={off['errors']}")

                # -- phase B: hot-toggle ON + recovery under storm ----
                for osd in c.osds.values():
                    osd.config.set("osd_mclock_tenant_profiles",
                                   json.dumps(PROFILES))
                    # recovery must CLEAR within the storm window, not
                    # trickle at the stock 4/s — client ops on a still-
                    # degraded object block on its recovery, so a slow
                    # reservation would punish exactly the tenants the
                    # scheduler protects
                    osd.config.set("osd_mclock_recovery_reservation",
                                   14.0)
                    osd.config.set("osd_mclock_enabled", True)
                # kill + degraded writes + revive: the revived OSD must
                # catch up THROUGH the scheduler's recovery reservation
                # while the storm runs. The degraded set is DEDICATED
                # `rec-*` objects no storm client touches: recovery of
                # an object gates client IO to it, and degrading storm
                # objects would measure recovery blocking, not
                # arbitration. 200 objects at ~12 pushes/s/OSD
                # (reservation 14, push cost ~1.2) keeps recovery
                # in flight across the whole storm window.
                victim_osd = N_OSDS - 1
                await c.kill_osd(victim_osd)
                io = cl.ioctx("swarm")
                for base in range(0, 200, 50):
                    await asyncio.gather(*[
                        io.write_full(f"rec-{r:04d}", bytes(16384))
                        for r in range(base, base + 50)])
                await c.start_osd(victim_osd)
                # let peering settle before the graded window opens —
                # ops parked on waiting_for_active measure peering,
                # not the arbitration under test (recovery itself
                # keeps running through the storm)
                await asyncio.sleep(5.0)
                on = await run_swarm(c.mon_addrs, "swarm",
                                     client_prefix="qb", **storm_kw)
                results["qos_errors_on"] = on["errors"]
                results["qos_fairness_ratio"] = on["demand_fairness"]
                results["qos_victim_isolation"] = \
                    on["victim_isolation"]
                results["qos_client_spread"] = on["good_fairness"]
                results["qos_victim_ops"] = \
                    on["per_tenant"].get("victim", {}).get("ops", 0)
                results["qos_victim_p99_ms"] = on["victim_p99_ms"]
                results["qos_goodput_mb_s"] = on["goodput_mb_s"]
                results["qos_mb_s_on"] = on["mb_s"]
                results["qos_victim_slo_ms"] = slo_ms
                results["qos_victim_slo_ok"] = bool(
                    0 < on["victim_p99_ms"] <= 4 * slo_ms)
                # graded bar: ON fairness within 1.5 absolute, or
                # within 1.5x of the no-adversary floor when the
                # platform itself cannot hold 1.5 at this scale
                results["qos_fairness_ok"] = bool(
                    on["demand_fairness"] <= max(
                        1.5, 1.5 * pb["demand_fairness"]))
                pushes = sum(
                    (o.perf.dump().get("recovery_push") or 0)
                    for o in c.osds.values())
                results["qos_recovery_pushes"] = pushes
                deferred = sum(o.op_queue.sched.total_deferred
                               for o in c.osds.values())
                results["qos_deferred_waits"] = deferred
                qs = c.osds[0].op_queue.qos_status()
                results["qos_status_entities"] = len(qs["entities"])
                results["qos_status_enabled"] = qs["enabled"]
                log(f"qos ON: fairness {on['demand_fairness']} victim "
                    f"p99 {on['victim_p99_ms']}ms goodput "
                    f"{on['goodput_mb_s']} MB/s recovery pushes "
                    f"{pushes} deferred {deferred} "
                    f"errors={on['errors']}")

                # -- phase C: overload admission control (shed) -------
                for osd in c.osds.values():
                    osd.config.set("osd_mclock_overload_policy", "shed")
                    osd.config.set("osd_mclock_shed_queue_depth", 8)
                shed_kw = dict(storm_kw, clients=300, procs=N_PROCS,
                               seconds=4.0, bullies=60, streamers=30,
                               spammers=60, victims=30)
                shed = await run_swarm(c.mon_addrs, "swarm",
                                       client_prefix="qc", **shed_kw)
                sheds = sum(o.op_queue.sched.total_shed
                            for o in c.osds.values())
                results["qos_shed_total"] = sheds
                results["qos_throttled_ops"] = shed["throttled_ops"]
                results["qos_shed_errors"] = shed["errors"]
                results["qos_admitted_p99_ms"] = shed["victim_p99_ms"]
                results["qos_shed_crumbs"] = len(
                    flight.dump(etype="qos_shed")["events"])
                results["qos_backpressure_crumbs"] = len(
                    flight.dump(etype="qos_backpressure")["events"])
                log(f"qos SHED: {sheds} shed, "
                    f"{shed['throttled_ops']} client-visible "
                    f"throttles, admitted victim p99 "
                    f"{shed['victim_p99_ms']}ms, "
                    f"{results['qos_shed_crumbs']} crumbs")

                # -- observability leg: mgr aggregation + exporter ----
                await asyncio.sleep(2.0)   # one report period
                agg = c.mgr.daemon_index.qos_aggregate()
                results["qos_mgr_tenants"] = len(agg)
                text = await _http_get(c.mgr.exporter.addr, "/metrics")
                fams = sorted(set(_re.findall(
                    r"# TYPE (ceph_qos_[a-z0-9_]+)", text)))
                series = sorted(set(_re.findall(
                    r'ceph_qos_[a-z0-9_]+\{tenant="([^"]+)"', text)))
                results["qos_exporter_families"] = len(fams)
                results["qos_tenant_series"] = len(series)
                log(f"qos obs: mgr {len(agg)} tenants, exporter "
                    f"{len(fams)} ceph_qos_* families over "
                    f"{len(series)} tenant series")
            finally:
                await c.stop()

    asyncio.run(asyncio.wait_for(body(), 520))
    results["elapsed_s"] = round(time.perf_counter() - t0, 1)
    return results


def stage_scrub_storm(device: str | None = None) -> dict:
    """Continuous integrity verification graded as a background
    workload on an 11-OSD CLAY(k=8,m=3,d=10, scalar_mds=tpu) pool:

      1. hash-path calibration: one clean deep-scrub round with host
         crc, one with the device CrcJob path (`ec_offload_crc_device`
         hot-flipped) — `scrub_mb_s` is the device round, the ratio is
         the device-vs-host grade, and the offload batch counters
         prove the digests really rode the CrcJob path;
      2. interference A/B: a paced swarm fleet measured with scrub
         OFF, then the same fleet with continuous deep-scrub rounds
         churning underneath — bit-rot injected on 12 objects via the
         faultinject hook right before the ON window, so detection
         latency (first scrub_mismatch flight crumb) and repair
         correctness (CLAY single-shard rebuild + read-back) are
         measured UNDER client load, and the victim p99 ratio is the
         interference grade (bar: <= 1.25x);
      3. health round-trip: fresh rot -> one deep round raises
         PG_DAMAGED + OSD_SCRUB_ERRORS through the report leg (and the
         exporter serves ceph_scrub_* families) -> a clean round
         retires the registry -> both checks clear.

    The OSDs on `device`, clay's MDS code `cuda` on it (the reference's
    `tpu`): the calibration's device round hashes through K2, the
    loaded phases on the host, as in the reference."""
    import asyncio
    import re as _re

    t0 = time.perf_counter()
    # the stage's device, checked to exist, its context opened
    device, _platform = _cluster_device(device)
    results: dict = {}
    N_OSDS, K8, M3, D10 = 11, 8, 3, 10
    N_ROT, N_ROT2 = 12, 3
    N_CLIENTS, N_PROCS, SECONDS = 200, 2, 6.0

    async def _http_get(addr, path: str) -> str:
        reader, writer = await asyncio.open_connection(*addr)
        writer.write(f"GET {path} HTTP/1.0\r\n\r\n".encode())
        await writer.drain()
        blob = await reader.read()
        writer.close()
        return blob.split(b"\r\n\r\n", 1)[1].decode()

    async def body():
        import tempfile

        from ceph_tpu_torch import convert
        from ceph_tpu_torch.offload import service as offload
        from ceph_tpu_torch.osd import scrub as scrub_mod
        from ceph_tpu_torch.tools.rados_swarm import raise_fd_limit, run_swarm
        from ceph_tpu_torch.tools.vstart import VCluster
        from ceph_tpu_torch.utils import flight

        raise_fd_limit(16384)
        storm_kw = dict(
            clients=N_CLIENTS, seconds=SECONDS, objects=96,
            slow_readers=0, bullies=0, streamers=0, spammers=0,
            victims=48, victim_iops=0.5, normal_iops=0.1,
            adversary_depth=1, procs=N_PROCS, connect_batch=16,
            op_timeout=60.0, settle_s=2.0)
        with tempfile.TemporaryDirectory(prefix="bench-scrub-") as base:
            c = VCluster(base, n_mons=1, n_osds=N_OSDS, with_mgr=True,
                         device=device)
            try:
                await c.start()
                cl = await c.client()
                cl.OP_TIMEOUT = 60.0
                await cl.command({
                    "prefix": "osd erasure-code-profile set",
                    "name": "scrubprof",
                    # clay's MDS code in the port's plugin names
                    # (tpu -> cuda) on the stage's device
                    "profile": {**convert.port_profile(
                        {"plugin": "clay", "k": str(K8), "m": str(M3),
                         "d": str(D10), "scalar_mds": "tpu"}),
                        "device": device}})
                await cl.pool_create("swarm", pg_num=8,
                                     pool_type="erasure",
                                     erasure_code_profile="scrubprof")
                io = cl.ioctx("swarm")
                # the periodic scheduler must not fire mid-grade: every
                # round below is triggered explicitly. Small ranges +
                # an inter-range breather keep each write-gate hold
                # short — the gate covers one 4-object slice, and the
                # sleep (taken with the gate OPEN) lets queued client
                # writes drain between slices.
                for osd in c.osds.values():
                    osd.config.set("osd_scrub_interval", 100000.0)
                    osd.config.set("osd_scrub_chunk_max", 4)
                    osd.config.set("osd_scrub_sleep", 0.02)
                pool = cl.osdmap.get_pool("swarm")
                obj_bytes = 2 * pool.stripe_width
                payloads = {f"rot-{i:03d}": os.urandom(obj_bytes)
                            for i in range(128)}
                names = sorted(payloads)
                for i in range(0, len(names), 32):
                    await asyncio.gather(*[
                        io.write_full(n, payloads[n])
                        for n in names[i:i + 32]])
                results["scrub_storm_osds"] = N_OSDS
                results["scrub_storm_object_bytes"] = obj_bytes

                async def deep_round():
                    """One explicit deep round over every primary PG,
                    OSD by OSD (gates stagger instead of slamming every
                    PG at once); returns the cross-PG aggregate."""
                    rt = time.perf_counter()
                    agg = {"errors": 0, "repaired": 0, "bytes": 0,
                           "objects": 0}
                    for osd in c.osds.values():
                        for res in (await osd.scrub_all(
                                deep=True)).values():
                            if res:
                                agg["errors"] += res["errors"]
                                agg["repaired"] += res["repaired"]
                                agg["bytes"] += res["bytes_hashed"]
                                agg["objects"] += res["objects"]
                    agg["dt"] = time.perf_counter() - rt
                    return agg

                # -- phase 1: host vs device hashing calibration ------
                host = await deep_round()
                assert host["errors"] == 0, host
                host_mb_s = host["bytes"] / max(host["dt"], 1e-9) / 2**20
                results["scrub_hash_host_mb_s"] = round(host_mb_s, 2)
                # the guarded throughput number is the SHIPPING path —
                # host-native CrcJob batches through the offload
                # service (crc_device stays a measured experiment)
                results["scrub_mb_s"] = round(host_mb_s, 2)
                svc = offload.get_service()
                c.osds[0].config.set("ec_offload_crc_device", True)
                sperf = scrub_mod.scrub_perf()
                b_before = svc.stats["batches"]
                h_before = sperf.dump()["digest_batch_blocks"]["count"]
                dev = await deep_round()
                assert dev["errors"] == 0, dev
                dev_mb_s = dev["bytes"] / max(dev["dt"], 1e-9) / 2**20
                results["scrub_hash_device_mb_s"] = round(dev_mb_s, 2)
                results["scrub_device_vs_host_hash_ratio"] = round(
                    dev_mb_s / max(host_mb_s, 1e-9), 3)
                results["scrub_offload_batches"] = \
                    svc.stats["batches"] - b_before
                results["scrub_digest_batches"] = \
                    sperf.dump()["digest_batch_blocks"]["count"] \
                    - h_before
                # back to the host-native CrcJob dispatch for the
                # loaded phases, as the reference does: the setting is
                # module-wide (every OSD of this process), and the
                # interference grade below compares the fleet with and
                # without scrub on the reference's host path
                c.osds[0].config.set("ec_offload_crc_device", False)
                log(f"scrub hash: host {results['scrub_hash_host_mb_s']}"
                    f" MB/s, device {results['scrub_hash_device_mb_s']}"
                    f" MB/s over {results['scrub_offload_batches']} "
                    f"offload batches")

                # -- phase 2a: swarm baseline, scrub OFF --------------
                off = await run_swarm(c.mon_addrs, "swarm",
                                      client_prefix="so", **storm_kw)
                p99_off = off["victim_p99_ms"]
                results["scrub_client_p99_off_ms"] = p99_off
                results["scrub_baseline_errors"] = off["errors"]
                log(f"scrub OFF baseline: victim p99 {p99_off}ms "
                    f"errors={off['errors']}")

                # -- phase 2b: bit-rot + swarm with scrub churning ----
                rot = names[:N_ROT]
                osd_ids = sorted(c.osds)
                for i, oid in enumerate(rot):
                    r = await c.osds[osd_ids[i % N_OSDS]] \
                        ._inject_bitrot(oid)
                    assert r.get("injected") == "bitrot", r
                t_inject = time.monotonic()
                results["scrub_bitrot_injected"] = len(rot)

                churn = {"errors": 0, "repaired": 0, "bytes": 0,
                         "rounds": 0, "busy_s": 0.0}
                stop = asyncio.Event()
                prim_pgs = [pg for osd in c.osds.values()
                            for pg in osd.pgs.values()
                            if pg.is_primary() and pg.state == "active"]

                async def scrub_churn():
                    """Continuous verification shaped for live
                    clusters: ONE PG's deep round at a time with a
                    breather between — the whole-round write gate only
                    ever covers one PG, so a colliding client write
                    waits one short round, not a full sweep."""
                    i = 0
                    while not stop.is_set():
                        pg = prim_pgs[i % len(prim_pgs)]
                        i += 1
                        rt = time.perf_counter()
                        res = await pg.scrub(deep=True)
                        churn["busy_s"] += time.perf_counter() - rt
                        churn["errors"] += res["errors"]
                        churn["repaired"] += res["repaired"]
                        churn["bytes"] += res["bytes_hashed"]
                        churn["rounds"] += 1
                        try:
                            await asyncio.wait_for(stop.wait(), 0.25)
                        except asyncio.TimeoutError:
                            pass

                churn_task = asyncio.get_running_loop().create_task(
                    scrub_churn())
                try:
                    on = await run_swarm(c.mon_addrs, "swarm",
                                         client_prefix="sn", **storm_kw)
                finally:
                    stop.set()
                    await churn_task
                # sweep the stragglers: PGs whose turn never came in
                # the loaded window still owe their detection + repair
                sweep = await deep_round()
                churn["errors"] += sweep["errors"]
                churn["repaired"] += sweep["repaired"]
                p99_on = on["victim_p99_ms"]
                results["scrub_client_p99_on_ms"] = p99_on
                results["scrub_storm_client_errors"] = on["errors"]
                results["scrub_rounds_under_load"] = churn["rounds"]
                results["scrub_errors_found"] = churn["errors"]
                results["scrub_errors_repaired"] = churn["repaired"]
                results["scrub_under_load_mb_s"] = round(
                    churn["bytes"] / max(churn["busy_s"], 1e-9) / 2**20,
                    2)
                results["scrub_client_p99_interference_pct"] = round(
                    100.0 * p99_on / max(p99_off, 1e-9), 1)
                results["scrub_interference_ok"] = bool(
                    p99_on <= 1.25 * p99_off)
                mism = [e for e in
                        flight.dump(etype="scrub_mismatch")["events"]
                        if e["detail"].get("oid", "").startswith("rot-")]
                if mism:
                    results["scrub_detect_latency_s"] = round(
                        min(e["mono"] for e in mism) - t_inject, 3)
                results["scrub_repair_crumbs"] = len(
                    flight.dump(etype="scrub_repair")["events"])
                bad = 0
                for oid in rot:
                    if await io.read(oid) != payloads[oid]:
                        bad += 1
                results["scrub_repair_readback_bad"] = bad
                log(f"scrub ON: {churn['rounds']} rounds under load, "
                    f"{churn['errors']} found {churn['repaired']} "
                    f"repaired, detect "
                    f"{results.get('scrub_detect_latency_s')}s, victim "
                    f"p99 {p99_on}ms vs {p99_off}ms off "
                    f"({results['scrub_client_p99_interference_pct']}%)"
                    f" readback_bad={bad}")

                # -- phase 3: health raise -> exporter -> clear -------
                rot2 = names[N_ROT:N_ROT + N_ROT2]
                for i, oid in enumerate(rot2):
                    r = await c.osds[osd_ids[(i + 5) % N_OSDS]] \
                        ._inject_bitrot(oid)
                    assert r.get("injected") == "bitrot", r
                hr = await deep_round()
                assert hr["errors"] >= len(rot2), hr
                registry = sum(
                    o._list_inconsistent(None)["objects"]
                    for o in c.osds.values())
                results["scrub_registry_objects"] = registry

                async def health_has(*codes):
                    h = await cl.command({"prefix": "health detail"})
                    return all(code in h["checks"] for code in codes)

                deadline = asyncio.get_running_loop().time() + 30
                raised = False
                while asyncio.get_running_loop().time() < deadline:
                    if await health_has("PG_DAMAGED",
                                        "OSD_SCRUB_ERRORS"):
                        raised = True
                        break
                    await asyncio.sleep(0.5)
                results["scrub_health_raised"] = raised
                text = await _http_get(c.mgr.exporter.addr, "/metrics")
                fams = sorted(set(_re.findall(
                    r"# TYPE (ceph_scrub_[a-z0-9_]+)", text)))
                results["scrub_exporter_families"] = len(fams)
                clean = await deep_round()
                assert clean["errors"] == 0, clean
                deadline = asyncio.get_running_loop().time() + 30
                cleared = False
                while asyncio.get_running_loop().time() < deadline:
                    if not await health_has("PG_DAMAGED") \
                            and not await health_has(
                                "OSD_SCRUB_ERRORS"):
                        cleared = True
                        break
                    await asyncio.sleep(0.5)
                results["scrub_health_cleared"] = cleared
                log(f"scrub health: raised={raised} cleared={cleared} "
                    f"{len(fams)} ceph_scrub_* exporter families, "
                    f"registry held {registry} objects")
            finally:
                await c.stop()

    asyncio.run(asyncio.wait_for(body(), 520))
    results["elapsed_s"] = round(time.perf_counter() - t0, 1)
    return results


def _zero_keys(out: dict) -> list[str]:
    """Numeric results that read zero or less (a measurement that did
    not happen), but for the keys whose zero is a reading."""
    return sorted(k for k, v in out.items()
                  if isinstance(v, (int, float)) and not isinstance(v, bool)
                  and v <= 0 and k not in ZERO_IS_A_READING)


#: each stage's flags: one that reads False, or is missing, fails the
#: run. The curves' bit-identity across their runs; the failure storm's
#: mark-down, recovery to clean and clay repair, its flight-recorder
#: drill and its deadlock drill; the swarm's SLO check fired and muted
#: and its client series capped; the scrub storm's health raised and
#: cleared; the QoS storm's fairness under the scheduler. The scrub
#: storm's `scrub_interference_ok` is recorded, not gated: it grades the
#: victim p99 with scrub on against scrub off, a latency of one
#: host-bound event loop (it read False for the reference on a CPU
#: host), not a correctness result. So is the QoS storm's
#: `qos_victim_slo_ok`, for the same reason: it grades about the third
#: slowest of a few hundred victim ops against 4x a baseline p99, and it
#: read False on one card host in the reference's own configuration
#: (its jerasure pool) as well as on the port's
FLAG_KEYS = {
    "mesh_scaling": ("scaling_bit_identical",),
    "cluster_tpu": ("pipeline_bit_identical", "reactor_shard_bit_identical",
                    "reactor_proc_bit_identical", "scaling_bit_identical"),
    "failure_storm": (
        "failure_storm_marked_down", "failure_storm_reached_clean",
        "failure_storm_repair_clean", "failure_storm_drill_marked_down",
        "failure_storm_drill_breaker_tripped",
        "failure_storm_drill_recovered", "failure_storm_drill_causal_ok",
        "deadlock_drill_detected", "deadlock_drill_suspected_raised",
        "deadlock_drill_broken", "deadlock_drill_suspected_cleared",
        "deadlock_drill_replay_identical"),
    "swarm": ("swarm_slo_fired", "swarm_slo_muted",
              "swarm_client_series_capped"),
    "scrub_storm": ("scrub_health_raised", "scrub_health_cleared"),
    "qos_storm": ("qos_fairness_ok",),
}

#: each stage's counts of wrong results: above 0 fails the run
ERROR_COUNT_KEYS = {
    "failure_storm": ("failure_storm_client_errors",),
    "swarm": ("swarm_errors",),
    "scrub_storm": ("scrub_storm_client_errors", "scrub_baseline_errors",
                    "scrub_repair_readback_bad"),
    "qos_storm": ("qos_baseline_errors", "qos_errors_off", "qos_errors_on",
                  "qos_shed_errors")}

#: the stderr line on which `main` reports a device run's kernel
#: launches and host fallbacks in this process (a stage's own
#: processes; its worker processes count theirs)
LAUNCH_LINE = "bench_driver: launches in this process "


def launch_counts() -> dict:
    """K1-K3 launches of this process and the ops its offload services
    served on the host fallback."""
    from ceph_tpu_torch.ops import crc32c, rs_codec
    from ceph_tpu_torch.utils.perf_counters import PerfCountersCollection
    pc = PerfCountersCollection.instance().get("offload")
    return {"gf_bitmatrix": rs_codec.launches,
            "crc32c_blocks": crc32c.launches,
            "gf_bitmatrix_csum": rs_codec.encode_local_launches,
            "fallback_ops": pc.dump()["fallback_ops"] if pc else 0}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--stage", required=True,
                   choices=["cpu", "probe", "device", "mesh_scaling",
                            "cluster", "cluster_tpu", "attribution",
                            "failure_storm", "interleave", "swarm",
                            "scrub_storm", "qos_storm"])
    p.add_argument("--device", default=_device.DEFAULT_DEVICE,
                   help="cuda (default), cuda:N or cpu")
    args = p.parse_args(argv)
    if args.stage == "cpu":
        out = stage_cpu()
    elif args.stage == "probe":
        out = stage_probe(args.device)
    elif args.stage == "device":
        out = stage_device(args.device)
    elif args.stage == "cluster":
        out = stage_cluster(args.device)
    elif args.stage == "cluster_tpu":
        out = stage_cluster_tpu(args.device)
    elif args.stage == "attribution":
        out = stage_attribution(args.device)
    elif args.stage == "failure_storm":
        out = stage_failure_storm(args.device)
    elif args.stage == "interleave":
        out = stage_interleave(args.device)
    elif args.stage == "swarm":
        out = stage_swarm(args.device)
    elif args.stage == "scrub_storm":
        out = stage_scrub_storm(args.device)
    elif args.stage == "qos_storm":
        out = stage_qos_storm(args.device)
    else:
        out = _mesh_scaling_body(args.device)
    print(json.dumps(out), flush=True)
    if args.device != "cpu":
        log(LAUNCH_LINE + json.dumps(launch_counts()))
    failed = False
    zero = _zero_keys(out)
    if zero:
        log(f"bench_driver: {args.stage}: no measurement for {zero}")
        failed = True
    false = [k for k in FLAG_KEYS.get(args.stage, ()) if not out.get(k)]
    if false:
        log(f"bench_driver: {args.stage}: flags read false or are missing: "
            f"{false}")
        failed = True
    errors = {k: out[k] for k in sorted(out) if k.endswith("_error")}
    errors.update({k: out.get(k) for k in ERROR_COUNT_KEYS.get(args.stage, ())
                   if out.get(k) != 0})
    if errors:
        log(f"bench_driver: {args.stage}: errors {errors}")
        failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
