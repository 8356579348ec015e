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

The north-star geometry throughout: k=8, m=3, 1 MiB chunks, 16 stripes
a batch (reference `ceph_erasure_code_benchmark -P k=8 -P m=3 -s 8M`;
GB/s = KiB / 2^20 / seconds). On the card the device stage runs at those
shapes; on the CPU (tests, rehearsals) at small ones, as the reference
shrinks off the TPU. Device times are CUDA events on a card and the host
clock on the CPU.

A measurement that fails raises, and `main` exits non-zero naming every
key that read zero (but for the counts, clamped shares and skews whose
zero is a reading, ZERO_IS_A_READING) or any bytes that differ across a
curve's runs: no stage records 0.0 and carries on. The
reference's round-over-round trend guard reads its own TPU records and
is not ported.
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
    "tracing_overhead_full_pct"})


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


def _zero_keys(out: dict) -> list[str]:
    """Numeric results that read zero or less (a measurement that did
    not happen), but for the keys whose zero is a reading."""
    return sorted(k for k, v in out.items()
                  if isinstance(v, (int, float)) and not isinstance(v, bool)
                  and v <= 0 and k not in ZERO_IS_A_READING)


#: each stage's bit-identity flags: False fails the run
IDENTITY_KEYS = {
    "mesh_scaling": ("scaling_bit_identical",),
    "cluster_tpu": ("pipeline_bit_identical", "reactor_shard_bit_identical",
                    "reactor_proc_bit_identical", "scaling_bit_identical"),
}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--stage", required=True,
                   choices=["cpu", "probe", "device", "mesh_scaling",
                            "cluster", "cluster_tpu", "attribution"])
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
    else:
        out = _mesh_scaling_body(args.device)
    print(json.dumps(out), flush=True)
    zero = _zero_keys(out)
    if zero:
        log(f"bench_driver: {args.stage}: no measurement for {zero}")
        return 1
    differ = [k for k in IDENTITY_KEYS.get(args.stage, ()) if not out[k]]
    if differ:
        log(f"bench_driver: {args.stage}: bytes differ across the runs "
            f"of {differ}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
