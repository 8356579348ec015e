"""Measurement stages of the port's benchmark, one JSON line each.

The device stages of ceph_tpu/tools/bench_driver.py on PyTorch:

    python -m ceph_tpu_torch.tools.bench_driver --stage X [--device D]

Stages:

  cpu           host baselines, on the host whatever --device says:
                  cpu_native_encode   the repo's C++ codec (isa stand-in)
                  cpu_native_decode   same kernel, 3-erasure recovery
                  cpu_numpy_encode    the numpy GF(2^8) matrix apply
                  cpu_crc32c          the C++ crc32c over 4 KiB blocks
                The reference's messenger frame microbench keys
                (msgr_*) wait for the messenger's port and are absent.
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

The north-star geometry throughout: k=8, m=3, 1 MiB chunks, 16 stripes
a batch (reference `ceph_erasure_code_benchmark -P k=8 -P m=3 -s 8M`;
GB/s = KiB / 2^20 / seconds). On the card the device stage runs at those
shapes; on the CPU (tests, rehearsals) at small ones, as the reference
shrinks off the TPU. Device times are CUDA events on a card and the host
clock on the CPU.

A measurement that fails raises, and `main` exits non-zero naming every
key that read zero: no stage records 0.0 and carries on. The
reference's round-over-round trend guard reads its own TPU records and
is not ported.
"""
from __future__ import annotations

import argparse
import json
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
    return results


def stage_probe(device: str | None = None) -> dict:
    t0 = time.perf_counter()
    dev = _device.resolve(device)
    torch.zeros(1, device=dev)
    _sync(dev)
    return {"platform": "gpu" if dev.type == "cuda" else "cpu",
            "device_count": torch.cuda.device_count()
            if dev.type == "cuda" else 1,
            "init_s": round(time.perf_counter() - t0, 4)}


def stage_device(device: str | None = None) -> dict:
    from ceph_tpu_torch.ops import crc32c
    from ceph_tpu_torch.tools import ec_benchmark
    t0 = time.perf_counter()
    dev = _device.resolve(device)
    torch.zeros(1, device=dev)
    _sync(dev)
    init_s = round(time.perf_counter() - t0, 4)
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


def _zero_keys(out: dict) -> list[str]:
    """Numeric results that read zero or less (a measurement that did
    not happen)."""
    return sorted(k for k, v in out.items()
                  if isinstance(v, (int, float)) and not isinstance(v, bool)
                  and v <= 0)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--stage", required=True,
                   choices=["cpu", "probe", "device", "mesh_scaling"])
    p.add_argument("--device", default=_device.DEFAULT_DEVICE,
                   help="cuda (default), cuda:N or cpu")
    args = p.parse_args(argv)
    if args.stage == "cpu":
        out = stage_cpu()
    elif args.stage == "probe":
        out = stage_probe(args.device)
    elif args.stage == "device":
        out = stage_device(args.device)
    else:
        out = _mesh_scaling_body(args.device)
    print(json.dumps(out), flush=True)
    zero = _zero_keys(out)
    if zero:
        log(f"bench_driver: {args.stage}: no measurement for {zero}")
        return 1
    if args.stage == "mesh_scaling" and not out["scaling_bit_identical"]:
        log("bench_driver: mesh_scaling: the widest mesh's parity differs "
            "from one slot's")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
