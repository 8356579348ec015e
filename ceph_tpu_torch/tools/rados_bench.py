"""Cluster-level I/O benchmark — the `rados bench` analog.

Re-creation of the reference's obj_bencher workload
(src/common/obj_bencher.cc driving `rados bench write|seq|rand`,
src/tools/rados/rados.cc:124): N concurrent writers/readers through the
librados-subset client against a live cluster; reports aggregate
throughput and p50/p99 op latency.

Usage (standalone, boots its own vstart-style cluster):
    python -m ceph_tpu_torch.tools.rados_bench [--seconds 5] [--concurrency 8]
        [--object-size 262144] [--pool-type replicated|erasure]
        [--k 2] [--m 1] [--osds 3] [--backend memstore|filestore]
        [--device cuda|cpu]
Prints one JSON object with write + read phases.

The in-process programmatic entry (`run_bench`) is what bench.py's
cluster stage and the tests call.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import time


async def _worker(io, prefix: str, object_size: int, mode: str,
                  stop_at: float, latencies: list, wrote: list,
                  n_objects: int = 1) -> int:
    payload = bytes(range(256)) * (object_size // 256 + 1)
    payload = payload[:object_size]
    i = 0
    while time.monotonic() < stop_at:
        t0 = time.monotonic()
        if mode == "write":
            await io.write_full(f"{prefix}-{i}", payload)
        else:
            data = await io.read(f"{prefix}-{i % n_objects}")
            assert len(data) == object_size
        latencies.append(time.monotonic() - t0)
        wrote[0] += object_size
        i += 1
    return i


async def _phase(io, mode: str, concurrency: int, seconds: float,
                 object_size: int, counts: dict) -> dict:
    latencies: list[float] = []
    wrote = [0]
    stop_at = time.monotonic() + seconds
    t0 = time.monotonic()
    done = await asyncio.gather(*[
        _worker(io, f"b{w}", object_size, mode, stop_at, latencies,
                wrote, n_objects=counts.get(f"b{w}", 1))
        for w in range(concurrency)])
    elapsed = time.monotonic() - t0
    latencies.sort()
    n = len(latencies)
    if mode == "write":
        for w, cnt in enumerate(done):
            counts[f"b{w}"] = max(1, cnt)
    return {
        "ops": n,
        "seconds": round(elapsed, 3),
        "mb_per_s": round(wrote[0] / elapsed / 1e6, 2),
        "iops": round(n / elapsed, 1),
        "lat_p50_ms": round(latencies[n // 2] * 1e3, 2) if n else None,
        "lat_p99_ms": round(latencies[int(n * 0.99)] * 1e3, 2)
        if n else None,
    }


async def run_bench(io, seconds: float = 5.0, concurrency: int = 8,
                    object_size: int = 256 * 1024) -> dict:
    """Write phase then sequential-read phase over the written objects."""
    counts: dict = {}
    write = await _phase(io, "write", concurrency, seconds, object_size,
                         counts)
    read = await _phase(io, "read", concurrency, seconds, object_size,
                        counts)
    return {"object_size": object_size, "concurrency": concurrency,
            "write": write, "read": read}


async def _main(args) -> dict:
    # boot/teardown via the shared helper: the timeout-bounded REAPING
    # stop (not abandoning — the "Task was destroyed but it is pending"
    # tail spam came from exactly this path bailing out mid-shutdown)
    # lives in cluster_boot.ephemeral_cluster now
    from ceph_tpu_torch.tools.cluster_boot import ephemeral_cluster

    def store_factory(tmp, i):
        if args.backend == "filestore":
            from ceph_tpu_torch.objectstore import FileStore
            return FileStore(f"{tmp}/osd{i}")
        return None

    async with ephemeral_cluster(args.osds, prefix="rados-bench-",
                                 store_factory=store_factory,
                                 device=args.device) \
            as (client, _osds, _mon):
        if args.pool_type == "erasure":
            await client.command({
                "prefix": "osd erasure-code-profile set",
                "name": "benchprof",
                "profile": {"plugin": args.plugin, "k": str(args.k),
                            "m": str(args.m), "device": args.device}})
            await client.pool_create("bench", pg_num=8,
                                     pool_type="erasure",
                                     erasure_code_profile="benchprof")
        else:
            await client.pool_create("bench", pg_num=8, size=args.osds)
        io = client.ioctx("bench")
        out = await run_bench(io, seconds=args.seconds,
                              concurrency=args.concurrency,
                              object_size=args.object_size)
        out["pool_type"] = args.pool_type
        return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--object-size", type=int, default=256 * 1024)
    ap.add_argument("--pool-type", default="replicated",
                    choices=["replicated", "erasure"])
    ap.add_argument("--plugin", default="jerasure")
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--m", type=int, default=1)
    ap.add_argument("--osds", type=int, default=3)
    ap.add_argument("--backend", default="memstore",
                    choices=["memstore", "filestore"])
    ap.add_argument("--device", default="cuda",
                    help="the OSDs' and the EC plugin's device: cuda "
                         "(default), cuda:N or cpu")
    args = ap.parse_args()
    out = asyncio.run(_main(args))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
