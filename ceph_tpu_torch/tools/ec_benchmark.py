"""Erasure-code benchmark — re-creation of `ceph_erasure_code_benchmark`.

Port of ceph_tpu/tools/ec_benchmark.py: the same CLI and the same output
line, `seconds \\t KiB_processed`, so `bench.sh`-style scripts compute
GB/s = KiB / 2^20 / seconds (qa/workunits/erasure-code/bench.sh:214).

Modes:
  --mode scalar        per-stripe encode() via the plugin contract
                       (reference semantics, one device round trip each)
  --mode batched       --batch stripes per launch through
                       encode_stripes/decode_stripes on data that lives
                       on the device, timed with CUDA events
  --mode batched-host  the same from host numpy buffers: includes the
                       pinned H2D/D2H transfers the OSD path pays
  --mode native        the C++ host codec from native/ (split-table SIMD,
                       the stand-in for the reference isa plugin)
  --device             cuda (default) or cpu

Programmatic use: `run_bench(BenchConfig(...)) -> BenchResult`.
"""
from __future__ import annotations

import argparse
import dataclasses
import random
import sys
import time
from typing import Iterable

import numpy as np
import torch

from ceph_tpu_torch import device as _device


@dataclasses.dataclass
class BenchConfig:
    plugin: str = "jerasure"
    workload: str = "encode"          # encode | decode
    size: int = 1024 * 1024           # bytes per in-buffer (stripe)
    iterations: int = 1
    erasures: int = 1
    erased: tuple[int, ...] = ()      # explicit erased chunk ids
    erasures_generation: str = "random"  # random | exhaustive
    parameters: dict = dataclasses.field(default_factory=dict)
    mode: str = "scalar"              # scalar | batched | batched-host | native
    batch: int = 32
    warmup: int = 1
    verbose: bool = False
    seed: int | None = None
    device: str = _device.DEFAULT_DEVICE


@dataclasses.dataclass
class BenchResult:
    seconds: float
    kib: float                        # KiB processed (reference accounting)
    config: BenchConfig

    @property
    def gb_per_s(self) -> float:
        # bench.sh:214 accounting: GB/s = KiB / 2^20 / seconds
        return self.kib / (1 << 20) / self.seconds if self.seconds > 0 else 0.0


def _make_instance(cfg: BenchConfig):
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry

    profile = dict(cfg.parameters)
    profile.setdefault("plugin", cfg.plugin)
    profile.setdefault("device", cfg.device)
    return ErasureCodePluginRegistry.instance().factory(cfg.plugin, profile)


def _erasure_patterns(cfg: BenchConfig, n_chunks: int,
                      rng: random.Random) -> Iterable[tuple[int, ...]]:
    """Patterns of chunk ids to erase for one decode iteration."""
    if not cfg.erased and cfg.erasures > n_chunks:
        raise ValueError(
            f"--erasures {cfg.erasures} exceeds chunk count {n_chunks}")
    if cfg.erased:
        yield tuple(cfg.erased)
    elif cfg.erasures_generation == "exhaustive":
        import itertools
        yield from itertools.combinations(range(n_chunks), cfg.erasures)
    else:
        chosen: set[int] = set()
        while len(chosen) < cfg.erasures:
            chosen.add(rng.randrange(n_chunks))
        yield tuple(sorted(chosen))


# ---------------------------------------------------------------------------
# Scalar (plugin-contract) workloads — reference semantics
# ---------------------------------------------------------------------------

def _time_host_loop(fn, iterations: int, warmup: int) -> float:
    """Time `iterations` synchronous calls of fn() after `warmup` untimed
    ones (shared by every host-side bench path)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iterations):
        fn()
    return max(time.perf_counter() - t0, 1e-9)


def _bench_encode_scalar(cfg: BenchConfig, code) -> BenchResult:
    data = b"X" * cfg.size
    want = set(range(code.get_chunk_count()))
    dt = _time_host_loop(lambda: code.encode(want, data),
                         cfg.iterations, cfg.warmup)
    return BenchResult(dt, cfg.iterations * (cfg.size / 1024), cfg)


def _bench_decode_scalar(cfg: BenchConfig, code) -> BenchResult:
    data = b"X" * cfg.size
    n = code.get_chunk_count()
    encoded = code.encode(set(range(n)), data)
    chunk_size = len(encoded[0])
    rng = random.Random(cfg.seed)
    want = set(range(n))

    def one_pass():
        for pattern in _erasure_patterns(cfg, n, rng):
            chunks = {i: b for i, b in encoded.items() if i not in pattern}
            decoded = code.decode(want, chunks, chunk_size)
            for i in pattern:
                if decoded[i] != encoded[i]:
                    raise RuntimeError(f"chunk {i} decode mismatch")

    dt = _time_host_loop(one_pass, cfg.iterations, cfg.warmup)
    return BenchResult(dt, cfg.iterations * (cfg.size / 1024), cfg)


# ---------------------------------------------------------------------------
# Batched workloads — the device amortization path (ECUtil batching site)
# ---------------------------------------------------------------------------

def time_device_loop(fn, iterations: int, warmup: int,
                     device: torch.device) -> float:
    """Seconds for `iterations` calls of fn() after `warmup` untimed ones.
    On a card the loop is bracketed by CUDA events (the launches are
    asynchronous; the events time the device's work); on the CPU it is
    the host clock."""
    if device.type != "cuda":
        return _time_host_loop(fn, iterations, warmup)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iterations):
        fn()
    end.record()
    end.synchronize()
    return max(start.elapsed_time(end) / 1e3, 1e-9)


def device_test_data(batch: int, k: int, chunk: int,
                     device: torch.device) -> torch.Tensor:
    """Pseudo-random (batch, k, chunk) uint8 stripes filled on the device:
    byte i of the flat buffer is ((i * 2654435761 mod 2^32) >> 7) & 0xFF,
    the formula of the JAX package's _device_test_data, so both packages
    encode the same bytes. Filled in slices to bound the int64 scratch."""
    n = batch * k * chunk
    out = torch.empty(n, dtype=torch.uint8, device=device)
    step = 1 << 24
    for lo in range(0, n, step):
        i = torch.arange(lo, min(n, lo + step), dtype=torch.int64,
                         device=device)
        out[lo:lo + step] = (((i * 2654435761) & 0xFFFFFFFF) >> 7).to(
            torch.uint8)
    return out.reshape(batch, k, chunk)


def _bench_encode_batched(cfg: BenchConfig, code) -> BenchResult:
    k = code.get_data_chunk_count()
    chunk = code.get_chunk_size(cfg.size)
    dev = device_test_data(cfg.batch, k, chunk, code.device)
    dt = time_device_loop(lambda: code.encode_stripes(dev),
                          cfg.iterations, cfg.warmup, code.device)
    return BenchResult(dt, cfg.iterations * cfg.batch * (cfg.size / 1024), cfg)


def _bench_encode_batched_host(cfg: BenchConfig, code) -> BenchResult:
    """Batched, but with host-resident numpy buffers: includes the H2D/D2H
    transfers the OSD path pays, pipelined by the plugin."""
    k = code.get_data_chunk_count()
    chunk = code.get_chunk_size(cfg.size)
    data = np.full((cfg.batch, k, chunk), ord("X"), dtype=np.uint8)
    dt = _time_host_loop(lambda: code.encode_stripes(data),
                         cfg.iterations, cfg.warmup)
    return BenchResult(dt, cfg.iterations * cfg.batch * (cfg.size / 1024), cfg)


def _bench_decode_batched(cfg: BenchConfig, code) -> BenchResult:
    k = code.get_data_chunk_count()
    n = code.get_chunk_count()
    chunk = code.get_chunk_size(cfg.size)
    rng = random.Random(cfg.seed)
    pattern = next(iter(_erasure_patterns(cfg, n, rng)))
    avail = tuple(i for i in range(n) if i not in pattern)[:k]
    want = tuple(pattern)
    dev = device_test_data(cfg.batch, k, chunk, code.device)
    dt = time_device_loop(lambda: code.decode_stripes(avail, want, dev),
                          cfg.iterations, cfg.warmup, code.device)
    return BenchResult(dt, cfg.iterations * cfg.batch * (cfg.size / 1024), cfg)


# ---------------------------------------------------------------------------
# Host-CPU baseline
# ---------------------------------------------------------------------------

def _baseline_matrix(cfg: BenchConfig, code):
    M = getattr(code, "coding_matrix", None)
    if M is None:
        raise RuntimeError(f"plugin {cfg.plugin} exposes no coding matrix")
    return np.asarray(M, dtype=np.uint8)


def _bench_encode_native(cfg: BenchConfig, code) -> BenchResult:
    """C++ split-table codec from native/ — the isa-plugin stand-in."""
    from ceph_tpu_torch.native import ec_native

    M = _baseline_matrix(cfg, code)
    k = code.get_data_chunk_count()
    chunk = code.get_chunk_size(cfg.size)
    data = np.full((k, chunk), ord("X"), dtype=np.uint8)
    out = np.zeros((M.shape[0], chunk), dtype=np.uint8)
    dt = _time_host_loop(lambda: ec_native.encode(M, data, out),
                         cfg.iterations, cfg.warmup)
    return BenchResult(dt, cfg.iterations * (cfg.size / 1024), cfg)


def _bench_decode_native(cfg: BenchConfig, code) -> BenchResult:
    from ceph_tpu_torch.native import ec_native
    from ceph_tpu_torch.ops import rs_codec

    M = _baseline_matrix(cfg, code)
    k = code.get_data_chunk_count()
    n = code.get_chunk_count()
    chunk = code.get_chunk_size(cfg.size)
    rng = random.Random(cfg.seed)
    pattern = next(iter(_erasure_patterns(cfg, n, rng)))
    avail = tuple(i for i in range(n) if i not in pattern)[:k]
    R = rs_codec.recovery_matrix(M, avail, tuple(pattern))
    data = np.full((k, chunk), ord("X"), dtype=np.uint8)
    out = np.zeros((R.shape[0], chunk), dtype=np.uint8)
    dt = _time_host_loop(lambda: ec_native.encode(R, data, out),
                         cfg.iterations, cfg.warmup)
    return BenchResult(dt, cfg.iterations * (cfg.size / 1024), cfg)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

_RUNNERS = {
    ("encode", "scalar"): _bench_encode_scalar,
    ("encode", "batched"): _bench_encode_batched,
    ("encode", "batched-host"): _bench_encode_batched_host,
    ("encode", "native"): _bench_encode_native,
    ("decode", "scalar"): _bench_decode_scalar,
    ("decode", "batched"): _bench_decode_batched,
    ("decode", "native"): _bench_decode_native,
}


def run_bench(cfg: BenchConfig) -> BenchResult:
    runner = _RUNNERS.get((cfg.workload, cfg.mode))
    if runner is None:
        raise ValueError(f"unknown workload/mode {cfg.workload}/{cfg.mode}")
    return runner(cfg, _make_instance(cfg))


def parse_args(argv: list[str] | None = None) -> BenchConfig:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("-s", "--size", type=int, default=1024 * 1024)
    p.add_argument("-i", "--iterations", type=int, default=1)
    p.add_argument("-p", "--plugin", default="jerasure")
    p.add_argument("-w", "--workload", default="encode",
                   choices=["encode", "decode"])
    p.add_argument("-e", "--erasures", type=int, default=1)
    p.add_argument("--erased", type=int, action="append", default=[])
    p.add_argument("-E", "--erasures-generation", default="random",
                   choices=["random", "exhaustive"])
    p.add_argument("-P", "--parameter", action="append", default=[])
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--mode", default="scalar",
                   choices=["scalar", "batched", "batched-host", "native"])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default=_device.DEFAULT_DEVICE)
    a = p.parse_args(argv)
    params = {}
    for kv in a.parameter:
        if kv.count("=") != 1:
            print(f"--parameter {kv} ignored because it does not contain "
                  "exactly one =", file=sys.stderr)
            continue
        key, val = kv.split("=")
        params[key] = val
    return BenchConfig(
        plugin=a.plugin, workload=a.workload, size=a.size,
        iterations=a.iterations, erasures=a.erasures,
        erased=tuple(a.erased), erasures_generation=a.erasures_generation,
        parameters=params, mode=a.mode, batch=a.batch, warmup=a.warmup,
        verbose=a.verbose, seed=a.seed, device=a.device)


def main(argv: list[str] | None = None) -> int:
    cfg = parse_args(argv)
    res = run_bench(cfg)
    # reference output format: seconds \t KiB (ceph_erasure_code_benchmark.cc:193)
    print(f"{res.seconds:.6f}\t{res.kib:.0f}")
    if cfg.verbose:
        print(f"# {res.gb_per_s:.3f} GB/s mode={cfg.mode} plugin={cfg.plugin} "
              f"device={cfg.device}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
