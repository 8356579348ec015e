"""The slice as a whole: the port's ECUtil with plugin `cuda` on the
CPU against the JAX package's ECUtil with plugin `tpu`, byte for byte —
encode, degraded read, shard rebuild and HashInfo at k=8 m=3 with 4 KiB
chunks over several stripes; and the port's benchmark accounting."""
import itertools

import numpy as np
import pytest

from ceph_tpu.ec.registry import ErasureCodePluginRegistry as RefRegistry
from ceph_tpu.osd import ec_util as ref_ec_util
from ceph_tpu.tools import ec_benchmark as ref_bench
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.tools import ec_benchmark
from ceph_tpu_torch.utils.checksummer import Checksummer

K, M, CHUNK, STRIPES = 8, 3, 4096, 5
PATTERNS = [(0,), (3, 9), (0, 1, 2), (4, 8, 10), (8, 9, 10), (7, 9, 10)]


@pytest.fixture(scope="module")
def written():
    port = ErasureCodePluginRegistry.instance().factory(
        "cuda", {"k": str(K), "m": str(M), "device": "cpu"})
    ref = RefRegistry.instance().factory("tpu", {"k": str(K), "m": str(M)})
    sinfo = ec_util.StripeInfo(K, K * CHUNK)
    ref_sinfo = ref_ec_util.StripeInfo(K, K * CHUNK)
    data = np.random.default_rng(21).integers(
        0, 256, STRIPES * K * CHUNK, dtype=np.uint8).tobytes()
    shards = {i: bytes(b) for i, b in ec_util.encode(sinfo, port, data).items()}
    ref_shards = {i: bytes(b) for i, b in
                  ref_ec_util.encode(ref_sinfo, ref, data).items()}
    return port, ref, sinfo, ref_sinfo, data, shards, ref_shards


def test_encode_matches_reference(written):
    _, _, _, _, _, shards, ref_shards = written
    assert sorted(shards) == list(range(K + M))
    assert shards == ref_shards
    assert all(len(b) == STRIPES * CHUNK for b in shards.values())


def test_encode_want_subset_and_scalar_fallback(written):
    port, ref, sinfo, ref_sinfo, data, shards, _ = written
    sub = ec_util.encode(sinfo, port, data, want=[0, 9])
    assert {i: bytes(b) for i, b in sub.items()} == {0: shards[0], 9: shards[9]}

    class Scalar:                    # a plugin without the batched API
        def __getattr__(self, name):
            if name in ("encode_stripes", "decode_stripes"):
                raise AttributeError(name)
            return getattr(port, name)

    scalar = ec_util.encode(sinfo, Scalar(), data)
    assert {i: bytes(b) for i, b in scalar.items()} == shards
    with pytest.raises(ErasureCodeError):
        ec_util.encode(sinfo, port, data[:-1])
    assert ec_util.encode(sinfo, port, b"") == {i: b"" for i in range(K + M)}


@pytest.mark.parametrize("pattern", PATTERNS)
def test_decode_concat_matches_reference(written, pattern):
    port, ref, sinfo, ref_sinfo, data, shards, _ = written
    have = {i: b for i, b in shards.items() if i not in pattern}
    got = ec_util.decode_concat(sinfo, port, have)
    assert got == ref_ec_util.decode_concat(ref_sinfo, ref, have)
    assert got == data


@pytest.mark.parametrize("pattern", PATTERNS)
def test_decode_shards_matches_reference(written, pattern):
    port, ref, sinfo, ref_sinfo, data, shards, _ = written
    have = {i: b for i, b in shards.items() if i not in pattern}
    got = ec_util.decode_shards(sinfo, port, have, pattern)
    assert got == ref_ec_util.decode_shards(ref_sinfo, ref, have, pattern)
    cs = Checksummer("crc32c", 4096, use_device=True, device="cpu")
    for i in pattern:
        assert got[i] == shards[i]
        np.testing.assert_array_equal(cs.calculate(got[i]),
                                      cs.calculate(shards[i]))


def test_decode_errors(written):
    port, _, sinfo, _, _, shards, _ = written
    with pytest.raises(ErasureCodeError):
        ec_util.decode_concat(sinfo, port, {})
    with pytest.raises(ErasureCodeError):
        ec_util.decode_concat(sinfo, port, {0: shards[0], 1: shards[1][:-CHUNK]})
    too_few = {i: shards[i] for i in range(K - 1)}
    with pytest.raises(ErasureCodeError):
        ec_util.decode_shards(sinfo, port, too_few, [K - 1])


def test_hashinfo_matches_reference(written):
    port, ref, sinfo, ref_sinfo, data, shards, _ = written
    h, rh = ec_util.HashInfo(K + M), ref_ec_util.HashInfo(K + M)
    half = STRIPES * CHUNK // 2
    for lo, hi in ((0, half), (half, STRIPES * CHUNK)):
        part = {i: b[lo:hi] for i, b in shards.items()}
        h.append(lo, part)
        rh.append(lo, part)
    assert h.to_dict() == rh.to_dict()
    assert h.get_total_logical_size(sinfo) == len(data)
    with pytest.raises(ValueError):
        h.append(0, shards)
    h2 = ec_util.HashInfo.from_dict(h.to_dict())
    assert h2.cumulative_shard_hashes == h.cumulative_shard_hashes


def test_stripe_info_offsets_match_reference():
    s, r = ec_util.StripeInfo(4, 4 * 128), ref_ec_util.StripeInfo(4, 4 * 128)
    for off, length in itertools.product((0, 100, 512, 1000), (0, 1, 513, 2048)):
        for fn in ("offset_len_to_stripe_bounds", "offset_len_to_chunk_bounds",
                   "offset_length_to_data_chunk_indices"):
            assert getattr(s, fn)(off, length) == getattr(r, fn)(off, length)
        assert s.logical_to_next_chunk_offset(off) == \
            r.logical_to_next_chunk_offset(off)


@pytest.mark.parametrize("workload,mode", [
    ("encode", "batched"), ("decode", "batched"), ("encode", "batched-host"),
    ("encode", "native"), ("decode", "native"), ("encode", "scalar"),
    ("decode", "scalar")])
def test_benchmark_accounting_matches_reference(workload, mode):
    """The port's ec_benchmark on the CPU at a tiny size reports the
    reference's KiB accounting and output line format."""
    kw = dict(workload=workload, mode=mode, size=8 * 1024, iterations=2,
              batch=3, warmup=0, erasures=M, seed=42,
              parameters={"k": str(K), "m": str(M)})
    port = ec_benchmark.run_bench(ec_benchmark.BenchConfig(
        plugin="cuda", device="cpu", **kw))
    ref = ref_bench.run_bench(ref_bench.BenchConfig(plugin="tpu", **kw))
    assert port.kib == ref.kib
    assert port.seconds > 0 and port.gb_per_s > 0


def test_benchmark_test_data_formula():
    import torch
    got = ec_benchmark.device_test_data(2, 3, 1000, torch.device("cpu")).numpy()
    i = np.arange(2 * 3 * 1000, dtype=np.uint64)
    want = (((i * 2654435761) & 0xFFFFFFFF) >> 7).astype(np.uint8)
    np.testing.assert_array_equal(got.reshape(-1), want)
    ref = np.asarray(ref_bench._device_test_data(2, 3, 1000))
    np.testing.assert_array_equal(got, ref)


def test_benchmark_cli_line(capsys):
    assert ec_benchmark.main(["-p", "cuda", "--device", "cpu", "--mode",
                              "batched", "-s", "8192", "--batch", "2",
                              "-i", "1", "-P", "k=8", "-P", "m=3"]) == 0
    seconds, kib = capsys.readouterr().out.strip().split("\t")
    assert float(seconds) > 0 and kib == "16"
