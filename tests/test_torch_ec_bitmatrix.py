"""The port's bitmatrix RAID-6 techniques (liberation / blaum_roth /
liber8tion, ceph_tpu_torch/ec/bitmatrix.py) against the JAX package's, on
the CPU (profile key device=cpu), with exact byte equality: the cases of
tests/test_ec_bitmatrix.py run through both packages on the same
payload, and every 1- and 2-erasure pattern must decode to the same
bytes in both."""
from __future__ import annotations

import itertools

import numpy as np
import pytest

from ceph_tpu.ec import bitmatrix as ref_bm
from ceph_tpu.ec.interface import ErasureCodeError as RefError
from ceph_tpu.ec.registry import ErasureCodePluginRegistry as RefRegistry
from ceph_tpu_torch import convert
from ceph_tpu_torch.ec import bitmatrix
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry

CASES = [
    ("liberation", 3, 7), ("liberation", 7, 7), ("liberation", 5, 5),
    ("blaum_roth", 4, 6), ("blaum_roth", 6, 6), ("blaum_roth", 5, 10),
    ("liber8tion", 3, 8), ("liber8tion", 5, 8),
]
IDS = [f"{t}-k{k}-w{w}" for t, k, w in CASES]


def _profile(tech, k, w, m=2):
    return {"plugin": "jerasure", "technique": tech,
            "k": str(k), "m": str(m), "w": str(w)}


def _pair(tech, k, w):
    port = ErasureCodePluginRegistry.instance().factory(
        "jerasure", {**_profile(tech, k, w), "device": "cpu"})
    ref = RefRegistry.instance().factory("jerasure", _profile(tech, k, w))
    return port, ref


@pytest.mark.parametrize("tech,k,w", CASES, ids=IDS)
def test_all_erasure_patterns_equal(tech, k, w):
    port, ref = _pair(tech, k, w)
    data = np.random.default_rng(k * 100 + w).integers(
        0, 256, k * w * 16 + 5, dtype=np.uint8).tobytes()
    n = k + 2
    enc = port.encode(range(n), data)
    assert enc == ref.encode(range(n), data)
    for r in (1, 2):
        for erased in itertools.combinations(range(n), r):
            chunks = {i: b for i, b in enc.items() if i not in erased}
            got = port.decode(list(erased), chunks, len(enc[0]))
            assert got == ref.decode(list(erased), chunks, len(enc[0]))
            for e in erased:
                assert got[e] == enc[e], (tech, k, w, erased)
    have = {i: enc[i] for i in range(1, n)}
    got = port.decode_concat(have, len(enc[0]))
    assert got == ref.decode_concat(have, len(enc[0]))
    assert got[:len(data)] == data


@pytest.mark.parametrize("tech,k,w", CASES, ids=IDS)
def test_generator_and_geometry_equal(tech, k, w):
    port, ref = _pair(tech, k, w)
    np.testing.assert_array_equal(port.code.G, ref.code.G)
    assert port.get_alignment() == ref.get_alignment() == w * 64
    for width in (1, 4096, 31744, 1 << 20):
        assert port.get_chunk_size(width) == ref.get_chunk_size(width)
    assert port.get_profile() == {**ref.get_profile(), "device": "cpu"}
    # the batched stripe API does not apply: ECUtil takes the scalar loop
    assert port.encode_stripes is None and port.decode_stripes is None
    convert.plugin_from_reference(_profile(tech, k, w),
                                  convert.generator(ref), "cpu")
    with pytest.raises(ValueError, match="another generator"):
        convert.plugin_from_reference(_profile(tech, k, w),
                                      ref.code.G ^ 1, "cpu")


@pytest.mark.parametrize("tech,k,w,m", [
    ("blaum_roth", 4, 7, 2),     # w+1 = 8 not prime
    ("liberation", 4, 6, 2),     # w = 6 not prime
    ("liber8tion", 4, 7, 2),     # w must be 8
    ("liber8tion", 7, 8, 2),     # beyond the supported k for w = 8
    ("liberation", 3, 7, 3),     # the RAID-6 family is m = 2 only
    ("liberation", 8, 7, 2),     # k > w
], ids=["blaum_roth-w7", "liberation-w6", "liber8tion-w7", "liber8tion-k7",
        "liberation-m3", "liberation-k8-w7"])
def test_w_and_prime_checks(tech, k, w, m):
    with pytest.raises(ErasureCodeError):
        ErasureCodePluginRegistry.instance().factory(
            "jerasure", {**_profile(tech, k, w, m), "device": "cpu"})
    with pytest.raises(RefError):
        RefRegistry.instance().factory("jerasure", _profile(tech, k, w, m))


def test_blaum_roth_blocks_limits():
    with pytest.raises(ErasureCodeError):
        bitmatrix.blaum_roth_blocks(9, 8)
    with pytest.raises(RefError):
        ref_bm.blaum_roth_blocks(9, 8)


@pytest.mark.parametrize("k,w", [(5, 5), (7, 7), (3, 8), (5, 8)])
def test_minimal_density(k, w):
    """The liberation property: disk 0 contributes w ones, every other
    disk w+1 for prime w (the lowest density of an MDS RAID-6 bitmatrix
    code); the blocks are the reference's, bit for bit."""
    blocks = bitmatrix.liberation_family_blocks(k, w)
    for got, want in zip(blocks, ref_bm.liberation_family_blocks(k, w),
                         strict=True):
        np.testing.assert_array_equal(got, want)
    assert int(blocks[0].sum()) == w
    if bitmatrix._is_prime(w):
        assert all(int(b.sum()) == w + 1 for b in blocks[1:]), (k, w)


def test_pinned_table_is_the_reference_table():
    assert bitmatrix._PINNED == ref_bm._PINNED
    assert bitmatrix.MAX_K == ref_bm.MAX_K


@pytest.mark.parametrize("k,w", [(2, 5), (3, 5), (2, 7), (3, 7)])
def test_search_reproduces_pinned(k, w):
    """The search that printed the table finds the same placements in
    both packages at the pinned (k, w) it is fast for."""
    specs = bitmatrix._search_specs(k, w)
    assert specs == ref_bm._search_specs(k, w)
    assert [(a, list(map(tuple, e))) for a, e in specs] == \
        [(a, list(map(tuple, e))) for a, e in bitmatrix._PINNED[(k, w)]]


@pytest.mark.parametrize("seed", range(4))
def test_gf2_solve_equal(seed):
    rng = np.random.default_rng(seed)
    n = 12
    while True:
        A = rng.integers(0, 2, size=(n, n)).astype(np.uint8)
        B = rng.integers(0, 2, size=(n, 5)).astype(np.uint8)
        if not ref_bm.gf2_invertible(A):
            assert not bitmatrix.gf2_invertible(A)
            with pytest.raises(ErasureCodeError):
                bitmatrix.gf2_solve(A, B)
            continue
        break
    X = bitmatrix.gf2_solve(A, B)
    np.testing.assert_array_equal(X, ref_bm.gf2_solve(A, B))
    assert ((A.astype(int) @ X.astype(int)) % 2 == B).all()
    inv = bitmatrix.gf2_solve(A, np.eye(n, dtype=np.uint8))
    assert ((A.astype(int) @ inv.astype(int)) % 2 == np.eye(n)).all()
    packets = rng.integers(0, 256, (n, 64), dtype=np.uint8)
    np.testing.assert_array_equal(bitmatrix.gf2_apply(A, packets),
                                  ref_bm.gf2_apply(A, packets))


def test_packet_layout_stability():
    """On-disk stability: the encoding of a fixed payload is pinned, the
    same crcs as the reference's test, and the same bytes as the JAX
    package's plugin."""
    from ceph_tpu_torch.native import ec_native
    port, ref = _pair("liberation", 4, 7)
    data = bytes(range(256)) * 14
    enc = port.encode(range(6), data)
    assert enc == ref.encode(range(6), data)
    crcs = [ec_native.crc32c(enc[i]) for i in range(6)]
    assert crcs == [2763749271, 1839738498, 2763749271, 1839738498,
                    225952960, 2023453278], crcs
