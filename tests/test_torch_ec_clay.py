"""The port's clay plugin against the JAX package's, on the CPU (profile
key device=cpu), with exact byte equality: the cases of
tests/test_ec_clay.py run through both packages on the same payload —
erasure sweeps, and the MSR repair's sub-chunk runs and bytes."""
from __future__ import annotations

import itertools

import numpy as np
import pytest

from ceph_tpu.ec.interface import ErasureCodeError as RefError
from ceph_tpu.ec.registry import ErasureCodePluginRegistry as RefRegistry
from ceph_tpu.osd import ec_util as ref_ec_util
from ceph_tpu_torch import convert
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.osd import ec_util

# the JAX package's inner-code names for the port's
_REF_MDS = {"cuda": "tpu"}


def _profile(k, m, d=None, **extra):
    profile = {"k": str(k), "m": str(m), **extra}
    if d is not None:
        profile["d"] = str(d)
    return profile


def _port(k=4, m=2, d=None, **extra):
    return ErasureCodePluginRegistry.instance().factory(
        "clay", {**_profile(k, m, d, **extra), "device": "cpu"})


def _pair(k=4, m=2, d=None, **extra):
    ref_extra = {key: _REF_MDS.get(v, v) for key, v in extra.items()}
    ref = RefRegistry.instance().factory("clay", _profile(k, m, d, **ref_extra))
    return _port(k, m, d, **extra), ref


def _encode(port, ref, seed=0):
    """The same payload through both packages; the chunks must be equal."""
    k = port.get_data_chunk_count()
    size = k * port.get_chunk_size(k * 1024)
    data = np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    n = port.get_chunk_count()
    enc = port.encode(set(range(n)), data)
    assert enc == ref.encode(set(range(n)), data)
    return data, enc


@pytest.mark.parametrize("k,m,d,sub,nu", [
    (4, 2, None, 8, 0), (8, 4, 11, 64, 0), (3, 3, 4, 8, 0), (5, 4, 6, 32, 1),
])
def test_geometry(k, m, d, sub, nu):
    port, ref = _pair(k, m, d)
    assert port.get_sub_chunk_count() == ref.get_sub_chunk_count() == sub
    assert (port.q, port.t, port.nu) == (ref.q, ref.t, ref.nu)
    assert port.nu == nu
    for width in (1, 4096, 12345, 1 << 20):
        assert port.get_chunk_size(width) == ref.get_chunk_size(width)
    assert port.get_profile() == {**ref.get_profile(), "device": "cpu"}
    np.testing.assert_array_equal(port.mds.coding_matrix,
                                  ref.mds.coding_matrix)
    convert.plugin_from_reference({"plugin": "clay", **_profile(k, m, d)},
                                  convert.generator(ref), "cpu")


@pytest.mark.parametrize("d", [3, 6])
def test_bad_d_rejected(d):
    with pytest.raises(ErasureCodeError):
        _port(4, 2, d=d)
    with pytest.raises(RefError):
        RefRegistry.instance().factory("clay", _profile(4, 2, d))


@pytest.mark.parametrize("k,m,d", [(4, 2, 5), (4, 2, 4), (3, 3, 4),
                                   (5, 4, 6), (6, 3, 8)])
def test_exhaustive_single_and_double_erasures(k, m, d):
    port, ref = _pair(k, m, d)
    data, enc = _encode(port, ref, seed=k * 100 + m)
    n = k + m
    chunk_size = len(enc[0])
    patterns = list(itertools.combinations(range(n), 1))
    patterns += list(itertools.combinations(range(n), min(2, m)))
    for pattern in patterns:
        chunks = {i: b for i, b in enc.items() if i not in pattern}
        got = port.decode(set(range(n)), chunks, chunk_size)
        assert got == ref.decode(set(range(n)), chunks, chunk_size), pattern
        for i in range(n):
            assert got[i] == enc[i], f"chunk {i} after erasing {pattern}"


def test_full_m_erasures():
    port, ref = _pair(4, 3, 6)
    data, enc = _encode(port, ref, seed=7)
    chunk_size = len(enc[0])
    for pattern in itertools.combinations(range(7), 3):
        chunks = {i: b for i, b in enc.items() if i not in pattern}
        got = port.decode(set(pattern), chunks, chunk_size)
        assert got == ref.decode(set(pattern), chunks, chunk_size)
        for i in pattern:
            assert got[i] == enc[i]


@pytest.mark.parametrize("pattern", [(0, 3), (1, 5), (4, 5)])
def test_decode_concat_roundtrip(pattern):
    port, ref = _pair(4, 2)
    data, enc = _encode(port, ref, seed=3)
    chunks = {i: b for i, b in enc.items() if i not in pattern}
    got = port.decode_concat(chunks, len(enc[0]))
    assert got == ref.decode_concat(chunks, len(enc[0])) == data


# -- the MSR property --------------------------------------------------------

def _fetch(enc, minimum, sub):
    """Only the sub-chunk runs of the plan, from each helper."""
    out = {}
    for cid, runs in minimum.items():
        buf = np.frombuffer(enc[cid], dtype=np.uint8).reshape(sub, -1)
        out[cid] = np.concatenate([buf[off:off + cnt]
                                   for off, cnt in runs]).tobytes()
    return out


@pytest.mark.parametrize("k,m,d", [(4, 2, 5), (8, 4, 11), (3, 3, 4),
                                   (5, 4, 6)])
def test_repair_subchunk_runs_and_bytes_equal(k, m, d):
    port, ref = _pair(k, m, d)
    data, enc = _encode(port, ref, seed=13)
    n = k + m
    sub = port.get_sub_chunk_count()
    chunk_size = len(enc[0])
    for lost in range(n):
        avail = set(range(n)) - {lost}
        minimum = port.minimum_to_decode({lost}, avail)
        assert minimum == ref.minimum_to_decode({lost}, avail)
        assert len(minimum) == d
        for runs in minimum.values():
            assert sum(c for _, c in runs) == sub // port.q
        helpers = _fetch(enc, minimum, sub)
        # bandwidth-optimal: d helpers, 1/q of each
        assert sum(map(len, helpers.values())) == d * chunk_size // port.q
        got = port.decode({lost}, helpers, chunk_size)
        assert got == ref.decode({lost}, helpers, chunk_size)
        assert got[lost] == enc[lost], f"repair of chunk {lost}"


def test_repair_reads_without_writing_the_callers_buffers():
    """Helpers handed as memoryviews over the caller's bytearrays: the
    repair reads them through np.frombuffer and leaves them as they were;
    a read-only view (bytes) works the same."""
    port, ref = _pair(8, 4, 11)
    data, enc = _encode(port, ref, seed=17)
    sub = port.get_sub_chunk_count()
    lost = 5
    minimum = port.minimum_to_decode({lost}, set(range(12)) - {lost})
    helpers = _fetch(enc, minimum, sub)
    owned = {i: bytearray(b) for i, b in helpers.items()}
    views = {i: memoryview(b) for i, b in owned.items()}
    got = port.decode({lost}, views, len(enc[0]))
    assert got[lost] == enc[lost]
    assert {i: bytes(b) for i, b in owned.items()} == helpers
    ro = {i: memoryview(b).toreadonly() for i, b in helpers.items()}
    assert port.decode({lost}, ro, len(enc[0]))[lost] == enc[lost]


def test_repair_through_ec_util_fragments():
    """ECUtil's shard rebuild from sub-chunk fragments of two stripes."""
    port, ref = _pair(4, 2, 5)
    chunk = port.get_chunk_size(4 * 1024)
    sinfo = ec_util.StripeInfo(4, 4 * chunk)
    ref_sinfo = ref_ec_util.StripeInfo(4, 4 * chunk)
    payload = np.random.default_rng(19).integers(
        0, 256, 2 * sinfo.stripe_width, dtype=np.uint8).tobytes()
    shards = {i: bytes(b) for i, b in ec_util.encode(sinfo, port,
                                                     payload).items()}
    assert shards == {i: bytes(b) for i, b in ref_ec_util.encode(
        ref_sinfo, ref, payload).items()}
    lost = 2
    minimum = port.minimum_to_decode({lost}, set(range(6)) - {lost})
    sub = port.get_sub_chunk_count()
    frags = {}
    for cid, runs in minimum.items():
        planes = np.frombuffer(shards[cid], dtype=np.uint8).reshape(
            2, sub, -1)
        frags[cid] = np.concatenate([planes[:, off:off + cnt]
                                     for off, cnt in runs], axis=1).tobytes()
    got = ec_util.decode_shards(sinfo, port, frags, [lost], fragments=True)
    assert got[lost] == shards[lost]
    assert got == ref_ec_util.decode_shards(ref_sinfo, ref, frags, [lost],
                                            fragments=True)


def test_minimum_to_decode_falls_back_without_group():
    port, ref = _pair(4, 2)
    lost = 0
    y0 = port._grid_id(lost) // port.q
    group = {port._chunk_id(node)
             for node in range(y0 * port.q, (y0 + 1) * port.q)}
    group -= {None, lost}
    companion = next(iter(group))
    avail = set(range(6)) - {lost, companion}
    minimum = port.minimum_to_decode({lost}, avail)
    assert minimum == ref.minimum_to_decode({lost}, avail)
    sub = port.get_sub_chunk_count()
    for runs in minimum.values():
        assert runs == [(0, sub)]


@pytest.mark.parametrize("k,m,d", [(4, 2, 5), (5, 4, 6)])
def test_read_plans_equal(k, m, d):
    port, ref = _pair(k, m, d)
    n = k + m
    for r in (1, 2):
        for lost in itertools.combinations(range(n), r):
            avail = set(range(n)) - set(lost)
            for want in ({lost[0]}, set(lost)):
                assert port.minimum_to_decode(want, avail) == \
                    ref.minimum_to_decode(want, avail), (want, avail)


@pytest.mark.parametrize("scalar", ["jerasure", "isa", "cuda"])
def test_inner_mds_plugins(scalar):
    """The port's inner code against the reference's (`cuda` against
    the JAX package's `tpu`), built on the pool's device."""
    port, ref = _pair(4, 2, scalar_mds=scalar)
    assert port.mds.get_profile()["device"] == "cpu"
    assert port.mds.device.type == "cpu"
    assert type(port.mds).__module__ == f"ceph_tpu_torch.ec.plugin_{scalar}"
    data, enc = _encode(port, ref, seed=5)
    chunks = {i: b for i, b in enc.items() if i not in (1, 4)}
    got = port.decode({1, 4}, chunks, len(enc[0]))
    assert got == ref.decode({1, 4}, chunks, len(enc[0]))
    assert got[1] == enc[1] and got[4] == enc[4]


def test_reference_inner_name_is_mapped():
    """`scalar_mds=tpu` is the JAX package's name: the port refuses it,
    and convert.port_profile maps it to `cuda`."""
    with pytest.raises(ErasureCodeError, match="unsupported"):
        _port(4, 2, scalar_mds="tpu")
    ref_profile = {"plugin": "clay", "k": "4", "m": "2", "scalar_mds": "tpu"}
    ref = RefRegistry.instance().factory("clay", ref_profile)
    port = convert.plugin_from_reference(ref_profile, convert.generator(ref),
                                         "cpu")
    assert port.get_profile()["scalar_mds"] == "cuda"
    assert type(port.mds).__name__ == "ErasureCodeCuda"
