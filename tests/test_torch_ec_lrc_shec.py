"""The port's lrc and shec plugins against the JAX package's, on the CPU
(profile key device=cpu), with exact byte equality: the cases of
tests/test_ec_lrc_shec.py run through both packages on the same payload,
and the read plans (`minimum_to_decode`) must be the same."""
from __future__ import annotations

import itertools
import json

import numpy as np
import pytest
import torch

from ceph_tpu.ec.interface import ErasureCodeError as RefError
from ceph_tpu.ec.registry import ErasureCodePluginRegistry as RefRegistry
from ceph_tpu_torch import convert
from ceph_tpu_torch.device import DeviceUnavailable
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry


def _strs(profile):
    return {k: str(v) for k, v in profile.items()}


def _port(name, **profile):
    return ErasureCodePluginRegistry.instance().factory(
        name, {**_strs(profile), "device": "cpu"})


def _pair(name, **profile):
    ref = RefRegistry.instance().factory(name, _strs(profile))
    return _port(name, **profile), ref


def _encode(port, ref, seed=0):
    """The same payload through both packages; the chunks must be equal."""
    k = port.get_data_chunk_count()
    data = np.random.default_rng(seed).integers(
        0, 256, k * 1024, dtype=np.uint8).tobytes()
    n = port.get_chunk_count()
    enc = port.encode(set(range(n)), data)
    assert enc == ref.encode(set(range(n)), data)
    return data, enc


def _decode_equal(port, ref, enc, pattern, want=None):
    want = set(pattern) if want is None else want
    chunks = {i: b for i, b in enc.items() if i not in pattern}
    got = port.decode(want, chunks, len(enc[0]))
    assert got == ref.decode(want, chunks, len(enc[0])), pattern
    for i in want:
        assert got[i] == enc[i], f"{i} after {pattern}"


def _plans_equal(port, ref, max_erasures):
    n = port.get_chunk_count()
    for r in range(1, max_erasures + 1):
        for lost in itertools.combinations(range(n), r):
            avail = set(range(n)) - set(lost)
            for want in ({lost[0]}, set(lost)):
                try:
                    plan = ref.minimum_to_decode(want, avail)
                except RefError:
                    with pytest.raises(ErasureCodeError):
                        port.minimum_to_decode(want, avail)
                    continue
                assert port.minimum_to_decode(want, avail) == plan, \
                    (want, avail)


# -- LRC ---------------------------------------------------------------------

def test_lrc_kml_geometry():
    port, ref = _pair("lrc", k=4, m=2, l=3)
    assert port.get_chunk_count() == ref.get_chunk_count() == 8
    assert port.get_data_chunk_count() == 4
    assert len(port.layers) == len(ref.layers) == 3   # 1 global + 2 local
    assert port.get_chunk_mapping() == ref.get_chunk_mapping() == [0, 1, 4, 5]
    assert [(a.pattern, a.data, a.coding) for a in port.layers] == \
        [(b.pattern, b.data, b.coding) for b in ref.layers]
    for width in (1, 4096, 12345, 1 << 20):
        assert port.get_chunk_size(width) == ref.get_chunk_size(width)
    assert port.get_profile() == {**ref.get_profile(), "device": "cpu"}
    convert.plugin_from_reference({"plugin": "lrc", "k": "4", "m": "2",
                                   "l": "3"}, convert.generator(ref), "cpu")


@pytest.mark.parametrize("profile", [
    {"k": 4, "m": 2, "l": 5},                  # (k+m) % l != 0
    {"k": 3, "m": 3, "l": 3},                  # k % groups != 0
    {"k": 4, "m": 2},                          # l missing
    {"k": 4, "m": 2, "l": 3, "mapping": "DD__"},  # kml + mapping
    {"mapping": "DD_"},                        # layers missing
    {"mapping": "DD_", "layers": '[["DDc_", ""]]'},  # pattern length
    {"mapping": "DD__", "layers": '[["DDc_", ""]]'},  # position 3 uncovered
], ids=["l5", "k3m3", "no-l", "kml-mapping", "no-layers", "pattern-length",
        "uncovered"])
def test_lrc_validation(profile):
    with pytest.raises(ErasureCodeError):
        _port("lrc", **profile)
    with pytest.raises(RefError):
        RefRegistry.instance().factory("lrc", _strs(profile))


@pytest.mark.parametrize("layers", [
    '[["DDc", ""]]',
    '[["DDc", {"plugin": "isa"}]]',
    '[["DDc", "plugin=jerasure technique=cauchy_good"]]',
], ids=["default", "isa-map", "kv-string"])
def test_lrc_explicit_layers(layers):
    port, ref = _pair("lrc", mapping="DD_", layers=layers)
    data, enc = _encode(port, ref, seed=1)
    _decode_equal(port, ref, enc, (1,))
    _decode_equal(port, ref, enc, (2,))
    assert convert.generator(port)[0].tobytes() == \
        convert.generator(ref)[0].tobytes()


def test_lrc_roundtrip_and_single_erasures():
    port, ref = _pair("lrc", k=4, m=2, l=3)
    data, enc = _encode(port, ref, seed=2)
    chunk_size = len(enc[0])
    assert port.decode_concat(enc, chunk_size) == data
    for lost in range(port.get_chunk_count()):
        _decode_equal(port, ref, enc, (lost,))
        have = {i: b for i, b in enc.items() if i != lost}
        assert port.decode_concat(have, chunk_size) == data


def test_lrc_local_repair_reads_fewer_chunks():
    port, ref = _pair("lrc", k=4, m=2, l=3)
    n = port.get_chunk_count()
    minimum = port.minimum_to_decode({0}, set(range(n)) - {0})
    assert minimum == ref.minimum_to_decode({0}, set(range(n)) - {0})
    # chunk 0's local group (l=3 chunks + local parity) suffices: fewer
    # reads than the global k=4, all of them in positions 0-3
    assert len(minimum) == 3
    assert set(minimum) <= {0, 1, 2, 3}


def test_lrc_read_plans_equal():
    port, ref = _pair("lrc", k=4, m=2, l=3)
    _plans_equal(port, ref, 3)


@pytest.mark.parametrize("pattern", [(0, 1), (0, 3), (4, 5)])
def test_lrc_double_erasure_falls_back_to_global(pattern):
    # two holes in ONE local group overwhelm the local parity; the global
    # layer (m=2) must absorb them
    port, ref = _pair("lrc", k=4, m=2, l=3)
    data, enc = _encode(port, ref, seed=3)
    _decode_equal(port, ref, enc, pattern)


def test_lrc_cascading_recovery():
    # a local parity AND a data chunk of the same group: decoding must
    # cascade (global recovers data, local layer re-derives its parity),
    # in the reference's order of layers
    port, ref = _pair("lrc", k=4, m=2, l=3)
    data, enc = _encode(port, ref, seed=4)
    _decode_equal(port, ref, enc, (0, 2, 3))


def test_lrc_unrecoverable_raises():
    port, ref = _pair("lrc", k=4, m=2, l=3)
    data, enc = _encode(port, ref, seed=5)
    pattern = (0, 1, 4, 5)       # all four data chunks
    chunks = {i: b for i, b in enc.items() if i not in pattern}
    with pytest.raises(ErasureCodeError):
        port.decode(set(pattern), chunks, len(enc[0]))
    with pytest.raises(RefError):
        ref.decode(set(pattern), chunks, len(enc[0]))


def test_lrc_cpu_pool_builds_cpu_layers():
    """The outer device goes to every layer, whose own profile check
    passes with it (the registry compares each key it was given)."""
    port = _port("lrc", k=4, m=2, l=3)
    assert port.device.type == "cpu"
    for layer in port.layers:
        assert layer.profile["device"] == "cpu"
        assert layer.code.get_profile()["device"] == "cpu"
        assert layer.code.device.type == "cpu"


def test_lrc_layer_names_its_own_device():
    layers = json.dumps([["DDc", {"device": "cuda"}]])
    if torch.cuda.is_available():
        code = _port("lrc", mapping="DD_", layers=layers)
        assert code.device.type == "cpu"
        assert code.layers[0].code.device.type == "cuda"
    else:
        with pytest.raises(DeviceUnavailable):
            _port("lrc", mapping="DD_", layers=layers)


def test_lrc_reference_layer_plugin_names():
    """A reference lrc profile whose layer runs the `tpu` plugin builds
    the port's `cuda` plugin in that layer."""
    ref_profile = {"plugin": "lrc", "mapping": "DD_",
                   "layers": json.dumps([["DDc", {"plugin": "tpu",
                                                  "k": "2", "m": "1"}]])}
    ref = RefRegistry.instance().factory("lrc", ref_profile)
    port = convert.plugin_from_reference(ref_profile, convert.generator(ref),
                                         "cpu")
    assert type(port.layers[0].code).__name__ == "ErasureCodeCuda"
    assert port.layers[0].code.device.type == "cpu"
    same = {"plugin": "lrc", "mapping": "DD_", "layers": '[["DDc", ""]]'}
    assert convert.port_profile(same) == same


# -- SHEC --------------------------------------------------------------------

@pytest.mark.parametrize("k,m,c,technique", [
    (6, 3, 2, "multiple"), (4, 3, 2, "single"), (8, 4, 3, "multiple"),
    (6, 4, 3, "multiple"),
])
def test_shec_matrix_is_shingled(k, m, c, technique):
    port, ref = _pair("shec", k=k, m=m, c=c, technique=technique)
    np.testing.assert_array_equal(port.matrix, ref.matrix)
    M = port.matrix
    widths = [np.count_nonzero(M[row]) for row in range(m)]
    assert all(w > 0 for w in widths)
    assert min(widths) < k
    # every data chunk is covered by at least c parities (durability)
    for col in range(k):
        assert np.count_nonzero(M[:, col]) >= c
    assert port.get_profile() == {**ref.get_profile(), "device": "cpu"}
    convert.plugin_from_reference(
        {"plugin": "shec", "k": str(k), "m": str(m), "c": str(c),
         "technique": technique}, convert.generator(ref), "cpu")


@pytest.mark.parametrize("profile", [
    {"k": 4, "m": 5, "c": 2},     # m > k
    {"k": 4, "m": 3, "c": 4},     # c > m
    {"k": 13, "m": 4, "c": 3},    # k > 12
    {"k": 4, "m": 3},             # c missing
    {"k": 4, "m": 3, "c": 2, "technique": "nope"},
    {"k": 4, "m": 3, "c": 2, "w": 16},
], ids=["m-gt-k", "c-gt-m", "k13", "no-c", "technique", "w16"])
def test_shec_validation(profile):
    with pytest.raises(ErasureCodeError):
        _port("shec", **profile)
    with pytest.raises(RefError):
        RefRegistry.instance().factory("shec", _strs(profile))


@pytest.mark.parametrize("k,m,c,technique", [
    (4, 3, 2, "multiple"), (6, 3, 2, "multiple"), (4, 3, 2, "single"),
    (8, 4, 3, "multiple"),
])
def test_shec_exhaustive_recoverable_erasures(k, m, c, technique):
    """Every erasure pattern up to c chunks: shec recovers any <= c
    erasures, to the same bytes in both packages."""
    port, ref = _pair("shec", k=k, m=m, c=c, technique=technique)
    data, enc = _encode(port, ref, seed=k * 7 + m)
    for r in range(1, c + 1):
        for pattern in itertools.combinations(range(k + m), r):
            _decode_equal(port, ref, enc, pattern)


@pytest.mark.parametrize("k,m,c", [(8, 4, 3), (6, 4, 3), (4, 3, 2)])
def test_shec_read_plans_equal(k, m, c):
    port, ref = _pair("shec", k=k, m=m, c=c)
    _plans_equal(port, ref, c + 1)


def test_shec_minimum_reads_window_not_all():
    port, ref = _pair("shec", k=8, m=4, c=3)
    minimum = port.minimum_to_decode({0}, set(range(12)) - {0})
    assert minimum == ref.minimum_to_decode({0}, set(range(12)) - {0})
    assert len(minimum) < 8, f"minimum {sorted(minimum)} not local"


def test_shec_unrecoverable_raises():
    port, ref = _pair("shec", k=6, m=4, c=3)
    data, enc = _encode(port, ref, seed=8)
    pattern = (0, 1, 2, 3, 4)             # more than m
    chunks = {i: b for i, b in enc.items() if i not in pattern}
    with pytest.raises(ErasureCodeError):
        port.decode(set(pattern), chunks, len(enc[0]))
    with pytest.raises(RefError):
        ref.decode(set(pattern), chunks, len(enc[0]))


@pytest.mark.parametrize("pattern", [(1, 5), (0, 3), (4, 6)])
def test_shec_decode_concat_roundtrip(pattern):
    port, ref = _pair("shec", k=4, m=3, c=2)
    data, enc = _encode(port, ref, seed=9)
    chunks = {i: b for i, b in enc.items() if i not in pattern}
    got = port.decode_concat(chunks, len(enc[0]))
    assert got == ref.decode_concat(chunks, len(enc[0])) == data
