"""The port's `cuda` and `jerasure` plugins against the JAX package's `tpu`
and `jerasure` plugins, on the CPU (profile key device=cpu), with exact
byte equality; plus every entry of the archived corpus and the port's
registry."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ec.registry import ErasureCodePluginRegistry as RefRegistry
from ceph_tpu_torch import convert
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry

CORPUS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "ceph-erasure-code-corpus", "v1")

# (port plugin, reference plugin, profile)
CASES = [
    ("cuda", "tpu", {"k": "8", "m": "3"}),
    ("cuda", "tpu", {"k": "8", "m": "3", "technique": "cauchy_good"}),
    ("cuda", "tpu", {"k": "4", "m": "2"}),
    ("jerasure", "jerasure", {"k": "4", "m": "2", "technique": "reed_sol_van"}),
    ("jerasure", "jerasure", {"k": "6", "m": "2", "technique": "reed_sol_r6_op"}),
    ("jerasure", "jerasure", {"k": "5", "m": "3", "technique": "cauchy_orig"}),
    ("jerasure", "jerasure", {"k": "6", "m": "2", "technique": "cauchy_good"}),
]
IDS = [f"{p}-{'-'.join(f'{k}={v}' for k, v in prof.items())}" for p, _, prof in CASES]


def _pair(port_name, ref_name, profile):
    port = ErasureCodePluginRegistry.instance().factory(
        port_name, {**profile, "plugin": port_name, "device": "cpu"})
    ref = RefRegistry.instance().factory(ref_name, {**profile, "plugin": ref_name})
    return port, ref


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_geometry_and_matrix(case):
    port, ref = _pair(*case)
    np.testing.assert_array_equal(port.coding_matrix, ref.coding_matrix)
    assert port.get_chunk_count() == ref.get_chunk_count()
    for width in (1, 4096, 12345, 1 << 20):
        assert port.get_chunk_size(width) == ref.get_chunk_size(width)
    assert convert.plugin_from_reference(
        {**case[2], "plugin": case[1]}, ref.coding_matrix, "cpu").coding_matrix \
        .tobytes() == ref.coding_matrix.tobytes()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_scalar_encode_decode(case):
    port, ref = _pair(*case)
    n = port.get_chunk_count()
    payload = np.random.default_rng(n).integers(0, 256, 5000, np.uint8).tobytes()
    enc = port.encode(range(n), payload)
    assert enc == ref.encode(range(n), payload)
    k = port.get_data_chunk_count()
    m = n - k
    for erased in ({0}, set(range(k - 1, k - 1 + m)), set(range(n - m, n))):
        have = {i: b for i, b in enc.items() if i not in erased}
        got = port.decode(range(n), have, len(enc[0]))
        assert got == ref.decode(range(n), have, len(enc[0]))
        assert got == enc
        assert port.decode_concat(have, len(enc[0]))[:len(payload)] == payload


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("form", ["numpy", "tensor"])
def test_batched_stripes(case, form):
    port, ref = _pair(*case)
    k, n = port.get_data_chunk_count(), port.get_chunk_count()
    rng = np.random.default_rng(3)
    stripes = rng.integers(0, 256, (5, k, 384), dtype=np.uint8)
    want = np.asarray(ref.encode_stripes(stripes))
    src = stripes if form == "numpy" else torch.from_numpy(stripes)
    parity = port.encode_stripes(src)
    assert isinstance(parity, np.ndarray if form == "numpy" else torch.Tensor)
    np.testing.assert_array_equal(np.asarray(parity), want)
    words = np.concatenate([stripes, want], axis=1)
    erased = (1, n - 1)
    avail = tuple(i for i in range(n) if i not in erased)[:k]
    chunks = np.ascontiguousarray(words[:, list(avail)])
    want_rec = np.asarray(ref.decode_stripes(avail, erased, chunks))
    src = chunks if form == "numpy" else torch.from_numpy(chunks)
    rec = port.decode_stripes(avail, erased, src)
    np.testing.assert_array_equal(np.asarray(rec), want_rec)
    np.testing.assert_array_equal(np.asarray(rec), words[:, list(erased)])


def test_cuda_plugin_matches_tpu_plugin_on_device_arrays():
    """Device in => device out on both sides, same bytes."""
    port, ref = _pair("cuda", "tpu", {"k": "8", "m": "3"})
    stripes = np.random.default_rng(4).integers(0, 256, (3, 8, 1024), np.uint8)
    want = np.asarray(ref.encode_stripes(jnp.asarray(stripes)))
    got = port.encode_stripes(torch.from_numpy(stripes))
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_read_only_host_views_are_staged():
    """ECUtil hands read-only np.frombuffer views; the plugin copies them."""
    port, _ = _pair("cuda", "tpu", {"k": "4", "m": "2"})
    buf = bytes(range(256)) * 4 * 3
    view = np.frombuffer(buf, dtype=np.uint8).reshape(3, 4, 256)
    assert not view.flags.writeable
    np.testing.assert_array_equal(
        port.encode_stripes(view), port.encode_stripes(view.copy()))


@pytest.mark.parametrize("entry", sorted(os.listdir(CORPUS)))
def test_corpus_reproduces(entry):
    d = os.path.join(CORPUS, entry)
    with open(os.path.join(d, "profile.json")) as f:
        profile = json.load(f)
    profile = {**convert.port_profile(profile), "device": "cpu"}
    code = ErasureCodePluginRegistry.instance().factory(profile["plugin"],
                                                        profile)
    with open(os.path.join(d, "payload"), "rb") as f:
        payload = f.read()
    chunks = code.encode(range(code.get_chunk_count()), payload)
    archived = sorted(int(x) for x in os.listdir(d) if x.isdigit())
    assert archived == sorted(chunks)
    for cid in archived:
        with open(os.path.join(d, str(cid)), "rb") as f:
            assert f.read() == chunks[cid], f"{entry} chunk {cid}"


def test_registry_loads_port_plugins():
    reg = ErasureCodePluginRegistry.instance()
    assert reg is not RefRegistry.instance()
    for name in ("cuda", "jerasure", "isa", "shec", "lrc", "clay"):
        plugin = reg.load(name)
        assert type(plugin).__module__ == f"ceph_tpu_torch.ec.plugin_{name}"
    code = reg.factory("cuda", {"device": "cpu"})
    assert (code.k, code.m, code.device_batched) == (8, 3, True)
    assert code.get_profile()["device"] == "cpu"


@pytest.mark.parametrize("technique", ["reed_sol_van", "reed_sol_r6_op",
                                       "cauchy_orig", "cauchy_good",
                                       "liberation", "blaum_roth",
                                       "liber8tion"])
def test_every_jerasure_technique_loads(technique):
    code = ErasureCodePluginRegistry.instance().factory(
        "jerasure", {"k": "4", "m": "2", "technique": technique,
                     "device": "cpu"})
    assert code.technique == technique
    assert code.get_profile()["device"] == "cpu"


def test_registry_rejects_unknown():
    reg = ErasureCodePluginRegistry.instance()
    with pytest.raises(ErasureCodeError, match="no builtin plugin"):
        reg.factory("tpu", {"device": "cpu"})
    with pytest.raises(ErasureCodeError):
        reg.factory("jerasure", {"technique": "nope", "device": "cpu"})
    with pytest.raises(ErasureCodeError):
        reg.factory("cuda", {"technique": "cauchy_orig", "device": "cpu"})
