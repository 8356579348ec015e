"""The port's bit-matrix codec (K1) against the JAX package's MatrixCodec.

Inputs are made with numpy from fixed seeds and fed to both packages; all
values are integers, so every comparison is exact byte equality. On the
CPU the port's wrapper runs the kernel's plain PyTorch version.
"""
import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ec import gf256 as ref_gf256
from ceph_tpu.ops import rs_codec as ref_rs
from ceph_tpu_torch import convert
from ceph_tpu_torch.ec import gf256
from ceph_tpu_torch.ops import rs_codec

CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _reference_case(k: int, m: int):
    """Data (8, k, 4097) and the JAX package's encode of it. The map is
    column-wise and stripe-wise independent, so every smaller (batch, N)
    case is a slice of this one: one XLA program per (k, m)."""
    rng = np.random.default_rng(1000 * k + m)
    data = rng.integers(0, 256, (8, k, 4097), dtype=np.uint8)
    M = ref_gf256.reed_sol_van_matrix(k, m)
    want = np.asarray(ref_rs.MatrixCodec.get(M).apply_batch_device(
        jnp.asarray(data)))
    return data, want


@pytest.mark.parametrize("k,m,n,b", list(itertools.product(
    (2, 4, 8, 12, 16), (1, 2, 3, 4), (1, 7, 1000, 4097), (1, 3, 8))))
def test_plain_k1_matches_reference(k, m, n, b):
    data, want = _reference_case(k, m)
    src = np.ascontiguousarray(data[:b, :, :n])
    codec = rs_codec.MatrixCodec.get(gf256.reed_sol_van_matrix(k, m))
    got = codec.apply_batch_device(torch.from_numpy(src)).numpy()
    assert got.shape == (b, m, n)
    np.testing.assert_array_equal(got, want[:b, :, :n])


@pytest.mark.parametrize("k,m,n", [(2, 1, 100), (4, 2, 4096), (8, 3, 1 << 15),
                                   (10, 4, 3333)])
def test_host_apply_matches_numpy_ground_truth(k, m, n):
    rng = np.random.default_rng(10)
    data = rng.integers(0, 256, (k, n)).astype(np.uint8)
    M = gf256.reed_sol_van_matrix(k, m)
    want = rs_codec.apply_matrix_np(M, data)
    got = rs_codec.MatrixCodec.get(M).apply(data, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, ref_rs.MatrixCodec.get(ref_gf256.reed_sol_van_matrix(k, m)).apply(data))


def test_all_erasure_patterns_k8_m3():
    """All C(11, 3) = 165 three-erasure patterns: the port's recovery
    matrix equals the reference's, its decode equals the reference's
    decode and rebuilds the erased chunks."""
    k, m, n = 8, 3, 256
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, (2, k, n), dtype=np.uint8)
    coding = gf256.reed_sol_van_matrix(k, m)
    parity = rs_codec.MatrixCodec.get(coding).apply_batch_device(
        torch.from_numpy(data)).numpy()
    words = np.concatenate([data, parity], axis=1)        # (2, 11, n)
    patterns = list(itertools.combinations(range(k + m), m))
    assert len(patterns) == 165
    for erased in patterns:
        avail = tuple(i for i in range(k + m) if i not in erased)[:k]
        R = rs_codec.recovery_matrix(coding, avail, erased)
        np.testing.assert_array_equal(
            R, ref_rs.recovery_matrix(ref_gf256.reed_sol_van_matrix(k, m),
                                      avail, erased))
        src = np.ascontiguousarray(words[:, list(avail)])
        rec = rs_codec.MatrixCodec.get(R).apply_batch_device(
            torch.from_numpy(src)).numpy()
        ref = np.asarray(ref_rs.MatrixCodec.get(R).apply_batch_device(
            jnp.asarray(src)))
        np.testing.assert_array_equal(rec, ref)
        np.testing.assert_array_equal(rec, words[:, list(erased)])


@pytest.mark.parametrize("nerased", [1, 2])
def test_fewer_erasures_recover(nerased):
    k, m, n = 4, 2, 512
    rng = np.random.default_rng(12)
    data = rng.integers(0, 256, (k, n), dtype=np.uint8)
    coding = gf256.reed_sol_van_matrix(k, m)
    words = np.vstack([data, rs_codec.apply_matrix_np(coding, data)])
    for erased in itertools.combinations(range(k + m), nerased):
        avail = tuple(i for i in range(k + m) if i not in erased)[:k]
        R = rs_codec.recovery_matrix(coding, avail, erased)
        rec = rs_codec.MatrixCodec.get(R).apply(words[list(avail)], "cpu")
        np.testing.assert_array_equal(rec, words[list(erased)])


def test_recovery_matrix_identity_when_available():
    coding = gf256.reed_sol_van_matrix(4, 2)
    R = rs_codec.recovery_matrix(coding, (0, 1, 2, 3), (0, 2))
    np.testing.assert_array_equal(R[0], np.eye(4, dtype=np.uint8)[0])
    np.testing.assert_array_equal(R[1], np.eye(4, dtype=np.uint8)[2])


def test_recovery_matrix_needs_k_chunks():
    with pytest.raises(ValueError):
        rs_codec.recovery_matrix(gf256.reed_sol_van_matrix(4, 2), (0, 1, 2), (3,))


@pytest.mark.parametrize("construction,args", [
    ("reed_sol_van_matrix", (8, 3)), ("reed_sol_van_matrix", (12, 4)),
    ("reed_sol_r6_matrix", (6,)), ("cauchy_orig_matrix", (8, 3)),
    ("cauchy_good_matrix", (8, 3)), ("cauchy_good_matrix", (6, 2))])
def test_matrix_constructions_equal_reference(construction, args):
    M = getattr(gf256, construction)(*args)
    np.testing.assert_array_equal(M, getattr(ref_gf256, construction)(*args))
    np.testing.assert_array_equal(gf256.matrix_to_bitmatrix(M),
                                  ref_gf256.matrix_to_bitmatrix(M))


def test_field_tables_equal_reference():
    np.testing.assert_array_equal(gf256.GF_MUL_TABLE, ref_gf256.GF_MUL_TABLE)
    np.testing.assert_array_equal(gf256.GF_INV_TABLE, ref_gf256.GF_INV_TABLE)
    M = gf256.cauchy_good_matrix(5, 3)[:, :3]
    np.testing.assert_array_equal(gf256.mat_invert(M), ref_gf256.mat_invert(M))


def test_packed_bitmatrix_is_bitmatrix_columns():
    """P[i, j, c] bit r == bitmatrix[i*8+r, j*8+c]: the kernel's operand
    carries exactly the bitmatrix."""
    M = gf256.cauchy_good_matrix(6, 3)
    P = rs_codec.packed_bitmatrix(M)
    B = gf256.matrix_to_bitmatrix(M)
    unpacked = (P[:, None, :, :] >> np.arange(8)[None, :, None, None]) & 1
    np.testing.assert_array_equal(unpacked.reshape(3 * 8, 6 * 8), B)


def test_codec_cache_and_lru_bound(monkeypatch):
    M = gf256.reed_sol_van_matrix(4, 2)
    assert rs_codec.MatrixCodec.get(M) is rs_codec.MatrixCodec.get(np.array(M))
    monkeypatch.setattr(rs_codec.MatrixCodec, "_cache",
                        type(rs_codec.MatrixCodec._cache)())
    monkeypatch.setattr(rs_codec.MatrixCodec, "_CACHE_MAX", 3)
    mats = [gf256.reed_sol_van_matrix(2 + i, 1) for i in range(4)]
    first = rs_codec.MatrixCodec.get(mats[0])
    for Mi in mats[1:3]:
        rs_codec.MatrixCodec.get(Mi)
    assert rs_codec.MatrixCodec.get(mats[0]) is first     # refreshes mats[0]
    rs_codec.MatrixCodec.get(mats[3])                     # evicts mats[1]
    assert len(rs_codec.MatrixCodec._cache) == 3
    assert rs_codec.MatrixCodec.get(mats[0]) is first
    keys = list(rs_codec.MatrixCodec._cache)
    assert mats[1].tobytes() + bytes(mats[1].shape) not in keys


def test_wrapper_rejects_bad_inputs():
    codec = rs_codec.MatrixCodec.get(gf256.reed_sol_van_matrix(4, 2))
    x = torch.zeros((2, 4, 64), dtype=torch.uint8)
    with pytest.raises(TypeError):
        codec.apply_batch_device(x.to(torch.int32))
    with pytest.raises(ValueError):
        codec.apply_batch_device(x.transpose(0, 1))
    with pytest.raises(ValueError):
        codec.apply_batch_device(torch.zeros((2, 5, 64), dtype=torch.uint8))
    assert rs_codec.launches == 0        # the CPU never launches a kernel


def test_codec_from_reference():
    M = ref_gf256.cauchy_good_matrix(8, 3)
    codec = convert.codec_from_reference(np.asarray(M), "cpu")
    assert codec is rs_codec.MatrixCodec.get(M)
    packed, bitm = codec._bitmatrix_for(CPU)
    np.testing.assert_array_equal(bitm.numpy(), ref_gf256.matrix_to_bitmatrix(M))
    data = np.random.default_rng(3).integers(0, 256, (8, 300), dtype=np.uint8)
    np.testing.assert_array_equal(
        codec.apply(data, "cpu"), ref_rs.MatrixCodec.get(M).apply(data))
