"""The port's mesh (ceph_tpu_torch/parallel/mesh.py) and K3's plain
version against the JAX package's mesh, on the CPU: the port's mesh is 8
x "cpu", the reference's the conftest's 8 virtual CPU devices. Same numpy
inputs from a seed; parity, reconstructed bytes and checksums must be
equal (tolerance 0: integer outputs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ceph_tpu.ec import gf256 as ref_gf256
from ceph_tpu.osd import ec_util as ref_ec_util
from ceph_tpu.ops import rs_codec as ref_rs_codec
from ceph_tpu.parallel import mesh as ref_mesh
from ceph_tpu_torch.ec import gf256
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.ops import rs_codec
from ceph_tpu_torch.parallel import mesh

K, M = 8, 3
CPU8 = ["cpu"] * 8


def _meshes(stripe=None, shard_max=M):
    return (mesh.make_mesh(8, stripe=stripe, shard_max=shard_max,
                           devices=CPU8),
            ref_mesh.make_mesh(8, stripe=stripe, shard_max=shard_max))


def _ref_place(ref, data: np.ndarray):
    return jax.device_put(jnp.asarray(data),
                          NamedSharding(ref, P("stripe", None, None)))


@pytest.mark.parametrize("stripe,shard_max", [
    (None, 3), (None, 1), (None, 2), (None, 8), (1, 3), (2, 3), (4, 3),
    (8, 3)])
def test_make_mesh_shape_matches_reference(stripe, shard_max):
    port, ref = _meshes(stripe, shard_max)
    assert port.shape == dict(ref.shape)
    assert [d for row in port.devices for d in row] == \
        [torch.device("cpu")] * 8


def test_make_mesh_rejects_stripe_not_dividing():
    with pytest.raises(ValueError):
        ref_mesh.make_mesh(8, stripe=3)
    with pytest.raises(ValueError):
        mesh.make_mesh(8, stripe=3, devices=CPU8)


@pytest.mark.parametrize("m_pad,rows,part", [
    (3, 3, 0),          # 1 shard column: all three rows
    (4, 2, 0), (4, 2, 1),   # 2 columns: the second holds one padding row
    (3, 1, 2),          # 3 columns
    (8, 1, 5),          # a column of padding only
])
def test_encode_local_matches_reference(m_pad, rows, part):
    """K3's wrapper on CPU tensors (its plain version) against
    `_encode_local` plus the checksum of `sharded_encode_fn`, on one
    row slice of the padded coding matrix, at a ragged N."""
    coding = np.zeros((m_pad, K), dtype=np.uint8)
    coding[:M] = gf256.reed_sol_van_matrix(K, M)
    lo, hi = part * rows, (part + 1) * rows
    B_local = ref_gf256.matrix_to_bitmatrix(coding)[lo * 8:hi * 8]
    data = np.random.default_rng(5 + part).integers(
        0, 256, (3, K, 1001), dtype=np.uint8)
    ref_parity = ref_mesh._encode_local(
        jnp.asarray(B_local.astype(np.int8)), jnp.asarray(data))
    ref_csum = int(jnp.sum(ref_parity.astype(jnp.uint32)
                           * jnp.uint32(rs_codec.CSUM_MUL)))
    packed = torch.from_numpy(np.ascontiguousarray(
        rs_codec.packed_bitmatrix(coding)[lo:hi]))
    parity, csum = rs_codec.encode_local(
        packed, torch.from_numpy(np.ascontiguousarray(B_local)),
        torch.from_numpy(data))
    np.testing.assert_array_equal(parity.numpy(), np.asarray(ref_parity))
    assert csum.dtype == torch.int64 and int(csum) == ref_csum


@pytest.mark.parametrize("stripe", [2, 4, 8])
def test_sharded_encode_matches_reference(stripe):
    port, ref = _meshes(stripe=stripe)
    data = np.random.default_rng(7).integers(0, 256, (8, K, 2048),
                                             dtype=np.uint8)
    ref_parity, ref_csum = jax.block_until_ready(
        ref_mesh.sharded_encode_fn(ref, K, M)(_ref_place(ref, data)))
    parity, csum = mesh.sharded_encode_fn(port, K, M)(torch.from_numpy(data))
    np.testing.assert_array_equal(parity.numpy(), np.asarray(ref_parity))
    assert int(csum) == int(ref_csum)
    coding = gf256.reed_sol_van_matrix(K, M)
    np.testing.assert_array_equal(
        parity.numpy(), np.stack([gf256.mat_vec_apply(coding, d)
                                  for d in data]))


@pytest.mark.parametrize("erased", [
    (0,), (K + 2,), (0, 1, 2), (2, 7, 9), (K, K + 1, K + 2), (1, 5, K + 1),
])
def test_pipeline_step_matches_reference(erased):
    port, ref = _meshes()
    data = np.random.default_rng(11).integers(0, 256, (4, K, 1024),
                                              dtype=np.uint8)
    ref_errs, ref_csum = jax.block_until_ready(
        ref_mesh.sharded_pipeline_step_fn(ref, K, M, erased)(
            _ref_place(ref, data)))
    errs, csum = mesh.sharded_pipeline_step_fn(port, K, M, erased)(
        torch.from_numpy(data))
    assert int(errs) == int(ref_errs) == 0
    assert int(csum) == int(ref_csum)


def test_pipeline_step_rejects_bad_erasures():
    port, _ = _meshes()
    for erased in ((0, 1, 2, 3), (0, 0), (K + M,)):
        with pytest.raises(ValueError):
            mesh.sharded_pipeline_step_fn(port, K, M, erased)


@pytest.mark.parametrize("rows", [3, 8, 13])   # non-multiples pad
def test_sharded_apply_fn_matches_reference(rows):
    """The service's oversized-batch shape, host in and host out, for
    the coding matrix and a recovery matrix."""
    port, ref = _meshes(stripe=8, shard_max=1)
    coding = gf256.reed_sol_van_matrix(K, M)
    data = np.random.default_rng(3).integers(0, 256, (rows, K, 1024),
                                             dtype=np.uint8)
    parity = mesh.sharded_apply_fn(port, coding)(data)
    assert parity.shape == (rows, M, 1024)
    np.testing.assert_array_equal(
        parity, ref_mesh.sharded_apply_fn(ref, coding)(data))
    avail = tuple(i for i in range(K + M) if i not in (0, 1, 2))[:K]
    R = rs_codec.recovery_matrix(coding, avail, (0, 1, 2))
    np.testing.assert_array_equal(
        R, ref_rs_codec.recovery_matrix(coding, avail, (0, 1, 2)))
    full = np.concatenate([data, parity], axis=1)
    rec = mesh.sharded_apply_fn(port, R)(full[:, avail, :])
    np.testing.assert_array_equal(
        rec, ref_mesh.sharded_apply_fn(ref, R)(full[:, avail, :]))
    np.testing.assert_array_equal(rec, full[:, (0, 1, 2), :])


@pytest.mark.parametrize("stripe,shard_max,lost", [
    (None, M, (0, 1, 2)), (8, 1, (1, K, K + 2))])
def test_mesh_storage_impl_matches_reference(stripe, shard_max, lost):
    """The storage path of the multi-device dry run: ECUtil encode, shard
    rebuild and degraded read over mesh_storage_impl, port against
    reference, at a stripe count that is not a multiple of the mesh's
    stripe extent."""
    port, ref = _meshes(stripe, shard_max)
    chunk = 2048
    impl = mesh.mesh_storage_impl(port, K, M)
    ref_impl = ref_mesh.mesh_storage_impl(ref, K, M)
    sinfo = ec_util.StripeInfo(K, K * chunk)
    ref_sinfo = ref_ec_util.StripeInfo(K, K * chunk)
    n_stripes = port.shape["stripe"] * 2 + 1
    payload = np.random.default_rng(1).integers(
        0, 256, n_stripes * K * chunk, dtype=np.uint8).tobytes()
    shards = {i: bytes(b) for i, b in
              ec_util.encode(sinfo, impl, payload).items()}
    assert shards == {i: bytes(b) for i, b in
                      ref_ec_util.encode(ref_sinfo, ref_impl, payload).items()}
    survivors = {i: shards[i] for i in range(K + M) if i not in lost}
    rebuilt = ec_util.decode_shards(sinfo, impl, survivors, lost)
    assert rebuilt == ref_ec_util.decode_shards(ref_sinfo, ref_impl,
                                                survivors, lost)
    assert all(rebuilt[i] == shards[i] for i in lost)
    assert ec_util.decode_concat(sinfo, impl, survivors) == payload
    # one recovery encoder per erasure pattern: the rebuild's, and the
    # degraded read's when it misses other chunks (data only)
    assert len(impl._dec_cache) == (1 if max(lost) < K else 2)
