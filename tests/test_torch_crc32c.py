"""The port's block crc32c (K2) and Checksummer against the JAX package.

On the CPU the port's wrapper runs the kernel's plain PyTorch version.
crc values are integers: every comparison is exact equality.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.native import ec_native as ref_native
from ceph_tpu.ops import crc32c as ref_crc
from ceph_tpu.utils.checksummer import Checksummer as RefChecksummer
from ceph_tpu_torch import convert
from ceph_tpu_torch.native import ec_native
from ceph_tpu_torch.ops import crc32c
from ceph_tpu_torch.utils.checksummer import Checksummer

SEEDS = (0xFFFFFFFF, 0, 0x1234ABCD)


def test_known_vector():
    # iSCSI check value: crc32c("123456789") = 0xE3069283 (standard, i.e.
    # seed -1 + final xor; ceph convention omits the final xor)
    assert ec_native.crc32c(b"123456789") ^ 0xFFFFFFFF == 0xE3069283


def test_table_and_zero_byte_op_equal_reference():
    np.testing.assert_array_equal(crc32c._table0(), ref_crc._table0())
    np.testing.assert_array_equal(crc32c._zero_byte_op(), ref_crc._zero_byte_op())


@pytest.mark.parametrize("bs", [1, 3, 64, 100, 512, 4096])
def test_crc_bitmatrix_equals_reference(bs):
    np.testing.assert_array_equal(crc32c.crc_bitmatrix(bs), ref_crc.crc_bitmatrix(bs))


@pytest.mark.parametrize("bs", [64, 512, 4096])
@pytest.mark.parametrize("seed", SEEDS)
def test_seed_const_equals_reference(bs, seed):
    assert crc32c._seed_const(bs, seed) == ref_crc._seed_const(bs, seed)


@functools.lru_cache(maxsize=None)
def _blocks(bs: int) -> np.ndarray:
    return np.random.default_rng(bs).integers(0, 256, (6, bs), dtype=np.uint8)


@pytest.mark.parametrize("bs", [512, 1024, 4096, 16384, 65536])
@pytest.mark.parametrize("seed", SEEDS)
def test_plain_k2_matches_jax_kernel_and_native(bs, seed):
    blocks = _blocks(bs)
    got = crc32c.Crc32cDevice(bs, seed, "cpu")(blocks)
    assert got.dtype == np.uint32 and got.shape == (6,)
    np.testing.assert_array_equal(got, ref_native.crc32c_blocks(blocks, bs, seed))
    jax_crc = ref_crc.get_device_crc(bs, seed)
    np.testing.assert_array_equal(got, np.asarray(jax_crc(blocks)))


@pytest.mark.parametrize("bs", [1, 33, 100, 700])
def test_plain_k2_ragged_block_sizes(bs):
    """K2 takes any block size, as the JAX kernel does."""
    blocks = np.random.default_rng(bs).integers(0, 256, (5, bs), dtype=np.uint8)
    got = crc32c.crc32c_blocks_plain(torch.from_numpy(blocks), 77).numpy()
    np.testing.assert_array_equal(got, ref_native.crc32c_blocks(blocks, bs, 77))


@pytest.mark.parametrize("bs", [100, 512, 4096])
def test_lane_advance_combines_segments(bs):
    """The kernel's host operands: per-lane table crcs advanced by the
    lane's Z power and XORed reproduce the crc (the kernel's algebra,
    replayed on the host)."""
    rng = np.random.default_rng(5)
    blk = rng.integers(0, 256, bs, dtype=np.uint8)
    seg = -(-bs // 32)
    A = crc32c._lane_advance(bs)
    acc = 0
    for lane in range(32):
        start, end = min(lane * seg, bs), min((lane + 1) * seg, bs)
        c = ec_native.crc32c(blk[start:end], 0)
        for bit in range(32):
            if c >> bit & 1:
                acc ^= int(A[bit, lane])
    assert acc ^ crc32c._seed_const(bs, 0xFFFFFFFF) == ec_native.crc32c(blk)
    t = crc32c._slice4_tables()
    assert t[1][0x5A] == crc32c._table0()[t[0][0x5A] & 0xFF] ^ (t[0][0x5A] >> 8)


def test_device_zero_blocks_are_the_seed_const():
    got = crc32c.Crc32cDevice(512, device="cpu")(np.zeros((4, 512), np.uint8))
    np.testing.assert_array_equal(got, ref_native.crc32c_blocks(
        np.zeros((4, 512), np.uint8), 512))


def test_wrapper_rejects_bad_inputs():
    crc = crc32c.Crc32cDevice(64, device="cpu")
    with pytest.raises(ValueError):
        crc.blocks(torch.zeros((2, 65), dtype=torch.uint8))
    with pytest.raises(TypeError):
        crc.blocks(torch.zeros((2, 64), dtype=torch.int16))
    with pytest.raises(ValueError):
        crc.blocks(torch.zeros((64, 2), dtype=torch.uint8).t())
    assert crc32c.launches == 0


@pytest.mark.parametrize("csum_type", ["crc32c", "crc32c_16", "crc32c_8"])
@pytest.mark.parametrize("path", ["host", "cpu-device", "cpu-tensor"])
def test_checksummer_matches_reference(csum_type, path):
    rng = np.random.default_rng(10)
    data = rng.integers(0, 256, 16 * 4096, dtype=np.uint8)
    ref = RefChecksummer(csum_type, 4096).calculate(data.tobytes())
    if path == "host":
        port = Checksummer(csum_type, 4096)
        got = port.calculate(data.tobytes())
    elif path == "cpu-device":
        port = Checksummer(csum_type, 4096, use_device=True, device="cpu")
        got = port.calculate(data.tobytes())
    else:                   # a CPU tensor (not on a card): native path
        port = Checksummer(csum_type, 4096)
        got = port.calculate(torch.from_numpy(data))
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, ref)
    if csum_type != "crc32c":
        bits = 16 if csum_type == "crc32c_16" else 8
        assert int(got.max()) < (1 << bits)
    assert port.verify(data.tobytes(), ref) == -1
    bad = data.copy()
    bad[5 * 4096 + 17] ^= 1
    assert port.verify(bad.tobytes(), ref) == 5 * 4096


def test_checksummer_device_path_matches_jax_device_path():
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, 16 * 4096, dtype=np.uint8)
    got = Checksummer("crc32c", 4096, use_device=True, device="cpu").calculate(data)
    ref = RefChecksummer("crc32c", 4096, use_device=True).calculate(jnp.asarray(data))
    np.testing.assert_array_equal(got, ref)


class _TensorOnCard(torch.Tensor):
    """A CPU tensor that reports itself as lying on a card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("use_device", [None, False, True])
@pytest.mark.parametrize("nblocks", [1, 16, 300])
def test_checksummer_keeps_card_tensors_on_the_card(monkeypatch, use_device,
                                                    nblocks):
    # a tensor on a card goes to the device crc at any block count and any
    # use_device; the host crc (which would copy it back) is never called
    calls = []

    def device_crc(block_size, seed=0xFFFFFFFF, device="cuda"):
        def run(blocks):
            calls.append((block_size, device, tuple(blocks.shape)))
            return crc32c.crc32c_blocks_plain(blocks).numpy().astype(np.uint32)
        return run

    def host_crc(*args):
        raise AssertionError("a tensor on a card reached the host crc")

    monkeypatch.setattr(crc32c, "get_device_crc", device_crc)
    monkeypatch.setattr(ec_native, "crc32c_blocks", host_crc)
    data = np.random.default_rng(12).integers(0, 256, nblocks * 512,
                                              dtype=np.uint8)
    on_card = torch.from_numpy(data).as_subclass(_TensorOnCard)
    got = Checksummer("crc32c", 512, use_device=use_device).calculate(on_card)
    assert calls == [(512, on_card.device, (nblocks, 512))]
    np.testing.assert_array_equal(
        got, RefChecksummer("crc32c", 512).calculate(data.tobytes()))


@pytest.mark.parametrize("use_device", [None, False])
def test_checksummer_keeps_host_buffers_on_the_host(monkeypatch, use_device):
    def device_crc(*args, **kwargs):
        raise AssertionError("a host buffer reached the device crc")

    monkeypatch.setattr(crc32c, "get_device_crc", device_crc)
    data = np.random.default_rng(13).integers(0, 256, 300 * 512, dtype=np.uint8)
    cs = Checksummer("crc32c", 512, use_device=use_device)
    want = RefChecksummer("crc32c", 512).calculate(data.tobytes())
    np.testing.assert_array_equal(cs.calculate(data.tobytes()), want)
    np.testing.assert_array_equal(cs.calculate(torch.from_numpy(data)), want)


def test_checksummer_misaligned_and_none():
    cs = Checksummer("crc32c", 4096)
    with pytest.raises(ValueError, match="not a multiple"):
        cs.calculate(b"x" * 4097)
    with pytest.raises(ValueError):
        Checksummer("crc32c", 4000)
    with pytest.raises(ValueError):
        Checksummer("xxhash64", 4096)
    assert Checksummer("none", 4096).calculate(b"x" * 4096).size == 0
    with pytest.raises(ValueError):
        cs.verify(b"x" * 8192, np.zeros(1, np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_crc_from_reference(seed):
    jax_crc = ref_crc.Crc32cDevice(512, seed)
    port = convert.crc_from_reference(np.asarray(jax_crc._L), int(jax_crc._const),
                                      512, "cpu")
    assert port.seed == seed
    blocks = _blocks(512)
    np.testing.assert_array_equal(port(blocks), np.asarray(jax_crc(blocks)))
    with pytest.raises(ValueError):
        convert.crc_from_reference(np.asarray(jax_crc._L)[:-8], 1, 512, "cpu")


# ---------------------------------------------------------------------------
# The kernel's algebra, emulated in numpy (ops/csrc/crc32c_blocks.cu)
# ---------------------------------------------------------------------------

# bs < 32, the byte path (ragged bs), and the 16-byte path at 1, 2 and 4
# words a lane a round
EMU_BLOCK_SIZES = (1, 31, 32, 33, 100, 512, 520, 1000, 1024, 2048, 4096, 4100, 8192,
                   65536)
EMU_SEEDS = (0xFFFFFFFF, 0, 0x12345678)


def _bank_private_tables() -> np.ndarray:
    """The kernel's shared-memory tables, (4, 256, 32) words [slice][entry]
    [lane]: uint4 i of the expansion holds words 4i..4i+3, each the flat
    table entry i >> 3."""
    flat = crc32c._slice4_tables().reshape(-1)
    uint4_of_word = np.arange(4 * 256 * 32) // 4
    return flat[uint4_of_word >> 3].reshape(4, 256, 32)


def _staged_words(seg_bytes: np.ndarray) -> np.ndarray:
    """(B, 32, seg) segment bytes of one warp -> (B, 32, seg // 16, 4)
    little-endian words in the order each lane reads them from its stage.
    A round stages q words a lane (q: the largest power of 2 <= 4 dividing
    seg / 16): copy k = i * 32 + lane moves word m = k % q of segment
    L = k // q into slot L * q + (m ^ sw(L)), sw(L) = (L >> (3 - log2 q))
    & (q - 1), and lane L reads slot L * q + (m ^ sw(L)) for m = 0..q-1."""
    nb, _, seg = seg_bytes.shape
    words = seg // 16
    lq = next(e for e in (2, 1, 0) if words % (1 << e) == 0)
    q = 1 << lq
    src = seg_bytes.reshape(nb, 32, words, 16)
    out = np.empty((nb, 32, words, 16), np.uint8)
    k = np.arange(32 * q)
    L, m = k >> lq, k & (q - 1)
    slot = L * q + (m ^ ((L >> (3 - lq)) & (q - 1)))
    assert sorted(slot) == list(range(32 * q))
    for g in range(0, 32 * q, 8):          # any 8 copies: 8 bank groups
        assert len(set(slot[g:g + 8] % 8)) == 8
    lanes = np.arange(32)
    for r in range(words // q):
        stage = np.zeros((nb, 32 * q, 16), np.uint8)
        stage[:, slot] = src[:, L, r * q + m]
        for mm in range(q):
            read = lanes * q + (mm ^ ((lanes >> (3 - lq)) & (q - 1)))
            if q > 1:                       # any 8 lanes: 8 bank groups
                assert all(len(set(read[g:g + 8] % 8)) == 8
                           for g in range(0, 32, 8))
            out[:, :, r * q + mm] = stage[:, read]
    return out.view("<u4").reshape(nb, 32, words, 4)


def emulate_k2(blocks: np.ndarray, seed: int) -> np.ndarray:
    """(B, bs) uint8 -> (B,) uint32 through the kernel's algebra: 32
    segments of ceil(bs / 32) bytes, segment l on lane l; slice-by-4 over
    staged 16-byte words when bs is a multiple of 512 (the kernel's 16-byte
    path), a byte loop otherwise; each lane's crc_0 advanced by
    `_lane_advance(bs)`, XORed over the lanes and with the seed constant."""
    nb, bs = blocks.shape
    T = _bank_private_tables()
    np.testing.assert_array_equal(T[:, :, 7], crc32c._slice4_tables())
    seg = -(-bs // 32)
    lane = np.arange(32)
    crc = np.zeros((nb, 32), np.uint32)
    if bs % 512 == 0:
        words = _staged_words(blocks.reshape(nb, 32, seg))
        np.testing.assert_array_equal(             # each lane reads its own
            words.reshape(nb, 32, seg // 4),       # segment, in order
            blocks.reshape(nb, 32, seg).view("<u4"))
        for j in range(seg // 16):
            for w in range(4):
                c = crc ^ words[:, :, j, w]
                crc = (T[3][c & 0xFF, lane] ^ T[2][(c >> 8) & 0xFF, lane]
                       ^ T[1][(c >> 16) & 0xFF, lane] ^ T[0][c >> 24, lane])
    else:
        padded = np.zeros((nb, 32 * seg), np.uint8)
        padded[:, :bs] = blocks
        segs = padded.reshape(nb, 32, seg)
        for i in range(seg):
            active = lane * seg + i < bs
            stepped = T[0][(crc ^ segs[:, :, i]) & 0xFF, lane] ^ (crc >> 8)
            crc = np.where(active, stepped, crc)
    A = crc32c._lane_advance(bs)                           # (32 bit, 32 lane)
    bits = (crc[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    advanced = np.bitwise_xor.reduce(
        np.where(bits == 1, A.T[None], np.uint32(0)), axis=2)   # (B, 32)
    return (np.bitwise_xor.reduce(advanced, axis=1)
            ^ np.uint32(crc32c._seed_const(bs, seed))).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _emu_case(bs: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    blocks = np.random.default_rng(bs + 1).integers(0, 256, (5, bs),
                                                    dtype=np.uint8)
    jax_crc = np.asarray(ref_crc._crc_blocks_jit(
        jnp.asarray(crc32c.crc_bitmatrix(bs).astype(np.int8)),
        jnp.uint32(ref_crc._seed_const(bs, seed)), jnp.asarray(blocks), bs))
    return blocks, jax_crc


@pytest.mark.parametrize("seed", EMU_SEEDS)
@pytest.mark.parametrize("bs", EMU_BLOCK_SIZES)
def test_emulated_kernel_equals_jax_and_native(bs, seed):
    blocks, jax_crc = _emu_case(bs, seed)
    got = emulate_k2(blocks, seed)
    np.testing.assert_array_equal(got, jax_crc)
    np.testing.assert_array_equal(got, ref_native.crc32c_blocks(blocks, bs,
                                                                seed))

