"""K3's algebra on the CPU: a numpy emulation of the kernel in
ceph_tpu_torch/ops/csrc/gf_bitmatrix_csum.cu against the JAX package's
`_encode_local` (ceph_tpu/parallel/mesh.py:54) plus the checksum of
`sharded_encode_fn` (:96-97), on the same seeded inputs. Parity bytes and
checksums must be equal (tolerance 0: integer outputs).

`emulate_k3` mirrors the kernel's constants (threads per CTA, input rows
per chunk, the operand table's row padding), its product-form
contraction, its persistent item walk, its per-CTA partials and the last
CTA's sum; `test_constants_mirror_the_kernel` holds those constants to the
source, so change both together."""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ceph_tpu.ec import gf256 as ref_gf256
from ceph_tpu.parallel import mesh as ref_mesh
from ceph_tpu_torch.ops import rs_codec

SOURCE = os.path.join(os.path.dirname(rs_codec.__file__), "csrc",
                      "gf_bitmatrix_csum.cu")
THREADS = 256           # kThreads
ROWS = 4                # kRows: input rows loaded ahead
STEP = 8                # kStep: the table's rows padded to a multiple
LANES = np.uint32(0x01010101)


def test_constants_mirror_the_kernel():
    src = open(SOURCE).read()
    for name, value in (("kThreads", THREADS), ("kRows", ROWS),
                        ("kStep", STEP)):
        m = re.search(rf"constexpr int {name} = ([^;]+);", src)
        assert m is not None, name
        assert eval(m.group(1), {"kRows": ROWS}) == value, name


def _mask(w: np.ndarray, c: int) -> np.ndarray:
    """0xFF in each byte lane of w whose bit c is set (K1's form)."""
    return ((w >> np.uint32(c)) & LANES) * np.uint32(0xFF)


@pytest.mark.parametrize("c", range(8))
def test_product_equals_mask_for_every_byte_and_operand(c):
    """b_c * P == mask & splat(P) for all 256 bytes and all 256 P: the
    product carries nothing across byte lanes."""
    x = np.arange(256, dtype=np.uint32)
    P = np.arange(256, dtype=np.uint32)
    bit = (x[:, None] >> np.uint32(c)) & np.uint32(1)
    want = np.where(bit == 1, P[None, :], np.uint32(0))
    np.testing.assert_array_equal(bit * P[None, :], want)
    # four byte lanes in one word: lane L holds byte x ^ (37 L)
    w = np.zeros(256, np.uint32)
    for lane in range(4):
        w |= ((x ^ np.uint32(37 * lane)) & np.uint32(0xFF)) << np.uint32(8 * lane)
    for p in (0, 1, 0x80, 0xFF, 0x1D, 0xA7):
        prod = ((w >> np.uint32(c)) & LANES) * np.uint32(p)
        np.testing.assert_array_equal(prod, _mask(w, c) & (np.uint32(p) * LANES))


def _grid(items: int, groups: int, sms: int, per_sm: int,
          slots: int = 2048) -> int:
    """The host's grid.x: min(SMs x CTAs per SM / groups, work, slots)."""
    blocks = sms * max(per_sm, 1) // groups
    blocks = min(blocks, -(-items // THREADS), slots // groups)
    return max(blocks, 1)


def _walk(b: int, per_stripe: int, grid_x: int):
    """Each round of the persistent walk: (thread ids, stripes, column
    blocks) of the threads still in range, stepping (s, cb) by the grid
    stride split the kernel's way (no division per item)."""
    first = np.arange(grid_x * THREADS, dtype=np.int64)
    s, cb = first // per_stripe, first % per_stripe
    ds, dcb = divmod(grid_x * THREADS, per_stripe)
    while True:
        live = s < b
        if not live.any():
            return
        yield first[live], s[live], cb[live]
        cb = cb + dcb
        s = s + ds
        wrap = cb >= per_stripe
        cb = np.where(wrap, cb - per_stripe, cb)
        s = np.where(wrap, s + 1, s)


@pytest.mark.parametrize("b,n,vec,grid_x", [
    (1, 16, True, 1), (3, 1024, True, 1), (3, 4097, False, 2),
    (5, 16 * 700, True, 3), (2, 1, False, 1), (7, 4000, True, 5)])
def test_walk_covers_each_item_once(b, n, vec, grid_x):
    cols = 16 if vec else 4
    per_stripe = -(-n // cols)
    seen = np.zeros((b, per_stripe), np.int64)
    rounds = 0
    for _, s, cb in _walk(b, per_stripe, grid_x):
        np.add.at(seen, (s, cb), 1)
        rounds += 1
    np.testing.assert_array_equal(seen, 1)
    assert rounds == -(-b * per_stripe // (grid_x * THREADS))


def _table(packed: np.ndarray, row0: int, k: int) -> np.ndarray:
    """(kpad*8, 4) uint32: the operands P of rows row0..row0+3 for each
    (j, c), zero past r and past k."""
    r = packed.shape[0]
    kpad = -(-k // STEP) * STEP
    tab = np.zeros((kpad * 8, 4), np.uint32)
    for g in range(4):
        if row0 + g < r:
            tab[:k * 8, g] = packed[row0 + g].reshape(-1)
    return tab


def _contract(acc: np.ndarray, w: np.ndarray, tab_j: np.ndarray,
              rg: int) -> None:
    """acc (RG, m, W) ^= input words w (m, W) of one row j contracted
    with its 8 table entries: b_c * P per bit c and row."""
    for c in range(8):
        bit = (w >> np.uint32(c)) & LANES                # 0 or 1 per lane
        for g in range(rg):
            acc[g] ^= bit * tab_j[c, g]


def emulate_k3(packed: np.ndarray, data: np.ndarray, vec: bool, sms: int,
               per_sm: int) -> tuple[np.ndarray, int]:
    """(parity (b, r, n) uint8, checksum) through the kernel's algebra:
    row groups of RG = min(r, 4) as grid.y, the persistent walk over
    (stripe, column block) items, kRows rows a chunk loaded with the row
    index clamped to k - 1, the contraction, per-thread byte sums of the
    words written, per-CTA partials, and their sum (taken by whichever
    CTA takes the last ticket: unsigned sums are order-free), times
    2654435761, mod 2^32."""
    r, k, _ = packed.shape
    b, _, n = data.shape
    rg = min(r, 4)
    groups = -(-r // rg)
    W, cols = (4, 16) if vec else (1, 4)
    per_stripe = -(-n // cols)
    padded = np.zeros((b, k, per_stripe * cols), np.uint8)
    padded[:, :, :n] = data                   # masked loads read zeros
    words = padded.view("<u4").reshape(b, k, per_stripe, W)
    grid_x = _grid(b * per_stripe, groups, sms, per_sm)
    out = np.zeros((b, r, per_stripe * cols), np.uint8)
    thread_sums = np.zeros((groups, grid_x * THREADS), np.uint32)
    kpad = -(-k // STEP) * STEP
    for y in range(groups):
        row0 = y * rg
        tab = _table(packed, row0, k)
        for tid, s, cb in _walk(b, per_stripe, grid_x):
            acc = np.zeros((rg, len(s), W), np.uint32)
            for j0 in range(0, kpad, ROWS):
                for i in range(ROWS):
                    j = j0 + i
                    w = words[s, min(j, k - 1), cb]          # (m, W)
                    _contract(acc, w, tab[j * 8:(j + 1) * 8], rg)
            for g in range(rg):
                if row0 + g >= r:
                    break
                flat = acc[g].astype("<u4").view(np.uint8).reshape(len(s), cols)
                idx = cb[:, None] * cols + np.arange(cols)
                out[s[:, None], row0 + g, idx] = flat
                thread_sums[y, tid] += flat.astype(np.uint32).sum(axis=1,
                                                                 dtype=np.uint32)
    partials = thread_sums.reshape(groups, grid_x, THREADS).sum(
        axis=2, dtype=np.uint32)                   # one per CTA (y, x)
    total = int(partials.sum(dtype=np.uint32))
    return out[:, :, :n], total * rs_codec.CSUM_MUL & 0xFFFFFFFF


@jax.jit
def _reference_jit(B_local, data):
    """`_encode_local` and the checksum beside it in `sharded_encode_fn`
    (mesh.py:96), compiled once per shape."""
    parity = ref_mesh._encode_local(B_local, data)
    return parity, jnp.sum(parity.astype(jnp.uint32)
                           * jnp.uint32(rs_codec.CSUM_MUL))


def _reference(M: np.ndarray, data: np.ndarray) -> tuple[np.ndarray, int]:
    B_local = ref_gf256.matrix_to_bitmatrix(M).astype(np.int8)
    parity, csum = _reference_jit(jnp.asarray(B_local), jnp.asarray(data))
    return np.asarray(parity), int(csum)


@pytest.mark.parametrize("b,k,r,n,vec,sms,per_sm", [
    (3, 8, 3, 1024, True, 1, 1),      # the main path's k and r, 2 rounds
    (8, 8, 2, 1024, True, 1, 1),      # the 2x2 mesh's per-device r
    (2, 8, 3, 1001, False, 2, 1),     # ragged N: the byte path
    (1, 3, 1, 64, True, 4, 2),
    (2, 1, 2, 48, True, 1, 3),
    (2, 20, 5, 160, True, 3, 1),      # two row groups, k past one chunk
    (3, 8, 4, 4097, False, 1, 2),
    (1, 8, 3, 16, False, 1, 1),       # an aligned N on the byte path
])
def test_emulated_kernel_equals_reference(b, k, r, n, vec, sms, per_sm):
    rng = np.random.default_rng(1000 * k + 10 * r + b)
    M = rng.integers(0, 256, (r, k), dtype=np.uint8)
    data = rng.integers(0, 256, (b, k, n), dtype=np.uint8)
    parity, csum = emulate_k3(rs_codec.packed_bitmatrix(M), data, vec, sms,
                              per_sm)
    want, want_csum = _reference(M, data)
    np.testing.assert_array_equal(parity, want)
    assert csum == want_csum


def test_emulated_zero_slice_checksum_is_zero():
    """An all-zero row slice (a padding column of the mesh) writes zeros
    and adds nothing to the checksum."""
    data = np.random.default_rng(7).integers(0, 256, (2, 8, 256),
                                             dtype=np.uint8)
    M = np.zeros((2, 8), np.uint8)
    parity, csum = emulate_k3(rs_codec.packed_bitmatrix(M), data, True, 1, 1)
    assert csum == 0 and not parity.any()
    want, want_csum = _reference(M, data)
    np.testing.assert_array_equal(parity, want)
    assert want_csum == 0
