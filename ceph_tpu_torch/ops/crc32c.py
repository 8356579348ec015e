"""crc32c over fixed-size blocks on the device (K2).

Port of ceph_tpu/ops/crc32c.py. CRC32C is GF(2)-linear in the message bits
for a fixed block length and seed: crc(m) = m_bits @ L  XOR  const, where L
is a (block_bits, 32) bitmatrix and const = crc(seed, zero block). The
host-side constructions below are the reference's: `_table0`,
`_zero_byte_op` (the 32x32 "advance one zero byte" operator Z),
`crc_bitmatrix` and `_seed_const` (tests/test_torch_crc32c.py holds them
equal).

`Crc32cDevice.blocks` is the kernel's wrapper: on a CUDA tensor it
launches the hand-written kernel in csrc/crc32c_blocks.cu (a table crc per
warp lane over bank-private tables, combined with powers of Z), on a CPU
tensor it runs
`crc32c_blocks_plain`, the reference's contraction against L in plain
PyTorch. CRC values stay
int64 inside torch (torch.uint32 lacks most operators) and leave the API
as numpy uint32. Seed convention matches ceph_crc32c: the caller passes
the seed (default -1), no final xor.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ceph_tpu_torch import device as _device
from ceph_tpu_torch.ops import _build

_POLY = 0x82F63B78  # reflected Castagnoli

#: kernel launches by `Crc32cDevice.blocks` (not by the plain version)
launches = 0

_KERNEL = "crc32c_blocks"
_SIGNATURES = {"crc32c_blocks_run": [ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_longlong, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_void_p, ctypes.c_void_p]}

# The plain version keeps its (blocks, 8*bs) plane tensor under this many
# bytes by working through the blocks in chunks, and its contraction depth
# under 2^23 bits so that float32 partial sums stay exact.
_PLANE_BUDGET = 1 << 30
_MAX_DEPTH = 1 << 23


@functools.lru_cache(maxsize=1)
def _table0() -> np.ndarray:
    t = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        t[i] = c
    return t


def _bits32(x: int) -> np.ndarray:
    return ((int(x) >> np.arange(32)) & 1).astype(np.uint8)


@functools.lru_cache(maxsize=1)
def _zero_byte_op() -> np.ndarray:
    """32x32 GF(2) matrix Z with Z @ bits(c) = bits(step(c, 0))."""
    t = _table0()
    Z = np.zeros((32, 32), dtype=np.uint8)
    for i in range(32):
        c = 1 << i
        nxt = int(t[c & 0xFF]) ^ (c >> 8)
        Z[:, i] = _bits32(nxt)
    return Z


def _gf2_matmul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    return (A.astype(np.uint32) @ B.astype(np.uint32) & 1).astype(np.uint8)


@functools.lru_cache(maxsize=8)
def crc_bitmatrix(block_size: int) -> np.ndarray:
    """(block_size*8, 32) uint8 bitmatrix L: crc_bits = m_bits @ L.

    m_bits layout: byte p contributes bits (p*8 + b), b = little-endian bit
    index within the byte (matches the uint8 >> b bitplane extraction).
    Row p*8+b is Z^(N-1-p) @ bits(table0[1 << b]), as in the reference;
    the powers of Z are applied as crc steps over a zero byte on packed
    32-bit values rather than as 32x32 matrix products (same L, in a
    fraction of the time for 64 KiB blocks).
    """
    t = _table0()
    cols = np.zeros((block_size, 8), dtype=np.uint32)
    v = [int(t[1 << b]) for b in range(8)]     # Z^0 columns, p = N-1
    for p in range(block_size - 1, -1, -1):
        cols[p] = v
        v = [int(t[x & 0xFF]) ^ (x >> 8) for x in v]
    bits = (cols[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.astype(np.uint8).reshape(block_size * 8, 32)


@functools.lru_cache(maxsize=8)
def _seed_const(block_size: int, seed: int) -> int:
    """crc of a zero block with the given starting crc (the affine const)."""
    t = _table0()
    c = seed & 0xFFFFFFFF
    for _ in range(block_size):
        c = int(t[c & 0xFF]) ^ (c >> 8)
    return c


# ---------------------------------------------------------------------------
# Kernel operands
# ---------------------------------------------------------------------------

def zero_bytes_op(n: int) -> np.ndarray:
    """Z^n: the 32x32 GF(2) operator advancing a crc over n zero bytes."""
    result = np.eye(32, dtype=np.uint8)
    base = _zero_byte_op()
    while n:
        if n & 1:
            result = _gf2_matmul(base, result)
        base = _gf2_matmul(base, base)
        n >>= 1
    return result


@functools.lru_cache(maxsize=1)
def _slice4_tables() -> np.ndarray:
    """(4, 256) uint32 slice-by-4 tables: T[s][i] = crc of byte i then s
    zero bytes (init 0)."""
    t = np.zeros((4, 256), dtype=np.uint32)
    t[0] = _table0()
    for s in range(1, 4):
        prev = t[s - 1]
        t[s] = t[0][prev & 0xFF] ^ (prev >> 8)
    return t


@functools.lru_cache(maxsize=8)
def _lane_advance(block_size: int) -> np.ndarray:
    """(32 bit, 32 lane) uint32: entry [i, l] packs column i of
    Z^(bytes after lane l's segment), with segments of ceil(bs/32) bytes."""
    seg = -(-block_size // 32)
    weights = (1 << np.arange(32, dtype=np.uint64))
    A = np.zeros((32, 32), dtype=np.uint32)
    for lane in range(32):
        end = min((lane + 1) * seg, block_size)
        Zn = zero_bytes_op(block_size - end)          # (32 rows, 32 cols)
        A[:, lane] = (Zn.astype(np.uint64) * weights[:, None]).sum(
            axis=0).astype(np.uint32)
    return A


# ---------------------------------------------------------------------------
# The kernel's wrapper and its plain version
# ---------------------------------------------------------------------------

def crc32c_blocks_plain(blocks: torch.Tensor, seed: int = 0xFFFFFFFF) -> torch.Tensor:
    """The kernel's function in plain PyTorch: blocks (B, bs) uint8 ->
    (B,) int64 crc32c values. Bit-planes contracted against
    crc_bitmatrix(bs) (int32 on the CPU, float32 on CUDA: exact, every
    partial sum stays under 2^23), & 1, packed, XOR _seed_const."""
    nb, bs = blocks.shape
    dev = blocks.device
    dt = torch.int32 if dev.type == "cpu" else torch.float32
    L = torch.from_numpy(crc_bitmatrix(bs)).to(dev, dt)     # (8bs, 32)
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    weights = torch.ones(1, dtype=torch.int64, device=dev) << torch.arange(
        32, dtype=torch.int64, device=dev)
    out = torch.empty(nb, dtype=torch.int64, device=dev)
    rows = max(1, _PLANE_BUDGET // (8 * bs * 4))
    depth = _MAX_DEPTH // 8                                 # bytes per pass
    for lo in range(0, nb, rows):
        blk = blocks[lo:lo + rows]
        bits = torch.zeros((blk.shape[0], 32), dtype=torch.int32, device=dev)
        for p in range(0, bs, depth):
            part = blk[:, p:p + depth]
            planes = ((part[:, :, None] >> shifts) & 1).to(dt).reshape(
                part.shape[0], -1)
            acc = torch.matmul(planes, L[p * 8:(p + part.shape[1]) * 8])
            bits ^= acc.to(torch.int32) & 1
        out[lo:lo + rows] = (bits.to(torch.int64) * weights).sum(dim=1)
    return out ^ _seed_const(bs, seed & 0xFFFFFFFF)


class Crc32cDevice:
    """Batched crc32c for one (block_size, seed) shape on one device."""

    def __init__(self, block_size: int, seed: int = 0xFFFFFFFF,
                 device: str | torch.device = "cuda"):
        if block_size <= 0:
            raise ValueError("block_size must be positive")
        self.block_size = block_size
        self.seed = seed & 0xFFFFFFFF
        self.const = _seed_const(block_size, self.seed)
        self.device = _device.resolve(device)
        self._tables = self._advance = None
        if self.device.type == "cuda":
            self._tables = torch.from_numpy(
                _slice4_tables().view(np.int32)).to(self.device)
            self._advance = torch.from_numpy(
                np.ascontiguousarray(_lane_advance(block_size)).view(
                    np.int32)).to(self.device)

    def blocks(self, blocks: torch.Tensor) -> torch.Tensor:
        """K2's wrapper: blocks (B, block_size) uint8 on this device ->
        (B,) int64 crcs there. A CUDA tensor launches the kernel; a CPU
        tensor takes the plain version."""
        global launches
        if not isinstance(blocks, torch.Tensor) or blocks.dtype != torch.uint8:
            raise TypeError("blocks must be a torch.uint8 tensor")
        if blocks.dim() != 2 or blocks.shape[1] != self.block_size:
            raise ValueError(f"expected (B, {self.block_size}), got "
                             f"{tuple(blocks.shape)}")
        if not blocks.is_contiguous():
            raise ValueError("blocks must be contiguous")
        if blocks.device.type == "cpu":
            return crc32c_blocks_plain(blocks, self.seed)
        if blocks.device != self.device:
            raise ValueError(f"blocks on {blocks.device}, crc on {self.device}")
        out = torch.empty(blocks.shape[0], dtype=torch.int64,
                          device=blocks.device)
        if blocks.shape[0] == 0:
            return out
        lib = _build.load(_KERNEL, _SIGNATURES)
        with torch.cuda.device(blocks.device):   # launch on blocks' card
            rc = lib.crc32c_blocks_run(
                _build.ptr(blocks), blocks.shape[0], self.block_size,
                _build.ptr(self._tables), _build.ptr(self._advance),
                self.const, _build.ptr(out), _build.stream(blocks.device))
        _build.check(lib, _KERNEL, rc)
        launches += 1
        return out

    def __call__(self, blocks) -> np.ndarray:
        """blocks (B, block_size) uint8, host array or tensor -> (B,)
        numpy uint32. Host bytes are copied to this device first."""
        if not isinstance(blocks, torch.Tensor):
            blocks = _device.staged(np.asarray(blocks)).to(self.device)
        return self.blocks(blocks).cpu().numpy().astype(np.uint32)


@functools.lru_cache(maxsize=8)
def get_device_crc(block_size: int, seed: int = 0xFFFFFFFF,
                   device: str = "cuda") -> Crc32cDevice:
    return Crc32cDevice(block_size, seed, device)
