"""Checksummer — per-block checksum calculate/verify.

Port of ceph_tpu/utils/checksummer.py, the re-creation of the reference's
`Checksummer` (src/common/Checksummer.h:74 algorithm dispatch, :195-234
calculate/verify loops over csum_block_size blocks), the engine behind
BlueStore's per-blob checksums (bluestore_blob_t::{calc,verify}_csum,
src/os/bluestore/bluestore_types.cc:814,840). Algorithms: crc32c,
crc32c_8 / crc32c_16 (truncated, as in the reference's csum_type menu).

Routing: a CUDA tensor, of any number of blocks, is checksummed on its
card by the device crc (K2); its bytes never travel back to the host.
`use_device` decides only for buffers on the host: True sends them to the
device crc on `device` (K2 on a card, its plain version for the CPU),
None or False keeps them on the native C++ crc. `calculate_async` submits
host buffers (one, or a list: a scatter job) to the offload service,
where they coalesce with other callers' blocks; tensors, a missing
service and csum type none take `calculate`.
"""
from __future__ import annotations

import numpy as np
import torch

CSUM_NONE = "none"
CSUM_CRC32C = "crc32c"
CSUM_CRC32C_16 = "crc32c_16"
CSUM_CRC32C_8 = "crc32c_8"

_VALUE_BITS = {CSUM_CRC32C: 32, CSUM_CRC32C_16: 16, CSUM_CRC32C_8: 8}


class Checksummer:
    """calculate/verify per-block checksums for one (type, block_size).

    `device` is where host buffers go when `use_device=True` (default
    cuda); a tensor sent to the device crc is checksummed on the device
    it lies on."""

    def __init__(self, csum_type: str = CSUM_CRC32C,
                 csum_block_size: int = 4096, use_device: bool | None = None,
                 device: str | torch.device = "cuda"):
        if csum_type != CSUM_NONE and csum_type not in _VALUE_BITS:
            raise ValueError(f"unknown csum type {csum_type!r}")
        if csum_block_size & (csum_block_size - 1):
            raise ValueError("csum_block_size must be a power of two")
        self.csum_type = csum_type
        self.block_size = csum_block_size
        self.use_device = use_device
        self.device = device

    def _crc_blocks(self, arr) -> np.ndarray:
        is_tensor = isinstance(arr, torch.Tensor)
        nblocks = (arr.numel() if is_tensor else arr.size) // self.block_size
        if (is_tensor and arr.is_cuda) or self.use_device:
            from ceph_tpu_torch.ops import crc32c as crc_dev
            dev = arr.device if is_tensor else self.device
            return crc_dev.get_device_crc(self.block_size, device=dev)(
                arr.reshape(nblocks, self.block_size))
        from ceph_tpu_torch.native import ec_native
        if is_tensor:
            arr = arr.numpy()
        return ec_native.crc32c_blocks(arr, self.block_size)

    def calculate(self, data) -> np.ndarray:
        """Per-block checksums of a block-aligned buffer (bytes, numpy, or
        tensor) -> uint32 array (truncated types still return uint32
        with high bits zero, like the reference storing into smaller
        csum_data slots)."""
        if self.csum_type == CSUM_NONE:
            return np.zeros(0, dtype=np.uint32)
        if isinstance(data, torch.Tensor):
            if data.dtype != torch.uint8:
                raise TypeError("tensor buffers must be torch.uint8")
            arr = data.contiguous().reshape(-1)
        elif isinstance(data, (bytes, bytearray, memoryview)):
            arr = np.frombuffer(data, dtype=np.uint8)
        else:
            arr = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
        size = arr.numel() if isinstance(arr, torch.Tensor) else arr.size
        if size % self.block_size:
            raise ValueError(
                f"buffer size {size} not a multiple of csum block "
                f"{self.block_size}")
        csums = self._crc_blocks(arr)
        bits = _VALUE_BITS[self.csum_type]
        if bits < 32:
            csums = csums & ((1 << bits) - 1)
        return csums

    def _as_blocks(self, data) -> np.ndarray:
        """One host buffer -> an (N, block_size) uint8 view (no copy for
        bytes-likes and contiguous arrays)."""
        if isinstance(data, (bytes, bytearray, memoryview)):
            arr = np.frombuffer(data, dtype=np.uint8)
        else:
            arr = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
        if arr.size % self.block_size:
            raise ValueError(
                f"buffer size {arr.size} not a multiple of csum block "
                f"{self.block_size}")
        return arr.reshape(-1, self.block_size)

    async def calculate_async(self, data, service=None) -> np.ndarray:
        """calculate() with the per-block crc batch submitted through the
        offload service: the blocks coalesce with concurrent callers
        (EC shard csums, other checksummers) into one crc job and the
        work leaves the event loop. `data` may be a LIST of block-aligned
        buffers (an EC write's shard buffers): they ride ONE scatter job
        whose fragments stack straight into the service's staging page,
        and the result concatenates in fragment order. Without a service,
        for tensors, or for csum type none this is calculate()."""
        scattered = isinstance(data, (list, tuple))
        if service is None or self.csum_type == CSUM_NONE \
                or (not scattered and isinstance(data, torch.Tensor)):
            if not scattered:
                return self.calculate(data)
            parts = [self.calculate(d) for d in data]
            return np.concatenate(parts) if parts \
                else np.zeros(0, dtype=np.uint32)
        if scattered:
            blocks = [self._as_blocks(d) for d in data if len(d)]
            if not blocks:
                return np.zeros(0, dtype=np.uint32)
        else:
            blocks = self._as_blocks(data)
            if blocks.size == 0:
                return np.zeros(0, dtype=np.uint32)
        csums = np.asarray(await service.crc32c_blocks(blocks,
                                                       self.block_size))
        bits = _VALUE_BITS[self.csum_type]
        if bits < 32:
            csums = csums & ((1 << bits) - 1)
        return csums

    def verify(self, data, expected: np.ndarray) -> int:
        """Returns -1 if all blocks match, else the byte offset of the
        first mismatching block (reference verify returns bad_pos)."""
        actual = self.calculate(data)
        expected = np.asarray(expected, dtype=np.uint32)
        if actual.size != expected.size:
            raise ValueError(
                f"{expected.size} expected csums for {actual.size} blocks")
        bad = np.nonzero(actual != expected)[0]
        return int(bad[0]) * self.block_size if bad.size else -1
