"""Carry the reference's parameters across to the port.

For this system the "weights" are the coding matrix with its bitmatrix
(the bit-matrix kernel's operand) and the CRC operator L with its seed
constant (the crc kernel's). Each function takes what the JAX package
holds, as numpy, builds the port's object on `device`, and checks that
the port derives the same parameters itself.
"""
from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch import device as _device
from ceph_tpu_torch.ec import gf256
from ceph_tpu_torch.ops import crc32c, rs_codec

#: reference plugin names whose port carries another name
_PLUGIN_NAMES = {"tpu": "cuda"}


def codec_from_reference(M: np.ndarray,
                         device: str | torch.device = "cuda") -> rs_codec.MatrixCodec:
    """The port's codec for the reference's (r, k) GF(2^8) matrix `M`,
    with its operands placed on `device`."""
    codec = rs_codec.MatrixCodec.get(np.asarray(M, dtype=np.uint8))
    codec._bitmatrix_for(_device.resolve(device))
    return codec


def _seed_for_const(const: int, block_size: int) -> int:
    """The seed whose zero-block crc is `const`: const = Z^bs @ seed over
    GF(2), and Z is invertible."""
    Zn = crc32c.zero_bytes_op(block_size)
    inv = gf256.bitmatrix_invert(Zn)
    bits = ((int(const) >> np.arange(32)) & 1).astype(np.uint8)
    seed_bits = (inv.astype(np.uint32) @ bits) & 1
    return int((seed_bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum())


def crc_from_reference(L: np.ndarray, const: int, block_size: int,
                       device: str | torch.device = "cuda") -> crc32c.Crc32cDevice:
    """The port's block crc for the reference's operator `L` (8*bs, 32)
    and affine constant `const` (e.g. np.asarray(jax_crc._L) and
    int(jax_crc._const)). Raises if the port's own L or constant differ."""
    L = np.asarray(L)
    if L.shape != (block_size * 8, 32):
        raise ValueError(f"L has shape {L.shape}, expected ({block_size * 8}, 32)")
    if not np.array_equal(L.astype(np.uint8), crc32c.crc_bitmatrix(block_size)):
        raise ValueError("reference crc bitmatrix differs from the port's")
    seed = _seed_for_const(const, block_size)
    port = crc32c.Crc32cDevice(block_size, seed, device)
    if port.const != int(const) & 0xFFFFFFFF:
        raise ValueError(f"seed constant {int(const):#x} not reproduced")
    return port


def plugin_from_reference(profile: dict, coding_matrix: np.ndarray,
                          device: str | torch.device = "cuda"):
    """The port's plugin instance for a reference profile (plugin `tpu`
    becomes `cuda`). Raises if its coding matrix is not the reference's."""
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
    profile = dict(profile)
    name = _PLUGIN_NAMES.get(profile.get("plugin", "jerasure"),
                             profile.get("plugin", "jerasure"))
    profile["plugin"] = name
    profile["device"] = str(device)
    instance = ErasureCodePluginRegistry.instance().factory(name, profile)
    if not np.array_equal(instance.coding_matrix,
                          np.asarray(coding_matrix, dtype=np.uint8)):
        raise ValueError(f"plugin {name} builds another coding matrix than "
                         f"the reference")
    return instance
