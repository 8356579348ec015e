"""Carry the reference's parameters across to the port.

For this system the "weights" are each plugin's generator (the coding
matrix with its bitmatrix, the bit-matrix kernel's operand; a GF(2)
generator, a shingled matrix, an inner code's or each layer's matrix
for the plugins built on other codes) and the CRC operator L with its
seed constant (the crc kernel's). Each function takes what the JAX
package holds, as numpy, builds the port's object on `device`, and
checks that the port derives the same parameters itself.
"""
from __future__ import annotations

import copy
import json
from typing import Mapping

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


def port_plugin_name(name: str) -> str:
    """The port's name for a reference plugin name."""
    return _PLUGIN_NAMES.get(name, name)


def _port_layers(raw) -> str:
    """lrc's `layers` with every layer plugin in the port's names; the
    string comes back unchanged when no layer names a renamed plugin."""
    from ceph_tpu_torch.ec.plugin_lrc import _parse_layer_profile
    layers = json.loads(raw) if isinstance(raw, str) else raw
    changed = False
    for entry in layers:
        if not isinstance(entry, list) or len(entry) < 2:
            continue
        sub = _parse_layer_profile(entry[1])
        if sub.get("plugin") in _PLUGIN_NAMES:
            sub["plugin"] = port_plugin_name(sub["plugin"])
            entry[1] = sub
            changed = True
    return json.dumps(layers) if changed else raw


def port_profile(profile: Mapping[str, str]) -> dict:
    """A reference profile in the port's plugin names: `tpu` becomes
    `cuda` as the plugin, as clay's `scalar_mds` and as an lrc layer's
    plugin."""
    out = dict(profile)
    name = port_plugin_name(out.get("plugin", "jerasure"))
    out["plugin"] = name
    if name == "clay" and out.get("scalar_mds"):
        out["scalar_mds"] = port_plugin_name(out["scalar_mds"])
    if name == "lrc" and out.get("layers"):
        out["layers"] = _port_layers(out["layers"])
    return out


def port_osdmap(d: Mapping) -> dict:
    """A reference OSDMap in its wire form (`OSDMap.to_dict()`, or
    `dumps()` parsed) with `port_profile` run over every entry of
    `ec_profiles`, so that a pool whose profile names plugin `tpu` loads
    in the port with plugin `cuda`. Nothing else changes."""
    out = copy.deepcopy(dict(d))
    if "ec_profiles" in out:
        out["ec_profiles"] = {name: port_profile(profile) for name, profile
                              in out["ec_profiles"].items()}
    return out


def generator(instance):
    """What fixes a plugin instance's bytes, read the same way from an
    instance of either package: the coding matrix of a GF(2^8) matrix
    code, the GF(2) generator `code.G` of a bitmatrix technique, shec's
    shingled `matrix`, clay's inner code's matrix, and for lrc the list
    of its layers' generators."""
    if hasattr(instance, "layers"):
        return [generator(layer.code) for layer in instance.layers]
    if getattr(instance, "mds", None) is not None:
        return generator(instance.mds)
    if getattr(instance, "matrix", None) is not None:
        return instance.matrix
    if getattr(instance, "code", None) is not None:
        return instance.code.G
    return instance.coding_matrix


def _same(a, b) -> bool:
    if isinstance(a, list) or isinstance(b, list):
        return (isinstance(a, list) and isinstance(b, list)
                and len(a) == len(b) and all(map(_same, a, b)))
    return np.array_equal(np.asarray(a, dtype=np.uint8),
                          np.asarray(b, dtype=np.uint8))


def plugin_from_reference(profile: dict, reference_generator,
                          device: str | torch.device = "cuda"):
    """The port's plugin instance for a reference profile, in the port's
    names (`port_profile`). Raises if its generator is not the
    reference's: `reference_generator` is the reference instance's
    coding matrix, or `generator(reference_instance)` for any plugin."""
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
    profile = port_profile(profile)
    profile["device"] = str(device)
    name = profile["plugin"]
    instance = ErasureCodePluginRegistry.instance().factory(name, profile)
    if not _same(generator(instance), reference_generator):
        raise ValueError(f"plugin {name} builds another generator than "
                         f"the reference")
    return instance
