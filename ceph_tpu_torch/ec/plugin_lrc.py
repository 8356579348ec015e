"""`lrc` plugin — locally repairable layered code.

Port of ceph_tpu/ec/plugin_lrc.py, a re-creation of the reference's LRC
plugin
(src/erasure-code/lrc/ErasureCodeLrc.{h,cc}): the code is a stack of
layers, each a (chunk-pattern, sub-profile) pair where the pattern marks
each global chunk position as data 'D', coding 'c', or absent '_' for that
layer; every layer recursively instantiates another registered plugin
(jerasure by default) over its own positions (ErasureCodeLrc.cc:140
layers_parse, :736 encode applying layers in sequence). Repair prefers the
cheapest local layer: `_minimum_to_decode` (:565) walks layers from the
most local and only falls back to wider layers when a local group cannot
recover.

Profiles: either explicit `layers` (JSON list of [pattern, profile]) +
`mapping`, or the generated k/m/l form (parse_kml, :290): (k+m)/l local
groups, one global layer plus one local parity per group.

Layers are built through the port's registry. Each layer's profile gets
the outer profile's `device` (default cuda) unless it names its own, so
a `device=cpu` pool builds CPU layers and a `device=cuda:1` pool builds
its layers on cuda:1; the jerasure layers run the bit-matrix kernel K1
there.
"""
from __future__ import annotations

import json
from typing import Iterable, Mapping

import numpy as np
import torch

from ceph_tpu_torch import device as _device
from ceph_tpu_torch.ec.interface import ErasureCode, ErasureCodeError
from ceph_tpu_torch.ec.registry import (ERASURE_CODE_VERSION, ErasureCodePlugin,
                                        ErasureCodePluginRegistry)

__erasure_code_version__ = ERASURE_CODE_VERSION


class Layer:
    def __init__(self, pattern: str, profile: dict, device: str):
        self.pattern = pattern
        self.data = [i for i, c in enumerate(pattern) if c == "D"]
        self.coding = [i for i, c in enumerate(pattern) if c == "c"]
        self.chunks = self.data + self.coding
        self.chunks_set = set(self.chunks)
        profile = dict(profile)
        profile.setdefault("k", str(len(self.data)))
        profile.setdefault("m", str(len(self.coding)))
        profile.setdefault("plugin", "jerasure")
        profile.setdefault("technique", "reed_sol_van")
        profile.setdefault("device", device)
        self.profile = profile
        self.code = ErasureCodePluginRegistry.instance().factory(
            profile["plugin"], profile)


def _generate_kml(k: int, m: int, l: int) -> tuple[str, list]:
    """mapping + layers for the k/m/l shorthand (ErasureCodeLrc::parse_kml)."""
    if l <= 0 or (k + m) % l:
        raise ErasureCodeError(f"k+m={k + m} must be a multiple of l={l}")
    groups = (k + m) // l
    if k % groups or m % groups:
        raise ErasureCodeError(
            f"k={k} and m={m} must be multiples of (k+m)/l={groups}")
    kg, mg = k // groups, m // groups
    mapping = ("D" * kg + "_" * mg + "_") * groups
    global_pattern = ("D" * kg + "c" * mg + "_") * groups
    layers = [[global_pattern, ""]]
    for i in range(groups):
        pattern = "".join("D" * l + "c" if i == j else "_" * (l + 1)
                          for j in range(groups))
        layers.append([pattern, ""])
    return mapping, layers


def _parse_layer_profile(spec) -> dict:
    if isinstance(spec, dict):
        return {str(a): str(b) for a, b in spec.items()}
    if isinstance(spec, str):
        if not spec.strip():
            return {}
        try:
            obj = json.loads(spec)
        except json.JSONDecodeError:
            # reference accepts space-separated k=v pairs via json_spirit
            # leniency; support the plain form too
            obj = dict(item.split("=", 1) for item in spec.split())
        if not isinstance(obj, dict):
            raise ErasureCodeError(f"layer profile {spec!r} is not a map")
        return {str(a): str(b) for a, b in obj.items()}
    raise ErasureCodeError(f"layer profile {spec!r} must be str or map")


class ErasureCodeLrc(ErasureCode):
    def __init__(self):
        super().__init__()
        self.layers: list[Layer] = []
        self._chunk_count = 0
        self.device: torch.device | None = None

    def init(self, profile: Mapping[str, str]) -> None:
        profile = dict(profile)
        has_kml = any(profile.get(x) not in (None, "")
                      for x in ("k", "m", "l"))
        if has_kml:
            if any(profile.get(x) in (None, "") for x in ("k", "m", "l")):
                raise ErasureCodeError("all of k, m, l must be set or none")
            for key in ("mapping", "layers"):
                if profile.get(key):
                    raise ErasureCodeError(
                        f"{key} cannot be set when k/m/l are set")
            k = self.to_int("k", profile, 4, minimum=1)
            m = self.to_int("m", profile, 2, minimum=1)
            l = self.to_int("l", profile, 3, minimum=1)
            mapping, layer_desc = _generate_kml(k, m, l)
            profile["mapping"] = mapping
        else:
            mapping = profile.get("mapping", "")
            if not mapping:
                raise ErasureCodeError("the 'mapping' profile is missing")
            raw = profile.get("layers", "")
            if not raw:
                raise ErasureCodeError("the 'layers' profile is missing")
            try:
                layer_desc = json.loads(raw) if isinstance(raw, str) else raw
            except json.JSONDecodeError as e:
                raise ErasureCodeError(f"layers is not valid JSON: {e}") from e
            if not isinstance(layer_desc, list):
                raise ErasureCodeError("layers must be a JSON array")

        super().init(profile)
        device = profile.get("device") or _device.DEFAULT_DEVICE
        self.device = _device.resolve(device)
        self._chunk_count = len(mapping)
        self.k = mapping.count("D")
        self.m = self._chunk_count - self.k

        self.layers = []
        for entry in layer_desc:
            if isinstance(entry, str):
                entry = [entry, ""]
            if not isinstance(entry, (list, tuple)) or not entry:
                raise ErasureCodeError(
                    f"each layer must be [pattern, profile], got {entry!r}")
            pattern = entry[0]
            if not isinstance(pattern, str):
                raise ErasureCodeError(f"layer pattern {pattern!r} not a string")
            if len(pattern) != self._chunk_count:
                raise ErasureCodeError(
                    f"layer pattern {pattern!r} length {len(pattern)} != "
                    f"mapping length {self._chunk_count}")
            sub = _parse_layer_profile(entry[1] if len(entry) > 1 else "")
            self.layers.append(Layer(pattern, sub, device))
        if not self.layers:
            raise ErasureCodeError("at least one layer is required")

        covered = set()
        for layer in self.layers:
            covered |= layer.chunks_set
        if covered != set(range(self._chunk_count)):
            raise ErasureCodeError(
                f"layers cover {sorted(covered)} != all positions "
                f"0..{self._chunk_count - 1}")

        echo = {"mapping": mapping}
        if has_kml:
            echo.update({"k": str(self.k), "m": profile["m"],
                         "l": profile["l"]})
        self._profile.update(echo)

    # -- geometry -----------------------------------------------------------

    def get_chunk_count(self) -> int:
        return self._chunk_count

    def get_chunk_size(self, stripe_width: int) -> int:
        align = max(layer.code.get_alignment() for layer in self.layers)
        padded = self.k * align * (-(-stripe_width // (self.k * align)))
        return padded // self.k

    # -- locality-aware minimum --------------------------------------------

    def _minimum_to_decode(self, want_to_read: set[int],
                           available: set[int]) -> set[int]:
        """Cheapest-layer-first read planning (ErasureCodeLrc.cc:565)."""
        all_ids = set(range(self._chunk_count))
        erasures_total = all_ids - available
        erasures_want = want_to_read & erasures_total
        if not erasures_want:
            return set(want_to_read)

        # case 2: recover wanted erasures with the most local layer possible
        minimum: set[int] = set()
        not_recovered = set(erasures_total)
        want_left = set(erasures_want)
        for layer in reversed(self.layers):
            layer_want = want_to_read & layer.chunks_set
            if not layer_want:
                continue
            if not layer_want & want_left:
                minimum |= layer_want
                continue
            layer_erasures = layer.chunks_set & not_recovered
            if len(layer_erasures) > len(layer.coding):
                continue  # too many holes for this layer
            minimum |= layer.chunks_set - not_recovered
            not_recovered -= layer_erasures
            want_left -= layer_erasures
        if not want_left:
            minimum |= want_to_read
            minimum -= erasures_total
            return minimum

        # case 3: cascade — some layer may repair chunks other layers need
        not_recovered = set(erasures_total)
        progress = True
        while progress and not_recovered:
            progress = False
            for layer in reversed(self.layers):
                layer_erasures = layer.chunks_set & not_recovered
                if layer_erasures and \
                        len(layer_erasures) <= len(layer.coding):
                    not_recovered -= layer_erasures
                    progress = True
        if not not_recovered:
            return set(available)
        raise ErasureCodeError(
            f"not enough chunks in {sorted(available)} to read "
            f"{sorted(want_to_read)}")

    # -- kernels ------------------------------------------------------------

    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        """Apply every layer in declaration order (global first, then
        locals) — ErasureCodeLrc::encode_chunks."""
        for layer in self.layers:
            sub_chunks = {j: chunks[c] for j, c in enumerate(layer.chunks)}
            layer.code.encode_chunks(sub_chunks)

    def decode_chunks(self, want_to_read: Iterable[int],
                      chunks: dict[int, np.ndarray],
                      available: set[int]) -> None:
        """Walk layers from most local, decoding whatever each can; later
        layers reuse chunks recovered by earlier ones."""
        want = set(want_to_read)
        erasures = set(range(self._chunk_count)) - set(available)
        progress = True
        while progress and want & erasures:
            progress = False
            for layer in reversed(self.layers):
                layer_erasures = layer.chunks_set & erasures
                if not layer_erasures:
                    continue
                if len(layer_erasures) > len(layer.coding):
                    continue
                sub_chunks = {}
                sub_avail = set()
                for j, c in enumerate(layer.chunks):
                    sub_chunks[j] = chunks[c]
                    if c not in erasures:
                        sub_avail.add(j)
                sub_want = {j for j, c in enumerate(layer.chunks)
                            if c in layer_erasures}
                layer.code.decode_chunks(sub_want, sub_chunks, sub_avail)
                erasures -= layer.chunks_set
                progress = True
                if not want & erasures:
                    break
        if want & erasures:
            raise ErasureCodeError(
                f"unable to read chunks {sorted(want & erasures)}")


class ErasureCodePluginLrc(ErasureCodePlugin):
    def factory(self, profile: Mapping[str, str], directory: str | None = None):
        instance = ErasureCodeLrc()
        instance.init(profile)
        return instance


def __erasure_code_init__(name: str, directory: str | None = None):
    ErasureCodePluginRegistry.instance().add(name, ErasureCodePluginLrc())
