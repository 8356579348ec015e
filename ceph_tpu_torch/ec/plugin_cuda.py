"""`cuda` plugin — the flagship erasure code on an NVIDIA card.

The counterpart of ceph_tpu/ec/plugin_tpu.py, the plugin the north-star
benchmark targets (BASELINE.json). It keeps that plugin's contract:
beyond the scalar interface it exposes

  - encode_stripes/decode_stripes: (batch, k, S) one-launch batch APIs —
    the ECUtil::encode stripe loop (reference src/osd/ECUtil.cc:134) maps
    here. numpy in gives numpy out; a tensor in gives a tensor on the
    same device out (CUDA tensors launch the bit-matrix kernel K1, CPU
    tensors run its plain version);
  - a pipelined host-buffer path: `pipeline-depth` sub-batches are each
    copied into pinned staging memory, uploaded on a copy stream, encoded
    on the current stream and downloaded on a third, so the host copy of
    one sub-batch overlaps the transfers and kernel of the one before;
    one synchronize precedes the numpy result.

Techniques: reed_sol_van (default), cauchy_good, over the same field
(0x11D) and matrices as the reference. The profile's `device` key picks
the card (default cuda); `device=cpu` runs the plain versions.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ceph_tpu_torch import device as _device
from ceph_tpu_torch.ec import gf256
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.plugin_jerasure import ErasureCodeJerasure
from ceph_tpu_torch.ec.registry import (ERASURE_CODE_VERSION, ErasureCodePlugin,
                                        ErasureCodePluginRegistry)
from ceph_tpu_torch.ops import rs_codec

__erasure_code_version__ = ERASURE_CODE_VERSION

DEFAULT_K = 8
DEFAULT_M = 3


class ErasureCodeCuda(ErasureCodeJerasure):
    technique = "reed_sol_van"
    #: batched APIs dispatch to the accelerator (plugin_tpu's flag: the
    #: OSD's EC backend sends such plugins through the offload service)
    device_batched = True

    def init(self, profile: Mapping[str, str]) -> None:
        profile = dict(profile)
        profile.setdefault("k", str(DEFAULT_K))
        profile.setdefault("m", str(DEFAULT_M))
        super().init(profile)
        # number of sub-batches whose transfers overlap compute on the
        # host-buffer path; 1 disables the overlap
        self.pipeline_depth = self.to_int("pipeline-depth", profile, 4, minimum=1)
        self._streams: tuple | None = None

    def _build_matrix(self) -> np.ndarray:
        if self._profile.get("technique", "reed_sol_van") == "cauchy_good":
            return gf256.cauchy_good_matrix(self.k, self.m)
        return gf256.reed_sol_van_matrix(self.k, self.m)

    def _check_technique(self) -> None:
        tech = self._profile.get("technique", "reed_sol_van")
        if tech not in ("reed_sol_van", "cauchy_good"):
            raise ErasureCodeError(f"cuda technique {tech!r} unsupported")

    # -- batched data path ---------------------------------------------------

    def encode_stripes(self, data):
        """(batch, k, S) -> (batch, m, S) parity. numpy in => pipelined
        host transfer + numpy out; tensor in => tensor out."""
        if isinstance(data, torch.Tensor):
            return self._encoder.apply_batch_device(data)
        return self._host_roundtrip(self._encoder, np.asarray(data),
                                    self.pipeline_depth)

    def decode_stripes(self, avail_ids: tuple[int, ...], want_ids: tuple[int, ...],
                       chunks):
        """Batched reconstruction: `chunks` is (batch, k, S) holding the
        available chunks stacked in `avail_ids` order; returns the
        reconstructed `want_ids` chunks as (batch, len(want), S)."""
        R = rs_codec.recovery_matrix(self.coding_matrix, avail_ids, want_ids)
        codec = rs_codec.MatrixCodec.get(R)
        if isinstance(chunks, torch.Tensor):
            return codec.apply_batch_device(chunks)
        return self._host_roundtrip(codec, np.asarray(chunks), 1)

    def _host_roundtrip(self, codec: rs_codec.MatrixCodec, data: np.ndarray,
                        depth: int) -> np.ndarray:
        """Host (b, k, S) bytes through `codec` on this plugin's device.

        The bytes are copied into staging first; on a card the staging
        memory is pinned and filled one sub-batch at a time, so the host
        copy of a sub-batch overlaps the upload, kernel and download of
        the one before."""
        dev = self.device
        if data.ndim != 3:
            raise ValueError(f"expected (batch, k, S), got {data.shape}")
        if dev.type != "cuda":
            return codec.apply_batch_device(_device.staged(data)).numpy()
        b, _, s = data.shape
        staging = torch.empty(data.shape, dtype=torch.uint8, pin_memory=True)
        out = torch.empty((b, codec.r, s), dtype=torch.uint8, pin_memory=True)
        if self._streams is None:
            self._streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
        h2d, d2h = self._streams
        compute = torch.cuda.current_stream(dev)
        for idx in np.array_split(np.arange(b), max(1, min(depth, b))):
            if len(idx) == 0:
                continue
            lo, hi = int(idx[0]), int(idx[-1]) + 1
            np.copyto(staging[lo:hi].numpy(), data[lo:hi], casting="unsafe")
            with torch.cuda.stream(h2d):
                src = staging[lo:hi].to(dev, non_blocking=True)
            compute.wait_stream(h2d)
            src.record_stream(compute)
            parity = codec.apply_batch_device(src)
            d2h.wait_stream(compute)
            with torch.cuda.stream(d2h):
                out[lo:hi].copy_(parity, non_blocking=True)
            parity.record_stream(d2h)
        d2h.synchronize()
        return out.numpy()


class ErasureCodePluginCuda(ErasureCodePlugin):
    def factory(self, profile: Mapping[str, str], directory: str | None = None):
        instance = ErasureCodeCuda()
        instance.init(profile)
        return instance


def __erasure_code_init__(name: str, directory: str | None = None):
    ErasureCodePluginRegistry.instance().add(name, ErasureCodePluginCuda())
