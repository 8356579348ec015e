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

Each batched call is one traced dispatch: the `tpu_encode_dispatch` /
`tpu_decode_dispatch` spans keep the reference's names (the critical
path buckets device time by them) and its tags, and the copy ledger gets
the h2d/d2h bytes of the host path. Under `tracer.profile_dispatch()`
the host path runs each sub-batch's upload, kernel and download one
after another, times each leg with a pair of CUDA events on its stream,
and tags the span with the sums (`h2d_us`, `kernel_us`, `d2h_us`).

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
from ceph_tpu_torch.utils import tracer

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
        device_resident = isinstance(data, torch.Tensor)
        if not device_resident:
            data = np.asarray(data)
        with tracer.span("tpu_encode_dispatch") as sp:
            if sp is not None:
                sp.set_tag("mode", "device" if device_resident
                           else "host-pipelined")
                sp.set_tag("batch", int(data.shape[0]))
                sp.set_tag("bytes", _numel(data))
                sp.set_tag("k", self.k)
                sp.set_tag("m", self.m)
                if device_resident:
                    sp.set_tag("device", str(data.device))
            if device_resident:
                return self._encoder.apply_batch_device(data)
            return self._host_roundtrip(self._encoder, data,
                                        self.pipeline_depth, sp)

    def decode_stripes(self, avail_ids: tuple[int, ...], want_ids: tuple[int, ...],
                       chunks):
        """Batched reconstruction: `chunks` is (batch, k, S) holding the
        available chunks stacked in `avail_ids` order; returns the
        reconstructed `want_ids` chunks as (batch, len(want), S)."""
        R = rs_codec.recovery_matrix(self.coding_matrix, avail_ids, want_ids)
        codec = rs_codec.MatrixCodec.get(R)
        device_resident = isinstance(chunks, torch.Tensor)
        if not device_resident:
            chunks = np.asarray(chunks)
        with tracer.span("tpu_decode_dispatch") as sp:
            if sp is not None:
                sp.set_tag("mode", "device" if device_resident else "host")
                sp.set_tag("batch", int(chunks.shape[0]))
                sp.set_tag("bytes", _numel(chunks))
                sp.set_tag("want", list(want_ids))
                if device_resident:
                    sp.set_tag("device", str(chunks.device))
            if device_resident:
                return codec.apply_batch_device(chunks)
            return self._host_roundtrip(codec, chunks, 1, sp)

    def _host_roundtrip(self, codec: rs_codec.MatrixCodec, data: np.ndarray,
                        depth: int, sp=None) -> np.ndarray:
        """Host (b, k, S) bytes through `codec` on this plugin's device.

        The bytes are copied into staging first; on a card the staging
        memory is pinned and filled one sub-batch at a time, so the host
        copy of a sub-batch overlaps the upload, kernel and download of
        the one before. With dispatch profiling on (and a span to tag)
        the sub-batches run one after another instead, each leg between
        two CUDA events on its stream (the host clock on the CPU)."""
        dev = self.device
        if data.ndim != 3:
            raise ValueError(f"expected (batch, k, S), got {data.shape}")
        legs = _device.Legs(dev) if sp is not None and \
            tracer.profile_dispatch() else None
        if dev.type != "cuda":
            with _device.leg(legs, _device.H2D):
                src = _device.staged(data)
            with _device.leg(legs, _device.KERNEL):
                res = codec.apply_batch_device(src)
            with _device.leg(legs, _device.D2H):
                out = res.numpy()
            _device.note_roundtrip(legs, data.nbytes, out.nbytes, sp)
            return out
        b, _, s = data.shape
        staging = torch.empty(data.shape, dtype=torch.uint8, pin_memory=True)
        out = torch.empty((b, codec.r, s), dtype=torch.uint8, pin_memory=True)
        if self._streams is None:
            self._streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
        h2d, d2h = self._streams
        compute = torch.cuda.current_stream(dev)
        with torch.cuda.device(dev):
            for idx in np.array_split(np.arange(b), max(1, min(depth, b))):
                if len(idx) == 0:
                    continue
                lo, hi = int(idx[0]), int(idx[-1]) + 1
                np.copyto(staging[lo:hi].numpy(), data[lo:hi],
                          casting="unsafe")
                if legs is not None:
                    # one leg at a time: this upload waits for the last
                    # download
                    h2d.wait_stream(d2h)
                with torch.cuda.stream(h2d), _device.leg(legs, _device.H2D,
                                                         h2d):
                    src = staging[lo:hi].to(dev, non_blocking=True)
                compute.wait_stream(h2d)
                src.record_stream(compute)
                with _device.leg(legs, _device.KERNEL, compute):
                    parity = codec.apply_batch_device(src)
                d2h.wait_stream(compute)
                with torch.cuda.stream(d2h), _device.leg(legs, _device.D2H,
                                                         d2h):
                    out[lo:hi].copy_(parity, non_blocking=True)
                parity.record_stream(d2h)
            d2h.synchronize()
        _device.note_roundtrip(legs, data.nbytes, out.numel(), sp)
        return out.numpy()


def _numel(data) -> int:
    return int(data.numel() if isinstance(data, torch.Tensor) else data.size)


class ErasureCodePluginCuda(ErasureCodePlugin):
    def factory(self, profile: Mapping[str, str], directory: str | None = None):
        instance = ErasureCodeCuda()
        instance.init(profile)
        return instance


def __erasure_code_init__(name: str, directory: str | None = None):
    ErasureCodePluginRegistry.instance().add(name, ErasureCodePluginCuda())
