"""`jerasure` plugin: the matrix Reed-Solomon techniques on the port's codec.

Port of ceph_tpu/ec/plugin_jerasure.py, itself a re-creation of the
reference's default plugin (src/erasure-code/jerasure/
ErasureCodeJerasure.{h,cc}): techniques are dispatched by the profile's
`technique` key (ErasureCodePluginJerasure.cc:34-71); each class's
prepare() builds its coding matrix once at init
(ErasureCodeJerasure.cc:203).

Techniques: reed_sol_van, reed_sol_r6_op, cauchy_orig, cauchy_good, all
GF(2^8) matrix codes. Scalar encode/decode run the bit-matrix kernel (K1)
on the profile's `device` (default cuda); the batched stripe API sends
host arrays to the native host codec and CUDA tensors to K1. The
minimal-density bitmatrix RAID-6 family (liberation, blaum_roth,
liber8tion) runs on the GF(2) packet-XOR path of ec/bitmatrix.py on the
host, as in the JAX package; those techniques still read and check the
profile's `device`.
"""
from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch

from ceph_tpu_torch import device as _device
from ceph_tpu_torch.ec import bitmatrix, gf256
from ceph_tpu_torch.ec.interface import ErasureCode, ErasureCodeError
from ceph_tpu_torch.ec.registry import (ERASURE_CODE_VERSION, ErasureCodePlugin,
                                        ErasureCodePluginRegistry)
from ceph_tpu_torch.ops import rs_codec

__erasure_code_version__ = ERASURE_CODE_VERSION

DEFAULT_K = 2
DEFAULT_M = 1
DEFAULT_W = 8


class ErasureCodeJerasure(ErasureCode):
    """Base for matrix techniques; subclasses provide _build_matrix()."""

    technique = "reed_sol_van"

    def __init__(self):
        super().__init__()
        self.w = DEFAULT_W
        self.coding_matrix: np.ndarray | None = None
        self.device: torch.device | None = None

    DEFAULT_TECHNIQUE_W = DEFAULT_W

    def init(self, profile: Mapping[str, str]) -> None:
        super().init(profile)
        self.device = _device.resolve(profile.get("device") or
                                      _device.DEFAULT_DEVICE)
        self.k = self.to_int("k", profile, DEFAULT_K, minimum=1)
        self.m = self.to_int("m", profile, DEFAULT_M, minimum=1)
        self.w = self.to_int("w", profile, self.DEFAULT_TECHNIQUE_W)
        self._check_w()
        if self.k + self.m > 256:
            raise ErasureCodeError("k+m must be <= 256 in GF(2^8)")
        self._check_technique()
        self.prepare()
        # normalize defaulted keys back into the profile like the reference
        self._profile.update({"k": str(self.k), "m": str(self.m), "w": str(self.w)})

    def _check_w(self) -> None:
        if self.w != 8:
            raise ErasureCodeError(f"w={self.w} unsupported; only w=8")

    def _check_technique(self) -> None:
        pass

    def prepare(self) -> None:
        self.coding_matrix = np.asarray(self._build_matrix(), dtype=np.uint8)
        self._encoder = rs_codec.MatrixCodec.get(self.coding_matrix)

    def _build_matrix(self) -> np.ndarray:
        raise NotImplementedError

    # -- kernels ------------------------------------------------------------

    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        data = np.stack([chunks[i] for i in range(self.k)])
        parity = self._encoder.apply(data, self.device)
        for i in range(self.m):
            chunks[self.k + i][:] = parity[i]

    def decode_chunks(self, want_to_read: Iterable[int],
                      chunks: dict[int, np.ndarray],
                      available: set[int]) -> None:
        # `available` is required: the kernel contract supplies `chunks` with
        # zero-filled holes for missing ids, so deriving it as set(chunks)
        # would make every chunk look present and skip reconstruction
        want = sorted(set(want_to_read) - available)
        if not want:
            return
        avail = tuple(sorted(available))[: self.k]
        if len(avail) < self.k:
            raise ErasureCodeError(
                f"cannot decode {want}: only {len(avail)} chunks available")
        R = rs_codec.recovery_matrix(self.coding_matrix, avail, tuple(want))
        src = np.stack([chunks[i] for i in avail])
        rec = rs_codec.MatrixCodec.get(R).apply(src, self.device)
        for row, i in enumerate(want):
            chunks[i][:] = rec[row]

    # -- batched stripe API (ec_util's one-dispatch path) ------------------

    def _apply_flat(self, M: np.ndarray, src):
        """(S, rows_in, C) through M (rows_out, rows_in) -> (S, rows_out, C).

        Tensors stay where they are (tensor in => tensor out): a CUDA
        tensor launches K1, a CPU tensor runs its plain version. Host
        arrays fold the stripe axis into the byte lanes so the whole
        batch is ONE matrix application through the native split-table
        codec (the reference amortizes the same way at its ECUtil::encode
        batching site, src/osd/ECUtil.cc:134). Host output is stripe-major
        as a VIEW over shard-major storage: the ec_util consumers
        re-transpose to shard-major, so their copies land back on this
        buffer for free."""
        if isinstance(src, torch.Tensor):
            return rs_codec.MatrixCodec.get(M).apply_batch_device(src)
        from ceph_tpu_torch.native import ec_native
        src = np.ascontiguousarray(src, dtype=np.uint8)
        S, kin, C = src.shape
        rows = M.shape[0]
        flat = np.ascontiguousarray(src.transpose(1, 0, 2)).reshape(
            kin, S * C)
        if ec_native.available():
            out = np.empty((rows, S * C), dtype=np.uint8)
            ec_native.encode(M, flat, out)
        else:
            out = rs_codec.MatrixCodec.get(M).apply(flat, self.device)
        return out.reshape(rows, S, C).transpose(1, 0, 2)

    def encode_stripes(self, data):
        """(S, k, C) data stripes -> (S, m, C) parity, one dispatch."""
        return self._apply_flat(self.coding_matrix, data)

    def decode_stripes(self, avail_ids: tuple[int, ...],
                       want_ids: tuple[int, ...], chunks):
        """Batched reconstruction of `want_ids` from the first-k available
        chunks stacked in `avail_ids` order: (S, k, C) -> (S, want, C)."""
        R = rs_codec.recovery_matrix(self.coding_matrix, tuple(avail_ids),
                                     tuple(want_ids))
        return self._apply_flat(R, chunks)


class ErasureCodeJerasureReedSolomonVandermonde(ErasureCodeJerasure):
    technique = "reed_sol_van"

    def _build_matrix(self) -> np.ndarray:
        return gf256.reed_sol_van_matrix(self.k, self.m)


class ErasureCodeJerasureReedSolomonRAID6(ErasureCodeJerasure):
    technique = "reed_sol_r6_op"

    def _check_technique(self) -> None:
        if self.m != 2:
            raise ErasureCodeError("reed_sol_r6_op requires m=2")

    def _build_matrix(self) -> np.ndarray:
        return gf256.reed_sol_r6_matrix(self.k)


class ErasureCodeJerasureCauchyOrig(ErasureCodeJerasure):
    technique = "cauchy_orig"

    def _build_matrix(self) -> np.ndarray:
        return gf256.cauchy_orig_matrix(self.k, self.m)


class ErasureCodeJerasureCauchyGood(ErasureCodeJerasure):
    technique = "cauchy_good"

    def _build_matrix(self) -> np.ndarray:
        return gf256.cauchy_good_matrix(self.k, self.m)


class ErasureCodeJerasureBitMatrix(ErasureCodeJerasure):
    """Base for the minimal-density GF(2) bitmatrix RAID-6 family
    (liberation/blaum_roth/liber8tion): m=2, word size w, chunk = w
    contiguous packets. Lowers onto ec/bitmatrix.py rather than the
    GF(2^8) codec (these codes are not GF(2^8) matrices)."""

    # the GF(2^8) batched stripe API does not apply to GF(2) bit codes;
    # ec_util's callable() gate sends these through the per-stripe loop
    encode_stripes = None
    decode_stripes = None

    def _check_w(self) -> None:
        pass            # per-technique constraints in _check_technique

    def _check_technique(self) -> None:
        if self.m != 2:
            raise ErasureCodeError(f"{self.technique} requires m=2")
        if self.k > self.w:
            raise ErasureCodeError(
                f"{self.technique}: k={self.k} > w={self.w}")

    def prepare(self) -> None:
        self.code = bitmatrix.RAID6BitCode(
            "blaum_roth" if self.technique == "blaum_roth"
            else "liberation", self.k, self.w)

    def get_alignment(self) -> int:
        # chunks must split into w equal packets; keep packets themselves
        # 64-byte aligned for the XOR path
        return self.w * 64

    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        self.code.encode(chunks)

    def decode_chunks(self, want_to_read: Iterable[int],
                      chunks: dict[int, np.ndarray],
                      available: set[int]) -> None:
        want = sorted(set(want_to_read) - available)
        if not want:
            return
        self.code.decode(want, chunks, available)


class ErasureCodeJerasureLiberation(ErasureCodeJerasureBitMatrix):
    technique = "liberation"
    DEFAULT_TECHNIQUE_W = 7

    def _check_technique(self) -> None:
        super()._check_technique()
        if not bitmatrix._is_prime(self.w):
            raise ErasureCodeError(f"liberation: w={self.w} must be prime")


class ErasureCodeJerasureBlaumRoth(ErasureCodeJerasureBitMatrix):
    technique = "blaum_roth"
    DEFAULT_TECHNIQUE_W = 6

    def _check_technique(self) -> None:
        super()._check_technique()
        if not bitmatrix._is_prime(self.w + 1):
            raise ErasureCodeError(
                f"blaum_roth: w+1={self.w + 1} must be prime")


class ErasureCodeJerasureLiber8tion(ErasureCodeJerasureBitMatrix):
    technique = "liber8tion"
    DEFAULT_TECHNIQUE_W = 8

    def _check_technique(self) -> None:
        if self.w != 8:
            raise ErasureCodeError("liber8tion requires w=8")
        super()._check_technique()


_TECHNIQUES = {
    cls.technique: cls
    for cls in (
        ErasureCodeJerasureReedSolomonVandermonde,
        ErasureCodeJerasureReedSolomonRAID6,
        ErasureCodeJerasureCauchyOrig,
        ErasureCodeJerasureCauchyGood,
        ErasureCodeJerasureLiberation,
        ErasureCodeJerasureBlaumRoth,
        ErasureCodeJerasureLiber8tion,
    )
}

# techniques of the reference plugin not implemented yet (none left)
_DEFERRED: set[str] = set()


class ErasureCodePluginJerasure(ErasureCodePlugin):
    def factory(self, profile: Mapping[str, str],
                directory: str | None = None):
        technique = profile.get("technique", "reed_sol_van")
        cls = _TECHNIQUES.get(technique)
        if cls is None:
            if technique in _DEFERRED:
                raise ErasureCodeError(
                    f"technique {technique!r} not yet implemented")
            raise ErasureCodeError(f"unknown jerasure technique {technique!r}")
        instance = cls()
        instance.init(profile)
        return instance


def __erasure_code_init__(name: str, directory: str | None = None):
    ErasureCodePluginRegistry.instance().add(name, ErasureCodePluginJerasure())
