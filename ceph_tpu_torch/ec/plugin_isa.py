"""`isa` plugin: ISA-L-matrix-compatible Reed-Solomon on the port's codec.

Port of ceph_tpu/ec/plugin_isa.py, a re-creation of the reference's
Intel ISA-L plugin (src/erasure-code/isa/ErasureCodeIsa.{h,cc}):
techniques `reed_sol_van` (gf_gen_rs_matrix Vandermonde, :388) and
`cauchy` (gf_gen_cauchy1_matrix, :390). The reference caches decode
tables in an LRU shared across instances (ErasureCodeIsaTableCache.h:35)
— here that role is played by the MatrixCodec / recovery-matrix LRUs in
ceph_tpu_torch.ops.rs_codec. The m=1 region_xor fast path (:127,201) is
the same bit-matrix kernel K1 with a 1-row all-ones matrix. Everything
else (the profile's `device`, scalar encode/decode through K1, the
batched stripe API) is the port's jerasure plugin's.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

from ceph_tpu_torch.ec import gf256
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.plugin_jerasure import ErasureCodeJerasure
from ceph_tpu_torch.ec.registry import (ERASURE_CODE_VERSION, ErasureCodePlugin,
                                        ErasureCodePluginRegistry)

__erasure_code_version__ = ERASURE_CODE_VERSION

DEFAULT_K = 7
DEFAULT_M = 3


class ErasureCodeIsa(ErasureCodeJerasure):
    """Shares the matrix-code machinery; differs in matrix construction."""

    technique = "reed_sol_van"

    def init(self, profile: Mapping[str, str]) -> None:
        # ISA defaults differ from jerasure's (ErasureCodeIsa.h)
        profile = dict(profile)
        profile.setdefault("k", str(DEFAULT_K))
        profile.setdefault("m", str(DEFAULT_M))
        super().init(profile)

    def get_alignment(self) -> int:
        # reference ISA-L pads to 64B (EC_ISA_ADDRESS_ALIGNMENT); the port
        # keeps the JAX package's 128, a multiple, so both contracts hold.
        return 128


class ErasureCodeIsaVandermonde(ErasureCodeIsa):
    technique = "reed_sol_van"

    def _check_technique(self) -> None:
        # The reference rejects (err=-EINVAL) geometries where the raw ISA-L
        # Vandermonde is not verified MDS: k<=32, m<=4, and k<=21 when m=4
        # (src/erasure-code/isa/ErasureCodeIsa.cc:331-362). Same limits here.
        if self.k > 32:
            raise ErasureCodeError(
                f"Vandermonde: k={self.k} should be less/equal than 32")
        if self.m > 4:
            raise ErasureCodeError(
                f"Vandermonde: m={self.m} should be less than 5 to guarantee "
                "an MDS codec; use technique=cauchy")
        if self.m == 4 and self.k > 21:
            raise ErasureCodeError(
                f"Vandermonde: k={self.k} should be less than 22 to guarantee "
                "an MDS codec with m=4")

    def _build_matrix(self) -> np.ndarray:
        return gf256.isa_rs_vandermonde_matrix(self.k, self.m)


class ErasureCodeIsaCauchy(ErasureCodeIsa):
    technique = "cauchy"

    def _build_matrix(self) -> np.ndarray:
        return gf256.isa_cauchy1_matrix(self.k, self.m)


_TECHNIQUES = {
    "reed_sol_van": ErasureCodeIsaVandermonde,
    "cauchy": ErasureCodeIsaCauchy,
}


class ErasureCodePluginIsa(ErasureCodePlugin):
    def factory(self, profile: Mapping[str, str], directory: str | None = None):
        technique = profile.get("technique", "reed_sol_van")
        cls = _TECHNIQUES.get(technique)
        if cls is None:
            raise ErasureCodeError(f"unknown isa technique {technique!r}")
        instance = cls()
        instance.init(profile)
        return instance


def __erasure_code_init__(name: str, directory: str | None = None):
    ErasureCodePluginRegistry.instance().add(name, ErasureCodePluginIsa())
