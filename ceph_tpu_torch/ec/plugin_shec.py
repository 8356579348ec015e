"""`shec` plugin — Shingled Erasure Code.

Port of ceph_tpu/ec/plugin_shec.py, a re-creation of the reference's SHEC
plugin
(src/erasure-code/shec/ErasureCodeShec.{h,cc}): a non-MDS code trading
storage for recovery bandwidth. The m x k coding matrix starts as a
Vandermonde RS matrix and is then "shingled": each parity row keeps only a
sliding window of data columns (shec_reedsolomon_coding_matrix,
ErasureCodeShec.cc:465), so single-chunk recovery touches only the window.
technique=multiple splits (m, c) into two shingle bands chosen to minimize
the reference's recovery-efficiency metric (:424); technique=single uses
one band. Decoding searches parity subsets for a minimal invertible system
(shec_make_decoding_matrix, :535) because arbitrary erasure patterns are
not always recoverable; `minimum_to_decode` (:113) reports exactly the
window chunks that search selects.

The encode and the solve of a decode run the bit-matrix kernel K1 on the
profile's `device` (default cuda; `cpu` runs its plain version).
"""
from __future__ import annotations

import itertools
from typing import Iterable, Mapping

import numpy as np
import torch

from ceph_tpu_torch import device as _device
from ceph_tpu_torch.ec import gf256
from ceph_tpu_torch.ec.interface import ErasureCode, ErasureCodeError
from ceph_tpu_torch.ec.registry import (ERASURE_CODE_VERSION, ErasureCodePlugin,
                                        ErasureCodePluginRegistry)
from ceph_tpu_torch.ops import rs_codec

__erasure_code_version__ = ERASURE_CODE_VERSION

DEFAULT_K = 4
DEFAULT_M = 3
DEFAULT_C = 2


def _band_zero_ranges(k: int, mb: int, cb: int, row: int) -> list[int]:
    """Columns zeroed for `row` of a (mb, cb) shingle band: the cyclic range
    [start, end) with start=((row+cb)*k)//mb % k, end=(row*k)//mb % k —
    i.e. each row KEEPS a window of ((row+cb)*k)//mb - (row*k)//mb columns."""
    end = (row * k) // mb % k
    start = ((row + cb) * k) // mb % k
    cols = []
    cc = start
    while cc != end:
        cols.append(cc)
        cc = (cc + 1) % k
    return cols


def _recovery_efficiency(k: int, m1: int, m2: int, c1: int, c2: int) -> float:
    """The reference's r_e1 metric (shec_calc_recovery_efficiency1)."""
    window = [10 ** 8] * k
    total = 0.0
    for mb, cb, in ((m1, c1), (m2, c2)):
        for row in range(mb):
            width = ((row + cb) * k) // mb - (row * k) // mb
            start = (row * k) // mb % k
            end = ((row + cb) * k) // mb % k
            cc = start
            first = True
            while first or cc != end:
                first = False
                window[cc] = min(window[cc], width)
                cc = (cc + 1) % k
            total += width
    return (total + sum(window)) / (k + m1 + m2)


def shec_matrix(k: int, m: int, c: int, technique: str) -> np.ndarray:
    """(m, k) shingled coding matrix."""
    if technique == "single":
        splits = [(0, 0, m, c)]
    else:
        best, best_re = None, float("inf")
        for c1 in range(c // 2 + 1):
            for m1 in range(m + 1):
                c2, m2 = c - c1, m - m1
                if m1 < c1 or m2 < c2:
                    continue
                if (m1 == 0) != (c1 == 0) or (m2 == 0) != (c2 == 0):
                    continue
                re = _recovery_efficiency(k, m1, m2, c1, c2)
                if re < best_re - 1e-12:
                    best_re, best = re, (m1, c1, m2, c2)
        if best is None:
            raise ErasureCodeError(f"no valid shingle split for m={m} c={c}")
        m1, c1, m2, c2 = best
        splits = [(0, m1, m1, c1), (m1, m1 + m2, m2, c2)]
        splits = [(off, _, mb, cb) for off, _, mb, cb in splits if mb]

    M = np.array(gf256.reed_sol_van_matrix(k, m), dtype=np.uint8).copy()
    for off, _, mb, cb in splits:
        for row in range(mb):
            for col in _band_zero_ranges(k, mb, cb, row):
                M[off + row, col] = 0
    M.setflags(write=False)
    return M


class ErasureCodeShec(ErasureCode):
    technique = "multiple"

    def __init__(self):
        super().__init__()
        self.c = 0
        self.matrix: np.ndarray | None = None
        self.device: torch.device | None = None

    def init(self, profile: Mapping[str, str]) -> None:
        super().init(profile)
        self.device = _device.resolve(profile.get("device") or
                                      _device.DEFAULT_DEVICE)
        has_any = any(profile.get(x) not in (None, "") for x in "kmc")
        has_all = all(profile.get(x) not in (None, "") for x in "kmc")
        if has_any and not has_all:
            raise ErasureCodeError("all of k, m, c must be chosen together")
        self.k = self.to_int("k", profile, DEFAULT_K, minimum=1)
        self.m = self.to_int("m", profile, DEFAULT_M, minimum=1)
        self.c = self.to_int("c", profile, DEFAULT_C, minimum=1)
        w = self.to_int("w", profile, 8)
        if w != 8:
            raise ErasureCodeError(f"w={w} unsupported; only w=8")
        if self.c > self.m:
            raise ErasureCodeError(f"c={self.c} must be <= m={self.m}")
        if self.k > 12:
            raise ErasureCodeError(f"k={self.k} must be <= 12")
        if self.k + self.m > 20:
            raise ErasureCodeError(f"k+m={self.k + self.m} must be <= 20")
        if self.m > self.k:
            raise ErasureCodeError(f"m={self.m} must be <= k={self.k}")
        technique = profile.get("technique", "multiple") or "multiple"
        if technique not in ("single", "multiple"):
            raise ErasureCodeError(f"unknown shec technique {technique!r}")
        self.technique = technique
        self.matrix = shec_matrix(self.k, self.m, self.c, technique)
        self._profile.update({"k": str(self.k), "m": str(self.m),
                              "c": str(self.c), "w": "8",
                              "technique": technique})

    # -- decode planning ----------------------------------------------------

    def _parity_support(self, p: int) -> set[int]:
        return {j for j in range(self.k) if self.matrix[p, j]}

    def _solve_plan(self, want: set[int], avail: set[int]):
        """Search parity subsets for a minimal solvable system
        (shec_make_decoding_matrix semantics). Returns
        (parities, unknown_data, A_inv, data_reads) or raises."""
        k, m = self.k, self.m
        erased = set(range(k + m)) - avail
        # data needed: wanted erased data + windows of wanted erased parity
        needed = {i for i in want if i < k and i in erased}
        for i in want:
            if i >= k and i in erased:
                needed |= self._parity_support(i - k) & erased
        best = None
        avail_parities = [p for p in range(m) if k + p in avail]
        for count in range(len(avail_parities) + 1):
            for P in itertools.combinations(avail_parities, count):
                unknowns = set(needed)
                for p in P:
                    unknowns |= self._parity_support(p) & erased
                if len(unknowns) != count:
                    continue
                cols = sorted(unknowns)  # all data ids: supports are < k
                A = self.matrix[np.ix_(list(P), cols)] if count else \
                    np.zeros((0, 0), dtype=np.uint8)
                if count:
                    try:
                        A_inv = gf256.mat_invert(A)
                    except np.linalg.LinAlgError:
                        continue
                else:
                    A_inv = A
                reads = set()
                for p in P:
                    reads |= self._parity_support(p) & avail
                best = (list(P), cols, A_inv, reads)
                break
            if best is not None:
                break
        if best is None:
            raise ErasureCodeError(
                f"cannot decode {sorted(want)} from {sorted(avail)}")
        return best

    def _minimum_to_decode(self, want_to_read: set[int],
                           available: set[int]) -> set[int]:
        want = set(want_to_read)
        avail = set(available)
        if want <= avail:
            return want
        P, cols, _, reads = self._solve_plan(want, avail)
        minimum = {self.k + p for p in P} | reads | (want & avail)
        # rebuilding a lost parity also reads the available part of its
        # data window (the erased part is in `cols`, recovered via P)
        for i in want:
            if i >= self.k and i not in avail:
                minimum |= self._parity_support(i - self.k) & avail
        return minimum

    # -- kernels ------------------------------------------------------------

    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        data = np.stack([chunks[i] for i in range(self.k)])
        parity = rs_codec.MatrixCodec.get(self.matrix).apply(data, self.device)
        for i in range(self.m):
            chunks[self.k + i][:] = parity[i]

    def decode_chunks(self, want_to_read: Iterable[int],
                      chunks: dict[int, np.ndarray],
                      available: set[int]) -> None:
        want = set(want_to_read) - set(available)
        if not want:
            return
        P, cols, A_inv, _ = self._solve_plan(want, set(available))
        k = self.k
        if cols:
            # rhs_p = parity_p XOR (contribution of available data)
            size = chunks[0].size
            rhs = np.zeros((len(P), size), dtype=np.uint8)
            for row, p in enumerate(P):
                acc = chunks[k + p].copy()
                for j in self._parity_support(p):
                    if j not in cols:
                        acc ^= gf256.GF_MUL_TABLE[self.matrix[p, j],
                                                  chunks[j]]
                rhs[row] = acc
            solved = rs_codec.MatrixCodec.get(A_inv).apply(rhs, self.device)
            for row, j in enumerate(cols):
                chunks[j][:] = solved[row]
        # recompute wanted erased parities from (now complete) data windows
        for i in want:
            if i >= k:
                p = i - k
                acc = np.zeros(chunks[0].size, dtype=np.uint8)
                for j in self._parity_support(p):
                    acc ^= gf256.GF_MUL_TABLE[self.matrix[p, j], chunks[j]]
                chunks[i][:] = acc


class ErasureCodeShecPlugin(ErasureCodePlugin):
    def factory(self, profile: Mapping[str, str], directory: str | None = None):
        instance = ErasureCodeShec()
        instance.init(profile)
        return instance


def __erasure_code_init__(name: str, directory: str | None = None):
    ErasureCodePluginRegistry.instance().add(name, ErasureCodeShecPlugin())
