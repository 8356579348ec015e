"""`clay` plugin — Coupled-LAYer MSR regenerating code.

Port of ceph_tpu/ec/plugin_clay.py, a re-creation of the reference's clay
plugin behavior
(src/erasure-code/clay/ErasureCodeClay.{h,cc}; algorithm from Vajha et al.,
"Clay Codes: Moulding MDS Codes to Yield Vector Codes", FAST '18): chunks
form a q x t grid (q = d-k+1, q*t = k+m+nu), each chunk split into
sub_chunk_no = q^t sub-chunks, one per "plane" z (a base-q vector). Repair
of a single chunk reads only sub_chunk_no/q sub-chunks from each of d
helpers — the bandwidth-optimal MSR property — surfaced through
`minimum_to_decode`'s per-chunk (sub-chunk offset, count) runs
(ErasureCodeClay.cc:98-130; note the reference snapshot disables its
`is_repair` gate with an XXX — here the sub-chunk repair path is live).

Design differences from the reference (original implementation, not
byte-compatible with reference clay chunks):
  * the pairwise coupling is an explicit 2x2 transform over GF(2^8),
    [U_a; U_b] = [[1, g],[g, 1]] [C_a; C_b] with g=2 (invertible since
    1 + g^2 != 0), applied as vectorized numpy table lookups — the
    reference routes every pair through a k=2,m=2 scalar-RS decode;
  * the per-plane MDS decodes are batched by decoding order: all planes of
    one intersection score go to the bit-matrix kernel K1 as a single
    matrix apply (ceph_tpu_torch.ops.rs_codec), instead of one scalar
    decode per plane.

The inner MDS code is any registered scalar plugin (jerasure/isa/cuda;
the JAX package's `tpu` is the port's `cuda`) with k' = k+nu, m' = m,
exposing its coding matrix. The profile's `device` (default cuda) picks
where K1 runs and is handed on to the inner code.
"""
from __future__ import annotations

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

GAMMA = 2  # coupling coefficient g; 1 XOR g*g = 5 != 0 so the PFT inverts


def _mul(c: int, arr: np.ndarray) -> np.ndarray:
    return gf256.GF_MUL_TABLE[c, arr]


_INV_DET = gf256.gf_inv(1 ^ gf256.gf_mul(GAMMA, GAMMA))
_INV_GAMMA = gf256.gf_inv(GAMMA)


class _Pair:
    """Solve the pairwise coupling transform given any two known symbols.

    Canonical order: `a` is the pair element whose own x-digit exceeds its
    companion's. U_a = C_a + g*C_b ; U_b = g*C_a + C_b.
    """

    @staticmethod
    def cc_from_uu(Ua, Ub):
        Ca = _mul(_INV_DET, Ua ^ _mul(GAMMA, Ub))
        Cb = _mul(_INV_DET, _mul(GAMMA, Ua) ^ Ub)
        return Ca, Cb

    @staticmethod
    def uu_from_cc(Ca, Cb):
        return Ca ^ _mul(GAMMA, Cb), _mul(GAMMA, Ca) ^ Cb

    @staticmethod
    def ua_from_ca_ub(Ca, Ub):
        Cb = Ub ^ _mul(GAMMA, Ca)
        return Ca ^ _mul(GAMMA, Cb)

    @staticmethod
    def ub_from_cb_ua(Cb, Ua):
        Ca = Ua ^ _mul(GAMMA, Cb)
        return _mul(GAMMA, Ca) ^ Cb

    @staticmethod
    def ca_from_ua_cb(Ua, Cb):
        return Ua ^ _mul(GAMMA, Cb)

    @staticmethod
    def cb_from_ub_ca(Ub, Ca):
        return Ub ^ _mul(GAMMA, Ca)

    @staticmethod
    def cb_from_ua_ca(Ua, Ca):
        return _mul(_INV_GAMMA, Ua ^ Ca)

    @staticmethod
    def ca_from_ub_cb(Ub, Cb):
        return _mul(_INV_GAMMA, Ub ^ Cb)


class ErasureCodeClay(ErasureCode):
    def __init__(self):
        super().__init__()
        self.d = 0
        self.q = 0
        self.t = 0
        self.nu = 0
        self.sub_chunk_no = 0
        self.mds = None  # inner scalar MDS over the q*t grid
        self.device: torch.device | None = None

    # -- init ---------------------------------------------------------------

    def init(self, profile: Mapping[str, str]) -> None:
        super().init(profile)
        device = profile.get("device") or _device.DEFAULT_DEVICE
        self.device = _device.resolve(device)
        self.k = self.to_int("k", profile, 4, minimum=1)
        self.m = self.to_int("m", profile, 2, minimum=1)
        self.d = self.to_int("d", profile, self.k + self.m - 1)
        if not self.k <= self.d <= self.k + self.m - 1:
            raise ErasureCodeError(
                f"d={self.d} must be within [{self.k},{self.k + self.m - 1}]")
        scalar_mds = profile.get("scalar_mds", "jerasure") or "jerasure"
        if scalar_mds not in ("jerasure", "isa", "cuda"):
            raise ErasureCodeError(
                f"scalar_mds {scalar_mds!r} unsupported; use jerasure/isa/cuda")
        technique = profile.get("technique", "reed_sol_van") or "reed_sol_van"

        self.q = self.d - self.k + 1
        self.nu = (-(self.k + self.m)) % self.q
        if self.k + self.m + self.nu > 254:
            raise ErasureCodeError("k+m+nu must be <= 254")
        self.t = (self.k + self.m + self.nu) // self.q
        self.sub_chunk_no = self.q ** self.t

        mds_profile = {"plugin": scalar_mds, "technique": technique,
                       "k": str(self.k + self.nu), "m": str(self.m),
                       "w": "8", "device": device}
        self.mds = ErasureCodePluginRegistry.instance().factory(
            scalar_mds, mds_profile)
        if getattr(self.mds, "coding_matrix", None) is None:
            raise ErasureCodeError(
                f"inner plugin {scalar_mds} exposes no coding matrix")
        self._profile.update({"k": str(self.k), "m": str(self.m),
                              "d": str(self.d), "scalar_mds": scalar_mds,
                              "technique": technique, "w": "8"})

    # -- geometry -----------------------------------------------------------

    def get_sub_chunk_count(self) -> int:
        return self.sub_chunk_no

    def get_chunk_size(self, stripe_width: int) -> int:
        # every sub-chunk must hold the scalar code's alignment
        # (reference ErasureCodeClay.cc get_chunk_size)
        alignment = self.sub_chunk_no * self.k * self.mds.get_alignment()
        padded = alignment * -(-stripe_width // alignment)
        return padded // self.k

    def _grid_id(self, chunk_id: int) -> int:
        """Real chunk id -> grid node id (virtual nodes occupy k..k+nu-1)."""
        return chunk_id if chunk_id < self.k else chunk_id + self.nu

    def _chunk_id(self, node: int) -> int | None:
        """Grid node id -> real chunk id (None for virtual nodes)."""
        if node < self.k:
            return node
        if node < self.k + self.nu:
            return None
        return node - self.nu

    def _z_vec(self, z: int) -> list[int]:
        """Base-q digits of plane z, most significant first (digit[y])."""
        digits = [0] * self.t
        for i in range(self.t - 1, -1, -1):
            digits[i] = z % self.q
            z //= self.q
        return digits

    def _z_sw(self, z: int, y: int, new_digit: int) -> int:
        old = self._z_vec(z)[y]
        return z + (new_digit - old) * self.q ** (self.t - 1 - y)

    # -- repair planning ----------------------------------------------------

    def is_repair(self, want_to_read: set[int], available: set[int]) -> bool:
        """True when the bandwidth-optimal single-chunk repair path applies:
        one lost chunk, its whole grid column group surviving, >= d helpers
        (original ErasureCodeClay::is_repair semantics)."""
        if want_to_read <= available:
            return False
        if len(want_to_read) != 1:
            return False
        if len(available) < self.d:
            return False
        lost = self._grid_id(next(iter(want_to_read)))
        y0 = lost // self.q
        for x in range(self.q):
            node = y0 * self.q + x
            cid = self._chunk_id(node)
            if cid is None or cid in want_to_read:
                continue
            if cid not in available:
                return False
        return True

    def get_repair_subchunks(self, lost_node: int) -> list[tuple[int, int]]:
        """(sub-chunk index, count) runs of planes with digit[y0] == x0
        (ErasureCodeClay::get_repair_subchunks semantics)."""
        y0, x0 = divmod(lost_node, self.q)
        run = self.q ** (self.t - 1 - y0)
        stride = run * self.q
        return [(x0 * run + s * stride, run) for s in range(self.q ** y0)]

    def minimum_to_decode(self, want_to_read: Iterable[int],
                          available: Iterable[int]) -> dict[int, list[tuple[int, int]]]:
        want = set(want_to_read)
        avail = set(available)
        if not self.is_repair(want, avail):
            return super().minimum_to_decode(want, avail)
        lost = self._grid_id(next(iter(want)))
        runs = self.get_repair_subchunks(lost)
        minimum: dict[int, list[tuple[int, int]]] = {}
        y0 = lost // self.q
        for x in range(self.q):
            cid = self._chunk_id(y0 * self.q + x)
            if cid is not None and cid not in want:
                minimum[cid] = list(runs)
        for cid in sorted(avail):
            if len(minimum) >= self.d:
                break
            minimum.setdefault(cid, list(runs))
        if len(minimum) != self.d:
            raise ErasureCodeError(
                f"repair needs {self.d} helpers, found {len(minimum)}")
        return minimum

    # -- kernels ------------------------------------------------------------

    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        C = self._grid_views(chunks)
        erased = {self._grid_id(i) for i in range(self.k, self.k + self.m)}
        self._decode_layered(erased, C)

    def decode_chunks(self, want_to_read: Iterable[int],
                      chunks: dict[int, np.ndarray],
                      available: set[int]) -> None:
        C = self._grid_views(chunks)
        erased = {self._grid_id(i) for i in range(self.k + self.m)
                  if i not in available}
        if not erased:
            return
        self._decode_layered(erased, C)

    def decode(self, want_to_read: Iterable[int],
               chunks: Mapping[int, bytes], chunk_size: int) -> dict[int, bytes]:
        want = set(want_to_read)
        avail = set(chunks)
        lens = {len(b) for b in chunks.values()}
        if self.is_repair(want, avail) and lens and max(lens) < chunk_size:
            return self._repair(want, chunks, chunk_size)
        return super().decode(want, chunks, chunk_size)

    # -- internals ----------------------------------------------------------

    def _grid_views(self, chunks: dict[int, np.ndarray]) -> dict[int, np.ndarray]:
        """Map chunk arrays into grid-node (sub_chunk_no, sc) views; virtual
        shortening nodes get zero buffers."""
        size = chunks[0].size
        if size % self.sub_chunk_no:
            raise ErasureCodeError(
                f"chunk size {size} not divisible by {self.sub_chunk_no} "
                "sub-chunks")
        sc = size // self.sub_chunk_no
        C: dict[int, np.ndarray] = {}
        for i in range(self.k + self.m):
            C[self._grid_id(i)] = chunks[i].reshape(self.sub_chunk_no, sc)
        for node in range(self.k, self.k + self.nu):
            C[node] = np.zeros((self.sub_chunk_no, sc), dtype=np.uint8)
        return C

    def _decode_uncoupled_batch(self, erased: set[int], zs: list[int],
                                U: dict[int, np.ndarray]) -> None:
        """MDS-decode the U symbols of `erased` nodes for all planes in
        `zs` with ONE device matrix apply (the reference decodes plane by
        plane, ErasureCodeClay::decode_uncoupled)."""
        if not zs:
            return
        avail = tuple(i for i in range(self.q * self.t) if i not in erased)
        want = tuple(sorted(erased))
        R = rs_codec.recovery_matrix(self.mds.coding_matrix, avail, want)
        sc = U[0].shape[1]
        src = np.stack([U[i][zs].reshape(-1) for i in avail])  # (k', nz*sc)
        out = rs_codec.MatrixCodec.get(R).apply(src, self.device)
        for row, node in enumerate(want):
            U[node][zs] = out[row].reshape(len(zs), sc)

    def _plane_scores(self, erased: set[int]) -> list[int]:
        scores = []
        for z in range(self.sub_chunk_no):
            zv = self._z_vec(z)
            scores.append(sum(1 for i in erased if i % self.q == zv[i // self.q]))
        return scores

    def _decode_layered(self, erased: set[int],
                        C: dict[int, np.ndarray]) -> None:
        """Full-chunk decode: recover the C symbols of `erased` grid nodes
        in place (ErasureCodeClay::decode_layered structure)."""
        erased = set(erased)
        # pad with virtual/parity nodes so the MDS step sees exactly m holes
        for node in range(self.k + self.nu, self.q * self.t):
            if len(erased) >= self.m:
                break
            erased.add(node)
        for node in range(self.k, self.k + self.nu):
            if len(erased) >= self.m:
                break
            erased.add(node)
        if len(erased) != self.m:
            raise ErasureCodeError(
                f"cannot decode {len(erased)} > m={self.m} erasures")
        # nodes added only to round the MDS hole count up to m may be
        # read-only caller views; recompute into private scratch copies
        for node in erased:
            if not C[node].flags.writeable:
                C[node] = C[node].copy()

        q, t = self.q, self.t
        sub, sc = C[0].shape
        U = {node: np.zeros((sub, sc), dtype=np.uint8)
             for node in range(q * t)}
        scores = self._plane_scores(erased)

        for score in range(max(scores) + 1):
            zs = [z for z in range(sub) if scores[z] == score]
            # phase 1a: uncouple every non-erased node's known symbols
            for z in zs:
                zv = self._z_vec(z)
                for node in range(q * t):
                    if node in erased:
                        continue
                    y, x = divmod(node, q)
                    if zv[y] == x:
                        U[node][z] = C[node][z]
                        continue
                    node_sw = y * q + zv[y]
                    z_sw = self._z_sw(z, y, x)
                    if zv[y] < x:
                        # canonical side: this node is `a`; fills both U's
                        Ua, Ub = _Pair.uu_from_cc(C[node][z], C[node_sw][z_sw])
                        U[node][z] = Ua
                        U[node_sw][z_sw] = Ub
                    elif node_sw in erased:
                        # companion erased: its C at z_sw was recovered at
                        # score-1; this node is `b` of the pair
                        Ua, Ub = _Pair.uu_from_cc(C[node_sw][z_sw], C[node][z])
                        U[node_sw][z_sw] = Ua
                        U[node][z] = Ub
            # phase 1b: one batched MDS decode for all planes of this score
            self._decode_uncoupled_batch(erased, zs, U)
            # phase 2: re-couple to recover erased C symbols
            for z in zs:
                zv = self._z_vec(z)
                for node in sorted(erased):
                    y, x = divmod(node, q)
                    node_sw = y * q + zv[y]
                    z_sw = self._z_sw(z, y, x)
                    if zv[y] == x:
                        C[node][z] = U[node][z]
                    elif node_sw not in erased:
                        # companion C known; recover this C from (U, C_sw)
                        if zv[y] < x:  # this node is `a`
                            C[node][z] = _Pair.ca_from_ua_cb(
                                U[node][z], C[node_sw][z_sw])
                        else:          # this node is `b`
                            C[node][z] = _Pair.cb_from_ub_ca(
                                U[node][z], C[node_sw][z_sw])
                    elif zv[y] < x:
                        # both erased: rebuild the whole pair from both U's
                        Ca, Cb = _Pair.cc_from_uu(U[node][z],
                                                  U[node_sw][z_sw])
                        C[node][z] = Ca
                        C[node_sw][z_sw] = Cb

    # -- sub-chunk repair ---------------------------------------------------

    def _repair(self, want: set[int], chunks: Mapping[int, bytes],
                chunk_size: int) -> dict[int, bytes]:
        """Single-chunk repair reading only repair sub-chunks from d helpers
        (ErasureCodeClay::repair / repair_one_lost_chunk structure)."""
        if chunk_size % self.sub_chunk_no:
            raise ErasureCodeError("chunk_size not sub-chunk aligned")
        sc = chunk_size // self.sub_chunk_no
        repair_subchunks = self.sub_chunk_no // self.q
        repair_blocksize = repair_subchunks * sc
        lost_cid = next(iter(want))
        lost = self._grid_id(lost_cid)
        q, t = self.q, self.t

        runs = self.get_repair_subchunks(lost)
        repair_zs = [z for off, cnt in runs for z in range(off, off + cnt)]
        plane_to_ind = {z: i for i, z in enumerate(repair_zs)}

        # helper C data, reshaped (repair_subchunks, sc); virtual nodes zero
        helper: dict[int, np.ndarray] = {}
        aloof: set[int] = set()
        for i in range(self.k + self.m):
            node = self._grid_id(i)
            if i in chunks:
                # a window over the caller's buffer, only ever read
                buf = np.frombuffer(chunks[i], dtype=np.uint8)
                if buf.size != repair_blocksize:
                    raise ErasureCodeError(
                        f"helper {i} has {buf.size} bytes, expected "
                        f"{repair_blocksize}")
                helper[node] = buf.reshape(repair_subchunks, sc)
            elif i != lost_cid:
                aloof.add(node)
        for node in range(self.k, self.k + self.nu):
            helper[node] = np.zeros((repair_subchunks, sc), dtype=np.uint8)
        if len(helper) + len(aloof) + 1 != q * t:
            raise ErasureCodeError("helper/aloof accounting mismatch")

        # MDS-erased set: the lost node's whole column group + aloof nodes
        y0 = lost // q
        group = {y0 * q + x for x in range(q)}
        erased = group | aloof
        if len(erased) > self.m:
            raise ErasureCodeError(
                f"repair needs {len(erased)} MDS erasures > m={self.m} "
                "(too few helpers)")
        # surplus helpers (caller sent more than d): demote to aloof so the
        # MDS step sees exactly m erasures
        for node in sorted((set(helper) - group), reverse=True):
            if len(erased) >= self.m:
                break
            if self._chunk_id(node) is None:
                continue  # keep virtual shortening helpers
            del helper[node]
            aloof.add(node)
            erased.add(node)
        if len(erased) != self.m:
            raise ErasureCodeError(
                f"{len(erased)} MDS erasures != m={self.m}")

        recovered = np.zeros((self.sub_chunk_no, sc), dtype=np.uint8)
        U = {node: np.zeros((self.sub_chunk_no, sc), dtype=np.uint8)
             for node in range(q * t)}

        # order repair planes by intersection score over the erased set
        scores = {}
        for z in repair_zs:
            zv = self._z_vec(z)
            scores[z] = sum(1 for i in erased if i % q == zv[i // q])

        for score in range(1, max(scores.values()) + 1):
            zs = sorted(z for z in repair_zs if scores[z] == score)
            for z in zs:
                zv = self._z_vec(z)
                for node in range(q * t):
                    if node in erased:
                        continue
                    y, x = divmod(node, q)
                    if zv[y] == x:
                        U[node][z] = helper[node][plane_to_ind[z]]
                        continue
                    node_sw = y * q + zv[y]
                    z_sw = self._z_sw(z, y, x)
                    c_here = helper[node][plane_to_ind[z]]
                    if node_sw in aloof:
                        # companion plane z_sw was handled at score-1; its
                        # U is known, companion C is not (aloof)
                        if zv[y] < x:
                            U[node][z] = _Pair.ua_from_ca_ub(
                                c_here, U[node_sw][z_sw])
                        else:
                            U[node][z] = _Pair.ub_from_cb_ua(
                                c_here, U[node_sw][z_sw])
                    else:
                        c_sw = helper[node_sw][plane_to_ind[z_sw]]
                        if zv[y] < x:
                            U[node][z] = _Pair.uu_from_cc(c_here, c_sw)[0]
                        else:
                            U[node][z] = _Pair.uu_from_cc(c_sw, c_here)[1]
            self._decode_uncoupled_batch(erased, zs, U)
            for z in zs:
                zv = self._z_vec(z)
                for node in sorted(erased - aloof):
                    y, x = divmod(node, q)
                    if zv[y] == x:
                        if node != lost:
                            raise ErasureCodeError("unexpected dot node")
                        recovered[z] = U[node][z]
                    else:
                        # group helper: its C is known; recover the LOST
                        # node's C at companion plane z_sw
                        node_sw = y * q + zv[y]
                        z_sw = self._z_sw(z, y, x)
                        if node_sw != lost:
                            raise ErasureCodeError("companion is not lost node")
                        c_here = helper[node][plane_to_ind[z]]
                        if zv[y] < x:
                            # node is `a` (knowns U_a, C_a), lost is `b`
                            recovered[z_sw] = _Pair.cb_from_ua_ca(
                                U[node][z], c_here)
                        else:
                            # node is `b` (knowns U_b, C_b), lost is `a`
                            recovered[z_sw] = _Pair.ca_from_ub_cb(
                                U[node][z], c_here)
        return {lost_cid: recovered.tobytes()}


class ErasureCodePluginClay(ErasureCodePlugin):
    def factory(self, profile: Mapping[str, str], directory: str | None = None):
        instance = ErasureCodeClay()
        instance.init(profile)
        return instance


def __erasure_code_init__(name: str, directory: str | None = None):
    ErasureCodePluginRegistry.instance().add(name, ErasureCodePluginClay())
