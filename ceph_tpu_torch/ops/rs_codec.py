"""Device-side GF(2^8) matrix application — the erasure-code hot path (K1).

Port of ceph_tpu/ops/rs_codec.py. A Reed-Solomon encode or decode over
GF(2^8) is a linear map over GF(2) once bytes are viewed as bit vectors:
output bit-row i*8+r is the XOR over (j, c) of bitmatrix[i*8+r, j*8+c]
times bit c of input chunk j (gf256.matrix_to_bitmatrix). Encode and
decode are the same kernel with different matrices; decode applies the
inverted survivor submatrix computed on host and cached.

`apply_bitmatrix` is the kernel's wrapper: on a CUDA tensor it launches
the hand-written kernel in csrc/gf_bitmatrix.cu, on a CPU tensor it runs
`apply_bitmatrix_plain`, the same function in bit-plane form in plain
PyTorch. The kernel masks ragged N itself, so nothing here pads lanes or
buckets batches.

`encode_local` is K3's wrapper, the per-device step of the sharded encode
(ceph_tpu/parallel/mesh.py `_encode_local` and its checksum): the same
apply over one device's slice of parity rows, which also returns
sum(parity * 2654435761) mod 2^32, both from one launch of the kernel in
csrc/gf_bitmatrix_csum.cu. `encode_local_plain` is its plain version.

Every launch goes to the device the tensor lies on, whatever the calling
thread's current device is.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import threading

import numpy as np
import torch

from ceph_tpu_torch import device as _device
from ceph_tpu_torch.ec import gf256
from ceph_tpu_torch.ops import _build

#: kernel launches by `apply_bitmatrix` (not by the plain version)
launches = 0
#: K3 launches by `encode_local` (not by its plain version)
encode_local_launches = 0

#: the sharded encode's checksum weight (ceph_tpu/parallel/mesh.py:96)
CSUM_MUL = 2654435761

_KERNEL = "gf_bitmatrix"
_APPLY_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
               ctypes.c_longlong]
_SIGNATURES = {"gf_bitmatrix_apply": _APPLY_ARGS + [ctypes.c_void_p]}
_CSUM_KERNEL = "gf_bitmatrix_csum"
_CSUM_SIGNATURES = {"gf_bitmatrix_csum_run": _APPLY_ARGS + [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]}

# K3's scratch per (device, stream): word 0 the ticket counter, zeroed once
# here and left zero by every launch; then one partial per CTA. A launch
# has at most 8 CTAs of 256 threads on each SM, so 2048 slots cover any
# card of up to 256 SMs; the kernel caps its grid at the slots given.
_CSUM_SLOTS = 2048
_csum_scratch: dict[tuple[torch.device, int], torch.Tensor] = {}
_csum_lock = threading.Lock()

# The plain version keeps its (b, 8k, width) plane tensor under this many
# bytes by working through N in chunks.
_PLANE_BUDGET = 1 << 30


def apply_matrix_np(M: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Ground-truth host encoder: out = M @ data over GF(2^8). (r,k)@(k,N)."""
    return gf256.mat_vec_apply(M, data)


def packed_bitmatrix(M: np.ndarray) -> np.ndarray:
    """(r, k, 8) uint8: P[i, j, c] = M[i, j] * 2^c over GF(2^8), which is
    column j*8+c of the bitmatrix packed over rows i*8..i*8+7 (bit r of
    the byte is bitmatrix[i*8+r, j*8+c]). The kernel's operand."""
    M = np.asarray(M, dtype=np.uint8)
    powers = (1 << np.arange(8)).astype(np.uint8)
    return np.ascontiguousarray(gf256.GF_MUL_TABLE[M[:, :, None],
                                                   powers[None, None, :]])


def apply_bitmatrix_plain(bitmatrix: torch.Tensor,
                          data: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, bit-plane form.

    bitmatrix (8r, 8k) {0,1}, data (b, k, N) uint8, both on one device ->
    (b, r, N) uint8. Contracts in float32 (an int8 `mm` returns int8 and
    wraps; CUDA has no int32 matmul, and the CPU's is several times
    slower than its float32 one), which is exact: every partial sum is at
    most 8k < 2^24."""
    b, k, n = data.shape
    r = bitmatrix.shape[0] // 8
    B = bitmatrix.to(torch.float32)
    out = torch.empty((b, r, n), dtype=torch.uint8, device=data.device)
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    weights = torch.arange(8, dtype=torch.int32, device=data.device)
    step = max(1, _PLANE_BUDGET // (b * 8 * k * 4))
    for lo in range(0, n, step):
        d = data[:, :, lo:lo + step]
        planes = ((d[:, :, None, :] >> shifts[None, None, :, None]) & 1)
        planes = planes.to(torch.float32).reshape(b, 8 * k, d.shape[2])
        bits = torch.matmul(B, planes).to(torch.int32) & 1  # (b, 8r, w)
        bits = bits.reshape(b, r, 8, d.shape[2])
        out[:, :, lo:lo + step] = (bits << weights[None, None, :, None]).sum(
            dim=2).to(torch.uint8)
    return out


def _check_operands(packed: torch.Tensor, bitmatrix: torch.Tensor,
                    data: torch.Tensor) -> None:
    if not isinstance(data, torch.Tensor) or data.dtype != torch.uint8:
        raise TypeError("data must be a torch.uint8 tensor")
    if data.dim() != 3 or not data.is_contiguous():
        raise ValueError(f"data must be contiguous (b, k, N), got "
                         f"{tuple(data.shape)} contiguous={data.is_contiguous()}")
    if data.shape[1] != packed.shape[1]:
        raise ValueError(f"expected {packed.shape[1]} input chunks, got "
                         f"{data.shape[1]}")
    if packed.device != data.device or bitmatrix.device != data.device:
        raise ValueError(f"matrix on {packed.device}, data on {data.device}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")


def apply_bitmatrix(packed: torch.Tensor, bitmatrix: torch.Tensor,
                    data: torch.Tensor) -> torch.Tensor:
    """K1's wrapper: data (b, k, N) uint8 -> (b, r, N) uint8.

    `packed` (r, k, 8) is the kernel's operand, `bitmatrix` (8r, 8k) the
    plain version's; both must lie on data's device. A CUDA tensor
    launches the kernel; a CPU tensor takes the plain version."""
    global launches
    _check_operands(packed, bitmatrix, data)
    if data.device.type == "cpu":
        return apply_bitmatrix_plain(bitmatrix, data)
    r, k, _ = packed.shape
    b, _, n = data.shape
    out = torch.empty((b, r, n), dtype=torch.uint8, device=data.device)
    if b == 0 or n == 0 or r == 0:
        return out
    lib = _build.load(_KERNEL, _SIGNATURES)
    with torch.cuda.device(data.device):
        rc = lib.gf_bitmatrix_apply(_build.ptr(data), _build.ptr(packed),
                                    _build.ptr(out), b, k, n, r,
                                    _build.stream(data.device))
    _build.check(lib, _KERNEL, rc)
    launches += 1
    return out


def encode_local_plain(bitmatrix_local: torch.Tensor,
                       data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's function in plain PyTorch: bitmatrix_local (8r, 8k) {0,1},
    data (b, k, N) uint8 -> (parity (b, r, N) uint8, checksum), the
    checksum a 0-d int64 tensor holding sum(parity * 2654435761) mod
    2^32. In int64 throughout: the byte sum is taken mod 2^32 first and
    the weight split in 16-bit halves, so no product reaches 2^63."""
    parity = apply_bitmatrix_plain(bitmatrix_local, data)
    s = parity.sum(dtype=torch.int64) & 0xFFFFFFFF
    lo, hi = CSUM_MUL & 0xFFFF, CSUM_MUL >> 16
    csum = (s * lo + (((s * hi) & 0xFFFF) << 16)) & 0xFFFFFFFF
    return parity, csum


def _scratch_for(device: torch.device, stream: ctypes.c_void_p,
                 groups: int) -> torch.Tensor:
    """K3's scratch for launches on `stream` of `device`, with at least
    `groups` partial slots (one CTA per row group at the least). Launches
    on one stream run in order, so they can share it."""
    key = (device, stream.value)
    with _csum_lock:
        scratch = _csum_scratch.get(key)
        if scratch is None or scratch.numel() <= groups:
            scratch = _csum_scratch[key] = torch.zeros(
                1 + max(_CSUM_SLOTS, groups), dtype=torch.int32,
                device=device)
    return scratch


def encode_local(packed_local: torch.Tensor, bitmatrix_local: torch.Tensor,
                 data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's wrapper: data (b, k, N) uint8 -> (parity (b, r, N) uint8,
    0-d int64 checksum on data's device), the operands being one
    device's row slice of the padded matrix (`packed_local` (r, k, 8)
    for the kernel, `bitmatrix_local` (8r, 8k) for the plain version).
    A CUDA tensor launches the kernel once, which writes parity and
    checksum; a CPU tensor takes the plain version."""
    global encode_local_launches
    _check_operands(packed_local, bitmatrix_local, data)
    if data.device.type == "cpu":
        return encode_local_plain(bitmatrix_local, data)
    r, k, _ = packed_local.shape
    b, _, n = data.shape
    out = torch.empty((b, r, n), dtype=torch.uint8, device=data.device)
    if b == 0 or n == 0 or r == 0:
        return out, torch.zeros((), dtype=torch.int64, device=data.device)
    csum = torch.empty((), dtype=torch.int64, device=data.device)
    lib = _build.load(_CSUM_KERNEL, _CSUM_SIGNATURES)
    with torch.cuda.device(data.device):
        stream = _build.stream(data.device)
        scratch = _scratch_for(data.device, stream, -(-r // 4))
        rc = lib.gf_bitmatrix_csum_run(
            _build.ptr(data), _build.ptr(packed_local), _build.ptr(out),
            b, k, n, r, _build.ptr(scratch), scratch.numel() - 1,
            _build.ptr(csum), stream)
    _build.check(lib, _CSUM_KERNEL, rc)
    encode_local_launches += 1
    return out, csum


class MatrixCodec:
    """Applies one fixed GF(2^8) matrix (r, k) to byte streams on a device.

    get() memoizes codecs by matrix content in an LRU of 2048: long-lived
    OSDs decoding under churn see many distinct erasure patterns, and each
    codec pins small device operands (the same role and bound as
    ErasureCodeIsaTableCache in the reference).
    """

    _cache: "collections.OrderedDict[bytes, MatrixCodec]" = collections.OrderedDict()
    _CACHE_MAX = 2048

    def __init__(self, M: np.ndarray):
        M = np.ascontiguousarray(M, dtype=np.uint8)
        self.M = M
        self.r, self.k = M.shape
        self.bitmatrix = gf256.matrix_to_bitmatrix(M)
        self.packed = packed_bitmatrix(M)
        # per-device copies of the operands: data on a device must meet
        # operands on that device
        self._dev: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    def _bitmatrix_for(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        """(packed, bitmatrix) pinned to `device`."""
        pinned = self._dev.get(device)
        if pinned is None:
            pinned = self._dev[device] = (
                torch.from_numpy(self.packed).to(device),
                torch.from_numpy(self.bitmatrix).to(device))
        return pinned

    @classmethod
    def get(cls, M: np.ndarray) -> "MatrixCodec":
        key = np.ascontiguousarray(M, dtype=np.uint8).tobytes() + bytes(M.shape)
        codec = cls._cache.get(key)
        if codec is None:
            codec = cls._cache[key] = cls(M)
            while len(cls._cache) > cls._CACHE_MAX:
                cls._cache.popitem(last=False)
        else:
            cls._cache.move_to_end(key)
        return codec

    def apply_device(self, data: torch.Tensor) -> torch.Tensor:
        """data (k, N) uint8 tensor -> (r, N) on the same device."""
        return self.apply_batch_device(data.unsqueeze(0))[0]

    def apply_batch_device(self, data: torch.Tensor) -> torch.Tensor:
        """data (batch, k, N) uint8 tensor -> (batch, r, N), one launch."""
        packed, bitmatrix = self._bitmatrix_for(data.device)
        return apply_bitmatrix(packed, bitmatrix, data)

    def apply(self, data: np.ndarray, device: str | torch.device = "cuda") -> np.ndarray:
        """Host in and out: ships (k, N) bytes to `device`, returns (r, N)."""
        data = np.asarray(data, dtype=np.uint8)
        k, _ = data.shape
        if k != self.k:
            raise ValueError(f"expected {self.k} input chunks, got {k}")
        dev = _device.resolve(device)
        out = self.apply_device(_device.staged(data).to(dev))
        return out.cpu().numpy()


# ---------------------------------------------------------------------------
# Decode support: survivor-submatrix inversion, host-side + cached
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4096)
def _recovery_matrix_cached(coding_bytes: bytes, k: int, m: int,
                            avail: tuple[int, ...], want: tuple[int, ...]) -> bytes:
    coding = np.frombuffer(coding_bytes, dtype=np.uint8).reshape(m, k)
    gen = np.vstack([np.eye(k, dtype=np.uint8), coding])  # (k+m, k) generator
    sub = gen[list(avail), :]  # (k, k) rows we have
    inv = gf256.mat_invert(sub)  # chunk j = inv[j] . avail_data
    rows = []
    for w in want:
        if w < k:
            rows.append(inv[w])
        else:
            # parity chunk = coding row applied to recovered data chunks
            rows.append(gf256.mat_mul(coding[w - k : w - k + 1, :], inv)[0])
    return np.asarray(rows, dtype=np.uint8).tobytes()


def recovery_matrix(coding: np.ndarray, avail: tuple[int, ...],
                    want: tuple[int, ...]) -> np.ndarray:
    """Matrix R (len(want), k) with chunk[w] = R @ data[avail] over GF(2^8).

    `coding` is the (m, k) parity matrix; chunk ids 0..k-1 are data chunks and
    k..k+m-1 parity chunks. `avail` must list exactly k available chunk ids in
    the order their data will be stacked.
    """
    coding = np.ascontiguousarray(coding, dtype=np.uint8)
    m, k = coding.shape
    if len(avail) != k:
        raise ValueError(f"need exactly {k} available chunks, got {len(avail)}")
    raw = _recovery_matrix_cached(coding.tobytes(), k, m, tuple(avail), tuple(want))
    return np.frombuffer(raw, dtype=np.uint8).reshape(len(want), k)
