"""GF(2^8) host-side arithmetic for Reed-Solomon erasure codes.

This is the control-plane math: building generator/coding matrices, inverting
decode submatrices, and converting GF(2^8) matrices to GF(2) bitmatrices that
the CUDA data path (ceph_tpu_torch.ops.rs_codec) executes. The port keeps
its own copy of these tables and constructions so that it imports nothing of the
JAX package; tests/test_torch_rs_codec.py holds the two copies equal.

All arithmetic uses the primitive polynomial x^8 + x^4 + x^3 + x^2 + 1
(0x11D), the field used by both jerasure/gf-complete (w=8) and Intel ISA-L
(reference: src/erasure-code/jerasure/ErasureCodeJerasure.cc,
src/erasure-code/isa/ErasureCodeIsa.cc:388-390).

Matrix constructions follow the published algorithms (Plank, "A Tutorial on
Reed-Solomon Coding for Fault-Tolerance in RAID-like Systems" + the 2003
correction note; Plank & Xu, "Optimizing Cauchy Reed-Solomon Codes").
"""
from __future__ import annotations

import functools

import numpy as np

PRIM_POLY = 0x11D  # x^8+x^4+x^3+x^2+1, generator alpha=2
W = 8
FIELD = 1 << W  # 256


def _build_tables():
    exp = np.zeros(2 * FIELD, dtype=np.uint16)
    log = np.zeros(FIELD, dtype=np.uint16)
    x = 1
    for i in range(FIELD - 1):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & FIELD:
            x ^= PRIM_POLY
    # duplicate so exp[log a + log b] never wraps
    exp[FIELD - 1 : 2 * (FIELD - 1)] = exp[: FIELD - 1]
    log[0] = 0  # undefined; callers must special-case 0
    return exp, log


GF_EXP, GF_LOG = _build_tables()

# Full 256x256 multiplication table: 64 KiB, used for vectorized host encode
# (the numpy ground-truth codec that the device kernels are held against).
_a = np.arange(FIELD, dtype=np.uint16)
GF_MUL_TABLE = np.where(
    (_a[:, None] == 0) | (_a[None, :] == 0),
    0,
    GF_EXP[(GF_LOG[_a[:, None]].astype(np.int32) + GF_LOG[_a[None, :]].astype(np.int32)) % (FIELD - 1)],
).astype(np.uint8)
del _a

GF_INV_TABLE = np.zeros(FIELD, dtype=np.uint8)
GF_INV_TABLE[1:] = GF_EXP[(FIELD - 1) - GF_LOG[np.arange(1, FIELD)].astype(np.int32)]


def gf_mul(a: int, b: int) -> int:
    return int(GF_MUL_TABLE[a, b])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(2^8) division by zero")
    if a == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) - int(GF_LOG[b])) % (FIELD - 1)])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(2^8) inverse of zero")
    return int(GF_INV_TABLE[a])


def gf_pow(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) * n) % (FIELD - 1)])


# ---------------------------------------------------------------------------
# Matrix ops over GF(2^8) (numpy uint8 matrices)
# ---------------------------------------------------------------------------

def mat_mul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """C = A @ B over GF(2^8). Shapes (n,k) @ (k,m) -> (n,m)."""
    A = np.asarray(A, dtype=np.uint8)
    B = np.asarray(B, dtype=np.uint8)
    # products[i,j,l] = A[i,l]*B[l,j]; XOR-reduce over l
    prod = GF_MUL_TABLE[A[:, :, None], B[None, :, :]]  # (n,k,m)
    return np.bitwise_xor.reduce(prod, axis=1)


def mat_vec_apply(M: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Apply coding matrix M (m,k) to data bytes (k, N) -> (m, N) over GF(2^8).

    This is the numpy ground-truth encoder the device kernels are held
    against (equivalent of jerasure_matrix_encode with w=8).
    """
    M = np.asarray(M, dtype=np.uint8)
    data = np.asarray(data, dtype=np.uint8)
    out = np.zeros((M.shape[0], data.shape[1]), dtype=np.uint8)
    for i in range(M.shape[0]):
        acc = out[i]
        for j in range(M.shape[1]):
            c = M[i, j]
            if c == 0:
                continue
            acc ^= GF_MUL_TABLE[c, data[j]]
        out[i] = acc
    return out


def mat_invert(M: np.ndarray) -> np.ndarray:
    """Invert a square matrix over GF(2^8) by Gauss-Jordan elimination."""
    M = np.asarray(M, dtype=np.uint8).copy()
    n = M.shape[0]
    if M.shape != (n, n):
        raise ValueError("matrix must be square")
    inv = np.eye(n, dtype=np.uint8)
    for col in range(n):
        # pivot search
        pivot = -1
        for row in range(col, n):
            if M[row, col] != 0:
                pivot = row
                break
        if pivot < 0:
            raise np.linalg.LinAlgError("singular matrix over GF(2^8)")
        if pivot != col:
            M[[col, pivot]] = M[[pivot, col]]
            inv[[col, pivot]] = inv[[pivot, col]]
        # scale pivot row to 1
        pv = int(M[col, col])
        if pv != 1:
            pinv = gf_inv(pv)
            M[col] = GF_MUL_TABLE[pinv, M[col]]
            inv[col] = GF_MUL_TABLE[pinv, inv[col]]
        # eliminate
        for row in range(n):
            if row == col or M[row, col] == 0:
                continue
            f = int(M[row, col])
            M[row] ^= GF_MUL_TABLE[f, M[col]]
            inv[row] ^= GF_MUL_TABLE[f, inv[col]]
    return inv


# ---------------------------------------------------------------------------
# Coding-matrix constructions
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def reed_sol_van_matrix(k: int, m: int) -> np.ndarray:
    """Systematic Vandermonde RS coding matrix (m, k), jerasure reed_sol_van.

    Construction-compatible with jerasure's reed_sol_vandermonde_coding_matrix (the
    published Plank algorithm wrapped by reference
    src/erasure-code/jerasure/ErasureCodeJerasure.cc:162): build the
    *extended* Vandermonde matrix — first row e_0, last row e_{k-1}, middle
    row i = [1, i, i^2, ...] — then systematize the top k rows to the
    identity with row swaps + elementary column operations, and finally
    normalize the coding block: scale each column of the coding rows so the
    first coding row is all ones, then scale every later coding row so its
    first element is 1 (both scalings preserve the MDS property). The
    all-ones first coding row is the documented jerasure property that makes
    m=1 parity plain XOR for any k (and is what the reference ISA plugin's
    region_xor single-erasure fast path relies on for its own Vandermonde,
    src/erasure-code/isa/ErasureCodeIsa.cc:206). Golden values pinned in
    tests/test_gf256.py.
    """
    if k + m > FIELD:
        raise ValueError("k+m must be <= 256 for GF(2^8)")
    rows = k + m
    vdm = np.zeros((rows, k), dtype=np.uint8)
    vdm[0, 0] = 1
    vdm[rows - 1, k - 1] = 1
    q = 1
    for i in range(1, rows - 1):
        vdm[i, 0] = 1
        for j in range(1, k):
            vdm[i, j] = gf_mul(int(vdm[i, j - 1]), q)
        q += 1
    # systematize: make row i equal e_i for i in 1..k-1 (row 0 already is e_0)
    for i in range(1, k):
        # find a row at/below i with a nonzero entry in column i, swap it up
        j = i
        while j < rows and vdm[j, i] == 0:
            j += 1
        if j >= rows:
            raise np.linalg.LinAlgError("vandermonde systematization failed")
        if j != i:
            vdm[[i, j]] = vdm[[j, i]]
        piv = int(vdm[i, i])
        if piv != 1:
            vdm[:, i] = GF_MUL_TABLE[gf_inv(piv), vdm[:, i]]
        for c in range(k):
            if c != i and vdm[i, c] != 0:
                vdm[:, c] ^= GF_MUL_TABLE[int(vdm[i, c]), vdm[:, i]]
    coding = vdm[k:].copy()
    # normalize: first coding row -> all ones (divide each coding column by
    # its first-row element), later rows -> leading element 1
    for j in range(k):
        d = int(coding[0, j])
        if d not in (0, 1):
            coding[:, j] = GF_MUL_TABLE[gf_inv(d), coding[:, j]]
    for i in range(1, m):
        d = int(coding[i, 0])
        if d not in (0, 1):
            coding[i] = GF_MUL_TABLE[gf_inv(d), coding[i]]
    coding.setflags(write=False)
    return coding


@functools.lru_cache(maxsize=None)
def reed_sol_r6_matrix(k: int) -> np.ndarray:
    """RAID-6 optimized matrix (m=2): row0 = all ones (P), row1[j] = 2^j (Q)."""
    coding = np.zeros((2, k), dtype=np.uint8)
    coding[0, :] = 1
    for j in range(k):
        coding[1, j] = gf_pow(2, j)
    coding.setflags(write=False)
    return coding


@functools.lru_cache(maxsize=None)
def cauchy_orig_matrix(k: int, m: int) -> np.ndarray:
    """Original Cauchy matrix: a[i][j] = 1/(i XOR (m+j)), i<m, j<k."""
    if k + m > FIELD:
        raise ValueError("k+m must be <= 256")
    coding = np.zeros((m, k), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            coding[i, j] = gf_inv(i ^ (m + j))
    coding.setflags(write=False)
    return coding


@functools.lru_cache(maxsize=256)
def _bitmatrix_ones(x: int) -> int:
    """Number of ones in the 8x8 GF(2) bitmatrix of multiply-by-x."""
    return int(elem_bitmatrix(x).sum())


@functools.lru_cache(maxsize=None)
def cauchy_good_matrix(k: int, m: int) -> np.ndarray:
    """Cauchy matrix optimized to minimize bitmatrix ones (Plank & Xu 2006).

    Start from cauchy_orig; divide each column j by its row-0 element so row 0
    becomes all ones; then for each subsequent row pick the element divisor
    that minimizes the total popcount of the row's bitmatrices. Divisor
    candidates are scanned in column order with strict-improvement comparison
    so ties resolve deterministically, matching jerasure's
    cauchy_good_general_coding_matrix scan order.
    """
    A = np.array(cauchy_orig_matrix(k, m), dtype=np.uint8)
    for j in range(k):
        d = int(A[0, j])
        if d not in (0, 1):
            A[:, j] = GF_MUL_TABLE[gf_inv(d), A[:, j]]
    for i in range(1, m):
        best_div, best_cost = 1, sum(_bitmatrix_ones(int(x)) for x in A[i])
        seen = {0, 1}
        for div in map(int, A[i]):
            if div in seen:
                continue
            seen.add(div)
            cand = GF_MUL_TABLE[gf_inv(div), A[i]]
            cost = sum(_bitmatrix_ones(int(x)) for x in cand)
            if cost < best_cost:
                best_div, best_cost = div, cost
        if best_div != 1:
            A[i] = GF_MUL_TABLE[gf_inv(best_div), A[i]]
    A.setflags(write=False)
    return A


@functools.lru_cache(maxsize=None)
def isa_rs_vandermonde_matrix(k: int, m: int) -> np.ndarray:
    """ISA-L gf_gen_rs_matrix-style coding rows: a[i][j] = (2^i)^j = 2^(i*j).

    Guaranteed MDS only for the ranges ISA-L supports (k+m <= 255 with m <= ...);
    the reference isa plugin switches to Cauchy for larger geometries
    (src/erasure-code/isa/ErasureCodeIsa.cc:388-390 behavior).
    """
    coding = np.zeros((m, k), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            coding[i, j] = gf_pow(2, i * j)
    coding.setflags(write=False)
    return coding


@functools.lru_cache(maxsize=None)
def isa_cauchy1_matrix(k: int, m: int) -> np.ndarray:
    """ISA-L gf_gen_cauchy1_matrix coding rows: a[i][j] = 1/((k+i) XOR j) —
    Cauchy with X = {k..k+m-1}, Y = {0..k-1} (i XOR j != 0 since i >= k > j)."""
    coding = np.zeros((m, k), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            coding[i, j] = gf_inv((k + i) ^ j)
    coding.setflags(write=False)
    return coding


# ---------------------------------------------------------------------------
# GF(2) bitmatrix conversion (for bitplane-matmul / XOR-network data path)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _elem_bitmatrix_cached(x: int) -> bytes:
    B = np.zeros((W, W), dtype=np.uint8)
    for c in range(W):
        y = gf_mul(x, 1 << c)
        for r in range(W):
            B[r, c] = (y >> r) & 1
    return B.tobytes()


def elem_bitmatrix(x: int) -> np.ndarray:
    """8x8 GF(2) matrix B with (x*v) bit r = XOR_c B[r,c] * v_c."""
    return np.frombuffer(_elem_bitmatrix_cached(int(x)), dtype=np.uint8).reshape(W, W)


def matrix_to_bitmatrix(M: np.ndarray) -> np.ndarray:
    """Expand an (m,k) GF(2^8) matrix to an (m*8, k*8) GF(2) bitmatrix.

    Output bit-row i*8+r of the product equals XOR over (j,c) of
    B[i*8+r, j*8+c] * (input chunk j, bit c) — the contract consumed by
    ceph_tpu_torch.ops bit-matrix kernel (jerasure_matrix_to_bitmatrix semantics).
    """
    M = np.asarray(M, dtype=np.uint8)
    m, k = M.shape
    B = np.zeros((m * W, k * W), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            B[i * W : (i + 1) * W, j * W : (j + 1) * W] = elem_bitmatrix(int(M[i, j]))
    return B


def bitmatrix_invert(B: np.ndarray) -> np.ndarray:
    """Invert a square GF(2) bitmatrix (Gauss-Jordan, XOR pivoting)."""
    B = np.asarray(B, dtype=np.uint8).copy()
    n = B.shape[0]
    if B.shape != (n, n):
        raise ValueError("bitmatrix must be square")
    inv = np.eye(n, dtype=np.uint8)
    for col in range(n):
        pivot = -1
        for row in range(col, n):
            if B[row, col]:
                pivot = row
                break
        if pivot < 0:
            raise np.linalg.LinAlgError("singular GF(2) matrix")
        if pivot != col:
            B[[col, pivot]] = B[[pivot, col]]
            inv[[col, pivot]] = inv[[pivot, col]]
        for row in range(n):
            if row != col and B[row, col]:
                B[row] ^= B[col]
                inv[row] ^= inv[col]
    return inv
