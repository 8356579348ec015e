"""GF(2) bitmatrix RAID-6 codes: blaum_roth, liberation, liber8tion.

Port of ceph_tpu/ec/bitmatrix.py, a re-creation of jerasure's
minimal-density bitmatrix technique family (reference
src/erasure-code/jerasure/ErasureCodeJerasure.{h,cc}:353 bitmatrix +
schedule dispatch; the vendored jerasure C implements the constructions
from the published papers):

  * blaum_roth: the Blaum-Roth construction over the ring
    GF(2)[x]/M_p(x) with p = w+1 prime, M_p(x) = 1 + x + ... + x^w;
    data disk i's Q-block is multiplication by x^i (the companion
    matrix power) — provably MDS for k <= w;
  * liberation / liber8tion: minimal-density codes of Plank's
    liberation family — Q-blocks are a cyclic rotation R^i plus extra
    bit(s). The defining property (lowest density + MDS) is enforced
    CONSTRUCTIVELY: extra-bit positions are found by a deterministic
    search that verifies every 2-erasure pattern decodes, rather than
    transcribing jerasure's tables. The placements are the JAX
    package's bit for bit (the `_PINNED` table and the same search);
    the non-regression corpus pins them for on-disk stability.

Data layout: a chunk of S bytes is w contiguous packets of S/w bytes
(jerasure's bitmatrix word layout); bit-row r of disk d is packet
d*w + r. Encoding XORs packets per the (m*w, k*w) coding bitmatrix;
decode inverts the surviving disks' generator rows over GF(2).

These codes run on the host XOR path (numpy bitwise_xor over packets),
as in the JAX package: RAID-6 m=2 workloads are XOR-bound, and the
bit-matrix kernel K1 (ops/rs_codec.py) stays the hot path of the
GF(2^8) family.
"""
from __future__ import annotations

import functools

import numpy as np

from ceph_tpu_torch.ec.interface import ErasureCodeError


# ---------------------------------------------------------------------------
# GF(2) linear algebra (dense uint8 {0,1} matrices)
# ---------------------------------------------------------------------------

def gf2_solve(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Solve A @ X = B over GF(2); raises if A is singular."""
    n = A.shape[0]
    M = np.concatenate([A.astype(np.uint8) & 1,
                        B.astype(np.uint8) & 1], axis=1)
    for col in range(n):
        piv = None
        for r in range(col, n):
            if M[r, col]:
                piv = r
                break
        if piv is None:
            raise ErasureCodeError("gf2_solve: singular matrix")
        if piv != col:
            M[[col, piv]] = M[[piv, col]]
        mask = M[:, col].astype(bool).copy()
        mask[col] = False
        M[mask] ^= M[col]
    return M[:, n:].copy()


def gf2_invertible(A: np.ndarray) -> bool:
    try:
        gf2_solve(A, np.eye(A.shape[0], dtype=np.uint8))
        return True
    except ErasureCodeError:
        return False


def gf2_apply(B: np.ndarray, packets: np.ndarray) -> np.ndarray:
    """out[r] = XOR of packets[c] where B[r, c] == 1.
    packets: (in_rows, packet_bytes) uint8."""
    out = np.zeros((B.shape[0], packets.shape[1]), dtype=np.uint8)
    for r in range(B.shape[0]):
        idx = np.nonzero(B[r])[0]
        if idx.size:
            out[r] = np.bitwise_xor.reduce(packets[idx], axis=0)
    return out


def _rot(w: int, i: int) -> np.ndarray:
    """R^i: ones at (j, (j + i) mod w)."""
    m = np.zeros((w, w), dtype=np.uint8)
    for j in range(w):
        m[j, (j + i) % w] = 1
    return m


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    return all(n % d for d in range(2, int(n ** 0.5) + 1))


# ---------------------------------------------------------------------------
# Constructions
# ---------------------------------------------------------------------------

def blaum_roth_blocks(k: int, w: int) -> list[np.ndarray]:
    """Q-blocks C^i over GF(2)[x]/M_p(x), p = w+1 prime."""
    if not _is_prime(w + 1):
        raise ErasureCodeError(f"blaum_roth: w+1={w + 1} must be prime")
    if k > w:
        raise ErasureCodeError(f"blaum_roth: k={k} > w={w}")
    # companion matrix of M_p(x) = 1 + x + ... + x^w  (x * x^j maps to
    # x^(j+1) for j < w-1; x * x^(w-1) = x^w = 1 + x + ... + x^(w-1))
    C = np.zeros((w, w), dtype=np.uint8)
    for j in range(w - 1):
        C[j + 1, j] = 1
    C[:, w - 1] = 1
    blocks = []
    X = np.eye(w, dtype=np.uint8)
    for _ in range(k):
        blocks.append(X.copy())
        X = (C @ X) & 1
    return blocks


def _mds_raid6(blocks: list[np.ndarray], w: int) -> bool:
    """Every 2-erasure pattern among (data..., P, Q) must decode."""
    k = len(blocks)
    n = k + 2
    G = generator(blocks, w)
    for a in range(n):
        for b in range(a + 1, n):
            keep = [d for d in range(n) if d not in (a, b)][:k]
            A = np.concatenate([G[d * w:(d + 1) * w] for d in keep])
            if not gf2_invertible(A):
                return False
    return True


def _mds_incremental(blocks: list[np.ndarray], w: int) -> bool:
    """MDS check for only the erasure patterns involving the LAST disk:
    for any pattern not touching it, that disk's identity rows make the
    system separable, so earlier verification still stands."""
    k = len(blocks)
    n = k + 2
    G = generator(blocks, w)
    i = k - 1
    for other in range(n):
        if other == i:
            continue
        keep = [d for d in range(n) if d not in (i, other)][:k]
        A = np.concatenate([G[d * w:(d + 1) * w] for d in keep])
        if not gf2_invertible(A):
            return False
    return True


# Pinned constructions: disk i -> (rotation offset a, extra bits).
# Found ONCE by _search_specs (deterministic) and embedded so plugin
# init is O(1); the MDS property is still re-verified at code build.
# Printed by tools/gen_bitmatrix_tables.py; runtime search covers any
# (k, w) not listed.
_PINNED: dict[tuple[int, int], list] = {
    (2, 7): [(0, []), (1, [(3, 0)])],
    (3, 7): [(0, []), (1, [(3, 0)]), (2, [(6, 2)])],
    (4, 7): [(0, []), (1, [(3, 0)]), (2, [(6, 2)]), (3, [(2, 1)])],
    (5, 7): [(0, []), (1, [(3, 0)]), (2, [(6, 2)]), (3, [(2, 1)]),
             (4, [(5, 5)])],
    (6, 7): [(0, []), (1, [(3, 0)]), (2, [(6, 3)]), (3, [(2, 1)]),
             (4, [(5, 4)]), (5, [(1, 2)])],
    (7, 7): [(0, []), (1, [(3, 0)]), (2, [(6, 4)]), (3, [(2, 1)]),
             (4, [(5, 5)]), (5, [(1, 2)]), (6, [(4, 6)])],
    (2, 5): [(0, []), (1, [(2, 0)])],
    (3, 5): [(0, []), (1, [(2, 0)]), (2, [(4, 2)])],
    (4, 5): [(0, []), (1, [(2, 0)]), (2, [(4, 2)]), (3, [(1, 1)])],
    (5, 5): [(0, []), (1, [(2, 0)]), (2, [(4, 3)]), (3, [(1, 1)]),
             (4, [(3, 4)])],
    (2, 8): [(0, []), (1, [(3, 0)])],
    (3, 8): [(0, []), (1, [(3, 0)]), (3, [(0, 1)])],
    (4, 8): [(0, []), (1, [(3, 0)]), (3, [(0, 1)]),
             (2, [(0, 0), (1, 1)])],
    (5, 8): [(0, []), (1, [(3, 0)]), (3, [(0, 1)]),
             (2, [(0, 0), (1, 1)]), (6, [(2, 2), (3, 7)])],
}

# w=8 constructions beyond k=5 need a structure our rotation+2-bit
# search family does not reach within budget (the published liber8tion
# tables go to k=8); callers get a clean error instead of a partial
# search burning minutes at plugin init.
MAX_K = {8: 5}


def _spec_block(w: int, a: int, extra: list) -> np.ndarray:
    m = _rot(w, a)
    for r, c in extra:
        m[r, c] ^= 1
    return m


def _search_specs(k: int, w: int) -> list:
    """Deterministic backtracking search for an MDS lowest-density
    construction: disk blocks R^a plus up to two extra bits (one
    suffices for prime w — the liberation codes; w=8 needs the wider
    family — liber8tion). Returns [(a, [(r, c), ...]), ...]."""
    # MDS-check budget: hard stop for the search (non-prime w needs the
    # wider 2-bit family and far more exploration)
    budget = [60000 if _is_prime(w) else 400000]

    def candidates(i: int):
        if _is_prime(w):
            # prime w: the liberation structure fixes disk i's rotation
            # at R^i; only the extra bit is searched
            offsets = [i % w]
        else:
            offsets = [i % w if i % w else 1] + \
                [a for a in range(1, w) if a != (i % w if i % w else 1)]
        y0 = (i * (w - 1) // 2) % w
        for nbits in (0, 1, 2):
            for a in offsets:
                if nbits == 0:
                    yield (a, [])
                elif nbits == 1:
                    for dr in range(w):
                        for c in range(w):
                            yield (a, [((y0 + dr) % w, c)])
                else:
                    cells = [(r, c) for r in range(w) for c in range(w)]
                    for p1 in range(len(cells)):
                        for p2 in range(p1 + 1, len(cells)):
                            yield (a, [cells[p1], cells[p2]])

    def search(specs: list, blocks: list):
        i = len(blocks)
        if i == k:
            return specs
        for a, extra in candidates(i):
            if budget[0] <= 0:
                return None
            budget[0] -= 1
            cand = _spec_block(w, a, extra)
            if _mds_incremental(blocks + [cand], w):
                out = search(specs + [(a, extra)], blocks + [cand])
                if out is not None:
                    return out
        return None

    specs = search([(0, [])], [np.eye(w, dtype=np.uint8)])
    if specs is None:
        raise ErasureCodeError(
            f"liberation family: no MDS construction found (k={k}, w={w})")
    return specs


def liberation_family_blocks(k: int, w: int) -> list[np.ndarray]:
    """Q-blocks R^a + extra bit(s): pinned table if available, else the
    deterministic search (lowest-density liberation property, Plank
    FAST'08; liber8tion for w=8)."""
    if k > w:
        raise ErasureCodeError(f"liberation family: k={k} > w={w}")
    if k > MAX_K.get(w, w):
        raise ErasureCodeError(
            f"liberation family: k={k} unsupported for w={w} "
            f"(max {MAX_K[w]} in this implementation)")
    specs = _PINNED.get((k, w)) or _search_specs(k, w)
    return [_spec_block(w, a, extra) for a, extra in specs]


@functools.lru_cache(maxsize=64)
def _blocks_cached(technique: str, k: int, w: int) -> tuple:
    if technique == "blaum_roth":
        return tuple(blaum_roth_blocks(k, w))
    return tuple(liberation_family_blocks(k, w))


def generator(blocks: list[np.ndarray], w: int) -> np.ndarray:
    """Full ((k+2)*w, k*w) generator: data identity rows, P = XOR of
    all data words, Q = the construction blocks."""
    k = len(blocks)
    G = np.zeros(((k + 2) * w, k * w), dtype=np.uint8)
    for d in range(k):
        G[d * w:(d + 1) * w, d * w:(d + 1) * w] = np.eye(w, dtype=np.uint8)
        G[k * w:(k + 1) * w, d * w:(d + 1) * w] = np.eye(w, dtype=np.uint8)
        G[(k + 1) * w:(k + 2) * w, d * w:(d + 1) * w] = blocks[d]
    return G


class RAID6BitCode:
    """One (k, w) bitmatrix RAID-6 code: packet-level encode/decode."""

    def __init__(self, technique: str, k: int, w: int):
        self.k, self.w = k, w
        self.blocks = [np.asarray(b) for b in
                       _blocks_cached(technique, k, w)]
        self.G = generator(self.blocks, w)
        if not _mds_raid6(self.blocks, w):
            raise ErasureCodeError(f"{technique} k={k} w={w}: not MDS")
        self._recovery_cache: dict[tuple, np.ndarray] = {}

    # chunk (S bytes) <-> packets (w, S/w)

    def _packets(self, chunks: dict[int, np.ndarray],
                 disks: list[int]) -> np.ndarray:
        size = next(len(chunks[d]) for d in disks)
        if size % self.w:
            raise ErasureCodeError(
                f"chunk size {size} not a multiple of w={self.w}")
        return np.concatenate(
            [np.asarray(chunks[d], dtype=np.uint8).reshape(self.w, -1)
             for d in disks])

    def encode(self, chunks: dict[int, np.ndarray]) -> None:
        """chunks[0..k-1] data in, chunks[k]=P chunks[k+1]=Q out."""
        data = self._packets(chunks, list(range(self.k)))
        coding = gf2_apply(self.G[self.k * self.w:], data)
        chunks[self.k][:] = coding[:self.w].reshape(-1)
        chunks[self.k + 1][:] = coding[self.w:].reshape(-1)

    def recovery_matrix(self, avail: tuple, want: tuple) -> np.ndarray:
        key = (avail, want)
        R = self._recovery_cache.get(key)
        if R is None:
            w = self.w
            A = np.concatenate([self.G[d * w:(d + 1) * w] for d in avail])
            inv = gf2_solve(A, np.eye(self.k * w, dtype=np.uint8))
            W = np.concatenate([self.G[d * w:(d + 1) * w] for d in want])
            R = (W.astype(np.int64) @ inv.astype(np.int64) % 2) \
                .astype(np.uint8)
            self._recovery_cache[key] = R
        return R

    def decode(self, want: list[int], chunks: dict[int, np.ndarray],
               available: set[int]) -> None:
        avail = tuple(sorted(available))[:self.k]
        if len(avail) < self.k:
            raise ErasureCodeError(
                f"cannot decode {want}: only {len(avail)} disks available")
        R = self.recovery_matrix(avail, tuple(sorted(want)))
        src = self._packets(chunks, list(avail))
        rec = gf2_apply(R, src)
        for row, d in enumerate(sorted(want)):
            chunks[d][:] = rec[row * self.w:(row + 1) * self.w].reshape(-1)
