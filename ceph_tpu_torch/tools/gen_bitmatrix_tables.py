"""Regenerate the pinned liberation-family constructions embedded in
ceph_tpu_torch/ec/bitmatrix.py (_PINNED), a copy of the JAX package's
table.

Runs the deterministic MDS search once per supported (k, w) and prints
the table literal. The placements are OURS (found by the search, not
transcribed from jerasure); the non-regression corpus pins them for
on-disk stability."""
from __future__ import annotations

import time

from ceph_tpu_torch.ec.bitmatrix import _search_specs


def main() -> None:
    combos = [(k, 7) for k in range(2, 8)]          # liberation w=7
    combos += [(k, 5) for k in range(2, 6)]         # liberation w=5
    combos += [(k, 8) for k in range(2, 9)]         # liber8tion w=8
    print("_PINNED: dict[tuple[int, int], list] = {")
    for k, w in combos:
        t0 = time.time()
        specs = _search_specs(k, w)
        compact = [(a, extra) for a, extra in specs]
        print(f"    ({k}, {w}): {compact!r},   # {time.time() - t0:.1f}s")
    print("}")


if __name__ == "__main__":
    main()
