"""monmaptool analog: create/inspect monmap files.

Reference: src/tools/monmaptool.cc (--create --add name addr --print).

Usage:
    python -m ceph_tpu_torch.tools.monmaptool --create \
        --add m0 127.0.0.1:6789 --add m1 127.0.0.1:6790 -o monmap.json
    python -m ceph_tpu_torch.tools.monmaptool -i monmap.json --print
"""
from __future__ import annotations

import argparse
import json
import sys

from ceph_tpu_torch.mon import MonMap


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="monmaptool")
    ap.add_argument("-i", "--infile")
    ap.add_argument("-o", "--outfile")
    ap.add_argument("--create", action="store_true")
    ap.add_argument("--add", nargs=2, action="append", default=[],
                    metavar=("NAME", "ADDR"))
    ap.add_argument("--rm", action="append", default=[], metavar="NAME")
    ap.add_argument("--print", dest="show", action="store_true")
    a = ap.parse_args(argv)
    if a.create:
        mons: dict = {}
    elif a.infile:
        mons = {n: tuple(addr)
                for n, addr in json.load(open(a.infile))["mons"].items()}
    else:
        print("need --create or -i", file=sys.stderr)
        return 2
    for name, addr in a.add:
        host, _, port = addr.rpartition(":")
        mons[name] = (host, int(port))
    for name in a.rm:
        mons.pop(name, None)
    if not mons:
        print("monmap is empty", file=sys.stderr)
        return 2
    monmap = MonMap(mons)
    blob = {"mons": {n: list(addr) for n, addr in monmap.mons.items()},
            "ranks": list(monmap.ranks)}
    if a.outfile:
        json.dump(blob, open(a.outfile, "w"))
        print(f"wrote {a.outfile} ({len(mons)} mons)")
    if a.show or not a.outfile:
        print(json.dumps(blob, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
