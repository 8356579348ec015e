"""osdmaptool analog: inspect OSDMap dumps and test PG mappings.

Reference: src/tools/osdmaptool.cc (--print, --test-map-pgs).
Operates on the JSON form (`ceph osd dump` output / OSDMap.to_dict).

Usage:
    python -m ceph_tpu_torch.tools.rados_cli -m HOST:PORT status   # live
    python -m ceph_tpu_torch.tools.osdmaptool -i osdmap.json --print
    python -m ceph_tpu_torch.tools.osdmaptool -i osdmap.json --test-map-pgs
"""
from __future__ import annotations

import argparse
import collections
import json
import sys

from ceph_tpu_torch.crush.crush import CRUSH_NONE
from ceph_tpu_torch.crush.osdmap import PG, OSDMap


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="osdmaptool")
    ap.add_argument("-i", "--infile", required=True)
    ap.add_argument("--print", dest="show", action="store_true")
    ap.add_argument("--test-map-pgs", action="store_true")
    a = ap.parse_args(argv)
    m = OSDMap()
    m.load_dict(json.load(open(a.infile)))
    if a.show or not a.test_map_pgs:
        up = sum(1 for st in m.osds.values() if st.up)
        print(json.dumps({
            "epoch": m.epoch,
            "num_osds": len(m.osds), "num_up_osds": up,
            "pools": {p.name: {"id": p.id, "type": p.type,
                               "size": p.size, "min_size": p.min_size,
                               "pg_num": p.pg_num}
                      for p in m.pools.values()},
        }, indent=1))
    if a.test_map_pgs:
        for pool in m.pools.values():
            counts: collections.Counter = collections.Counter()
            primaries: collections.Counter = collections.Counter()
            short = 0
            for ps in range(pool.pg_num):
                up, acting = m.pg_to_up_acting_osds(PG(pool.id, ps))
                live = [o for o in acting if o != CRUSH_NONE]
                counts.update(live)
                if live:
                    primaries[live[0]] += 1
                if len(live) < pool.size:
                    short += 1
            n = len(counts) or 1
            mean = sum(counts.values()) / n
            dev = (sum((c - mean) ** 2
                       for c in counts.values()) / n) ** 0.5
            print(json.dumps({
                "pool": pool.name, "pg_num": pool.pg_num,
                "short_mappings": short,
                "per_osd_mean": round(mean, 2),
                "per_osd_stddev": round(dev, 2),
                "primary_spread": dict(sorted(primaries.items())),
            }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
