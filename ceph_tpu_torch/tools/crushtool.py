"""crushtool analog: build and test CRUSH maps offline.

Reference: src/tools/crushtool.cc (--build, --test --show-statistics,
--show-mappings). Operates on the JSON form of CrushMap.

Usage:
    python -m ceph_tpu_torch.tools.crushtool --build --num-osds 12 \
        --failure-domain host --osds-per-host 3 -o map.json
    python -m ceph_tpu_torch.tools.crushtool -i map.json --test \
        --num-rep 3 --mode firstn --samples 1024
"""
from __future__ import annotations

import argparse
import collections
import json
import sys

from ceph_tpu_torch.crush.crush import CRUSH_NONE, CrushMap


def build_map(num_osds: int, osds_per_host: int) -> CrushMap:
    crush = CrushMap()
    root = crush.add_bucket(10, "default")
    for h in range(-(-num_osds // osds_per_host)):
        hid = crush.add_bucket(1, f"host{h}")
        osds = range(h * osds_per_host,
                     min((h + 1) * osds_per_host, num_osds))
        for o in osds:
            crush.add_item(hid, o, 1.0, name=f"osd.{o}")
        # host weight = what it actually holds, or a short last host
        # would draw osds_per_host's share onto fewer devices
        crush.add_item(root, hid, float(len(osds)))
    return crush


_DOMAIN_TYPES = {"osd": 0, "host": 1, "rack": 2, "row": 3, "root": 10}


def test_map(crush: CrushMap, num_rep: int, mode: str,
             samples: int, failure_domain: str) -> dict:
    rule_id = max(crush._rules, default=-1) + 1
    crush.make_simple_rule(rule_id, "test_rule", "default",
                           _DOMAIN_TYPES[failure_domain], mode=mode)
    counts: collections.Counter = collections.Counter()
    bad = short = 0
    for x in range(samples):
        out = crush.do_rule(rule_id, x, num_rep)
        live = [o for o in out if o != CRUSH_NONE]
        if len(set(live)) != len(live):
            bad += 1
        if len(live) < num_rep:
            short += 1
        counts.update(live)
    n = len(counts) or 1
    mean = sum(counts.values()) / n
    dev = (sum((c - mean) ** 2 for c in counts.values()) / n) ** 0.5
    return {
        "samples": samples, "num_rep": num_rep, "mode": mode,
        "placed": sum(counts.values()),
        "short_mappings": short, "duplicate_mappings": bad,
        "per_osd_mean": round(mean, 2),
        "per_osd_stddev": round(dev, 2),
        "utilization": {f"osd.{o}": c for o, c in sorted(counts.items())},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="crushtool")
    ap.add_argument("-i", "--infile")
    ap.add_argument("-o", "--outfile")
    ap.add_argument("--build", action="store_true")
    ap.add_argument("--num-osds", type=int, default=6)
    ap.add_argument("--osds-per-host", type=int, default=2)
    ap.add_argument("--failure-domain", default="host")
    ap.add_argument("--test", action="store_true")
    ap.add_argument("--num-rep", type=int, default=3)
    ap.add_argument("--mode", default="firstn",
                    choices=["firstn", "indep"])
    ap.add_argument("--samples", type=int, default=1024)
    a = ap.parse_args(argv)
    if a.build:
        crush = build_map(a.num_osds, a.osds_per_host)
    elif a.infile:
        crush = CrushMap.from_dict(json.load(open(a.infile)))
    else:
        print("need --build or -i", file=sys.stderr)
        return 2
    if a.outfile:
        json.dump(crush.to_dict(), open(a.outfile, "w"))
        print(f"wrote {a.outfile}")
    if a.test:
        print(json.dumps(test_map(crush, a.num_rep, a.mode, a.samples,
                                  a.failure_domain), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
