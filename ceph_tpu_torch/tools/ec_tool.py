"""ceph-erasure-code-tool — offline encode/decode of files with any profile.

Port of ceph_tpu/tools/ec_tool.py, a re-creation of the reference's EC
CLI
(src/test/ceph-erasure-code-tool/ceph_erasure_code_tool.cc): subcommands

  test-plugin-exists <plugin>
  calc-chunk-size <profile> <object_size>
  encode <profile> <stripe_unit> <want_chunks> <file>
      writes <file>.<chunk_id> for each wanted chunk
  decode <profile> <stripe_unit> <chunk_files> <out_file>
      chunk ids parsed from the file suffixes

Profile syntax: comma-separated k=v pairs, e.g.
  jerasure,k=4,m=2,technique=reed_sol_van  (first item = plugin name)

--device (default cuda; cuda:N or cpu) is where the plugin runs, unless
the profile names its own `device`; encode and decode go through the
port's osd/ec_util.py.
"""
from __future__ import annotations

import argparse
import os
import sys

from ceph_tpu_torch import device as _device
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.osd import ec_util


def parse_profile(text: str) -> tuple[str, dict]:
    items = [p for p in text.split(",") if p]
    if not items:
        raise ValueError("empty profile")
    plugin = items[0]
    profile = {}
    for item in items[1:]:
        if "=" not in item:
            raise ValueError(f"profile item {item!r} is not k=v")
        key, val = item.split("=", 1)
        profile[key] = val
    profile["plugin"] = plugin
    return plugin, profile


def _instance(text: str, device: str):
    plugin, profile = parse_profile(text)
    profile.setdefault("device", device)
    return ErasureCodePluginRegistry.instance().factory(plugin, profile)


def cmd_test_plugin_exists(args) -> int:
    try:
        ErasureCodePluginRegistry.instance().load(args.plugin)
    except Exception as e:
        print(f"plugin {args.plugin}: NOT FOUND ({e})", file=sys.stderr)
        return 1
    print(f"plugin {args.plugin}: ok")
    return 0


def cmd_calc_chunk_size(args) -> int:
    code = _instance(args.profile, args.device)
    print(code.get_chunk_size(args.object_size))
    return 0


def cmd_encode(args) -> int:
    code = _instance(args.profile, args.device)
    with open(args.file, "rb") as f:
        data = f.read()
    k = code.get_data_chunk_count()
    si = ec_util.StripeInfo(k, k * code.get_chunk_size(args.stripe_unit * k))
    pad = (-len(data)) % si.stripe_width
    want = ([int(x) for x in args.want.split(",")] if args.want != "all"
            else list(range(code.get_chunk_count())))
    shards = ec_util.encode(si, code, data + b"\0" * pad, want)
    for cid, buf in shards.items():
        path = f"{args.file}.{cid}"
        with open(path, "wb") as f:
            f.write(buf)
        print(f"wrote {path} ({len(buf)} bytes)")
    return 0


def cmd_decode(args) -> int:
    code = _instance(args.profile, args.device)
    k = code.get_data_chunk_count()
    si = ec_util.StripeInfo(k, k * code.get_chunk_size(args.stripe_unit * k))
    chunks = {}
    for path in args.chunks.split(","):
        suffix = os.path.basename(path).rsplit(".", 1)[-1]
        if not suffix.isdigit():
            print(f"chunk file {path!r} has no numeric .<chunk_id> suffix",
                  file=sys.stderr)
            return 1
        cid = int(suffix)
        if cid in chunks:
            print(f"duplicate chunk id {cid} from {path!r}", file=sys.stderr)
            return 1
        with open(path, "rb") as f:
            chunks[cid] = f.read()
    data = ec_util.decode_concat(si, code, chunks)
    with open(args.out, "wb") as f:
        f.write(data)
    print(f"wrote {args.out} ({len(data)} bytes)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ceph-erasure-code-tool")
    p.add_argument("--device", default=_device.DEFAULT_DEVICE,
                   help="cuda (default), cuda:N or cpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("test-plugin-exists")
    s.add_argument("plugin")
    s.set_defaults(fn=cmd_test_plugin_exists)

    s = sub.add_parser("calc-chunk-size")
    s.add_argument("profile")
    s.add_argument("object_size", type=int)
    s.set_defaults(fn=cmd_calc_chunk_size)

    s = sub.add_parser("encode")
    s.add_argument("profile")
    s.add_argument("stripe_unit", type=int)
    s.add_argument("want", help="comma-separated chunk ids or 'all'")
    s.add_argument("file")
    s.set_defaults(fn=cmd_encode)

    s = sub.add_parser("decode")
    s.add_argument("profile")
    s.add_argument("stripe_unit", type=int)
    s.add_argument("chunks", help="comma-separated chunk file paths")
    s.add_argument("out")
    s.set_defaults(fn=cmd_decode)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
