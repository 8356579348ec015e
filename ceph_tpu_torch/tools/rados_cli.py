"""`rados`-style CLI against a running cluster.

Re-creation of the reference tool surface (src/tools/rados/rados.cc:124
usage: put/get/ls/rm/stat/bench; plus the `ceph status|health` mon
plane from src/ceph.in) over the librados subset.

Usage:
    python -m ceph_tpu_torch.tools.rados_cli -m 127.0.0.1:PORT [-p POOL] CMD...

Commands:
    ls                      list objects in the pool
    put OBJ FILE            write FILE (or - for stdin) to OBJ
    get OBJ FILE            read OBJ into FILE (or - for stdout)
    rm OBJ                  delete OBJ
    stat OBJ                object size
    bench SECONDS write     throughput bench (obj_bencher analog)
    lspools                 pool names
    mkpool NAME [SIZE]      create a replicated pool
    status                  cluster status (ceph -s)
    health                  health checks (ceph health)
    df                      per-pool object counts
    osd tree|dump           osd hierarchy / full map (ceph osd ...)
    osd out|in|down ID...   osd state admin
    pg                      per-PG up/acting dump (ceph pg dump)
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys

from ceph_tpu_torch.rados import RadosClient
from ceph_tpu_torch.utils.async_util import read_file, write_file


MIN_OPERANDS = {"ls": 0, "put": 2, "get": 2, "rm": 1, "stat": 1,
                "bench": 1, "lspools": 0, "mkpool": 1, "status": 0,
                "health": 0, "df": 0, "osd": 1, "pg": 0}


def _check_operands(cmd: list[str]) -> str | None:
    if cmd[0] not in MIN_OPERANDS:
        return f"unknown command {cmd[0]!r}"
    if len(cmd) - 1 < MIN_OPERANDS[cmd[0]]:
        return f"missing operand for {' '.join(cmd)!r} (see --help)"
    return None


async def _run(args) -> int:
    err = _check_operands(args.cmd)
    if err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    host, port = args.mon.rsplit(":", 1)
    client = RadosClient([(host, int(port))])
    await client.connect()
    try:
        cmd = args.cmd[0]
        if cmd == "status":
            print(json.dumps(await client.command({"prefix": "status"}),
                             indent=1))
        elif cmd == "health":
            out = await client.command({"prefix": "health"})
            print(out["status"])
            for name, chk in out.get("checks", {}).items():
                print(f"  [{chk['severity']}] {name}: {chk['summary']}")
                for d in chk.get("detail", []):
                    print(f"      {d}")
        elif cmd == "lspools":
            for name in sorted(client.osdmap.pool_names):
                print(name)
        elif cmd == "mkpool":
            name = args.cmd[1]
            size = int(args.cmd[2]) if len(args.cmd) > 2 else 3
            out = await client.pool_create(name, pg_num=8, size=size)
            print(json.dumps(out))
        elif cmd == "df":
            for name in sorted(client.osdmap.pool_names):
                objs = await client.ioctx(name).list_objects()
                print(f"{name}\t{len(objs)} objects")
        elif cmd == "osd":
            # `ceph osd ...` admin plane (src/ceph.in verbs)
            sub = args.cmd[1]
            if sub == "tree":
                out = await client.command({"prefix": "osd tree"})
                for bname, b in sorted(out["buckets"].items()):
                    print(f"{b['type']}\t{bname}")
                    for item, w in zip(b["items"], b["weights"]):
                        label = f"osd.{item}" if item >= 0 else f"#{item}"
                        print(f"\t{label}\tweight {w}")
            elif sub == "dump":
                out = await client.command({"prefix": "osd dump"})
                print(json.dumps(out, indent=1))
            elif sub in ("out", "in", "down"):
                ids = [int(i) for i in args.cmd[2:]]
                out = await client.command(
                    {"prefix": f"osd {sub}", "ids": ids})
                print(json.dumps(out))
            else:
                print(f"unknown osd subcommand {sub!r}", file=sys.stderr)
                return 2
        elif cmd == "pg":
            # `ceph pg dump`-lite: per-PG acting sets from the map
            from ceph_tpu_torch.crush.osdmap import PG as PGId
            for name in sorted(client.osdmap.pool_names):
                pool = client.osdmap.get_pool(name)
                for ps in range(pool.pg_num):
                    up, acting = client.osdmap.pg_to_up_acting_osds(
                        PGId(pool.id, ps))
                    print(f"{pool.id}.{ps:x}\tup {up}\tacting {acting}")
        else:
            if not args.pool:
                print("error: -p POOL required", file=sys.stderr)
                return 2
            io = client.ioctx(args.pool)
            if cmd == "ls":
                for oid in await io.list_objects():
                    print(oid)
            elif cmd == "put":
                oid, path = args.cmd[1], args.cmd[2]
                data = sys.stdin.buffer.read() if path == "-" else \
                    await read_file(path)
                await io.write_full(oid, data)
                print(f"wrote {len(data)} bytes to {oid}")
            elif cmd == "get":
                oid, path = args.cmd[1], args.cmd[2]
                data = await io.read(oid)
                if path == "-":
                    sys.stdout.buffer.write(data)
                else:
                    await write_file(path, data)
                    print(f"read {len(data)} bytes from {oid}")
            elif cmd == "rm":
                await io.remove(args.cmd[1])
            elif cmd == "stat":
                st = await io.stat(args.cmd[1])
                print(f"{args.pool}/{args.cmd[1]} size {st['size']}")
            elif cmd == "bench":
                from ceph_tpu_torch.tools.rados_bench import run_bench
                out = await run_bench(io, seconds=float(args.cmd[1]),
                                      concurrency=args.concurrency,
                                      object_size=args.object_size)
                print(json.dumps(out, indent=1))
            else:
                print(f"unknown command {cmd!r}", file=sys.stderr)
                return 2
        return 0
    finally:
        await client.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rados")
    ap.add_argument("-m", "--mon", required=True,
                    help="monitor address host:port")
    ap.add_argument("-p", "--pool", default=None)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--object-size", type=int, default=65536)
    ap.add_argument("cmd", nargs="+")
    args = ap.parse_args(argv)
    return asyncio.run(_run(args))


if __name__ == "__main__":
    sys.exit(main())
