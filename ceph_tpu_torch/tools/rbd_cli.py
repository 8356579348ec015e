"""`rbd`-style CLI against a running cluster.

Re-creation of the reference rbd tool surface (src/tools/rbd/: create/
ls/info/rm/resize/snap {create,ls,rm,rollback}/clone/flatten/lock
{ls,break}/export/import) over the rbd image library.

Usage:
    python -m ceph_tpu_torch.tools.rbd_cli -m HOST:PORT [-p POOL] CMD...

Commands:
    create NAME SIZE_MB [--order N] [--data-pool POOL]
    ls
    info NAME
    rm NAME
    resize NAME SIZE_MB
    export NAME FILE              (- for stdout)
    import FILE NAME              (- for stdin)
    snap create NAME@SNAP
    snap ls NAME
    snap rm NAME@SNAP
    snap rollback NAME@SNAP
    clone PARENT@SNAP CHILD
    flatten NAME
    lock ls NAME
    lock break NAME
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys

from ceph_tpu_torch.rados import RadosClient
from ceph_tpu_torch.rbd.image import DEFAULT_ORDER, RBD, Image
from ceph_tpu_torch.utils.async_util import read_file

MB = 1 << 20


def _split_at(spec: str) -> tuple[str, str]:
    if "@" not in spec:
        raise SystemExit(f"expected IMAGE@SNAP, got {spec!r}")
    name, snap = spec.split("@", 1)
    return name, snap


#: operands each command requires AFTER the command word
MIN_OPERANDS = {"create": 2, "ls": 0, "info": 1, "rm": 1, "resize": 2,
                "export": 2, "import": 2, "snap": 2, "clone": 2,
                "flatten": 1, "lock": 2}


def _check_operands(cmd: list[str], table: dict[str, int]) -> str | None:
    if cmd[0] not in table:
        return f"unknown command {cmd[0]!r}"
    if len(cmd) - 1 < table[cmd[0]]:
        return f"missing operand for {' '.join(cmd)!r} (see --help)"
    return None


async def _run(args) -> int:
    err = _check_operands(args.cmd, MIN_OPERANDS)
    if err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    if args.cmd[0] == "snap" and args.cmd[1] == "ls" \
            and len(args.cmd) < 3:
        print("error: snap ls needs an image name", file=sys.stderr)
        return 2
    host, port = args.mon.rsplit(":", 1)
    client = RadosClient([(host, int(port))])
    await client.connect()
    io = client.ioctx(args.pool)
    try:
        cmd = args.cmd[0]
        rest = args.cmd[1:]
        if cmd == "create":
            await RBD.create(io, rest[0], int(float(rest[1]) * MB),
                             order=args.order or DEFAULT_ORDER,
                             data_pool=getattr(args, "data_pool", None))
        elif cmd == "ls":
            for name in await RBD.list(io):
                print(name)
        elif cmd == "info":
            img = await Image.open(io, rest[0])
            try:
                print(json.dumps(await img.stat(), indent=1))
            finally:
                await img.close()
        elif cmd == "rm":
            await RBD.remove(io, rest[0])
        elif cmd == "resize":
            img = await Image.open(io, rest[0])
            try:
                await img.resize(int(float(rest[1]) * MB))
            finally:
                await img.close()
        elif cmd == "export":
            img = await Image.open(io, rest[0])
            loop = asyncio.get_running_loop()
            out = sys.stdout.buffer if rest[1] == "-" else \
                await loop.run_in_executor(None, open, rest[1], "wb")
            try:
                # stream object-size chunks (the reference rbd export
                # does the same) instead of one whole-image buffer;
                # file writes go through the executor so a slow disk
                # cannot stall the image reads' event loop
                off = 0
                while off < img.size:
                    n = min(img.object_size, img.size - off)
                    chunk = await img.read(off, n)
                    await loop.run_in_executor(None, out.write, chunk)
                    off += n
            finally:
                if out is not sys.stdout.buffer:
                    out.close()
                await img.close()
        elif cmd == "import":
            blob = sys.stdin.buffer.read() if rest[0] == "-" else \
                await read_file(rest[0])
            await RBD.create(io, rest[1], len(blob),
                             order=args.order or DEFAULT_ORDER)
            img = await Image.open(io, rest[1])
            try:
                await img.write(0, blob)
            finally:
                await img.close()
        elif cmd == "snap":
            sub = rest[0]
            if sub == "ls":
                img = await Image.open(io, rest[1])
                try:
                    for name, meta in sorted(img.snap_list().items()):
                        print(f"{name}\tid={meta['id']}\t"
                              f"size={meta['size']}")
                finally:
                    await img.close()
                return 0
            name, snap = _split_at(rest[1])
            img = await Image.open(io, name)
            try:
                if sub == "create":
                    await img.snap_create(snap)
                elif sub == "rm":
                    await img.snap_remove(snap)
                elif sub == "rollback":
                    await img.snap_rollback(snap)
                else:
                    raise SystemExit(f"unknown snap subcommand {sub!r}")
            finally:
                await img.close()
        elif cmd == "clone":
            parent, snap = _split_at(rest[0])
            await RBD.clone(io, parent, snap, rest[1])
        elif cmd == "flatten":
            img = await Image.open(io, rest[0])
            try:
                await img.flatten()
            finally:
                await img.close()
        elif cmd == "lock":
            img = await Image.open(io, rest[1])
            try:
                if rest[0] == "ls":
                    print(json.dumps(await img.lock_info(), indent=1))
                elif rest[0] == "break":
                    await img.break_lock()
                else:
                    raise SystemExit(f"unknown lock subcommand "
                                     f"{rest[0]!r}")
            finally:
                await img.close()
        else:
            raise SystemExit(f"unknown command {cmd!r}")
        return 0
    finally:
        await client.shutdown()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-m", "--mon", required=True, help="HOST:PORT")
    p.add_argument("-p", "--pool", default="rbd")
    p.add_argument("--order", type=int, default=0)
    p.add_argument("--data-pool", default=None,
                   help="separate (EC) pool for data objects")
    p.add_argument("cmd", nargs="+")
    args = p.parse_args(argv)
    return asyncio.run(asyncio.wait_for(_run(args), 120))


if __name__ == "__main__":
    sys.exit(main())
