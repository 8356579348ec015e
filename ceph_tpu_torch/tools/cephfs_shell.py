"""`cephfs-shell`-style CLI for the CephFS layer.

Re-creation of the reference's cephfs-shell command surface
(src/tools/cephfs/shell/cephfs-shell: ls/mkdir/rmdir/put/get/rm/mv/
stat/du) over the mds client.

Usage:
    python -m ceph_tpu_torch.tools.cephfs_shell -m HOST:PORT --mds HOST:PORT \
        CMD [ARGS...]

Commands:
    ls PATH                 list a directory
    mkdir PATH              create a directory
    rmdir PATH              remove an empty directory
    put FILE PATH           upload local FILE (- for stdin)
    get PATH FILE           download to local FILE (- for stdout)
    cat PATH                print a file
    rm PATH                 unlink a file
    mv SRC DST              rename
    stat PATH               dentry metadata
    du                      data-pool usage summary (statfs)
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys

from ceph_tpu_torch.mds import CephFS
from ceph_tpu_torch.utils.async_util import read_file, write_file


MIN_OPERANDS = {"ls": 0, "mkdir": 1, "rmdir": 1, "put": 2, "get": 2,
                "cat": 1, "rm": 1, "mv": 2, "stat": 1, "du": 0}


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
    mon_host, mon_port = args.mon.rsplit(":", 1)
    mds_host, mds_port = args.mds.rsplit(":", 1)
    fs = CephFS([(mon_host, int(mon_port))], (mds_host, int(mds_port)))
    await fs.mount()
    try:
        cmd = args.cmd[0]
        rest = args.cmd[1:]
        if cmd == "ls":
            entries = await fs.readdir(rest[0] if rest else "/")
            for name, d in sorted(entries.items()):
                kind = "d" if d["type"] == "dir" else "-"
                size = d.get("size", 0)
                print(f"{kind} {size:>12}  {name}")
        elif cmd == "mkdir":
            await fs.mkdir(rest[0])
        elif cmd == "rmdir":
            await fs.rmdir(rest[0])
        elif cmd == "put":
            blob = sys.stdin.buffer.read() if rest[0] == "-" else \
                await read_file(rest[0])
            await fs.write_file(rest[1], blob)
        elif cmd in ("get", "cat"):
            data = await fs.read_file(rest[0])
            if cmd == "cat" or rest[1] == "-":
                sys.stdout.buffer.write(data)
            else:
                await write_file(rest[1], data)
        elif cmd == "rm":
            await fs.unlink(rest[0])
        elif cmd == "mv":
            await fs.rename(rest[0], rest[1])
        elif cmd == "stat":
            print(json.dumps(await fs.stat(rest[0]), indent=1))
        elif cmd == "du":
            print(json.dumps(await fs.request("statfs", path="/"),
                             indent=1))
        else:
            raise SystemExit(f"unknown command {cmd!r}")
        return 0
    finally:
        await fs.unmount()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-m", "--mon", required=True, help="mon HOST:PORT")
    p.add_argument("--mds", required=True, help="mds HOST:PORT")
    p.add_argument("cmd", nargs="+")
    args = p.parse_args(argv)
    return asyncio.run(asyncio.wait_for(_run(args), 120))


if __name__ == "__main__":
    sys.exit(main())
