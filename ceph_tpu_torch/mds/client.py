"""CephFS client: POSIX-ish filesystem API over MDS + RADOS data pool.

Re-creation of the reference client's shape (src/client/Client.cc,
libcephfs): metadata ops round-trip to the MDS as
MClientRequest/MClientReply; file DATA is striped by the client
straight into the data pool ({ino:x}.{index:08x} objects — the
Striper/file-layout path, src/osdc/Striper.cc) without touching the
MDS; size/mtime flush to the MDS at fsync/close (the caps-flush
stand-in).

Idiomatic divergences: whole paths ride each request (no dentry/inode
cache or leases); open files track size locally and last-writer-wins at
flush instead of the caps protocol.
"""
from __future__ import annotations

import asyncio
import time

from ceph_tpu_torch.mds.daemon import data_oid
from ceph_tpu_torch.msg.messages import MClientReply, MClientRequest, Message
from ceph_tpu_torch.msg.messenger import Connection, Dispatcher, Messenger, Policy
from ceph_tpu_torch.rados.client import ObjectNotFound, RadosClient


class CephFSError(Exception):
    def __init__(self, rc: int, message: str):
        super().__init__(f"rc={rc}: {message}")
        self.rc = rc


class CephFS(Dispatcher):
    """A mounted filesystem handle (ceph_mount)."""

    REQUEST_TIMEOUT = 15.0

    def __init__(self, mon_addrs, mds_addr: tuple[str, int],
                 data_pool: str = "cephfs_data",
                 auth_key: bytes | None = None):
        self.rados = RadosClient(mon_addrs, auth_key=auth_key)
        self.mds_addr = tuple(mds_addr)
        self.data_pool = data_pool
        self.messenger = Messenger("cephfs-client", auth_key=auth_key)
        self.messenger.add_dispatcher(self)
        self._conn: Connection | None = None
        self._tid = 0
        self._waiters: dict[int, asyncio.Future] = {}

    async def mount(self) -> None:
        await self.rados.connect()
        self.data = self.rados.ioctx(self.data_pool)
        await self.messenger.bind("127.0.0.1", 0)

    async def unmount(self) -> None:
        await self.rados.shutdown()
        await self.messenger.shutdown()

    # -- mds round trip ------------------------------------------------------

    async def _mds_conn(self) -> Connection:
        if self._conn is not None and not self._conn._closed \
                and self._conn.connected:
            return self._conn
        self._conn = await self.messenger.connect(
            self.mds_addr, Policy.lossy_client())
        return self._conn

    async def request(self, op: str, **kw) -> dict:
        self._tid += 1
        tid = self._tid
        fut = asyncio.get_running_loop().create_future()
        self._waiters[tid] = fut
        try:
            conn = await self._mds_conn()
            conn.send_message(MClientRequest(
                {"tid": tid, "op": op, **kw}))
            p = await asyncio.wait_for(fut, self.REQUEST_TIMEOUT)
        finally:
            self._waiters.pop(tid, None)
        if p.get("rc", 0) < 0:
            raise CephFSError(p["rc"], p.get("error", op))
        return p.get("out", {})

    async def ms_dispatch(self, conn: Connection, msg: Message) -> bool:
        if isinstance(msg, MClientReply):
            fut = self._waiters.get(msg.payload.get("tid", 0))
            if fut is not None and not fut.done():
                fut.set_result(msg.payload)
            return True
        return False

    def ms_handle_reset(self, conn: Connection) -> None:
        if conn is self._conn:
            self._conn = None

    # -- namespace ops -------------------------------------------------------

    async def mkdir(self, path: str) -> int:
        return (await self.request("mkdir", path=path))["ino"]

    async def rmdir(self, path: str) -> None:
        await self.request("rmdir", path=path)

    async def readdir(self, path: str) -> dict[str, dict]:
        return (await self.request("readdir", path=path))["entries"]

    async def stat(self, path: str) -> dict:
        return (await self.request("getattr", path=path))["dentry"]

    async def unlink(self, path: str) -> None:
        await self.request("unlink", path=path)

    async def rename(self, src: str, dst: str) -> None:
        await self.request("rename", path=src, dst=dst)

    async def exists(self, path: str) -> bool:
        try:
            await self.stat(path)
            return True
        except CephFSError as e:
            if e.rc == -2:
                return False
            raise

    # -- file I/O ------------------------------------------------------------

    async def open(self, path: str, mode: str = "r",
                   exclusive: bool = False) -> "File":
        """mode: "r" (must exist), "w" (create/truncate), "a"
        (create/append)."""
        if mode == "r":
            dentry = await self.stat(path)
            if dentry["type"] != "file":
                raise CephFSError(-21, f"not a file: {path}")
            return File(self, path, dentry["ino"], dentry["size"],
                        dentry.get("stripe", 1 << 22), writable=False)
        out = await self.request("create", path=path,
                                 exclusive=exclusive)
        f = File(self, path, out["ino"], out["size"], out["stripe"],
                 writable=True)
        if mode == "w" and out["size"]:
            await f.truncate(0)
        return f

    async def write_file(self, path: str, data: bytes) -> None:
        f = await self.open(path, "w")
        try:
            await f.write(data, 0)
        finally:
            await f.close()

    async def read_file(self, path: str) -> bytes:
        f = await self.open(path, "r")
        try:
            return await f.read()
        finally:
            await f.close()


class File:
    """An open file: striped reads/writes + size flush on close."""

    def __init__(self, fs: CephFS, path: str, ino: int, size: int,
                 stripe: int, writable: bool):
        self.fs = fs
        self.path = path
        self.ino = ino
        self.size = size
        self.stripe = stripe
        self.writable = writable
        self._dirty = False

    # -- striping ------------------------------------------------------------

    def _extents(self, offset: int,
                 length: int) -> list[tuple[int, int, int]]:
        """(object index, offset in object, length in object) spans."""
        out = []
        end = offset + length
        while offset < end:
            idx = offset // self.stripe
            off_in = offset - idx * self.stripe
            n = min(end - offset, self.stripe - off_in)
            out.append((idx, off_in, n))
            offset += n
        return out

    async def write(self, data: bytes, offset: int | None = None) -> int:
        if not self.writable:
            raise CephFSError(-9, "file not open for write")
        if offset is None:                 # append
            offset = self.size
        pos = 0
        for idx, off_in, n in self._extents(offset, len(data)):
            await self.fs.data.write(data_oid(self.ino, idx),
                                     data[pos:pos + n], offset=off_in)
            pos += n
        self.size = max(self.size, offset + len(data))
        self._dirty = True
        return len(data)

    async def read(self, length: int | None = None,
                   offset: int = 0) -> bytes:
        if length is None:
            length = max(0, self.size - offset)
        length = min(length, max(0, self.size - offset))
        if length == 0:
            return b""
        chunks = []
        for idx, off_in, n in self._extents(offset, length):
            try:
                blob = await self.fs.data.read(
                    data_oid(self.ino, idx), offset=off_in, length=n)
            except ObjectNotFound:
                blob = b""                 # hole
            chunks.append(blob.ljust(n, b"\x00"))
        return b"".join(chunks)

    async def truncate(self, size: int) -> None:
        if not self.writable:
            raise CephFSError(-9, "file not open for write")
        old_objs = max(1, -(-self.size // self.stripe))
        keep_objs = -(-size // self.stripe) if size else 0
        for idx in range(keep_objs, old_objs):
            try:
                await self.fs.data.remove(data_oid(self.ino, idx))
            except ObjectNotFound:
                pass
        if size and size % self.stripe:
            try:
                await self.fs.data.truncate(data_oid(self.ino,
                                                     keep_objs - 1),
                                            size % self.stripe)
            except ObjectNotFound:
                pass
        self.size = size
        self._dirty = True
        await self.flush()

    async def flush(self) -> None:
        """Report size/mtime to the MDS (cap flush)."""
        if self._dirty:
            await self.fs.request("setattr", path=self.path,
                                  size=self.size, mtime=time.time())
            self._dirty = False

    async def close(self) -> None:
        if self.writable:
            await self.flush()
