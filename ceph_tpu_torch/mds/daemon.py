"""MDS: the CephFS metadata server, storing its state in RADOS.

Re-creation of the reference MDS essentials (src/mds/):

  * all metadata lives in the METADATA POOL as RADOS objects — one
    dirfrag object per directory whose omap maps dentry name -> the
    embedded inode record (the reference stores inodes inside dentries
    the same way, src/mds/CDentry.h / CInode::encode_bare);
  * an inode-number table object allocates inos (src/mds/InoTable.h);
  * every metadata mutation is journaled FIRST: an EMetaBlob-style
    event is appended to the MDLog journal object in the metadata pool
    (src/mds/MDLog.h, journaler in src/osdc/Journaler.h), then applied
    write-through to the dirfrag omaps; an MDS restart replays the
    journal tail idempotently, and the log is trimmed once applied
    events are safely reflected (src/mds/LogSegment expiry);
  * clients speak MClientRequest/MClientReply over the messenger
    (src/messages/MClientRequest.h; src/mds/Server.cc
    handle_client_request dispatch): mkdir/create/lookup/readdir/
    unlink/rmdir/rename/setattr/getattr/statfs;
  * file DATA never passes through the MDS: clients stripe it straight
    into the data pool as {ino:x}.{index:08x} objects (the Striper /
    file layout, src/osdc/Striper.cc); unlink purges those objects the
    way the reference's PurgeQueue does.

Idiomatic divergences: one MDS rank with a single metadata mutation
lock instead of the distributed cache/Locker/subtree migration
machinery; clients send whole paths and the MDS walks them (no client
dentry lease protocol); size/mtime propagate via client setattr at
flush/close instead of the caps protocol.
"""
from __future__ import annotations

import asyncio
import json
import time

from ceph_tpu_torch.mgr.mgr_client import MgrClient
from ceph_tpu_torch.msg.messages import MClientReply, MClientRequest, Message
from ceph_tpu_torch.msg.messenger import Connection, Dispatcher, Messenger
from ceph_tpu_torch.rados.client import ObjectNotFound, RadosClient, RadosError
from ceph_tpu_torch.utils.dout import dout
from ceph_tpu_torch.utils.perf_counters import TYPE_AVG, PerfCountersCollection

ROOT_INO = 1
DEFAULT_STRIPE = 1 << 22          # 4 MiB objects (file_layout_t default)

INOTABLE_OID = "mds_inotable"
MDLOG_OID = "mds_journal"
JOURNAL_TRIM_EVERY = 64


def dirfrag_oid(ino: int) -> str:
    return f"{ino:x}.dir"


def data_oid(ino: int, index: int) -> str:
    return f"{ino:x}.{index:08x}"


class MDSDaemon(Dispatcher):
    """One MDS rank (mds.a): metadata service over a RADOS client."""

    def __init__(self, mon_addrs, metadata_pool: str = "cephfs_metadata",
                 data_pool: str = "cephfs_data",
                 auth_key: bytes | None = None, name: str = "mds.a"):
        self.name = name
        self.rados = RadosClient(mon_addrs, auth_key=auth_key)
        self.metadata_pool = metadata_pool
        self.data_pool = data_pool
        self.messenger = Messenger(name, auth_key=auth_key)
        self.messenger.add_dispatcher(self)
        self.addr: tuple[str, int] | None = None
        self._mdlock = asyncio.Lock()     # one mutation at a time
        self._journal_seq = 0
        self._since_trim = 0
        self.stripe_unit = DEFAULT_STRIPE
        # per-daemon perf counters, shipped to the mgr like every
        # other daemon's (src/mds/MDSDaemon.cc mds_server counters)
        coll = PerfCountersCollection.instance()
        coll.remove(name)               # a restarted rank re-registers
        self.perf = coll.create(name)
        self.perf.add("request", description="client requests handled")
        self.perf.add("request_latency", type=TYPE_AVG,
                      description="client request latency (seconds)")
        self.perf.add("reply_err",
                      description="client requests answered with errors")
        self.perf.add("journal_event",
                      description="metadata events journaled")
        self.mgr_client = MgrClient(
            self.messenger, name, "mds",
            resolve=lambda: (self.rados.monc.mgrmap
                             or {}).get("active_addr"),
            status_cb=lambda: {"metadata_pool": self.metadata_pool,
                               "data_pool": self.data_pool,
                               "journal_seq": self._journal_seq},
            extra_loggers=("sanitizer",))

    # -- lifecycle -----------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> None:
        await self.rados.connect()
        self.rados.monc.subscribe("mgrmap", 1)
        self.meta = self.rados.ioctx(self.metadata_pool)
        self.data = self.rados.ioctx(self.data_pool)
        await self._bootstrap_fs()
        await self._replay_journal()
        self.addr = await self.messenger.bind(host, port)
        self.mgr_client.start()
        dout("mds", 1, f"mds up at {self.addr} "
                       f"(meta={self.metadata_pool} data={self.data_pool})")

    async def stop(self) -> None:
        await self.mgr_client.stop()
        await self.rados.shutdown()
        await self.messenger.shutdown()

    async def _bootstrap_fs(self) -> None:
        """First start: root directory + ino table (ceph fs new)."""
        try:
            await self.meta.stat(INOTABLE_OID)
        except ObjectNotFound:
            await self.meta.write_full(
                INOTABLE_OID, json.dumps({"next": ROOT_INO + 1}).encode())
        try:
            await self.meta.stat(dirfrag_oid(ROOT_INO))
        except ObjectNotFound:
            await self.meta.create(dirfrag_oid(ROOT_INO), exclusive=False)

    async def _alloc_ino(self) -> int:
        blob = await self.meta.read(INOTABLE_OID)
        table = json.loads(blob)
        ino = table["next"]
        table["next"] = ino + 1
        await self.meta.write_full(INOTABLE_OID, json.dumps(table).encode())
        return ino

    # -- journal (MDLog) -----------------------------------------------------

    async def _journal_and_apply(self, event: dict) -> None:
        """The journal-first discipline in one place, so the journaled
        and applied events can never drift apart."""
        await self._journal(event)
        await self._apply_event(event)
        await self._trim_journal()

    async def _journal(self, event: dict) -> None:
        """Append an EMetaBlob-style event BEFORE applying it: a crash
        between journal and apply replays it at next start."""
        self._journal_seq += 1
        event = dict(event, seq=self._journal_seq)
        await self.meta.append(
            MDLOG_OID, json.dumps(event).encode() + b"\n")
        self.perf.inc("journal_event")

    async def _trim_journal(self) -> None:
        """Applied events need no replay: reset the log (LogSegment
        expiry collapsed to whole-log trim — every event is applied
        write-through before the next is admitted)."""
        self._since_trim += 1
        if self._since_trim < JOURNAL_TRIM_EVERY:
            return
        self._since_trim = 0
        await self.meta.write_full(MDLOG_OID, b"")

    async def _replay_journal(self) -> None:
        try:
            blob = await self.meta.read(MDLOG_OID)
        except ObjectNotFound:
            return
        n = 0
        for line in blob.splitlines():
            if not line.strip():
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                break                      # torn tail
            await self._apply_event(ev)
            self._journal_seq = max(self._journal_seq, ev.get("seq", 0))
            n += 1
        if n:
            dout("mds", 1, f"mds journal replay: {n} events")
        await self.meta.write_full(MDLOG_OID, b"")

    async def _apply_event(self, ev: dict) -> None:
        """Idempotent apply of one journaled metadata event."""
        kind = ev["ev"]
        if kind == "set_dentry":
            await self.meta.omap_set(
                dirfrag_oid(ev["dir"]),
                {ev["name"]: json.dumps(ev["dentry"]).encode()})
            if ev["dentry"]["type"] == "dir":
                await self.meta.create(dirfrag_oid(ev["dentry"]["ino"]),
                                       exclusive=False)
        elif kind == "rm_dentry":
            try:
                await self.meta.omap_rm(dirfrag_oid(ev["dir"]),
                                        [ev["name"]])
            except ObjectNotFound:
                pass
        elif kind == "rename":
            d = ev["dentry"]
            await self.meta.omap_set(
                dirfrag_oid(ev["dst_dir"]),
                {ev["dst_name"]: json.dumps(d).encode()})
            try:
                await self.meta.omap_rm(dirfrag_oid(ev["src_dir"]),
                                        [ev["src_name"]])
            except ObjectNotFound:
                pass

    # -- path walking --------------------------------------------------------

    @staticmethod
    def _split(path: str) -> list[str]:
        return [p for p in path.strip("/").split("/") if p]

    async def _lookup_in(self, dir_ino: int, name: str) -> dict | None:
        try:
            vals = await self.meta.omap_get(dirfrag_oid(dir_ino))
        except ObjectNotFound:
            return None
        blob = vals.get(name)
        return None if blob is None else json.loads(blob)

    async def _walk(self, parts: list[str]) -> dict:
        """Resolve to the dentry of the LAST component ({"ino": 1,
        "type": "dir"} pseudo-dentry for root)."""
        cur = {"ino": ROOT_INO, "type": "dir"}
        for name in parts:
            if cur["type"] != "dir":
                raise FSError(-20, f"not a directory: {name}")  # ENOTDIR
            nxt = await self._lookup_in(cur["ino"], name)
            if nxt is None:
                raise FSError(-2, f"no such entry: {name}")
            cur = nxt
        return cur

    async def _walk_inos(self, parts: list[str]) -> list[int]:
        """Inode chain from root through `parts` (ancestry checks)."""
        chain = [ROOT_INO]
        cur = {"ino": ROOT_INO, "type": "dir"}
        for name in parts:
            if cur["type"] != "dir":
                raise FSError(-20, f"not a directory: {name}")
            cur = await self._lookup_in(cur["ino"], name)
            if cur is None:
                raise FSError(-2, f"no such entry: {name}")
            chain.append(cur["ino"])
        return chain

    async def _walk_parent(self, path: str) -> tuple[int, str]:
        parts = self._split(path)
        if not parts:
            raise FSError(-22, "root has no parent")
        parent = await self._walk(parts[:-1])
        if parent["type"] != "dir":
            raise FSError(-20, "parent not a directory")
        return parent["ino"], parts[-1]

    # -- request dispatch ----------------------------------------------------

    async def ms_dispatch(self, conn: Connection, msg: Message) -> bool:
        if not isinstance(msg, MClientRequest):
            return False
        p = msg.payload
        t0 = time.monotonic()
        self.perf.inc("request")
        try:
            handler = getattr(self, f"_op_{p['op']}", None)
            if handler is None:
                raise FSError(-22, f"unknown mds op {p['op']!r}")
            if p["op"] in ("getattr", "readdir", "lookup", "statfs"):
                out = await handler(p)
            else:
                async with self._mdlock:
                    out = await handler(p)
            conn.send_message(MClientReply(
                {"tid": p.get("tid", 0), "rc": 0, "out": out}))
        except FSError as e:
            self.perf.inc("reply_err")
            conn.send_message(MClientReply(
                {"tid": p.get("tid", 0), "rc": e.rc, "error": str(e)}))
        except (RadosError, TimeoutError) as e:
            self.perf.inc("reply_err")
            conn.send_message(MClientReply(
                {"tid": p.get("tid", 0), "rc": -5,
                 "error": f"{type(e).__name__}: {e}"}))
        except Exception as e:
            # a malformed request or corrupt record must still ANSWER:
            # a dropped exception would leave the client hanging its
            # full request timeout (the monitor replies rc=-22 likewise)
            self.perf.inc("reply_err")
            conn.send_message(MClientReply(
                {"tid": p.get("tid", 0), "rc": -22,
                 "error": f"{type(e).__name__}: {e}"}))
        finally:
            self.perf.avg_add("request_latency", time.monotonic() - t0)
        return True

    # -- operations (Server.cc handle_client_* subset) -----------------------

    async def _op_mkdir(self, p: dict) -> dict:
        dir_ino, name = await self._walk_parent(p["path"])
        if await self._lookup_in(dir_ino, name) is not None:
            raise FSError(-17, f"exists: {name}")
        ino = await self._alloc_ino()
        dentry = {"ino": ino, "type": "dir", "mtime": time.time()}
        await self._journal_and_apply(
            {"ev": "set_dentry", "dir": dir_ino, "name": name,
             "dentry": dentry})
        return {"ino": ino}

    async def _op_create(self, p: dict) -> dict:
        dir_ino, name = await self._walk_parent(p["path"])
        existing = await self._lookup_in(dir_ino, name)
        if existing is not None:
            if existing["type"] != "file":
                raise FSError(-21, f"is a directory: {name}")   # EISDIR
            if p.get("exclusive"):
                raise FSError(-17, f"exists: {name}")
            return {"ino": existing["ino"], "size": existing["size"],
                    "stripe": existing.get("stripe", self.stripe_unit)}
        ino = await self._alloc_ino()
        dentry = {"ino": ino, "type": "file", "size": 0,
                  "mtime": time.time(), "stripe": self.stripe_unit}
        await self._journal_and_apply(
            {"ev": "set_dentry", "dir": dir_ino, "name": name,
             "dentry": dentry})
        return {"ino": ino, "size": 0, "stripe": self.stripe_unit}

    async def _op_lookup(self, p: dict) -> dict:
        dentry = await self._walk(self._split(p["path"]))
        return {"dentry": dentry}

    async def _op_getattr(self, p: dict) -> dict:
        return await self._op_lookup(p)

    async def _op_readdir(self, p: dict) -> dict:
        dentry = await self._walk(self._split(p["path"]))
        if dentry["type"] != "dir":
            raise FSError(-20, "not a directory")
        try:
            vals = await self.meta.omap_get(dirfrag_oid(dentry["ino"]))
        except ObjectNotFound:
            vals = {}
        return {"entries": {name: json.loads(blob)
                            for name, blob in sorted(vals.items())}}

    async def _op_setattr(self, p: dict) -> dict:
        """Size/mtime flush from a client (the caps-flush stand-in)."""
        dir_ino, name = await self._walk_parent(p["path"])
        dentry = await self._lookup_in(dir_ino, name)
        if dentry is None:
            raise FSError(-2, f"no such entry: {name}")
        if "size" in p:
            dentry["size"] = int(p["size"])
        if "mtime" in p:
            dentry["mtime"] = float(p["mtime"])
        await self._journal_and_apply(
            {"ev": "set_dentry", "dir": dir_ino, "name": name,
             "dentry": dentry})
        return {"dentry": dentry}

    async def _op_unlink(self, p: dict) -> dict:
        dir_ino, name = await self._walk_parent(p["path"])
        dentry = await self._lookup_in(dir_ino, name)
        if dentry is None:
            raise FSError(-2, f"no such entry: {name}")
        if dentry["type"] != "file":
            raise FSError(-21, "is a directory (use rmdir)")
        await self._journal_and_apply(
            {"ev": "rm_dentry", "dir": dir_ino, "name": name})
        await self._purge_file(dentry)
        return {}

    async def _op_rmdir(self, p: dict) -> dict:
        dir_ino, name = await self._walk_parent(p["path"])
        dentry = await self._lookup_in(dir_ino, name)
        if dentry is None:
            raise FSError(-2, f"no such entry: {name}")
        if dentry["type"] != "dir":
            raise FSError(-20, "not a directory")
        try:
            kids = await self.meta.omap_get(dirfrag_oid(dentry["ino"]))
        except ObjectNotFound:
            kids = {}
        if kids:
            raise FSError(-39, "directory not empty")       # ENOTEMPTY
        await self._journal_and_apply(
            {"ev": "rm_dentry", "dir": dir_ino, "name": name})
        try:
            await self.meta.remove(dirfrag_oid(dentry["ino"]))
        except ObjectNotFound:
            pass
        return {}

    async def _op_rename(self, p: dict) -> dict:
        src_dir, src_name = await self._walk_parent(p["path"])
        dst_dir, dst_name = await self._walk_parent(p["dst"])
        if (src_dir, src_name) == (dst_dir, dst_name):
            return {}                      # POSIX: same-path rename no-op
        dentry = await self._lookup_in(src_dir, src_name)
        if dentry is None:
            raise FSError(-2, f"no such entry: {src_name}")
        if dentry["type"] == "dir":
            # renaming a directory under itself would orphan the whole
            # subtree (the reference MDS rejects with EINVAL)
            dst_chain = await self._walk_inos(
                self._split(p["dst"])[:-1])
            if dentry["ino"] in dst_chain:
                raise FSError(-22, "cannot move a directory into itself")
        target = await self._lookup_in(dst_dir, dst_name)
        if target is not None and target["type"] == "dir":
            raise FSError(-21, "target is a directory")
        ev = {"ev": "rename", "src_dir": src_dir, "src_name": src_name,
              "dst_dir": dst_dir, "dst_name": dst_name, "dentry": dentry}
        await self._journal_and_apply(ev)
        if target is not None:
            # purge the REPLACED file only after the rename is durable:
            # a crash before the journal append must leave /dst intact
            await self._purge_file(target)
        return {}

    async def _op_statfs(self, p: dict) -> dict:
        objs = await self.data.list_objects()
        return {"data_objects": len(objs),
                "stripe_unit": self.stripe_unit}

    async def _purge_file(self, dentry: dict) -> None:
        """Delete the file's data objects (the PurgeQueue role,
        src/mds/PurgeQueue.cc — synchronous here). Purges by LISTING,
        not by recorded size: a writer that crashed before its size
        flush may have landed more stripe objects than the dentry
        admits, and those must not leak (inos are never reused)."""
        prefix = f"{dentry['ino']:x}."
        try:
            names = [o for o in await self.data.list_objects()
                     if o.startswith(prefix)]
        except Exception:
            # listing unavailable: fall back to the recorded size
            stripe = dentry.get("stripe", self.stripe_unit)
            names = [data_oid(dentry["ino"], idx)
                     for idx in range(
                         max(1, -(-dentry.get("size", 0) // stripe)))]
        for name in names:
            try:
                await self.data.remove(name)
            except ObjectNotFound:
                pass


class FSError(Exception):
    def __init__(self, rc: int, message: str):
        super().__init__(message)
        self.rc = rc
