"""FileStore: persistent ObjectStore — WAL + blob files + checkpointed
metadata.

Re-creation of the reference BlueStore's durability contract
(src/os/bluestore/BlueStore.cc) at v1 scope:
  * every transaction is journaled to a crc-framed WAL and fsync'd
    BEFORE being applied (the deferred-write/RocksDB-WAL role,
    BlueStore.cc:14882 queue_transactions -> _kv_sync_thread :14191);
    a crash between journal and apply replays the record at mount;
  * object data lives in per-object blob files whose crc32c is stored
    in metadata and VERIFIED ON EVERY READ (bluestore_blob_t::
    {calc,verify}_csum, src/os/bluestore/bluestore_types.cc:814,840;
    read-time check BlueStore.cc:12234) — a flipped bit on disk raises
    EIO instead of serving garbage;
  * metadata (collections, xattrs, omap, blob refs) is checkpointed
    (tmp+rename+fsync) every N transactions and the WAL trimmed, so
    disk stays O(live state) and mounts replay a bounded tail.

Idiomatic divergences: transactions are journaled in PHYSICAL form —
partial writes / zeros / truncates / clones are resolved to the full
resulting object bytes before logging — which makes replay idempotent
without rollback metadata or an allocator; blob files are whole-object
and immutable per (txn, op), named deterministically so replay
overwrites rather than duplicates.

The port's copy of ceph_tpu/objectstore/filestore.py (jax-free; the port
imports nothing of the JAX package).
"""
from __future__ import annotations

import json
import os
import struct

from ceph_tpu_torch.objectstore.memstore import MemStore
from ceph_tpu_torch.objectstore.store import Op, StoreError, Transaction
from ceph_tpu_torch.objectstore.types import (CollectionId, Ghobject, cid_from,
                                              cid_key, oid_from, oid_key)
from ceph_tpu_torch.utils.crash import SimulatedCrash


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _crc32c(data: bytes) -> int:
    from ceph_tpu_torch.native import ec_native
    return ec_native.crc32c(data)


_cid_key, _cid_from = cid_key, cid_from
_oid_key, _oid_from = oid_key, oid_from


def _b2s(d: dict) -> dict:
    return {k: v.decode("latin1") for k, v in d.items()}


def _s2b(d: dict) -> dict:
    return {k: v.encode("latin1") for k, v in d.items()}


class _FileObject:
    """Metadata-only object: data lives in a blob file."""

    __slots__ = ("blob", "size", "crc", "xattrs", "omap", "mtime")

    def __init__(self):
        self.blob: str | None = None
        self.size = 0
        self.crc = 0
        self.xattrs: dict[str, bytes] = {}
        self.omap: dict[str, bytes] = {}
        self.mtime = 0.0


# physical WAL op kinds (data-bearing ops are resolved before logging):
# FULLWRITE replaces an object's data; FULLSTATE replaces data AND
# xattrs/omap (clone semantics: the destination is replaced, not merged)
_FULLWRITE = "fullwrite"
_FULLSTATE = "fullstate"


class FileStore(MemStore):
    """Durable ObjectStore over a directory. Subclasses MemStore for the
    metadata index + validation; overrides the data plane."""

    CHECKPOINT_INTERVAL = 64

    def __init__(self, path: str):
        super().__init__(name=os.path.basename(path) or "filestore")
        self.path = path
        self.blob_dir = os.path.join(path, "blobs")
        self.wal_path = os.path.join(path, "wal.log")
        self.ckpt_path = os.path.join(path, "meta.json")
        self._seq = 0               # last journaled txn seq
        self._ckpt_seq = 0          # seq covered by the checkpoint
        self._wal_f = None
        self._dirty_blobs: set[str] = set()
        self.fail_after_wal = False

    # -- lifecycle -----------------------------------------------------------

    def mkfs(self) -> None:
        with self._lock:
            os.makedirs(self.blob_dir, exist_ok=True)
            for name in os.listdir(self.blob_dir):
                os.unlink(os.path.join(self.blob_dir, name))
            self._colls.clear()
            self._seq = self._ckpt_seq = 0
            self._write_checkpoint()
            with open(self.wal_path, "wb") as f:
                f.flush()
                os.fsync(f.fileno())

    def mount(self) -> None:
        with self._lock:
            if not os.path.isdir(self.blob_dir) or \
                    not os.path.exists(self.ckpt_path):
                raise StoreError("ENOENT", f"{self.path}: not mkfs'd")
            self._load_checkpoint()
            self._replay_wal()
            self._wal_f = open(self.wal_path, "ab")
            self._mounted = True

    def umount(self) -> None:
        with self._lock:
            if self._mounted:
                self._checkpoint()
            if self._wal_f is not None:
                self._wal_f.close()
                self._wal_f = None
            self._mounted = False

    # -- checkpoint ----------------------------------------------------------

    def _write_checkpoint(self) -> None:
        meta = {
            "seq": self._seq,
            "colls": [
                [_cid_key(cid),
                 [[_oid_key(oid),
                   {"blob": obj.blob, "size": obj.size, "crc": obj.crc,
                    "xattrs": _b2s(obj.xattrs), "omap": _b2s(obj.omap),
                    "mtime": obj.mtime}]
                  for oid, obj in objs.items()]]
                for cid, objs in self._colls.items()],
        }
        tmp = self.ckpt_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.ckpt_path)
        # the rename itself must be durable before the WAL is truncated,
        # or a power loss loses transactions whose on_commit already fired
        # (the reference fsyncs the containing dir after every rename)
        _fsync_dir(self.path)
        self._ckpt_seq = self._seq

    def _checkpoint(self) -> None:
        """Durable point: blobs fsync'd, meta snapshotted, WAL trimmed."""
        for name in list(self._dirty_blobs):
            p = os.path.join(self.blob_dir, name)
            if os.path.exists(p):
                fd = os.open(p, os.O_RDONLY)
                try:
                    os.fsync(fd)
                finally:
                    os.close(fd)
        if self._dirty_blobs:
            # newly created blob files' directory entries must be durable
            # too, or replay finds the checkpoint pointing at nothing
            _fsync_dir(self.blob_dir)
        self._dirty_blobs.clear()
        self._write_checkpoint()
        if self._wal_f is not None:
            self._wal_f.close()
        with open(self.wal_path, "wb") as f:
            f.flush()
            os.fsync(f.fileno())
        if self._mounted or self._wal_f is not None:
            self._wal_f = open(self.wal_path, "ab")
        self._gc_blobs()

    def _gc_blobs(self) -> None:
        live = {obj.blob for objs in self._colls.values()
                for obj in objs.values() if obj.blob}
        for name in os.listdir(self.blob_dir):
            if name not in live:
                try:
                    os.unlink(os.path.join(self.blob_dir, name))
                except OSError:
                    pass

    def _load_checkpoint(self) -> None:
        with open(self.ckpt_path) as f:
            meta = json.load(f)
        self._seq = self._ckpt_seq = meta["seq"]
        self._colls = {}
        for cid_key, objs in meta["colls"]:
            coll: dict = {}
            for oid_key, od in objs:
                obj = _FileObject()
                obj.blob = od["blob"]
                obj.size = od["size"]
                obj.crc = od["crc"]
                obj.xattrs = _s2b(od["xattrs"])
                obj.omap = _s2b(od["omap"])
                obj.mtime = od.get("mtime", 0.0)
                coll[_oid_from(oid_key)] = obj
            self._colls[_cid_from(cid_key)] = coll

    # -- WAL -----------------------------------------------------------------

    def _wal_append(self, seq: int, phys_ops: list) -> None:
        """Record: u32 header_len | header json | payload | u32 crc32c
        (over header+payload)."""
        payload = bytearray()
        ops_enc = []
        for op in phys_ops:
            kind = op[0]
            if kind == _FULLWRITE:
                _, cid, oid, data = op
                ops_enc.append([kind, _cid_key(cid), _oid_key(oid),
                                [len(payload), len(data)]])
                payload += data
            elif kind == _FULLSTATE:
                _, cid, oid, data, xattrs, omap = op
                ops_enc.append([kind, _cid_key(cid), _oid_key(oid),
                                [len(payload), len(data)],
                                _b2s(xattrs), _b2s(omap)])
                payload += data
            else:
                ops_enc.append(self._encode_meta_op(op))
        header = json.dumps({"seq": seq, "ops": ops_enc}).encode()
        rec = struct.pack("<I", len(header)) + header + bytes(payload)
        rec += struct.pack("<I", _crc32c(rec[4:]))
        self._wal_f.write(rec)
        self._wal_f.flush()
        os.fsync(self._wal_f.fileno())

    @staticmethod
    def _encode_meta_op(op: tuple) -> list:
        kind = op[0]
        enc: list = [kind.name]
        if kind in (Op.MKCOLL, Op.RMCOLL):
            enc.append(_cid_key(op[1]))
        elif kind in (Op.TOUCH, Op.REMOVE, Op.OMAP_CLEAR):
            enc += [_cid_key(op[1]), _oid_key(op[2])]
        elif kind == Op.SETATTRS:
            enc += [_cid_key(op[1]), _oid_key(op[2]), _b2s(op[3])]
        elif kind == Op.RMATTR:
            enc += [_cid_key(op[1]), _oid_key(op[2]), op[3]]
        elif kind == Op.OMAP_SETKEYS:
            enc += [_cid_key(op[1]), _oid_key(op[2]), _b2s(op[3])]
        elif kind == Op.OMAP_RMKEYS:
            enc += [_cid_key(op[1]), _oid_key(op[2]), list(op[3])]
        elif kind == Op.COLL_MOVE_RENAME:
            enc += [_cid_key(op[1]), _oid_key(op[2]),
                    _cid_key(op[3]), _oid_key(op[4])]
        else:
            raise StoreError("EINVAL", f"cannot journal {kind}")
        return enc

    @staticmethod
    def _decode_meta_op(enc: list) -> tuple:
        kind = Op[enc[0]]
        if kind in (Op.MKCOLL, Op.RMCOLL):
            return (kind, _cid_from(enc[1]))
        if kind in (Op.TOUCH, Op.REMOVE, Op.OMAP_CLEAR):
            return (kind, _cid_from(enc[1]), _oid_from(enc[2]))
        if kind == Op.SETATTRS:
            return (kind, _cid_from(enc[1]), _oid_from(enc[2]), _s2b(enc[3]))
        if kind == Op.RMATTR:
            return (kind, _cid_from(enc[1]), _oid_from(enc[2]), enc[3])
        if kind == Op.OMAP_SETKEYS:
            return (kind, _cid_from(enc[1]), _oid_from(enc[2]), _s2b(enc[3]))
        if kind == Op.OMAP_RMKEYS:
            return (kind, _cid_from(enc[1]), _oid_from(enc[2]), enc[3])
        if kind == Op.COLL_MOVE_RENAME:
            return (kind, _cid_from(enc[1]), _oid_from(enc[2]),
                    _cid_from(enc[3]), _oid_from(enc[4]))
        raise StoreError("EINVAL", f"cannot decode {enc[0]}")

    def _replay_wal(self) -> None:
        if not os.path.exists(self.wal_path):
            return
        with open(self.wal_path, "rb") as f:
            raw = f.read()
        off = 0
        while off + 8 <= len(raw):
            (hlen,) = struct.unpack_from("<I", raw, off)
            header_end = off + 4 + hlen
            if header_end > len(raw):
                break   # torn header: crash mid-append; discard tail
            try:
                header = json.loads(raw[off + 4:header_end])
            except ValueError:
                break
            payload_len = sum(ref[3][1] for ref in header["ops"]
                              if ref[0] in (_FULLWRITE, _FULLSTATE))
            rec_end = header_end + payload_len + 4
            if rec_end > len(raw):
                break   # torn payload
            body = raw[off + 4:rec_end - 4]
            (crc,) = struct.unpack_from("<I", raw, rec_end - 4)
            if _crc32c(body) != crc:
                break   # torn/corrupt record: everything before it was
                # fsync'd in order, so the tail is the crash frontier
            payload = raw[header_end:rec_end - 4]
            seq = header["seq"]
            if seq > self._seq:
                phys = []
                for enc in header["ops"]:
                    if enc[0] == _FULLWRITE:
                        o, ln = enc[3]
                        phys.append((_FULLWRITE, _cid_from(enc[1]),
                                     _oid_from(enc[2]),
                                     payload[o:o + ln]))
                    elif enc[0] == _FULLSTATE:
                        o, ln = enc[3]
                        phys.append((_FULLSTATE, _cid_from(enc[1]),
                                     _oid_from(enc[2]),
                                     payload[o:o + ln],
                                     _s2b(enc[4]), _s2b(enc[5])))
                    else:
                        phys.append(self._decode_meta_op(enc))
                self._apply_physical(seq, phys)
                self._seq = seq
            off = rec_end

    # -- transaction resolution (logical -> physical) ------------------------

    def _resolve(self, txn: Transaction) -> list:
        """Turn the logical op list into idempotent physical ops: every
        data mutation becomes the full resulting object content, so
        replay never needs pre-transaction blob state."""
        staged: dict[tuple, bytearray] = {}
        staged_meta: dict[tuple, tuple[dict, dict]] = {}

        def content(cid, oid) -> bytearray:
            key = (cid, oid)
            if key not in staged:
                coll = self._colls.get(cid, {})
                obj = coll.get(oid)
                staged[key] = bytearray(self._load(obj)) \
                    if obj is not None else bytearray()
            return staged[key]

        def meta(cid, oid) -> tuple[dict, dict]:
            """(xattrs, omap) as visible at this point IN the txn —
            a clone must copy same-transaction attr/omap updates."""
            key = (cid, oid)
            if key not in staged_meta:
                obj = self._colls.get(cid, {}).get(oid)
                staged_meta[key] = ((dict(obj.xattrs), dict(obj.omap))
                                    if obj is not None else ({}, {}))
            return staged_meta[key]

        phys: list = []

        def emit_full(cid, oid):
            phys.append((_FULLWRITE, cid, oid, bytes(content(cid, oid))))

        for op in txn.ops:
            kind = op[0]
            if kind == Op.WRITE:
                _, cid, oid, offset, data = op
                buf = content(cid, oid)
                end = offset + len(data)
                if len(buf) < end:
                    buf.extend(b"\0" * (end - len(buf)))
                buf[offset:end] = data
                emit_full(cid, oid)
            elif kind == Op.ZERO:
                _, cid, oid, offset, length = op
                buf = content(cid, oid)
                end = offset + length
                if len(buf) < end:
                    buf.extend(b"\0" * (end - len(buf)))
                buf[offset:end] = b"\0" * length
                emit_full(cid, oid)
            elif kind == Op.TRUNCATE:
                _, cid, oid, size = op
                buf = content(cid, oid)
                if size < len(buf):
                    del buf[size:]
                else:
                    buf.extend(b"\0" * (size - len(buf)))
                emit_full(cid, oid)
            elif kind == Op.CLONE:
                # clone REPLACES the destination (data, xattrs, omap) —
                # merging into a surviving dst would diverge from the
                # MemStore/ObjectStore contract
                _, cid, src, dst = op
                xattrs, omap = meta(cid, src)
                staged[(cid, dst)] = bytearray(content(cid, src))
                staged_meta[(cid, dst)] = (dict(xattrs), dict(omap))
                phys.append((_FULLSTATE, cid, dst,
                             bytes(staged[(cid, dst)]),
                             dict(xattrs), dict(omap)))
            elif kind == Op.CLONE_RANGE:
                _, cid, src, dst, src_off, length, dst_off = op
                src_buf = content(cid, src)
                data = bytes(src_buf[src_off:src_off + length])
                buf = content(cid, dst)
                end = dst_off + len(data)
                if len(buf) < end:
                    buf.extend(b"\0" * (end - len(buf)))
                buf[dst_off:end] = data
                emit_full(cid, dst)
            else:
                if kind == Op.SETATTRS:
                    meta(op[1], op[2])[0].update(op[3])
                elif kind == Op.RMATTR:
                    meta(op[1], op[2])[0].pop(op[3], None)
                elif kind == Op.OMAP_SETKEYS:
                    meta(op[1], op[2])[1].update(op[3])
                elif kind == Op.OMAP_RMKEYS:
                    for k in op[3]:
                        meta(op[1], op[2])[1].pop(k, None)
                elif kind == Op.OMAP_CLEAR:
                    meta(op[1], op[2])[1].clear()
                elif kind == Op.REMOVE:
                    # a later op in this txn recreating the object must
                    # see fresh state, not the removed content
                    staged[(op[1], op[2])] = bytearray()
                    staged_meta[(op[1], op[2])] = ({}, {})
                elif kind == Op.COLL_MOVE_RENAME:
                    # a later write to the new name must see the moved
                    # content, and the old name becomes empty
                    _, ocid, ooid, ncid, noid = op
                    staged[(ncid, noid)] = bytearray(content(ocid, ooid))
                    ox, oo = meta(ocid, ooid)
                    staged_meta[(ncid, noid)] = (dict(ox), dict(oo))
                    staged[(ocid, ooid)] = bytearray()
                    staged_meta[(ocid, ooid)] = ({}, {})
                phys.append(op)
        return self._coalesce(phys)

    @staticmethod
    def _coalesce(phys: list) -> list:
        """Drop a FULLWRITE/FULLSTATE when a later one for the same
        object follows with no intervening op that re-reads or moves
        that object — a txn of N writes to one object journals one blob,
        not N. REMOVE/COLL_MOVE_RENAME act as barriers."""
        last_write: dict[tuple, tuple[int, str]] = {}
        drop: set[int] = set()
        for i, op in enumerate(phys):
            kind = op[0]
            if kind in (_FULLWRITE, _FULLSTATE):
                key = (op[1], op[2])
                prev = last_write.get(key)
                # a FULLWRITE cannot subsume an earlier FULLSTATE (it
                # replaces data only, not the attr/omap reset)
                if prev is not None and not (prev[1] == _FULLSTATE
                                             and kind == _FULLWRITE):
                    drop.add(prev[0])
                last_write[key] = (i, kind)
            elif kind == Op.REMOVE:
                last_write.pop((op[1], op[2]), None)
            elif kind == Op.COLL_MOVE_RENAME:
                last_write.pop((op[1], op[2]), None)
                last_write.pop((op[3], op[4]), None)
        return [op for i, op in enumerate(phys) if i not in drop]

    # -- apply ---------------------------------------------------------------

    def queue_transaction(self, txn: Transaction) -> None:
        with self._lock:
            self._validate(txn)
            seq = self._seq + 1
            phys = self._resolve(txn)
            self._wal_append(seq, phys)
            self._seq = seq
            if self.fail_after_wal:
                raise SimulatedCrash(f"txn {seq} journaled but not applied")
            self._apply_physical(seq, phys)
            self.perf.inc("ops", len(txn.ops))
            self.perf.inc("txns")
            if seq - self._ckpt_seq >= self.CHECKPOINT_INTERVAL:
                self._checkpoint()
        for fn in txn.on_applied:
            fn()
        for fn in txn.on_commit:
            fn()

    def _apply_physical(self, seq: int, phys: list) -> None:
        import time as _time
        for i, op in enumerate(phys):
            kind = op[0]
            if kind in (_FULLWRITE, _FULLSTATE):
                cid, oid, data = op[1], op[2], op[3]
                obj = self._obj_create(cid, oid)
                if data:
                    blob = f"{seq:016x}-{i}"
                    with open(os.path.join(self.blob_dir, blob), "wb") as f:
                        f.write(data)
                    obj.blob = blob
                    self._dirty_blobs.add(blob)
                else:
                    obj.blob = None
                obj.size = len(data)
                obj.crc = _crc32c(data)
                obj.mtime = _time.time()
                if kind == _FULLSTATE:
                    obj.xattrs = dict(op[4])
                    obj.omap = dict(op[5])
                self.perf.inc("bytes_written", len(data))
            else:
                self._apply(op)

    def _obj_create(self, cid, oid):
        coll = self._coll(cid)
        obj = coll.get(oid)
        if obj is None:
            obj = coll[oid] = _FileObject()
        return obj

    # -- data plane ----------------------------------------------------------

    def _load(self, obj: _FileObject) -> bytes:
        """Blob content, crc32c-verified (BlueStore _verify_csum)."""
        if obj.blob is None:
            return b""
        try:
            with open(os.path.join(self.blob_dir, obj.blob), "rb") as f:
                data = f.read()
        except FileNotFoundError:
            raise StoreError("EIO", f"blob {obj.blob} missing") from None
        if _crc32c(data) != obj.crc:
            raise StoreError(
                "EIO", f"blob {obj.blob}: crc mismatch "
                f"({_crc32c(data):#x} != {obj.crc:#x}) — refusing to "
                f"serve corrupt data")
        return data

    # -- reads (data from blobs, metadata from the index) --------------------

    def stat(self, cid: CollectionId, oid: Ghobject) -> dict:
        with self._lock:
            obj = self._obj(cid, oid)
            return {"size": obj.size, "mtime": obj.mtime,
                    "num_xattrs": len(obj.xattrs),
                    "num_omap": len(obj.omap)}

    def read(self, cid: CollectionId, oid: Ghobject, offset: int = 0,
             length: int | None = None) -> bytes:
        with self._lock:
            data = self._load(self._obj(cid, oid))
        if length is None:
            return data[offset:]
        return data[offset:offset + length]
