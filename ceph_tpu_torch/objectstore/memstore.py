"""MemStore: in-memory ObjectStore (the reference test double,
src/os/memstore/MemStore.h:30).

Transactions are validated then applied under the store lock; validation
failures reject the WHOLE transaction with no partial effects (the
all-or-nothing contract queue_transaction promises). on_applied fires
when the data is readable, on_commit immediately after (memory is always
"durable" here) — same ordering the OSD relies on.

The port's copy of ceph_tpu/objectstore/memstore.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import threading
import time
from typing import Iterable

from ceph_tpu_torch.objectstore.store import (ObjectStore, Op, StoreError,
                                              Transaction)
from ceph_tpu_torch.objectstore.types import CollectionId, Ghobject
from ceph_tpu_torch.utils.perf_counters import PerfCounters


class _Object:
    __slots__ = ("data", "xattrs", "omap", "mtime")

    def __init__(self):
        self.data = bytearray()
        self.xattrs: dict[str, bytes] = {}
        self.omap: dict[str, bytes] = {}
        self.mtime = time.time()

    def clone(self) -> "_Object":
        out = _Object()
        out.data = bytearray(self.data)
        out.xattrs = dict(self.xattrs)
        out.omap = dict(self.omap)
        return out

    def write(self, offset: int, data: bytes) -> None:
        end = offset + len(data)
        if len(self.data) < end:
            self.data.extend(b"\0" * (end - len(self.data)))
        self.data[offset:end] = data
        self.mtime = time.time()


class MemStore(ObjectStore):
    def __init__(self, name: str = "memstore"):
        self.name = name
        self._colls: dict[CollectionId, dict[Ghobject, _Object]] = {}
        self._lock = threading.RLock()
        self._mounted = False
        self._used_cache: tuple[float, int] | None = None
        self.perf = PerfCounters(f"memstore:{name}")
        self.perf.add("ops")
        self.perf.add("txns")
        self.perf.add("bytes_written")

    # -- lifecycle -----------------------------------------------------------

    def mkfs(self) -> None:
        with self._lock:
            self._colls.clear()

    def mount(self) -> None:
        self._mounted = True

    def umount(self) -> None:
        self._mounted = False

    #: statfs calls land once per mgr report period; a full O(objects)
    #: rescan under the store lock each time would stall commits on a
    #: bench-scale store, so the answer is cached briefly — NEARFULL
    #: thresholds tolerate seconds of staleness
    USED_BYTES_TTL = 2.0

    def used_bytes(self) -> int:
        now = time.monotonic()
        cached = self._used_cache
        if cached is not None and now - cached[0] < self.USED_BYTES_TTL:
            return cached[1]
        with self._lock:
            used = sum(len(obj.data)
                       for coll in self._colls.values()
                       for obj in coll.values())
        self._used_cache = (now, used)
        return used

    # -- lookup helpers ------------------------------------------------------

    def _coll(self, cid: CollectionId) -> dict[Ghobject, _Object]:
        coll = self._colls.get(cid)
        if coll is None:
            raise StoreError("ENOENT", f"no collection {cid}")
        return coll

    def _obj(self, cid: CollectionId, oid: Ghobject) -> _Object:
        obj = self._coll(cid).get(oid)
        if obj is None:
            raise StoreError("ENOENT", f"no object {oid} in {cid}")
        return obj

    def _obj_create(self, cid: CollectionId, oid: Ghobject) -> _Object:
        coll = self._coll(cid)
        obj = coll.get(oid)
        if obj is None:
            obj = coll[oid] = _Object()
        return obj

    # -- transactions --------------------------------------------------------

    def _validate(self, txn: Transaction) -> None:
        """Reject impossible transactions before touching state, so apply
        below cannot fail halfway (atomicity)."""
        colls = {cid: set(objs) for cid, objs in self._colls.items()}

        def need_coll(cid):
            if cid not in colls:
                raise StoreError("ENOENT", f"no collection {cid}")

        def need_obj(cid, oid):
            need_coll(cid)
            if oid not in colls[cid]:
                raise StoreError("ENOENT", f"no object {oid} in {cid}")

        for op in txn.ops:
            kind = op[0]
            if kind == Op.MKCOLL:
                if op[1] in colls:
                    raise StoreError("EEXIST", f"collection {op[1]} exists")
                colls[op[1]] = set()
            elif kind == Op.RMCOLL:
                need_coll(op[1])
                if colls[op[1]]:
                    raise StoreError("ENOTEMPTY",
                                     f"collection {op[1]} not empty")
                del colls[op[1]]
            elif kind in (Op.TOUCH, Op.WRITE, Op.ZERO, Op.TRUNCATE,
                          Op.SETATTRS, Op.OMAP_SETKEYS, Op.OMAP_RMKEYS,
                          Op.OMAP_CLEAR):
                need_coll(op[1])
                colls[op[1]].add(op[2])
            elif kind in (Op.REMOVE, Op.RMATTR):
                need_obj(op[1], op[2])
                if kind == Op.REMOVE:
                    colls[op[1]].discard(op[2])
            elif kind in (Op.CLONE, Op.CLONE_RANGE):
                need_obj(op[1], op[2])
                colls[op[1]].add(op[3])
            elif kind == Op.COLL_MOVE_RENAME:
                need_obj(op[1], op[2])
                need_coll(op[3])
                colls[op[1]].discard(op[2])
                colls[op[3]].add(op[4])

    def queue_transaction(self, txn: Transaction) -> None:
        with self._lock:
            self._validate(txn)
            for op in txn.ops:
                self._apply(op)
            self.perf.inc("ops", len(txn.ops))
            self.perf.inc("txns")
        for fn in txn.on_applied:
            fn()
        for fn in txn.on_commit:
            fn()

    def _apply(self, op: tuple) -> None:
        kind = op[0]
        if kind == Op.MKCOLL:
            self._colls[op[1]] = {}
        elif kind == Op.RMCOLL:
            del self._colls[op[1]]
        elif kind == Op.TOUCH:
            self._obj_create(op[1], op[2])
        elif kind == Op.WRITE:
            _, cid, oid, offset, data = op
            self._obj_create(cid, oid).write(offset, data)
            self.perf.inc("bytes_written", len(data))
        elif kind == Op.ZERO:
            _, cid, oid, offset, length = op
            self._obj_create(cid, oid).write(offset, b"\0" * length)
        elif kind == Op.TRUNCATE:
            _, cid, oid, size = op
            obj = self._obj_create(cid, oid)
            if size < len(obj.data):
                del obj.data[size:]
            else:
                obj.data.extend(b"\0" * (size - len(obj.data)))
        elif kind == Op.REMOVE:
            del self._coll(op[1])[op[2]]
        elif kind == Op.SETATTRS:
            self._obj_create(op[1], op[2]).xattrs.update(op[3])
        elif kind == Op.RMATTR:
            self._obj(op[1], op[2]).xattrs.pop(op[3], None)
        elif kind == Op.CLONE:
            _, cid, src, dst = op
            self._coll(cid)[dst] = self._obj(cid, src).clone()
        elif kind == Op.CLONE_RANGE:
            _, cid, src, dst, src_off, length, dst_off = op
            data = bytes(self._obj(cid, src).data[src_off:src_off + length])
            self._obj_create(cid, dst).write(dst_off, data)
        elif kind == Op.OMAP_SETKEYS:
            self._obj_create(op[1], op[2]).omap.update(op[3])
        elif kind == Op.OMAP_RMKEYS:
            omap = self._obj(op[1], op[2]).omap
            for key in op[3]:
                omap.pop(key, None)
        elif kind == Op.OMAP_CLEAR:
            self._obj(op[1], op[2]).omap.clear()
        elif kind == Op.COLL_MOVE_RENAME:
            _, old_cid, old_oid, new_cid, new_oid = op
            obj = self._coll(old_cid).pop(old_oid)
            self._coll(new_cid)[new_oid] = obj
        else:
            raise StoreError("EINVAL", f"unknown op {kind}")

    # -- reads ---------------------------------------------------------------

    def list_collections(self) -> list[CollectionId]:
        with self._lock:
            return sorted(self._colls)

    def collection_exists(self, cid: CollectionId) -> bool:
        with self._lock:
            return cid in self._colls

    def collection_list(self, cid: CollectionId, start: Ghobject | None = None,
                        max_count: int = 2 ** 31) -> list[Ghobject]:
        with self._lock:
            objs = sorted(self._coll(cid))
        if start is not None:
            objs = [o for o in objs if o > start]
        return objs[:max_count]

    def exists(self, cid: CollectionId, oid: Ghobject) -> bool:
        with self._lock:
            coll = self._colls.get(cid)
            return coll is not None and oid in coll

    def stat(self, cid: CollectionId, oid: Ghobject) -> dict:
        with self._lock:
            obj = self._obj(cid, oid)
            return {"size": len(obj.data), "mtime": obj.mtime,
                    "num_xattrs": len(obj.xattrs),
                    "num_omap": len(obj.omap)}

    def read(self, cid: CollectionId, oid: Ghobject, offset: int = 0,
             length: int | None = None) -> bytes:
        with self._lock:
            data = self._obj(cid, oid).data
            if length is None:
                return bytes(data[offset:])
            return bytes(data[offset:offset + length])

    def getattr(self, cid: CollectionId, oid: Ghobject, name: str) -> bytes:
        with self._lock:
            xattrs = self._obj(cid, oid).xattrs
            if name not in xattrs:
                raise StoreError("ENODATA", f"no xattr {name} on {oid}")
            return xattrs[name]

    def getattrs(self, cid: CollectionId, oid: Ghobject) -> dict[str, bytes]:
        with self._lock:
            return dict(self._obj(cid, oid).xattrs)

    def omap_get(self, cid: CollectionId, oid: Ghobject) -> dict[str, bytes]:
        with self._lock:
            return dict(self._obj(cid, oid).omap)

    def omap_get_values(self, cid: CollectionId, oid: Ghobject,
                        keys: Iterable[str]) -> dict[str, bytes]:
        with self._lock:
            omap = self._obj(cid, oid).omap
            return {k: omap[k] for k in keys if k in omap}
