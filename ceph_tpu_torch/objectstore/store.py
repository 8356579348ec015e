"""ObjectStore abstract API + Transaction.

Re-creation of the reference's ObjectStore contract (src/os/ObjectStore.h,
src/os/Transaction.h): collections of objects with byte extents, xattrs,
and omap; mutations travel as atomic `Transaction` op batches through
`queue_transaction`, with on_applied (readable) and on_commit (durable)
callbacks. Backends: MemStore here; a file-backed store can implement the
same API later.

The port's copy of ceph_tpu/objectstore/store.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import enum
import functools
import time
from typing import Callable, Iterable, Mapping

from ceph_tpu_torch.objectstore.types import CollectionId, Ghobject
from ceph_tpu_torch.utils import sanitizer, tracer

NO_SHARD = -1


class StoreError(Exception):
    def __init__(self, code: str, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code  # ENOENT / EEXIST / ...


class Op(enum.Enum):
    TOUCH = "touch"
    WRITE = "write"
    ZERO = "zero"
    TRUNCATE = "truncate"
    REMOVE = "remove"
    SETATTRS = "setattrs"
    RMATTR = "rmattr"
    CLONE = "clone"
    CLONE_RANGE = "clone_range"
    OMAP_SETKEYS = "omap_setkeys"
    OMAP_RMKEYS = "omap_rmkeys"
    OMAP_CLEAR = "omap_clear"
    MKCOLL = "mkcoll"
    RMCOLL = "rmcoll"
    COLL_MOVE_RENAME = "coll_move_rename"


class Transaction:
    """Ordered op batch, applied atomically (Transaction.h)."""

    def __init__(self):
        self.ops: list[tuple] = []
        self.on_applied: list[Callable[[], None]] = []
        self.on_commit: list[Callable[[], None]] = []

    def __len__(self) -> int:
        return len(self.ops)

    # -- collection ops ------------------------------------------------------

    def create_collection(self, cid: CollectionId) -> "Transaction":
        self.ops.append((Op.MKCOLL, cid))
        return self

    def remove_collection(self, cid: CollectionId) -> "Transaction":
        self.ops.append((Op.RMCOLL, cid))
        return self

    # -- object ops ----------------------------------------------------------

    def touch(self, cid: CollectionId, oid: Ghobject) -> "Transaction":
        self.ops.append((Op.TOUCH, cid, oid))
        return self

    def write(self, cid: CollectionId, oid: Ghobject, offset: int,
              data: bytes) -> "Transaction":
        # snapshot MUTABLE buffers (bytearray, numpy views): the txn
        # applies later and must see the bytes as queued. Immutable
        # payloads — bytes, and the read-only memoryviews the zero-copy
        # receive path delivers — pass through by reference: bytes()
        # here silently re-copied every full payload, exactly the copy
        # the rx discipline removed (and invisibly to the copy ledger).
        # A sanitizer-guarded rx view unwraps first (with its
        # use-after-recycle check) so it keeps the by-reference path
        # instead of being silently bytes()-copied below.
        data = sanitizer.unwrap(data)
        if not isinstance(data, bytes) and \
                not (isinstance(data, memoryview) and data.readonly):
            data = bytes(data)
        self.ops.append((Op.WRITE, cid, oid, offset, data))
        return self

    def zero(self, cid: CollectionId, oid: Ghobject, offset: int,
             length: int) -> "Transaction":
        self.ops.append((Op.ZERO, cid, oid, offset, length))
        return self

    def truncate(self, cid: CollectionId, oid: Ghobject,
                 size: int) -> "Transaction":
        self.ops.append((Op.TRUNCATE, cid, oid, size))
        return self

    def remove(self, cid: CollectionId, oid: Ghobject) -> "Transaction":
        self.ops.append((Op.REMOVE, cid, oid))
        return self

    def setattrs(self, cid: CollectionId, oid: Ghobject,
                 attrs: Mapping[str, bytes]) -> "Transaction":
        self.ops.append((Op.SETATTRS, cid, oid,
                         {k: bytes(v) for k, v in attrs.items()}))
        return self

    def setattr(self, cid: CollectionId, oid: Ghobject, name: str,
                value: bytes) -> "Transaction":
        return self.setattrs(cid, oid, {name: value})

    def rmattr(self, cid: CollectionId, oid: Ghobject,
               name: str) -> "Transaction":
        self.ops.append((Op.RMATTR, cid, oid, name))
        return self

    def clone(self, cid: CollectionId, src: Ghobject,
              dst: Ghobject) -> "Transaction":
        self.ops.append((Op.CLONE, cid, src, dst))
        return self

    def clone_range(self, cid: CollectionId, src: Ghobject, dst: Ghobject,
                    src_off: int, length: int, dst_off: int) -> "Transaction":
        self.ops.append((Op.CLONE_RANGE, cid, src, dst, src_off, length,
                         dst_off))
        return self

    def collection_move_rename(self, old_cid: CollectionId, old_oid: Ghobject,
                               new_cid: CollectionId,
                               new_oid: Ghobject) -> "Transaction":
        self.ops.append((Op.COLL_MOVE_RENAME, old_cid, old_oid, new_cid,
                         new_oid))
        return self

    # -- omap ----------------------------------------------------------------

    def omap_setkeys(self, cid: CollectionId, oid: Ghobject,
                     keys: Mapping[str, bytes]) -> "Transaction":
        self.ops.append((Op.OMAP_SETKEYS, cid, oid,
                         {k: bytes(v) for k, v in keys.items()}))
        return self

    def omap_rmkeys(self, cid: CollectionId, oid: Ghobject,
                    keys: Iterable[str]) -> "Transaction":
        self.ops.append((Op.OMAP_RMKEYS, cid, oid, list(keys)))
        return self

    def omap_clear(self, cid: CollectionId, oid: Ghobject) -> "Transaction":
        self.ops.append((Op.OMAP_CLEAR, cid, oid))
        return self

    # -- completions ---------------------------------------------------------

    def register_on_applied(self, fn: Callable[[], None]) -> None:
        self.on_applied.append(fn)

    def register_on_commit(self, fn: Callable[[], None]) -> None:
        self.on_commit.append(fn)

    def append(self, other: "Transaction") -> "Transaction":
        self.ops.extend(other.ops)
        self.on_applied.extend(other.on_applied)
        self.on_commit.extend(other.on_commit)
        return self


def _observed_txn(fn):
    """Wrap a backend's queue_transaction with commit observability: a
    `store_commit` trace span (the objectstore stage of an op's trace)
    and, when the hosting daemon attached a histogram sink
    (`store.commit_perf`), a `store_commit_us` latency sample. Both
    gates are plain attribute/flag reads — the undecorated fast path
    runs when neither is on."""
    @functools.wraps(fn)
    def queue_transaction(self, txn):
        perf = self.commit_perf
        if perf is None and not tracer.active():
            return fn(self, txn)
        t0 = time.perf_counter()
        try:
            with tracer.span("store_commit",
                             getattr(self, "name", type(self).__name__)
                             ) as sp:
                if sp is not None:
                    sp.set_tag("ops", len(txn))
                return fn(self, txn)
        finally:
            if perf is not None:
                perf.hist_add("store_commit_us",
                              (time.perf_counter() - t0) * 1e6)
    queue_transaction._observed = True
    return queue_transaction


class ObjectStore:
    """Abstract store API (ObjectStore.h)."""

    #: optional PerfCounters holding a `store_commit_us` histogram; the
    #: hosting daemon points this at its own registered counters
    commit_perf = None

    def __init_subclass__(cls, **kwargs):
        # every concrete backend's queue_transaction picks up the commit
        # span + histogram without each backend re-implementing it
        super().__init_subclass__(**kwargs)
        impl = cls.__dict__.get("queue_transaction")
        if impl is not None and not getattr(impl, "_observed", False):
            cls.queue_transaction = _observed_txn(impl)

    #: nominal device size for utilization reporting (statfs); daemons
    #: report used/capacity to the mgr, which drives OSD_NEARFULL/FULL
    capacity_bytes = 1 << 30

    def statfs(self) -> dict:
        """Space accounting (ObjectStore::statfs). Backends that can
        measure override `used_bytes`; the base answer keeps health
        reporting total-ordered even for stores that cannot."""
        used = self.used_bytes()
        cap = self.capacity_bytes
        return {"used_bytes": used, "capacity_bytes": cap,
                "utilization": round(used / cap, 4) if cap else 0.0}

    def used_bytes(self) -> int:
        return 0

    # lifecycle
    def mkfs(self) -> None:
        raise NotImplementedError

    def mount(self) -> None:
        raise NotImplementedError

    def umount(self) -> None:
        raise NotImplementedError

    # transactions
    def queue_transaction(self, txn: Transaction) -> None:
        raise NotImplementedError

    # collections
    def list_collections(self) -> list[CollectionId]:
        raise NotImplementedError

    def collection_exists(self, cid: CollectionId) -> bool:
        raise NotImplementedError

    def collection_list(self, cid: CollectionId, start: Ghobject | None = None,
                        max_count: int = 2 ** 31) -> list[Ghobject]:
        raise NotImplementedError

    # objects
    def exists(self, cid: CollectionId, oid: Ghobject) -> bool:
        raise NotImplementedError

    def stat(self, cid: CollectionId, oid: Ghobject) -> dict:
        raise NotImplementedError

    def read(self, cid: CollectionId, oid: Ghobject, offset: int = 0,
             length: int | None = None) -> bytes:
        raise NotImplementedError

    def corrupt(self, cid: CollectionId, oid: Ghobject, offset: int = 0,
                xor: int = 0x01) -> bool:
        """Fault-injection hook: flip bits of one stored byte in place
        through a normal write transaction. Store-level checksums (the
        BlueStore per-AU csums) follow the write — exactly like silent
        media rot below them — so the HIGHER-layer integrity machinery
        (EC per-chunk crc attrs, scrub shard comparison) is what must
        catch it. Returns False when the object is absent or empty."""
        try:
            data = self.read(cid, oid)
        except StoreError:
            return False
        if not data:
            return False
        offset = min(max(0, int(offset)), len(data) - 1)
        txn = Transaction()
        txn.write(cid, oid, offset, bytes([data[offset] ^ (xor or 0x01)]))
        self.queue_transaction(txn)
        return True

    def getattr(self, cid: CollectionId, oid: Ghobject, name: str) -> bytes:
        raise NotImplementedError

    def getattrs(self, cid: CollectionId, oid: Ghobject) -> dict[str, bytes]:
        raise NotImplementedError

    def omap_get(self, cid: CollectionId, oid: Ghobject) -> dict[str, bytes]:
        raise NotImplementedError

    def omap_get_values(self, cid: CollectionId, oid: Ghobject,
                        keys: Iterable[str]) -> dict[str, bytes]:
        raise NotImplementedError
