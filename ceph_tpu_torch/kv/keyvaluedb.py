"""KeyValueDB: the storage engine contract under BlueStore/MonStore.

Re-creation of the reference's KeyValueDB abstraction
(src/kv/KeyValueDB.h): prefixed keyspaces (the column-family role),
atomic write batches (`KVTransaction` ~ KeyValueDB::Transaction),
point gets and ordered prefix iteration. Implementations: `MemDB`
(src/kv/MemDB.cc role — tests/ephemeral) and `LSMStore` in lsm.py
(the RocksDBStore role).

The port's copy of ceph_tpu/kv/keyvaluedb.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

from typing import Iterator


class KVTransaction:
    """Atomic batch of set/rmkey ops (KeyValueDB::TransactionImpl)."""

    def __init__(self):
        # (op, prefix, key, value|None); replayed in order
        self.ops: list[tuple] = []

    def set(self, prefix: str, key: str, value: bytes) -> "KVTransaction":
        self.ops.append(("set", prefix, key, bytes(value)))
        return self

    def rmkey(self, prefix: str, key: str) -> "KVTransaction":
        self.ops.append(("rm", prefix, key))
        return self

    def rmkeys_by_prefix(self, prefix: str) -> "KVTransaction":
        self.ops.append(("rmprefix", prefix))
        return self

    def __len__(self) -> int:
        return len(self.ops)


class KeyValueDB:
    """Abstract engine: prefixes ~ column families (KeyValueDB.h)."""

    def open(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    def transaction(self) -> KVTransaction:
        return KVTransaction()

    def submit_transaction(self, txn: KVTransaction,
                           sync: bool = True) -> None:
        raise NotImplementedError

    def get(self, prefix: str, key: str) -> bytes | None:
        raise NotImplementedError

    def iterate(self, prefix: str,
                start: str = "") -> Iterator[tuple[str, bytes]]:
        """Ordered (key, value) pairs with key >= start, one prefix."""
        raise NotImplementedError


class MemDB(KeyValueDB):
    """In-memory engine (the reference's MemDB test backend)."""

    def __init__(self):
        self._data: dict[str, dict[str, bytes]] = {}

    def open(self) -> None:
        pass

    def close(self) -> None:
        pass

    def submit_transaction(self, txn: KVTransaction,
                           sync: bool = True) -> None:
        for op in txn.ops:
            if op[0] == "set":
                self._data.setdefault(op[1], {})[op[2]] = op[3]
            elif op[0] == "rm":
                self._data.get(op[1], {}).pop(op[2], None)
            elif op[0] == "rmprefix":
                self._data.pop(op[1], None)

    def get(self, prefix: str, key: str) -> bytes | None:
        return self._data.get(prefix, {}).get(key)

    def iterate(self, prefix: str,
                start: str = "") -> Iterator[tuple[str, bytes]]:
        table = self._data.get(prefix, {})
        for k in sorted(table):
            if k >= start:
                yield k, table[k]
