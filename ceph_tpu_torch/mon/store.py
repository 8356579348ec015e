"""MonStore — MonitorDBStore-lite (src/mon/MonitorDBStore.h).

Prefixed key/value store with atomic transactions and JSON-file
persistence. The reference runs RocksDB; monitor state is tiny (maps,
paxos versions, service state), so a dict snapshotted to disk with
atomic rename gives the same contract: a transaction is either fully
visible after restart or not at all.

The port's copy of ceph_tpu/mon/store.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import json
import os
import tempfile


class MonStoreTxn:
    def __init__(self):
        self.ops: list[tuple] = []

    def put(self, prefix: str, key: str, value) -> None:
        self.ops.append(("put", prefix, str(key), value))

    def erase(self, prefix: str, key: str) -> None:
        self.ops.append(("erase", prefix, str(key)))


class MonStore:
    def __init__(self, path: str | None = None):
        self.path = path
        self._data: dict[str, dict[str, object]] = {}
        if path and os.path.exists(path):
            with open(path) as f:
                self._data = json.load(f)

    # -- reads ---------------------------------------------------------------

    def get(self, prefix: str, key: str, default=None):
        return self._data.get(prefix, {}).get(str(key), default)

    def exists(self, prefix: str, key: str) -> bool:
        return str(key) in self._data.get(prefix, {})

    def keys(self, prefix: str) -> list[str]:
        return sorted(self._data.get(prefix, {}))

    # -- writes --------------------------------------------------------------

    def apply_transaction(self, txn: MonStoreTxn) -> None:
        for op in txn.ops:
            if op[0] == "put":
                _, prefix, key, value = op
                self._data.setdefault(prefix, {})[key] = value
            else:
                _, prefix, key = op
                self._data.get(prefix, {}).pop(key, None)
        self._persist()

    def put_one(self, prefix: str, key: str, value) -> None:
        txn = MonStoreTxn()
        txn.put(prefix, key, value)
        self.apply_transaction(txn)

    # -- full sync (Monitor store sync for hopelessly-behind peers) ----------

    def dump(self) -> dict:
        return json.loads(json.dumps(self._data))   # deep, JSON-safe copy

    def load_dump(self, data: dict) -> None:
        self._data = data
        self._persist()

    def size_bytes(self) -> int:
        """Serialized size — used by the bounded-growth test."""
        return len(json.dumps(self._data))

    def _persist(self) -> None:
        if not self.path:
            return
        d = os.path.dirname(self.path) or "."
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".monstore.")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._data, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
