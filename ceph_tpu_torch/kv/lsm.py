"""LSMStore: persistent log-structured KeyValueDB (the RocksDBStore role).

Re-creation of the reference's RocksDBStore essentials
(src/kv/RocksDBStore.cc over the vendored src/rocksdb/) as a compact
log-structured merge engine:

  * every batch is appended to a crc-framed WAL and fsync'd before it
    is acknowledged (rocksdb WriteBatch + WAL semantics);
  * the memtable absorbs writes; when it exceeds the flush threshold it
    is written out as an immutable sorted-run file (SSTable role) and
    the WAL is truncated;
  * lookups go memtable -> runs newest-to-oldest; deletes are
    tombstones that shadow older runs;
  * when the run count exceeds the compaction trigger, runs are merged
    into one and tombstones are dropped (full compaction — the
    reference's leveled compaction collapsed to one level);
  * the MANIFEST (tmp+rename+fsync) names the live runs, so a crash
    mid-flush/mid-compaction falls back to the previous run set plus
    WAL replay.

Idiomatic divergences: runs are loaded into memory at open (block
cache = whole-file residency — state here is control-plane-sized);
values are latin1-mapped JSON rather than varint-framed blocks.

The port's copy of ceph_tpu/kv/lsm.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import json
import os
import struct

from ceph_tpu_torch.kv.keyvaluedb import KeyValueDB, KVTransaction
from ceph_tpu_torch.utils.crash import SimulatedCrash  # noqa: F401 (re-export)

_TOMB = None          # tombstone marker inside tables


def _crc32c(data: bytes) -> int:
    from ceph_tpu_torch.native import ec_native
    return ec_native.crc32c(data)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class LSMStore(KeyValueDB):

    FLUSH_BYTES = 4 * 1024 * 1024     # memtable flush threshold
    COMPACT_RUNS = 6                  # full-compaction trigger

    def __init__(self, path: str, flush_bytes: int | None = None):
        self.path = path
        if flush_bytes is not None:
            self.FLUSH_BYTES = flush_bytes
        # "prefix\x00key" -> bytes | None(tombstone)
        self._memtable: dict[str, bytes | None] = {}
        self._mem_bytes = 0
        self._runs: list[dict[str, bytes | None]] = []   # newest first
        self._run_files: list[str] = []
        self._wal = None
        self._next_file = 1
        self.fail_after_wal = False     # SimulatedCrash hook

    # -- lifecycle -----------------------------------------------------------

    def open(self) -> None:
        os.makedirs(os.path.join(self.path, "sst"), exist_ok=True)
        manifest = os.path.join(self.path, "MANIFEST")
        if os.path.exists(manifest):
            with open(manifest) as f:
                m = json.load(f)
            self._run_files = list(m["runs"])
            self._next_file = m["next"]
            self._runs = [self._load_run(fn) for fn in self._run_files]
        self._replay_wal()
        self._wal = open(os.path.join(self.path, "wal.log"), "ab")

    def close(self) -> None:
        if self._wal is not None:
            self._wal.close()
            self._wal = None

    # -- WAL -----------------------------------------------------------------

    def _wal_path(self) -> str:
        return os.path.join(self.path, "wal.log")

    def _replay_wal(self) -> None:
        path = self._wal_path()
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            blob = f.read()
        off = 0
        while off + 8 <= len(blob):
            length, crc = struct.unpack_from("<II", blob, off)
            rec = blob[off + 8:off + 8 + length]
            if len(rec) < length or _crc32c(rec) != crc:
                break                       # torn tail: stop replay here
            for op in json.loads(rec):
                if op[0] == "set":
                    self._mem_set(f"{op[1]}\x00{op[2]}",
                                  op[3].encode("latin1"))
                elif op[0] == "rm":
                    self._mem_set(f"{op[1]}\x00{op[2]}", _TOMB)
                elif op[0] == "rmprefix":
                    self._rm_prefix_mem(op[1])
            off += 8 + length

    # -- batch submit --------------------------------------------------------

    def submit_transaction(self, txn: KVTransaction,
                           sync: bool = True) -> None:
        if not txn.ops:
            return
        rec = json.dumps(
            [(o[0], o[1], *([] if len(o) < 3 else [o[2]]),
              *([] if len(o) < 4 else [o[3].decode("latin1")]))
             for o in txn.ops]).encode()
        self._wal.write(struct.pack("<II", len(rec), _crc32c(rec)) + rec)
        self._wal.flush()
        if sync:
            os.fsync(self._wal.fileno())
        if self.fail_after_wal:
            raise SimulatedCrash("crash between WAL append and apply")
        for op in txn.ops:
            if op[0] == "set":
                self._mem_set(f"{op[1]}\x00{op[2]}", op[3])
            elif op[0] == "rm":
                self._mem_set(f"{op[1]}\x00{op[2]}", _TOMB)
            elif op[0] == "rmprefix":
                self._rm_prefix_mem(op[1])
        if self._mem_bytes >= self.FLUSH_BYTES:
            self._flush()

    def _mem_set(self, fq: str, value: bytes | None) -> None:
        old = self._memtable.get(fq)
        self._memtable[fq] = value
        self._mem_bytes += len(fq) + (len(value) if value else 0) \
            - (len(old) if old else 0)

    def _rm_prefix_mem(self, prefix: str) -> None:
        """Tombstone every key under `prefix` visible anywhere."""
        p = prefix + "\x00"
        names = {k for k in self._memtable if k.startswith(p)}
        for run in self._runs:
            names.update(k for k in run if k.startswith(p))
        for k in names:
            self._memtable[k] = _TOMB

    # -- flush / compaction --------------------------------------------------

    def _run_path(self, name: str) -> str:
        return os.path.join(self.path, "sst", name)

    def _load_run(self, name: str) -> dict[str, bytes | None]:
        with open(self._run_path(name), "rb") as f:
            blob = f.read()
        crc, = struct.unpack_from("<I", blob, 0)
        body = blob[4:]
        if _crc32c(body) != crc:
            raise IOError(f"sst {name}: crc mismatch")
        raw = json.loads(body)
        return {k: (v.encode("latin1") if v is not None else _TOMB)
                for k, v in raw.items()}

    def _write_run(self, table: dict[str, bytes | None]) -> str:
        name = f"{self._next_file:06d}.sst"
        self._next_file += 1
        body = json.dumps(
            {k: (v.decode("latin1") if v is not None else None)
             for k, v in sorted(table.items())}).encode()
        tmp = self._run_path(name) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(struct.pack("<I", _crc32c(body)) + body)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._run_path(name))
        return name

    def _commit_manifest(self) -> None:
        tmp = os.path.join(self.path, "MANIFEST.tmp")
        with open(tmp, "w") as f:
            json.dump({"runs": self._run_files, "next": self._next_file},
                      f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.path, "MANIFEST"))
        _fsync_dir(self.path)

    def _flush(self) -> None:
        if not self._memtable:
            return
        name = self._write_run(self._memtable)
        self._run_files.insert(0, name)
        self._runs.insert(0, dict(self._memtable))
        self._commit_manifest()
        self._memtable.clear()
        self._mem_bytes = 0
        # WAL content is now durable in the run: start a fresh log
        self._wal.close()
        os.truncate(self._wal_path(), 0)
        self._wal = open(self._wal_path(), "ab")
        if len(self._run_files) > self.COMPACT_RUNS:
            self._compact()

    def _compact(self) -> None:
        """Merge every run into one; tombstones drop out (nothing older
        remains to shadow)."""
        merged: dict[str, bytes | None] = {}
        for run in reversed(self._runs):         # oldest first
            merged.update(run)
        merged = {k: v for k, v in merged.items() if v is not None}
        name = self._write_run(merged)
        old_files = self._run_files
        self._run_files = [name]
        self._runs = [merged]
        self._commit_manifest()
        for fn in old_files:
            try:
                os.unlink(self._run_path(fn))
            except OSError:
                pass

    def compact(self) -> None:
        """Explicit full compaction (rocksdb CompactRange)."""
        self._flush()
        if len(self._run_files) > 1:
            self._compact()

    # -- reads ---------------------------------------------------------------

    def get(self, prefix: str, key: str) -> bytes | None:
        fq = f"{prefix}\x00{key}"
        if fq in self._memtable:
            return self._memtable[fq]
        for run in self._runs:
            if fq in run:
                return run[fq]
        return None

    def iterate(self, prefix: str, start: str = ""):
        p = prefix + "\x00"
        view: dict[str, bytes | None] = {}
        for run in reversed(self._runs):
            for k, v in run.items():
                if k.startswith(p):
                    view[k] = v
        for k, v in self._memtable.items():
            if k.startswith(p):
                view[k] = v
        for k in sorted(view):
            key = k[len(p):]
            if view[k] is not None and key >= start:
                yield key, view[k]
