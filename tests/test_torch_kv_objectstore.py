"""The port's storage layer (ceph_tpu_torch/kv/, objectstore/) against the
JAX package's, on the CPU, byte for byte.

Every case of tests/test_objectstore.py (over memstore, filestore and
bluestore) and tests/test_kv_bluestore.py runs twice: once as written,
through `ceph_tpu.*`, and once with its imports renamed to
`ceph_tpu_torch.*` (the EC case's plugin `tpu` becomes `cuda` on the
CPU). Both runs draw the same bytes (`os.urandom` is seeded), keep their
assertions, and record every read the case makes of a store or a KV
engine: reads, stats, attrs, omap, listings and the errors raised. The
two records must be equal, and so must each store's final state (every
object's bytes, attrs and omap) and every file the case left on disk:
the LSM's WAL, SSTs and MANIFEST, BlueStore's block file with its
per-AU csum lists in the onodes, FileStore's WAL, checkpoint and blobs.

Then the cross-mount cases: a store written by one package mounts in the
other, both ways (LSM and MemDB engines, FileStore, BlueStore with
extents, per-AU csums, inline objects, omap and attrs), and the
`store_commit` span carries the reference's tags.
"""
from __future__ import annotations

import dataclasses
import inspect
import os
import random
import re
import time
import types
import zlib

import numpy as np
import pytest

import ceph_tpu.kv as ref_kv
import ceph_tpu.objectstore as ref_os
from ceph_tpu.utils import tracer as ref_tracer
import ceph_tpu_torch.kv as port_kv
import ceph_tpu_torch.objectstore as port_os
from ceph_tpu_torch.utils import tracer as port_tracer

TESTS = os.path.dirname(os.path.abspath(__file__))
BACKENDS = ("memstore", "filestore", "bluestore")
STORE_READS = ("read", "stat", "getattr", "getattrs", "omap_get",
               "omap_get_values", "collection_list", "list_collections",
               "exists", "collection_exists")
KV_READS = ("get", "iterate")
#: the one line of the reference's EC case that names a plugin
_TPU_FACTORY = 'factory("tpu", {"k": str(k), "m": str(m)})'
_CUDA_FACTORY = 'factory("cuda", {"k": str(k), "m": str(m), "device": "cpu"})'


@pytest.fixture(autouse=True)
def _port_gates():
    """The port's own leak gates (tests/conftest.py gates the
    reference's modules)."""
    yield
    from ceph_tpu_torch.utils import loopprof, sanitizer
    assert not loopprof.installed_loops(), "port loopprof left armed"
    strays = sanitizer.take_foreign_call_soon()
    assert not strays, f"port sanitizer saw foreign call_soon: {strays}"


@pytest.fixture(autouse=True)
def _fixed_clock(monkeypatch):
    """MemStore and FileStore stamp mtimes from time.time(); one fixed
    clock lets both packages write the same bytes."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9)


# -- running a reference test module through either package -------------------

class _SeededOS(types.ModuleType):
    """`os` for a loaded test module, with `urandom` drawn from a seed."""

    def __init__(self, seed: int):
        super().__init__("os")
        self._rng = random.Random(seed)

    def urandom(self, n: int) -> bytes:
        return self._rng.randbytes(n)

    def __getattr__(self, name):
        return getattr(os, name)


def canon(x):
    """A result as plain data that compares across packages (the
    packages' dataclasses, Ghobject, CollectionId, PG, compare by repr)."""
    if isinstance(x, (bytes, bytearray, memoryview)):
        return bytes(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, dict):
        return {canon(k): canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    if dataclasses.is_dataclass(x):
        return repr(x)
    return x


def recording(cls, log: list, names: tuple):
    """A subclass of `cls` that appends every call of `names` (its
    arguments, and its result or the error it raised) to `log`."""
    def wrap(name):
        def method(self, *args, **kwargs):
            try:
                out = getattr(super(sub, self), name)(*args, **kwargs)
                if inspect.isgenerator(out):
                    out = list(out)
            except Exception as e:
                log.append((name, canon(args), canon(kwargs), "raised",
                            type(e).__name__, getattr(e, "code", None)))
                raise
            log.append((name, canon(args), canon(kwargs), canon(out)))
            return iter(out) if name == "iterate" else out
        return method
    sub = type(cls.__name__, (cls,),
               {n: wrap(n) for n in names if hasattr(cls, n)})
    return sub


def load_reference_tests(name: str, port: bool, log: list, record: dict,
                         seed: int = 0,
                         edits: tuple = ()) -> types.ModuleType:
    """tests/<name>.py as a fresh module: as written, or with its imports
    renamed to the port and each (old, new) of `edits` applied; the
    classes named in `record` (name -> methods) record into `log`, and
    `os.urandom` draws from `seed`."""
    path = os.path.join(TESTS, name + ".py")
    with open(path) as f:
        src = f.read()
    if port:
        src = re.sub(r"\bceph_tpu\.", "ceph_tpu_torch.", src)
        src = src.replace("from ceph_tpu import", "from ceph_tpu_torch import")
        for old, new in edits:
            assert old in src, f"{name}.py no longer holds {old!r}"
            src = src.replace(old, new)
    mod = types.ModuleType(f"{'port' if port else 'ref'}_{name}")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    mod.os = _SeededOS(seed)
    for cls_name, methods in record.items():
        if hasattr(mod, cls_name):
            setattr(mod, cls_name,
                    recording(getattr(mod, cls_name), log, methods))
    return mod


def _load(name: str, port: bool, log: list, seed: int) -> types.ModuleType:
    edits = ((_TPU_FACTORY, _CUDA_FACTORY),) \
        if name == "test_objectstore" else ()
    record = {"MemStore": STORE_READS, "FileStore": STORE_READS,
              "BlueStore": STORE_READS, "MemDB": KV_READS,
              "LSMStore": KV_READS}
    return load_reference_tests(name, port, log, record, seed, edits)


def _cases(name: str) -> list[tuple]:
    """(module, function, argument) for every case of tests/<name>.py,
    as pytest would collect it."""
    src = open(os.path.join(TESTS, name + ".py")).read()
    out = []
    for fn in re.findall(r"^def (test_\w+)\((\w*)", src, re.M):
        fname, first = fn
        if first == "store":
            out += [(name, fname, b) for b in BACKENDS]
        elif first == "engine":
            out += [(name, fname, e) for e in ("memdb", "lsm")]
        else:
            out.append((name, fname, None))
    return out


CASES = _cases("test_objectstore") + _cases("test_kv_bluestore")


def _tree(root: str) -> dict:
    """Every file under root: relative path -> bytes."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _dump(store) -> dict:
    """A mounted store's whole state through its public API."""
    out = {}
    for cid in store.list_collections():
        for oid in store.collection_list(cid):
            out[repr(cid), repr(oid)] = (
                store.read(cid, oid), store.getattrs(cid, oid),
                store.omap_get(cid, oid))
    return out


def _run_case(mod, fname: str, arg, tmp) -> dict | None:
    fn = getattr(mod, fname)
    os.makedirs(tmp, exist_ok=True)
    params = list(inspect.signature(fn).parameters)
    if params[:1] == ["store"]:
        if arg == "memstore":
            store = mod.MemStore()
        elif arg == "bluestore":
            store = mod.BlueStore(os.path.join(tmp, "bs"))
        else:
            store = mod.FileStore(os.path.join(tmp, "fs"))
        store.mkfs()
        store.mount()
        fn(store)
        state = _dump(store)
        store.umount()
        return state
    from pathlib import Path
    kwargs = {"tmp_path": Path(tmp)} if "tmp_path" in params else {}
    if params[:1] == ["engine"]:
        kwargs["engine"] = arg
    fn(**kwargs)
    return None


@pytest.mark.parametrize(
    "case", CASES,
    ids=[f"{m[5:]}::{f}" + (f"[{a}]" if a else "") for m, f, a in CASES])
def test_reference_case_same_bytes(case, tmp_path):
    """One reference case through both packages: the same reads, the
    same final state, the same files."""
    name, fname, arg = case
    seed = zlib.crc32(f"{fname}[{arg}]".encode())
    ref_log, port_log = [], []
    ref_state = _run_case(_load(name, False, ref_log, seed), fname, arg,
                          str(tmp_path / "ref"))
    port_state = _run_case(_load(name, True, port_log, seed), fname, arg,
                           str(tmp_path / "port"))
    assert port_log == ref_log
    assert port_state == ref_state
    ref_files = _tree(str(tmp_path / "ref"))
    assert _tree(str(tmp_path / "port")) == ref_files
    if arg in ("filestore", "bluestore") or name == "test_kv_bluestore":
        assert ref_files or fname == "test_kv_basic_and_iterate"


def test_every_reference_case_is_mirrored():
    """50 reference cases: 12 x 3 backends + 5 FileStore cases in
    test_objectstore.py, 2 engines + 7 in test_kv_bluestore.py."""
    assert len(CASES) == 50
    assert _TPU_FACTORY in open(
        os.path.join(TESTS, "test_objectstore.py")).read()


# -- cross-mount: a store written by one package mounts in the other -----------

PKGS = {"ref": (ref_kv, ref_os), "port": (port_kv, port_os)}
DIRECTIONS = [("ref", "port"), ("port", "ref")]


def _bytes(rng: np.random.Generator, n: int) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _fill(os_mod, store, rng) -> None:
    """Objects of every shape: inline, extents over several AUs, ragged
    tails, attrs, omap, a clone, a shard collection, a removal."""
    T, G, C = os_mod.Transaction, os_mod.Ghobject, os_mod.CollectionId
    cid, shard = C.make_pg(4, 0x11), C.make_pg(4, 0x11, shard=2)
    big = _bytes(rng, 64 * 1024 + 3 * 4096 + 123)
    t = T().create_collection(cid).create_collection(shard)
    t.write(cid, G(pool=4, name="small"), 0, _bytes(rng, 700))
    t.write(cid, G(pool=4, name="big"), 0, big)
    t.setattrs(cid, G(pool=4, name="big"), {"_": b"oi", "hinfo_key": b"\x01"})
    t.omap_setkeys(cid, G(pool=4, name="big"), {"k1": b"v1", "k2": b"v2"})
    t.write(shard, G(pool=4, name="big", shard=2), 0, _bytes(rng, 9 * 4096))
    t.touch(cid, G(pool=4, name="gone"))
    store.queue_transaction(t)
    t = T().clone(cid, G(pool=4, name="big"), G(pool=4, name="copy"))
    t.write(cid, G(pool=4, name="big"), 4096 * 5 + 7, _bytes(rng, 5000))
    t.remove(cid, G(pool=4, name="gone"))
    t.omap_rmkeys(cid, G(pool=4, name="big"), ["k1"])
    store.queue_transaction(t)


def _store(kv_mod, os_mod, kind: str, path: str, memdb=None):
    if kind == "filestore":
        return os_mod.FileStore(path)
    if kind == "bluestore-memdb":
        return os_mod.BlueStore(path, kv=memdb)
    return os_mod.BlueStore(path)


@pytest.mark.parametrize("kind", ["filestore", "bluestore-lsm",
                                  "bluestore-memdb"])
@pytest.mark.parametrize("direction", DIRECTIONS,
                         ids=[f"{a}-to-{b}" for a, b in DIRECTIONS])
def test_store_cross_mount(kind, direction, tmp_path):
    """Written by one package, mounted by the other: the same objects,
    attrs and omap, reads that pass the writer's csums; a write by the
    second package reads back in the first."""
    w_kv, w_os = PKGS[direction[0]]
    r_kv, r_os = PKGS[direction[1]]
    path = str(tmp_path / "store")
    memdb = w_kv.MemDB() if kind == "bluestore-memdb" else None
    a = _store(w_kv, w_os, kind, path, memdb)
    a.mkfs()
    a.mount()
    _fill(w_os, a, np.random.default_rng(3))
    want = {k: v for k, v in _dump(a).items()}
    a.umount()
    b = _store(r_kv, r_os, kind, path, memdb)
    b.mount()
    assert {k: v for k, v in _dump(b).items()} == want
    cid = r_os.CollectionId.make_pg(4, 0x11)
    later = _bytes(np.random.default_rng(4), 70 * 1024)
    b.queue_transaction(r_os.Transaction().write(
        cid, r_os.Ghobject(pool=4, name="later"), 0, later))
    b.umount()
    c = _store(w_kv, w_os, kind, path, memdb)
    c.mount()
    assert c.read(w_os.CollectionId.make_pg(4, 0x11),
                  w_os.Ghobject(pool=4, name="later")) == later
    for key, value in want.items():
        assert _dump(c)[key] == value
    c.umount()


def _kv_fill(kv_mod, db, rng) -> None:
    for i in range(60):
        t = db.transaction()
        t.set("P", f"k{i:03d}", _bytes(rng, 40 + i))
        if i % 7 == 0:
            t.rmkey("P", f"k{i // 2:03d}")
        if i == 30:
            t.rmkeys_by_prefix("Q")
        t.set("Q", f"q{i}", b"x" * (i % 5))
        db.submit_transaction(t)


def _kv_items(db, prefixes=("P", "Q")) -> dict:
    return {p: list(db.iterate(p)) for p in prefixes}


@pytest.mark.parametrize("engine", ["lsm", "memdb"])
@pytest.mark.parametrize("direction", DIRECTIONS,
                         ids=[f"{a}-to-{b}" for a, b in DIRECTIONS])
def test_kv_cross_mount(engine, direction, tmp_path):
    """An LSM written by one package (WAL, flushed SSTs, a compaction)
    opens in the other with the same contents; a MemDB filled by one
    package serves the other's engine-level reads and writes. The
    LSM's files are byte-equal to the other package's for the same
    batches."""
    w_kv, r_kv = PKGS[direction[0]][0], PKGS[direction[1]][0]
    if engine == "memdb":
        db = w_kv.MemDB()
        db.open()
        _kv_fill(w_kv, db, np.random.default_rng(5))
        twin = r_kv.MemDB()
        twin.open()
        _kv_fill(r_kv, twin, np.random.default_rng(5))
        assert _kv_items(twin) == _kv_items(db)
        t = r_kv.KVTransaction()
        t.set("P", "zz", b"from the other package")
        db.submit_transaction(t)
        assert db.get("P", "zz") == b"from the other package"
        return
    db = w_kv.LSMStore(str(tmp_path / "w"), flush_bytes=1024)
    db.open()
    _kv_fill(w_kv, db, np.random.default_rng(5))
    assert len(db._run_files) >= 2
    want = _kv_items(db)
    db.close()
    twin = r_kv.LSMStore(str(tmp_path / "r"), flush_bytes=1024)
    twin.open()
    _kv_fill(r_kv, twin, np.random.default_rng(5))
    twin.close()
    assert _tree(str(tmp_path / "r")) == _tree(str(tmp_path / "w"))
    other = r_kv.LSMStore(str(tmp_path / "w"), flush_bytes=1024)
    other.open()
    assert _kv_items(other) == want
    other.compact()
    t = other.transaction()
    t.set("P", "zz", b"from the other package")
    other.submit_transaction(t)
    other.close()
    back = w_kv.LSMStore(str(tmp_path / "w"))
    back.open()
    assert back.get("P", "zz") == b"from the other package"
    assert _kv_items(back, ("Q",)) == {"Q": want["Q"]}
    back.close()


# -- the store_commit span -----------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_store_commit_span_tags(backend, tmp_path):
    """queue_transaction under the tracer opens one `store_commit` span
    with the reference's name, service and tags."""
    def spans(tr, os_mod, root):
        if backend == "memstore":
            store = os_mod.MemStore()
        elif backend == "bluestore":
            store = os_mod.BlueStore(str(root / "bs"))
        else:
            store = os_mod.FileStore(str(root / "fs"))
        store.mkfs()
        store.mount()
        cid = os_mod.CollectionId.make_pg(1, 2)
        tr.reset()
        tr.enable()
        try:
            t = os_mod.Transaction().create_collection(cid)
            t.write(cid, os_mod.Ghobject(name="o"), 0, b"x" * 9000)
            t.setattr(cid, os_mod.Ghobject(name="o"), "a", b"1")
            store.queue_transaction(t)
            store.queue_transaction(os_mod.Transaction().touch(
                cid, os_mod.Ghobject(name="p")))
            got = [sp for trace in tr.dump()["traces"]
                   for sp in trace["spans"]]
        finally:
            tr.disable()
            tr.reset()
            store.umount()
        keep = ("name", "service", "tags")
        return sorted(({k: sp.get(k) for k in keep} for sp in got
                       if sp["name"] == "store_commit"),
                      key=lambda sp: sp["tags"]["ops"])
    ref = spans(ref_tracer, ref_os, tmp_path / "ref")
    port = spans(port_tracer, port_os, tmp_path / "port")
    assert len(ref) == 2
    assert [sp["tags"]["ops"] for sp in ref] == [1, 3]
    assert port == ref
