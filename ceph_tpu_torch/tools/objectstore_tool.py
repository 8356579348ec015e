"""ceph-objectstore-tool analog: offline surgery on a FileStore.

Reference: src/tools/ceph_objectstore_tool.cc (--op list / info /
export / import / remove against a stopped OSD's data path). The
export format is a self-contained JSON bundle (objects with data,
attrs, omap + the PG meta/log), so a PG can be lifted off a dead OSD's
store and imported into another — the disaster-recovery workflow.

Usage:
    python -m ceph_tpu_torch.tools.objectstore_tool --data-path DIR --op list
    python -m ceph_tpu_torch.tools.objectstore_tool --data-path DIR \
        --op export --pgid 1.0 --file pg.export
    python -m ceph_tpu_torch.tools.objectstore_tool --data-path DIR2 \
        --op import --file pg.export
    python -m ceph_tpu_torch.tools.objectstore_tool --data-path DIR \
        --op remove --pgid 1.0 --oid obj1
"""
from __future__ import annotations

import argparse
import base64
import json
import sys

from ceph_tpu_torch.objectstore import FileStore
from ceph_tpu_torch.objectstore.store import Transaction
from ceph_tpu_torch.objectstore.types import CollectionId, Ghobject


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


def _parse_pgid(s: str) -> tuple[int, int]:
    pool, _, ps = s.partition(".")
    return int(pool), int(ps)


def _pg_coll(store: FileStore, pool: int, ps: int) -> CollectionId:
    for cid in store.list_collections():
        if getattr(cid, "pool", None) == pool and \
                getattr(cid, "pg_seed", None) == ps:
            return cid
    raise SystemExit(f"pg {pool}.{ps} not found in this store")


def op_list(store: FileStore, pgid: str | None) -> None:
    for cid in sorted(store.list_collections(), key=str):
        if pgid and _parse_pgid(pgid) != (getattr(cid, "pool", None),
                                          getattr(cid, "pg_seed", None)):
            continue
        for gh in store.collection_list(cid):
            print(json.dumps({"pgid": f"{cid.pool}.{cid.pg_seed}",
                              "oid": gh.name}))


def op_export(store: FileStore, pgid: str, path: str) -> None:
    pool, ps = _parse_pgid(pgid)
    cid = _pg_coll(store, pool, ps)
    objects = []
    for gh in store.collection_list(cid):
        objects.append({
            "name": gh.name, "shard": gh.shard,
            "data": _b64(store.read(cid, gh)),
            "attrs": {k: _b64(v)
                      for k, v in store.getattrs(cid, gh).items()},
            "omap": {k: _b64(v)
                     for k, v in store.omap_get(cid, gh).items()},
        })
    bundle = {"version": 1, "pgid": [pool, ps],
              "shard": cid.shard, "objects": objects}
    with open(path, "w") as f:
        json.dump(bundle, f)
    print(f"exported pg {pgid}: {len(objects)} objects -> {path}")


def op_import(store: FileStore, path: str) -> None:
    bundle = json.load(open(path))
    pool, ps = bundle["pgid"]
    cid = CollectionId.make_pg(pool, ps, bundle.get("shard", -1))
    txn = Transaction()
    if not store.collection_exists(cid):
        txn.create_collection(cid)
    for obj in bundle["objects"]:
        gh = Ghobject(pool=pool, name=obj["name"],
                      shard=obj.get("shard", -1))
        if store.collection_exists(cid) and store.exists(cid, gh):
            txn.remove(cid, gh)
        txn.touch(cid, gh)
        data = _unb64(obj["data"])
        if data:
            txn.write(cid, gh, 0, data)
        if obj["attrs"]:
            txn.setattrs(cid, gh, {k: _unb64(v)
                                   for k, v in obj["attrs"].items()})
        if obj["omap"]:
            txn.omap_setkeys(cid, gh, {k: _unb64(v)
                                       for k, v in obj["omap"].items()})
    store.queue_transaction(txn)
    print(f"imported pg {pool}.{ps}: {len(bundle['objects'])} objects")


def op_remove(store: FileStore, pgid: str, oid: str) -> None:
    pool, ps = _parse_pgid(pgid)
    cid = _pg_coll(store, pool, ps)
    gh = Ghobject(pool=pool, name=oid)
    if not store.exists(cid, gh):
        raise SystemExit(f"{oid} not in pg {pgid}")
    store.queue_transaction(Transaction().remove(cid, gh))
    print(f"removed {pgid}/{oid}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="objectstore-tool")
    ap.add_argument("--data-path", required=True)
    ap.add_argument("--op", required=True,
                    choices=["list", "export", "import", "remove"])
    ap.add_argument("--pgid")
    ap.add_argument("--oid")
    ap.add_argument("--file")
    a = ap.parse_args(argv)
    store = FileStore(a.data_path)
    store.mount()
    try:
        if a.op == "list":
            op_list(store, a.pgid)
        elif a.op == "export":
            op_export(store, a.pgid, a.file)
        elif a.op == "import":
            op_import(store, a.file)
        elif a.op == "remove":
            op_remove(store, a.pgid, a.oid)
    finally:
        store.umount()
    return 0


if __name__ == "__main__":
    sys.exit(main())
