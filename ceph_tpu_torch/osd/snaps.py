"""RADOS snapshots: SnapSet, clone-on-write, snap reads, SnapMapper.

Re-creation of the reference's snapshot machinery essentials:

  * clone-on-write (src/osd/PrimaryLogPG.cc make_writeable): the first
    mutation after a new snap appears in the client's SnapContext clones
    the head into a read-only clone object covering the new snaps;
  * SnapSet (src/osd/osd_types.h SnapSet): per-object record of the
    newest snap observed (seq) and the clone list with the exact snap
    ids each clone covers;
  * snap-directed reads (PrimaryLogPG::find_object_context): a read at
    snap s serves head when s is newer than every mutation, the covering
    clone when one exists, and ENOENT when the object did not exist at s;
  * SnapMapper (src/osd/SnapMapper.h): an omap index snap -> object
    names on the PG meta object so snaptrim can find the affected
    objects without scanning the collection;
  * snaptrim (PrimaryLogPG::trim_object): when the monitor marks a snap
    removed, the primary strips it from covering clones and deletes
    clones left covering nothing.

Idiomatic divergences: the SnapSet lives on a per-object "snapdir"
companion (snap=SNAPDIR_SNAP) instead of head-attr-with-migration, so
head delete/recreate never moves it; clones are full copies (no overlap
extents); all helpers are deterministic pure store operations so
replicas replay the same clone/trim ops the primary logged.

The port's copy of ceph_tpu/osd/snaps.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import dataclasses
import json

from ceph_tpu_torch.objectstore.store import ObjectStore, StoreError, Transaction
from ceph_tpu_torch.objectstore.types import CEPH_NOSNAP, CollectionId, Ghobject

# companion object holding the SnapSet (reference: CEPH_SNAPDIR head
# stand-in); distinct from NOSNAP and NO_GEN sentinels
SNAPDIR_SNAP = 2 ** 64 - 3

SS_ATTR = "ss"
SM_PREFIX = "sm_"


def snapdir_gh(head: Ghobject) -> Ghobject:
    return dataclasses.replace(head, snap=SNAPDIR_SNAP)


def clone_gh(head: Ghobject, cloneid: int) -> Ghobject:
    return dataclasses.replace(head, snap=cloneid)


def sm_key(snapid: int, name: str) -> str:
    return f"{SM_PREFIX}{snapid:016x}|{name}"


@dataclasses.dataclass
class SnapSet:
    """seq + clone list, ascending by clone id; each clone records the
    exact snap ids whose object state it preserves."""

    seq: int = 0
    # [{"id": int, "snaps": [int,...] ascending, "size": int}, ...]
    clones: list[dict] = dataclasses.field(default_factory=list)

    def to_json(self) -> bytes:
        return json.dumps({"seq": self.seq, "clones": self.clones}).encode()

    @classmethod
    def from_json(cls, blob: bytes) -> "SnapSet":
        d = json.loads(blob)
        return cls(seq=d["seq"], clones=list(d["clones"]))


def load_snapset(store: ObjectStore, cid: CollectionId,
                 head: Ghobject) -> SnapSet | None:
    sd = snapdir_gh(head)
    try:
        return SnapSet.from_json(store.getattr(cid, sd, SS_ATTR))
    except StoreError:
        return None


def save_snapset(txn: Transaction, cid: CollectionId, head: Ghobject,
                 ss: SnapSet, store: ObjectStore) -> None:
    """Persist even a clone-less SnapSet while seq > 0: the seq is what
    lets resolve_read answer ENOENT for snaps that predate the object."""
    sd = snapdir_gh(head)
    if not ss.clones and ss.seq == 0:
        if store.exists(cid, sd):
            txn.remove(cid, sd)
        return
    if not store.exists(cid, sd):
        txn.touch(cid, sd)
    txn.setattr(cid, sd, SS_ATTR, ss.to_json())


def resolve_read(ss: SnapSet | None, snapid: int,
                 head_exists: bool):
    """Which object serves a read at `snapid`: "head", a clone id, or
    None for ENOENT (the object did not exist at that snap)."""
    if ss is None:
        return "head" if head_exists else None
    if snapid > ss.seq:
        return "head" if head_exists else None
    for clone in ss.clones:                      # ascending clone id
        if snapid in clone["snaps"]:
            return clone["id"]
    return None


# -- deterministic store-level ops (replayed identically on replicas) ------

def apply_clone(store: ObjectStore, cid: CollectionId, head: Ghobject,
                pgmeta: Ghobject, cloneid: int, snaps: list[int],
                seq_only: bool, size: int | None = None) -> None:
    """make_writeable's clone step: preserve the current head state as
    clone `cloneid` covering `snaps`, and advance SnapSet.seq. With
    seq_only (head absent at clone time: nothing to preserve) only the
    seq advances, so a later clone cannot claim to cover snaps that
    predate the object. `size` overrides the recorded clone size (EC
    shards pass the LOGICAL object size; their local blob is a padded
    chunk stack)."""
    ss = load_snapset(store, cid, head) or SnapSet()
    if cloneid <= ss.seq:
        return                               # replayed / stale clone op
    txn = Transaction()
    if not seq_only and store.exists(cid, head):
        cgh = clone_gh(head, cloneid)
        if store.exists(cid, cgh):
            txn.remove(cid, cgh)
        txn.clone(cid, head, cgh)
        if size is None:
            size = store.stat(cid, head)["size"]
        ss.clones.append({"id": cloneid, "snaps": sorted(snaps),
                          "size": size})
        txn.omap_setkeys(cid, pgmeta,
                         {sm_key(s, head.name): b"1" for s in snaps})
    ss.seq = cloneid
    save_snapset(txn, cid, head, ss, store)
    store.queue_transaction(txn)


def apply_rollback(store: ObjectStore, cid: CollectionId, head: Ghobject,
                   snapid: int,
                   extra_attrs: dict[str, bytes] | None = None) -> None:
    """Copy the clone covering `snapid` back over head (rollback op,
    PrimaryLogPG::_rollback_to). The primary rejects ENOENT resolutions
    before logging, so an unresolvable replay is a no-op. `extra_attrs`
    are stamped onto the restored head (the EC backend re-stamps the
    shard's version attr so the rolled-back chunks carry the rollback
    entry's eversion, not the clone-time one)."""
    ss = load_snapset(store, cid, head)
    src = resolve_read(ss, snapid, store.exists(cid, head))
    if src is None or src == "head":
        return
    cgh = clone_gh(head, src)
    if not store.exists(cid, cgh):
        return
    txn = Transaction()
    if store.exists(cid, head):
        txn.remove(cid, head)
    txn.clone(cid, cgh, head)
    if extra_attrs:
        txn.setattrs(cid, head, extra_attrs)
    store.queue_transaction(txn)


def apply_snaptrim(store: ObjectStore, cid: CollectionId, head: Ghobject,
                   pgmeta: Ghobject, snapid: int) -> None:
    """Strip a removed snap from this object: drop it from the covering
    clone's snap list, delete the clone once it covers nothing, clear
    the SnapMapper key (PrimaryLogPG::trim_object)."""
    txn = Transaction()
    txn.omap_rmkeys(cid, pgmeta, [sm_key(snapid, head.name)])
    ss = load_snapset(store, cid, head)
    if ss is not None:
        kept = []
        for clone in ss.clones:
            if snapid in clone["snaps"]:
                clone = dict(clone, snaps=[s for s in clone["snaps"]
                                           if s != snapid])
            if clone["snaps"]:
                kept.append(clone)
            else:
                cgh = clone_gh(head, clone["id"])
                if store.exists(cid, cgh):
                    txn.remove(cid, cgh)
        ss.clones = kept
        save_snapset(txn, cid, head, ss, store)
    store.queue_transaction(txn)


def purge_object(store: ObjectStore, cid: CollectionId, head: Ghobject,
                 pgmeta: Ghobject) -> None:
    """Remove head AND every clone + the snapdir + SnapMapper keys: the
    stray-deletion path during backfill (a stray's snapshots are strays
    too, unlike a client delete which preserves clones)."""
    txn = Transaction()
    ss = load_snapset(store, cid, head)
    if ss is not None:
        rm_keys = []
        for clone in ss.clones:
            cgh = clone_gh(head, clone["id"])
            if store.exists(cid, cgh):
                txn.remove(cid, cgh)
            rm_keys.extend(sm_key(s, head.name) for s in clone["snaps"])
        if rm_keys:
            txn.omap_rmkeys(cid, pgmeta, rm_keys)
        txn.remove(cid, snapdir_gh(head))
    if store.exists(cid, head):
        txn.remove(cid, head)
    if len(txn):
        store.queue_transaction(txn)


# -- recovery payload helpers ----------------------------------------------

def snap_state_for_push(store: ObjectStore, cid: CollectionId,
                        head: Ghobject) -> dict | None:
    """Clones + SnapSet for a recovery push payload (None when the
    object has no snapshot state)."""
    ss = load_snapset(store, cid, head)
    if ss is None:
        return None
    clones = {}
    for clone in ss.clones:
        cgh = clone_gh(head, clone["id"])
        try:
            clones[str(clone["id"])] = {
                "data": store.read(cid, cgh).decode("latin1"),
                "attrs": {k: v.decode("latin1")
                          for k, v in store.getattrs(cid, cgh).items()}}
        except StoreError:
            pass
    return {"ss": ss.to_json().decode(), "clones": clones}


def apply_snap_push(store: ObjectStore, cid: CollectionId, head: Ghobject,
                    pgmeta: Ghobject, state: dict | None) -> None:
    """Replace local snapshot state with a pushed one (or clear it)."""
    old = load_snapset(store, cid, head)
    txn = Transaction()
    if old is not None:
        rm = []
        for clone in old.clones:
            cgh = clone_gh(head, clone["id"])
            if store.exists(cid, cgh):
                txn.remove(cid, cgh)
            rm.extend(sm_key(s, head.name) for s in clone["snaps"])
        if rm:
            txn.omap_rmkeys(cid, pgmeta, rm)
        txn.remove(cid, snapdir_gh(head))
    if state is not None:
        ss = SnapSet.from_json(state["ss"].encode())
        sd = snapdir_gh(head)
        txn.touch(cid, sd)
        txn.setattr(cid, sd, SS_ATTR, ss.to_json())
        sm = {}
        for clone in ss.clones:
            blob = state["clones"].get(str(clone["id"]))
            if blob is None:
                continue
            cgh = clone_gh(head, clone["id"])
            txn.touch(cid, cgh)
            txn.write(cid, cgh, 0, blob["data"].encode("latin1"))
            if blob["attrs"]:
                txn.setattrs(cid, cgh,
                             {k: v.encode("latin1")
                              for k, v in blob["attrs"].items()})
            for s in clone["snaps"]:
                sm[sm_key(s, head.name)] = b"1"
        if sm:
            txn.omap_setkeys(cid, pgmeta, sm)
    if len(txn):
        store.queue_transaction(txn)


def snapmapper_objects(store: ObjectStore, cid: CollectionId,
                       pgmeta: Ghobject, snapid: int) -> list[str]:
    """Object names with a clone covering `snapid` (SnapMapper
    get_next_objects_to_trim): a prefix scan of the pgmeta omap."""
    prefix = f"{SM_PREFIX}{snapid:016x}|"
    try:
        omap = store.omap_get(cid, pgmeta)
    except StoreError:
        return []
    return sorted(k[len(prefix):] for k in omap if k.startswith(prefix))


def headless_snap_objects(store: ObjectStore,
                          cid: CollectionId) -> set[str]:
    """Names whose head is gone but snapshot state survives (these must
    still be recovered/backfilled and must not be swept as strays)."""
    heads, snapdirs = set(), set()
    for gh in store.collection_list(cid):
        if gh.snap == CEPH_NOSNAP:
            heads.add(gh.name)
        elif gh.snap == SNAPDIR_SNAP:
            snapdirs.add(gh.name)
    return snapdirs - heads
