"""Object/collection identity types.

Re-creation of the reference's ghobject_t / coll_t
(src/common/hobject.h, src/osd/osd_types.h): an object id carries pool,
namespace, name, snapshot, a placement hash, plus the EC **shard id** and
a generation used for rollback — the pieces ECBackend needs to store k+m
shards of one logical object side by side.

The port's copy of ceph_tpu/objectstore/types.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import dataclasses

NO_SHARD = -1       # shard_id_t::NO_SHARD
NO_GEN = 2 ** 64 - 1  # ghobject_t::NO_GEN
CEPH_NOSNAP = 2 ** 64 - 2


@dataclasses.dataclass(frozen=True, order=True)
class Ghobject:
    """Sortable object identity (ghobject_t)."""

    pool: int = 0
    nspace: str = ""
    name: str = ""
    snap: int = CEPH_NOSNAP
    gen: int = NO_GEN
    shard: int = NO_SHARD

    def with_shard(self, shard: int) -> "Ghobject":
        return dataclasses.replace(self, shard=shard)

    def with_gen(self, gen: int) -> "Ghobject":
        return dataclasses.replace(self, gen=gen)

    def head(self) -> "Ghobject":
        return dataclasses.replace(self, snap=CEPH_NOSNAP)

    def __str__(self) -> str:
        parts = [f"{self.pool}", self.nspace, self.name]
        if self.snap != CEPH_NOSNAP:
            parts.append(f"snap{self.snap}")
        if self.gen != NO_GEN:
            parts.append(f"gen{self.gen}")
        if self.shard != NO_SHARD:
            parts.append(f"s{self.shard}")
        return ":".join(parts)


def cid_key(cid: "CollectionId") -> list:
    """JSON-stable identity list (shared by FileStore/BlueStore key
    encodings — one codec so the stores can never disagree)."""
    return [cid.pool, cid.pg_seed, cid.shard, cid.meta]


def cid_from(key: list) -> "CollectionId":
    return CollectionId(pool=key[0], pg_seed=key[1], shard=key[2],
                        meta=key[3])


def oid_key(oid: Ghobject) -> list:
    return [oid.pool, oid.nspace, oid.name, oid.snap, oid.gen, oid.shard]


def oid_from(key: list) -> Ghobject:
    return Ghobject(pool=key[0], nspace=key[1], name=key[2], snap=key[3],
                    gen=key[4], shard=key[5])


@dataclasses.dataclass(frozen=True, order=True)
class CollectionId:
    """Collection identity (coll_t): a PG shard or the meta collection."""

    pool: int = -1
    pg_seed: int = 0
    shard: int = NO_SHARD
    meta: bool = False

    @classmethod
    def make_meta(cls) -> "CollectionId":
        return cls(meta=True)

    @classmethod
    def make_pg(cls, pool: int, pg_seed: int,
                shard: int = NO_SHARD) -> "CollectionId":
        return cls(pool=pool, pg_seed=pg_seed, shard=shard)

    def __str__(self) -> str:
        if self.meta:
            return "meta"
        s = f"{self.pool}.{self.pg_seed:x}"
        return s if self.shard == NO_SHARD else f"{s}s{self.shard}"
