"""OSDMap: epoch-versioned cluster map driving placement.

Re-creation of the reference's OSDMap essentials (src/osd/OSDMap.{h,cc}):
osd up/down + in/out states and reweights, pools (replicated or erasure,
pg_num, size/min_size, crush rule, EC profile name), and the placement
pipeline `pg_to_up_acting_osds` (:2923) = raw CRUSH mapping (:2670
`_pg_to_raw_osds`: x = stable_mod seed, crush.do_rule with the reweight
vector) + pg_temp overrides. Epochs advance through `Incremental` deltas
(`apply_incremental`) so daemons converge on identical maps from any
starting epoch; full-map encode/decode exists for bootstrap.

The port's copy of ceph_tpu/crush/osdmap.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable

from ceph_tpu_torch.crush.crush import CRUSH_NONE, CrushMap


def stable_mod(x: int, b: int, bmask: int) -> int:
    """OSDMap::calc_pg_masks stable modulo: pgid -> [0, pg_num) staying
    stable as pg_num grows through powers of two (src/osd/osd_types.h)."""
    if (x & bmask) < b:
        return x & bmask
    return x & (bmask >> 1)


def _pg_seed(pool: int, ps: int) -> int:
    # placement seed fed to CRUSH; pool mixed in so pools diverge
    from ceph_tpu_torch.crush.crush import _mix
    return _mix(0x2A, pool, ps) & 0x7FFFFFFF


@dataclasses.dataclass(frozen=True, order=True)
class PG:
    pool: int
    ps: int

    def __str__(self) -> str:
        return f"{self.pool}.{self.ps:x}"


@dataclasses.dataclass
class Pool:
    id: int
    name: str
    type: str = "replicated"          # replicated | erasure
    size: int = 3
    min_size: int = 2
    pg_num: int = 32
    crush_rule: int = 0
    ec_profile: str = ""
    stripe_width: int = 0
    # snapshots (pg_pool_t snap_seq/snaps/removed_snaps): snap ids are
    # allocated from snap_seq; pool_snaps names the pool-level ones
    # (str keys: the record round-trips through JSON); removed ids are
    # what OSD snaptrim consumes
    snap_seq: int = 0
    pool_snaps: dict = dataclasses.field(default_factory=dict)
    removed_snaps: list = dataclasses.field(default_factory=list)

    def pg_mask(self) -> int:
        return (1 << (self.pg_num - 1).bit_length()) - 1 if self.pg_num else 0

    def raw_pg_to_pg(self, ps: int) -> int:
        return stable_mod(ps, self.pg_num, self.pg_mask())


@dataclasses.dataclass
class OsdState:
    up: bool = False
    in_cluster: bool = True
    weight: float = 1.0               # reweight in [0,1]
    addr: str = ""


@dataclasses.dataclass
class Incremental:
    """Delta between OSDMap epoch-1 and epoch (OSDMap::Incremental,
    src/osd/OSDMap.h): daemons at any older epoch apply the chain of
    incrementals the monitor publishes and converge on an identical map
    without refetching the full map each time.

    Fields left at their sentinel are "no change". new_pools carries full
    Pool records (pool mutations are rare and small); new_pg_temp maps a
    PG to its override list, [] meaning "erase the override".
    """
    epoch: int = 0                               # the epoch this produces
    new_up: dict[int, str] = dataclasses.field(default_factory=dict)
    # osd -> addr of the newly-up daemon
    new_down: list[int] = dataclasses.field(default_factory=list)
    new_in: list[int] = dataclasses.field(default_factory=list)
    new_out: list[int] = dataclasses.field(default_factory=list)
    new_weights: dict[int, float] = dataclasses.field(default_factory=dict)
    new_osds: dict[int, str] = dataclasses.field(default_factory=dict)
    new_pools: dict[int, Pool] = dataclasses.field(default_factory=dict)
    new_pg_temp: dict[PG, list[int]] = dataclasses.field(default_factory=dict)
    # full crush dump when the hierarchy changed (the reference also ships
    # a whole crush blob in Incremental::crush, OSDMap.h) and new/updated
    # EC profiles (profiles are cluster state living in the OSDMap)
    new_crush: dict | None = None
    new_ec_profiles: dict[str, dict] = dataclasses.field(default_factory=dict)

    def empty(self) -> bool:
        return not (self.new_up or self.new_down or self.new_in
                    or self.new_out or self.new_weights or self.new_osds
                    or self.new_pools or self.new_pg_temp
                    or self.new_crush or self.new_ec_profiles)

    def to_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "new_up": {str(o): a for o, a in self.new_up.items()},
            "new_down": self.new_down,
            "new_in": self.new_in,
            "new_out": self.new_out,
            "new_weights": {str(o): w for o, w in self.new_weights.items()},
            "new_osds": {str(o): a for o, a in self.new_osds.items()},
            "new_pools": {str(p): dataclasses.asdict(pool)
                          for p, pool in self.new_pools.items()},
            "new_pg_temp": {str(pg): osds
                            for pg, osds in self.new_pg_temp.items()},
            "new_crush": self.new_crush,
            "new_ec_profiles": self.new_ec_profiles,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Incremental":
        inc = cls(epoch=d["epoch"])
        inc.new_up = {int(o): a for o, a in d.get("new_up", {}).items()}
        inc.new_down = list(d.get("new_down", []))
        inc.new_in = list(d.get("new_in", []))
        inc.new_out = list(d.get("new_out", []))
        inc.new_weights = {int(o): w
                           for o, w in d.get("new_weights", {}).items()}
        inc.new_osds = {int(o): a for o, a in d.get("new_osds", {}).items()}
        inc.new_pools = {int(p): Pool(**pool)
                         for p, pool in d.get("new_pools", {}).items()}
        for key, osds in d.get("new_pg_temp", {}).items():
            pool_s, ps_s = key.split(".")
            inc.new_pg_temp[PG(int(pool_s), int(ps_s, 16))] = list(osds)
        inc.new_crush = d.get("new_crush")
        inc.new_ec_profiles = dict(d.get("new_ec_profiles", {}))
        return inc


class OSDMap:
    def __init__(self, crush: CrushMap | None = None):
        self.epoch = 0
        self.crush = crush or CrushMap()
        self.osds: dict[int, OsdState] = {}
        self.pools: dict[int, Pool] = {}
        self.pool_names: dict[str, int] = {}
        self.pg_temp: dict[PG, list[int]] = {}
        self.ec_profiles: dict[str, dict] = {}
        # raw-placement memo: the full straw2 walk per op showed up as
        # ~7% of a busy OSD loop (every client submit and every sub-op
        # handler recomputes its PG's mapping). Raw placement depends
        # only on the crush map + pool defs + weight vector — all of
        # which change with the epoch or through the explicit mutators
        # below, each of which drops the memo. Up/down state is NOT
        # part of raw placement (pg_to_up_acting filters it per call),
        # so mark-downs stay visible instantly with a warm memo.
        self._raw_memo: dict[PG, list[int]] = {}
        self._raw_memo_epoch = -1

    def _placement_changed(self) -> None:
        """Drop the raw-placement memo (weights/pools/crush mutated)."""
        self._raw_memo.clear()
        self._raw_memo_epoch = self.epoch

    # -- membership ----------------------------------------------------------

    def add_osd(self, osd: int, addr: str = "") -> None:
        self.osds[osd] = OsdState(addr=addr)
        self._placement_changed()

    def set_up(self, osd: int, up: bool, addr: str | None = None) -> None:
        state = self.osds[osd]
        state.up = up
        if addr is not None:
            state.addr = addr

    def set_in(self, osd: int, in_cluster: bool) -> None:
        self.osds[osd].in_cluster = in_cluster
        self._placement_changed()

    def reweight(self, osd: int, weight: float) -> None:
        self.osds[osd].weight = max(0.0, min(1.0, weight))
        self._placement_changed()

    def is_up(self, osd: int) -> bool:
        return osd in self.osds and self.osds[osd].up

    def get_addr(self, osd: int) -> str:
        return self.osds[osd].addr

    # -- pools ---------------------------------------------------------------

    def create_pool(self, name: str, **kwargs) -> Pool:
        if name in self.pool_names:
            raise ValueError(f"pool {name!r} exists")
        pid = max(self.pools, default=0) + 1
        pool = Pool(id=pid, name=name, **kwargs)
        self.pools[pid] = pool
        self.pool_names[name] = pid
        self._placement_changed()
        return pool

    def get_pool(self, ref: int | str) -> Pool:
        pid = self.pool_names[ref] if isinstance(ref, str) else ref
        return self.pools[pid]

    # -- placement -----------------------------------------------------------

    def object_to_pg(self, pool_ref: int | str, name: str) -> PG:
        from ceph_tpu_torch.crush.crush import _mix
        pool = self.get_pool(pool_ref)
        raw_ps = _mix(0x5F, *name.encode()) & 0x7FFFFFFF
        return PG(pool.id, pool.raw_pg_to_pg(raw_ps))

    def _weights(self) -> dict[int, float]:
        """CRUSH weight vector: out or missing osds weigh 0."""
        return {osd: (s.weight if s.in_cluster else 0.0)
                for osd, s in self.osds.items()}

    def pg_to_raw_osds(self, pg: PG) -> list[int]:
        if self._raw_memo_epoch != self.epoch:
            # epoch moved (incrementals, load_dict, mon commits): any
            # of crush/pools/weights may have changed with it
            self._raw_memo.clear()
            self._raw_memo_epoch = self.epoch
        raw = self._raw_memo.get(pg)
        if raw is None:
            pool = self.pools[pg.pool]
            x = _pg_seed(pg.pool, pg.ps)
            raw = self._raw_memo[pg] = self.crush.do_rule(
                pool.crush_rule, x, pool.size, self._weights())
        return raw

    def pg_to_up_acting_osds(self, pg: PG) -> tuple[list[int], list[int]]:
        """(up, acting): raw mapping with down osds removed (holes stay for
        EC pools), then pg_temp overrides acting (OSDMap.cc:2923)."""
        pool = self.pools[pg.pool]
        raw = self.pg_to_raw_osds(pg)
        if pool.type == "erasure":
            up = [o if o != CRUSH_NONE and self.is_up(o) else CRUSH_NONE
                  for o in raw]
        else:
            up = [o for o in raw if o != CRUSH_NONE and self.is_up(o)]
        acting = self.pg_temp.get(pg, up)
        return up, acting

    def primary(self, pg: PG) -> int:
        _, acting = self.pg_to_up_acting_osds(pg)
        for osd in acting:
            if osd != CRUSH_NONE:
                return osd
        return CRUSH_NONE

    # -- epochs --------------------------------------------------------------

    def inc_epoch(self) -> int:
        self.epoch += 1
        return self.epoch

    def apply_incremental(self, inc: Incremental) -> None:
        """Advance this map by one epoch delta (OSDMap::apply_incremental,
        src/osd/OSDMap.cc). Raises if the delta isn't for epoch+1 —
        callers must fetch intervening incrementals (or a full map) first.
        """
        if inc.epoch != self.epoch + 1:
            raise ValueError(
                f"incremental for epoch {inc.epoch} cannot apply to "
                f"map at epoch {self.epoch}")
        for osd, addr in inc.new_osds.items():
            if osd not in self.osds:
                self.add_osd(osd, addr=addr)
        for osd, addr in inc.new_up.items():
            self.set_up(osd, True, addr=addr)
        for osd in inc.new_down:
            self.set_up(osd, False)
        for osd in inc.new_in:
            self.set_in(osd, True)
        for osd in inc.new_out:
            self.set_in(osd, False)
        for osd, w in inc.new_weights.items():
            self.reweight(osd, w)
        if inc.new_pools:
            self.pools.update(inc.new_pools)
            # rebuild rather than insert: a renamed pool must drop its old
            # name or incremental-appliers diverge from full-map bootstrap
            self.pool_names = {pool.name: pid
                               for pid, pool in self.pools.items()}
        for pg, osds in inc.new_pg_temp.items():
            if osds:
                self.pg_temp[pg] = list(osds)
            else:
                self.pg_temp.pop(pg, None)
        if inc.new_crush is not None:
            self.crush = CrushMap.from_dict(inc.new_crush)
        self.ec_profiles.update(inc.new_ec_profiles)
        self.epoch = inc.epoch

    # -- encode/decode (wire form for map distribution) ----------------------

    def to_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "osds": {str(o): dataclasses.asdict(s)
                     for o, s in self.osds.items()},
            "pools": {str(p): dataclasses.asdict(pool)
                      for p, pool in self.pools.items()},
            "pg_temp": {str(pg): osds for pg, osds in self.pg_temp.items()},
            "crush": self.crush.to_dict(),
            "ec_profiles": self.ec_profiles,
        }

    def dumps(self) -> bytes:
        return json.dumps(self.to_dict(), sort_keys=True).encode()

    def load_dict(self, d: dict) -> None:
        self.epoch = d["epoch"]
        self.osds = {int(o): OsdState(**s) for o, s in d["osds"].items()}
        self.pools = {int(p): Pool(**pool) for p, pool in d["pools"].items()}
        self.pool_names = {pool.name: pid for pid, pool in self.pools.items()}
        self.pg_temp = {}
        for key, osds in d.get("pg_temp", {}).items():
            pool_s, ps_s = key.split(".")
            self.pg_temp[PG(int(pool_s), int(ps_s, 16))] = osds
        if d.get("crush") is not None:
            self.crush = CrushMap.from_dict(d["crush"])
        self.ec_profiles = dict(d.get("ec_profiles", {}))


def apply_map_payload(osdmap: "OSDMap", payload: dict) -> bool:
    """Apply a mon osdmap-subscription payload (full map and/or
    incremental chain) to `osdmap` in place; returns True if the epoch
    advanced. Shared by every map consumer (client/mgr/...) so the
    update protocol lives in ONE place."""
    import json as _json
    before = osdmap.epoch
    full = payload.get("full")
    if full is not None and full["epoch"] > osdmap.epoch:
        osdmap.load_dict(full)
    for raw in payload.get("incrementals", []):
        inc = Incremental.from_dict(
            _json.loads(raw) if isinstance(raw, str) else raw)
        if inc.epoch == osdmap.epoch + 1:
            osdmap.apply_incremental(inc)
    return osdmap.epoch > before
