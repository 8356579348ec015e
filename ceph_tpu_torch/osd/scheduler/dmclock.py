"""dmclock-analog tag clocks (src/osd/scheduler/mClockScheduler.h,
after Gulati's mClock / the dmClock distributed variant).

Every scheduling ENTITY — a client tenant, or a background class's
pseudo-entity — carries three virtual-time tags:

  r_tag  reservation clock: advances by cost/reservation per service.
         While r_tag <= now the entity is BEHIND its guaranteed rate
         and is served in the reservation phase (strict priority,
         earliest r_tag first).
  l_tag  limit clock: advances by cost/limit. While l_tag > now the
         entity is at its cap and is ineligible for weight-phase
         service (reservation phase ignores the limit: reservation <=
         limit is the operator's contract, and a guarantee that a cap
         could veto would be no guarantee).
  p_tag  proportional clock: advances by cost/weight. The weight phase
         serves the earliest p_tag among eligible entities — weighted
         fair queueing over the capacity reservations leave behind.

Tags advance as max(tag + cost/rate, now): an idle entity re-anchors
to `now` instead of banking credit, and EVERY service advances ALL
clocks — weight-phase service counts toward the reservation (the
dmclock R-tag adjustment), so a reservation is a floor, not a bonus.

Cost is byte-normalized: cost_of(nbytes) = 1 + nbytes/cost_per_io_bytes,
so a 256 KiB streamer pays ~5x a 4 KiB writer per op and cannot hide
behind op counts.

Overload admission (past saturation, chosen by osd_mclock_overload_policy):

  backpressure  entities at their limit are simply ineligible; when
                every queued entity is limit-blocked the queue sleeps
                until the earliest l_tag matures (deferred dequeue) —
                queue depth is bounded by arrival throttling upstream.
  shed          enqueue refuses (EAGAIN-style throttle reply) once an
                entity's queued depth passes osd_mclock_shed_queue_depth
                — the client's existing backoff path absorbs the retry.

The clock is injectable (`clock=`) so the interleave tier can drive the
arbitration with a deterministic counter and assert same seed => same
dequeue digest.

The port's copy of ceph_tpu/osd/scheduler/dmclock.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import time

from .profile import QosProfile, default_profile

#: entity-table cap: past this, idle zero-queue entities are culled
#: oldest-active-first (a 100k-client storm must not grow an unbounded
#: tag table; an evicted tenant just re-anchors at `now` on return)
MAX_ENTITIES = 1024


class _Entity:
    """One tenant's (or background class's) tag clocks + QoS ledger."""

    __slots__ = ("name", "klass", "reservation", "limit", "weight",
                 "r_tag", "l_tag", "p_tag", "queued", "shed",
                 "deferred", "deq_reservation", "deq_weight",
                 "cost_total", "last_active")

    def __init__(self, name: str, klass: str, now: float,
                 reservation: float, limit: float, weight: float):
        self.name = name
        self.klass = klass
        self.reservation = reservation
        self.limit = limit
        self.weight = weight
        self.r_tag = now
        self.l_tag = now
        self.p_tag = now
        self.queued = 0             # ops waiting in the shard queues
        self.shed = 0               # enqueues refused (shed policy)
        self.deferred = 0           # times this entity's limit deferred
        self.deq_reservation = 0    # dequeues served by reservation
        self.deq_weight = 0         # dequeues served by weight phase
        self.cost_total = 0.0       # cost units served
        self.last_active = now

    def to_dict(self) -> dict:
        return {"klass": self.klass,
                "reservation": self.reservation, "limit": self.limit,
                "weight": self.weight,
                "r_tag": round(self.r_tag, 6),
                "l_tag": round(self.l_tag, 6),
                "p_tag": round(self.p_tag, 6),
                "queued": self.queued, "shed": self.shed,
                "deferred": self.deferred,
                "dequeue_reservation": self.deq_reservation,
                "dequeue_weight": self.deq_weight,
                "cost": round(self.cost_total, 3)}


class MClockScheduler:
    """Tag-clock arbiter. Owns NO queues — ShardedOpQueue keeps the
    per-shard per-entity deques and the ordering windows; this object
    answers "in what order should entities be tried" (schedule), "may
    this op even enter" (note_enqueue / shed) and advances the clocks
    on each admission (charge)."""

    def __init__(self, profile: QosProfile | None = None,
                 clock=time.monotonic):
        self.profile = profile if profile is not None \
            else default_profile()
        self.clock = clock
        self._ents: dict[str, _Entity] = {}
        # client-entity defaults + per-tenant overrides (knobs)
        self.cost_per_io_bytes = 65536
        self.client_reservation = 0.0
        self.client_limit = 0.0
        self.client_weight = 1.0
        self.tenant_profiles: dict[str, dict] = {}
        self.overload_policy = "backpressure"
        self.shed_queue_depth = 256
        # global ledger (the daemon mirrors these into qos_* perf
        # counters; per-entity splits live on the entities)
        self.total_shed = 0
        self.total_deferred = 0

    # -- knobs ---------------------------------------------------------------

    def configure(self, *, cost_per_io_bytes=None,
                  client_reservation=None, client_limit=None,
                  client_weight=None, tenant_profiles=None,
                  overload_policy=None, shed_queue_depth=None,
                  class_params=None) -> None:
        """Apply knob values (config observer path) and re-resolve the
        parameters of every live entity — a hot limit change must bite
        on the next schedule() without waiting for entity churn."""
        if cost_per_io_bytes is not None:
            self.cost_per_io_bytes = max(1, int(cost_per_io_bytes))
        if client_reservation is not None:
            self.client_reservation = max(0.0, float(client_reservation))
        if client_limit is not None:
            self.client_limit = max(0.0, float(client_limit))
        if client_weight is not None:
            self.client_weight = max(0.0, float(client_weight))
        if tenant_profiles is not None:
            self.tenant_profiles = dict(tenant_profiles)
        if overload_policy in ("backpressure", "shed"):
            self.overload_policy = overload_policy
        if shed_queue_depth is not None:
            self.shed_queue_depth = max(1, int(shed_queue_depth))
        if class_params:
            for name, p in class_params.items():
                spec = self.profile.ensure(name)
                if "reservation" in p:
                    spec.reservation = max(0.0, float(p["reservation"]))
                if "limit" in p:
                    spec.limit = max(0.0, float(p["limit"]))
                if "weight" in p:
                    spec.weight = max(0.0, float(p["weight"]))
        for e in self._ents.values():
            e.reservation, e.limit, e.weight = \
                self._params_for(e.name, e.klass)

    def _params_for(self, entity: str,
                    klass: str) -> tuple[float, float, float]:
        if klass != "client":
            spec = self.profile.ensure(klass)
            return spec.reservation, spec.limit, spec.weight
        p = self.tenant_profiles.get(entity)
        if p:
            return (max(0.0, float(p.get("reservation",
                                         self.client_reservation))),
                    max(0.0, float(p.get("limit", self.client_limit))),
                    max(0.0, float(p.get("weight",
                                         self.client_weight))))
        return (self.client_reservation, self.client_limit,
                self.client_weight)

    def cost_of(self, nbytes: int) -> float:
        """Byte-normalized op cost: 1 IOP plus the payload's share of
        the per-IO byte budget."""
        return 1.0 + max(0, int(nbytes)) / self.cost_per_io_bytes

    # -- entity table --------------------------------------------------------

    def entity(self, name: str, klass: str) -> _Entity:
        e = self._ents.get(name)
        if e is None:
            if len(self._ents) >= MAX_ENTITIES:
                self._cull()
            now = self.clock()
            res, lim, wgt = self._params_for(name, klass)
            e = self._ents[name] = _Entity(name, klass, now,
                                           res, lim, wgt)
        return e

    def _cull(self) -> None:
        idle = sorted((e for e in self._ents.values() if e.queued == 0),
                      key=lambda e: e.last_active)
        for e in idle[:max(1, len(idle) // 2)]:
            del self._ents[e.name]

    # -- admission-side ------------------------------------------------------

    def note_enqueue(self, entity: str, klass: str) -> bool:
        """Called before an op enters a shard queue. Returns False to
        SHED it (policy `shed`, entity backlog past the depth cap) —
        background classes are never shed; their producers self-pace
        on completion and a refused recovery push would just stall
        recovery silently."""
        e = self.entity(entity, klass)
        if (self.overload_policy == "shed" and klass == "client"
                and e.queued >= self.shed_queue_depth):
            e.shed += 1
            self.total_shed += 1
            return False
        e.queued += 1
        return True

    def note_drop(self, entity: str) -> None:
        """An enqueued op left the queues without service (migration
        loss paths); keeps the shed depth gauge honest."""
        e = self._ents.get(entity)
        if e is not None and e.queued > 0:
            e.queued -= 1

    # -- scheduling ----------------------------------------------------------

    def schedule(self, ready) -> tuple[list, float | None, str | None]:
        """Arbitrate over `ready` (entity names with queued work the
        queue could try). Returns (order, defer_s, defer_entity):

        order: (entity, phase) pairs to try in sequence — reservation
        phase first (entities behind their guarantee, earliest r_tag),
        then weight phase (limit-eligible entities, earliest p_tag).
        The queue tries each in turn because an entity's head may be
        window-blocked; ties break on entity name so the arbitration
        is schedule-deterministic under an injected clock.

        defer_s/defer_entity: set only when order is empty but work is
        queued — every entity is limit-blocked; defer_s is the time
        until the earliest l_tag matures (the backpressure sleep)."""
        now = self.clock()
        ents = [self.entity(name, "client") if name not in self._ents
                else self._ents[name] for name in ready]
        order: list[tuple[str, str]] = []
        seen: set[str] = set()
        rphase = sorted((e for e in ents
                         if e.reservation > 0.0 and e.r_tag <= now),
                        key=lambda e: (e.r_tag, e.name))
        for e in rphase:
            order.append((e.name, "reservation"))
            seen.add(e.name)
        wphase = sorted((e for e in ents if e.name not in seen
                         and (e.limit <= 0.0 or e.l_tag <= now)),
                        key=lambda e: (e.p_tag, e.name))
        for e in wphase:
            order.append((e.name, "weight"))
        if order or not ents:
            return order, None, None
        blocker = min(ents, key=lambda e: (e.l_tag, e.name))
        blocker.deferred += 1
        self.total_deferred += 1
        return [], max(0.001, blocker.l_tag - now), blocker.name

    def charge(self, entity: str, cost: float,
               phase: str = "weight") -> None:
        """One op of `entity` admitted for execution: advance all three
        clocks by its cost (service counts toward reservation AND
        limit AND proportional share regardless of which phase won)."""
        e = self._ents.get(entity)
        if e is None:
            return
        now = self.clock()
        if e.reservation > 0.0:
            e.r_tag = max(e.r_tag + cost / e.reservation, now)
        if e.limit > 0.0:
            e.l_tag = max(e.l_tag + cost / e.limit, now)
        if e.weight > 0.0:
            e.p_tag = max(e.p_tag + cost / e.weight, now)
        if e.queued > 0:
            e.queued -= 1
        if phase == "reservation":
            e.deq_reservation += 1
        else:
            e.deq_weight += 1
        e.cost_total += cost
        e.last_active = now

    # -- introspection -------------------------------------------------------

    def status(self) -> dict:
        """Admin-socket `qos status` body: knobs in force + every live
        entity's tag clocks and ledger."""
        return {"cost_per_io_bytes": self.cost_per_io_bytes,
                "client_reservation": self.client_reservation,
                "client_limit": self.client_limit,
                "client_weight": self.client_weight,
                "tenant_profiles": dict(self.tenant_profiles),
                "overload_policy": self.overload_policy,
                "shed_queue_depth": self.shed_queue_depth,
                "total_shed": self.total_shed,
                "total_deferred": self.total_deferred,
                "now": round(self.clock(), 6),
                "classes": self.profile.to_dict(),
                "entities": {name: e.to_dict() for name, e
                             in sorted(self._ents.items())}}

    def tenant_metrics(self) -> dict:
        """Per-entity qos ledger for the MgrReport leg (absolute
        counters; the mgr stores latest-wins per daemon)."""
        return {name: {"shed": e.shed, "deferred": e.deferred,
                       "dequeue_reservation": e.deq_reservation,
                       "dequeue_weight": e.deq_weight,
                       "queued": e.queued,
                       "cost": round(e.cost_total, 3)}
                for name, e in self._ents.items()
                if e.cost_total > 0 or e.shed or e.queued}

    def tag_columns(self, entity: str) -> dict:
        """dump_clients merge: the live QoS tag columns of one tenant
        (empty when the tenant has no tag state yet)."""
        e = self._ents.get(entity)
        if e is None:
            return {}
        return {"qos_r_tag": round(e.r_tag, 6),
                "qos_l_tag": round(e.l_tag, 6),
                "qos_p_tag": round(e.p_tag, 6),
                "qos_queued": e.queued, "qos_shed": e.shed}
