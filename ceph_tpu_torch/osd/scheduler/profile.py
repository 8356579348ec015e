"""Op-class registration profile (src/osd/scheduler/OpSchedulerItem.h
op_scheduler_class + mClock profile defaults).

Classes are DECLARED here, not hardcoded in the queue: each ClassSpec
carries both the legacy WRR weight (the scheduler-off arbitration) and
the dmclock parameters its pseudo-entity runs with when the scheduler
is on. Background classes (recovery, scrub, snaptrim) are queue-side
entities — they arbitrate against client tenants under the same tag
clocks, which is exactly how a reservation guarantees background
progress without letting it starve clients.

The port's copy of ceph_tpu/osd/scheduler/profile.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations


class ClassSpec:
    """One declared op class.

    wrr: dequeues per round under the legacy weighted-round-robin path
    (scheduler off). reservation/limit/weight: dmclock parameters of
    the class pseudo-entity (background classes) — client-class ops are
    tagged per TENANT instead, from the osd_mclock_client_* knobs, so
    the client spec's QoS fields are only the fallback defaults.
    Rates are in cost units/second where one cost unit is a small op
    (byte-normalized; see MClockScheduler.cost_of)."""

    __slots__ = ("name", "wrr", "reservation", "limit", "weight",
                 "background")

    def __init__(self, name: str, wrr: int = 1,
                 reservation: float = 0.0, limit: float = 0.0,
                 weight: float = 1.0, background: bool = False):
        self.name = name
        self.wrr = max(1, int(wrr))
        self.reservation = float(reservation)
        self.limit = float(limit)
        self.weight = float(weight)
        self.background = background

    def to_dict(self) -> dict:
        return {"name": self.name, "wrr": self.wrr,
                "reservation": self.reservation, "limit": self.limit,
                "weight": self.weight, "background": self.background}


class QosProfile:
    """Ordered registry of op classes. Declaration order IS the legacy
    WRR scan order (dict insertion order), so the default profile must
    list `client` first to keep the historical interleave."""

    def __init__(self, classes):
        self.classes: dict[str, ClassSpec] = {}
        for c in classes:
            self.classes[c.name] = c

    def spec(self, name: str) -> ClassSpec:
        return self.classes[name]

    def ensure(self, name: str) -> ClassSpec:
        """Late registration for a class no profile declared: it gets
        wrr=1 best-effort background defaults rather than a KeyError —
        producers declare intent by enqueueing, the profile only
        refuses to hardcode."""
        c = self.classes.get(name)
        if c is None:
            c = self.classes[name] = ClassSpec(name, wrr=1,
                                               background=True)
        return c

    def wrr_weights(self) -> dict[str, int]:
        return {c.name: c.wrr for c in self.classes.values()}

    def to_dict(self) -> dict:
        return {name: c.to_dict() for name, c in self.classes.items()}


def default_profile() -> QosProfile:
    """The stock OSD profile: client traffic at the historical 4:1 WRR
    edge over the background classes; under dmclock, recovery's
    pseudo-entity gets a small reservation (guaranteed progress while
    degraded) but only half a client tenant's weight (yields excess
    bandwidth). Scrub and snaptrim are DECLARED background customers —
    scrub's scan-chunk grant tokens and snaptrim's per-object trims
    enqueue under these specs, so they pace against client I/O with a
    guaranteed trickle instead of late-registering at best-effort
    wrr=1 defaults. Their reservations are deliberately small: integrity
    scanning and snap GC must keep moving, never compete."""
    return QosProfile([
        ClassSpec("client", wrr=4,
                  reservation=0.0, limit=0.0, weight=1.0),
        ClassSpec("recovery", wrr=1, background=True,
                  reservation=4.0, limit=0.0, weight=0.5),
        ClassSpec("scrub", wrr=1, background=True,
                  reservation=2.0, limit=0.0, weight=0.25),
        ClassSpec("snaptrim", wrr=1, background=True,
                  reservation=1.0, limit=0.0, weight=0.25),
    ])
