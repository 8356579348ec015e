"""OSD op scheduling (src/osd/scheduler/): class registration profile
and the dmclock-analog tag-clock arbiter.

The package mirrors the reference's scheduler split: `profile` declares
the op classes (what used to be the hardcoded `ShardedOpQueue.WEIGHTS`)
and their default QoS parameters; `dmclock` holds the tag math —
per-entity reservation/limit/weight clocks plus overload admission
(shed / backpressure). `ShardedOpQueue` stays the owner of queues,
ordering windows and workers; it consults the scheduler only for
"which entity next" and "may this op even enter".

The port's copy of ceph_tpu/osd/scheduler/__init__.py (jax-free; the port imports
nothing of the JAX package).
"""
from .profile import ClassSpec, QosProfile, default_profile
from .dmclock import MClockScheduler

__all__ = ["ClassSpec", "QosProfile", "default_profile",
           "MClockScheduler"]
