"""CRUSH placement (straw2 buckets + rule engine) and OSDMap.

The port's copy of ceph_tpu/crush/__init__.py (jax-free; the port imports
nothing of the JAX package).
"""
from ceph_tpu_torch.crush.crush import CrushMap, Bucket, Rule, Step, CRUSH_NONE
from ceph_tpu_torch.crush.osdmap import OSDMap, Pool, PG, Incremental

__all__ = ["CrushMap", "Bucket", "Rule", "Step", "CRUSH_NONE",
           "OSDMap", "Pool", "PG", "Incremental"]
