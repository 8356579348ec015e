"""KeyValueDB layer (src/kv/): engine contract + MemDB + LSMStore.

The port's copy of ceph_tpu/kv/__init__.py (jax-free; the port imports
nothing of the JAX package).
"""
from ceph_tpu_torch.kv.keyvaluedb import KeyValueDB, KVTransaction, MemDB
from ceph_tpu_torch.kv.lsm import LSMStore, SimulatedCrash as KVSimulatedCrash

__all__ = ["KeyValueDB", "KVTransaction", "MemDB", "LSMStore",
           "KVSimulatedCrash"]
