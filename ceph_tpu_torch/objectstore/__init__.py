"""Local object stores: ObjectStore API, MemStore (test double),
FileStore (WAL + crc-verified blobs + checkpointed meta), and BlueStore
(block file + bitmap allocator + KeyValueDB metadata + per-extent crc).

The port's copy of ceph_tpu/objectstore/__init__.py (jax-free; the port imports
nothing of the JAX package).
"""
from ceph_tpu_torch.objectstore.types import Ghobject, CollectionId
from ceph_tpu_torch.objectstore.store import (ObjectStore, StoreError,
                                              Transaction, NO_SHARD)
from ceph_tpu_torch.objectstore.memstore import MemStore
from ceph_tpu_torch.objectstore.filestore import FileStore, SimulatedCrash
from ceph_tpu_torch.objectstore.bluestore import BlueStore

__all__ = ["Ghobject", "CollectionId", "ObjectStore", "StoreError",
           "Transaction", "MemStore", "FileStore", "BlueStore",
           "SimulatedCrash", "NO_SHARD"]
