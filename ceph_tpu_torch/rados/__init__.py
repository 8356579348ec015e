"""Client library: librados-subset + Objecter-lite.

Reference: src/osdc/Objecter.cc (placement + resend-on-map-change),
src/librados/librados_c.cc (public API shape).

The port's copy of ceph_tpu/rados/__init__.py (jax-free; the port imports
nothing of the JAX package).
"""
from ceph_tpu_torch.rados.client import (IoCtx, ObjectNotFound, RadosClient,
                                         RadosError)
from ceph_tpu_torch.rados.aio import AioCompletion, AioDispatcher

__all__ = ["IoCtx", "ObjectNotFound", "RadosClient", "RadosError",
           "AioCompletion", "AioDispatcher"]
