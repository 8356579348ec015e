"""Object classes: server-side methods executed inside the OSD.

Re-creation of the reference cls framework (src/objclass/objclass.h
cls_register / cls_register_cxx_method; src/osd/ClassHandler.{h,cc}
loads class plugins and PrimaryLogPG::do_osd_ops dispatches
CEPH_OSD_OP_CALL to them). RBD, RGW, and CephFS push their metadata
logic server-side through exactly this hook in the reference
(src/cls/: rbd, lock, refcount, ...).

A class method runs ON THE PRIMARY with a handle exposing reads and
writes of the target object; writes performed by the method are
replicated through the normal backend fan-out (one log entry for the
whole call, like the reference wrapping the generated txn).

The port's copy of ceph_tpu/cls/__init__.py (jax-free; the port imports
nothing of the JAX package).
"""
from ceph_tpu_torch.cls.registry import (ClassCallError, ClassHandler,
                                         MethodContext, cls_method, cls_register)
# built-in classes register on package import (the reference preloads
# every cls_*.so at OSD start via ClassHandler::open_all_classes)
import ceph_tpu_torch.cls.lock  # noqa: E402,F401

__all__ = ["ClassHandler", "MethodContext", "ClassCallError",
           "cls_register", "cls_method"]
