"""Class registry + method execution context.

Reference shape: `cls_register("lock", &h)` then
`cls_register_cxx_method(h, "lock", CLS_METHOD_RD|CLS_METHOD_WR, fn)`
(src/objclass/objclass.h); the OSD's ClassHandler resolves
(class, method) at CALL time (src/osd/ClassHandler.cc).

Methods are async callables `fn(ctx, indata: bytes) -> bytes`; `ctx`
(MethodContext) exposes object reads and STAGED writes — mutations are
collected and applied as ONE backend write after the method returns,
so a class call is atomic and replicated like any other op.

The port's copy of ceph_tpu/cls/registry.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

from typing import Awaitable, Callable

CLS_METHOD_RD = 1
CLS_METHOD_WR = 2


class ClassCallError(Exception):
    def __init__(self, rc: int, message: str):
        super().__init__(message)
        self.rc = rc


class _Method:
    def __init__(self, name: str, flags: int, fn):
        self.name = name
        self.flags = flags
        self.fn = fn


class ClassHandler:
    """Process-wide (class, method) registry (ClassHandler.h)."""

    _classes: dict[str, dict[str, _Method]] = {}

    @classmethod
    def register(cls, class_name: str) -> None:
        cls._classes.setdefault(class_name, {})

    @classmethod
    def register_method(cls, class_name: str, method: str, flags: int,
                        fn) -> None:
        cls.register(class_name)
        cls._classes[class_name][method] = _Method(method, flags, fn)

    @classmethod
    def resolve(cls, class_name: str, method: str) -> _Method:
        methods = cls._classes.get(class_name)
        if methods is None:
            raise ClassCallError(-95, f"no class {class_name!r}")
        m = methods.get(method)
        if m is None:
            raise ClassCallError(-95,
                                 f"no method {class_name}.{method}")
        return m


def cls_register(class_name: str) -> None:
    ClassHandler.register(class_name)


def cls_method(class_name: str, method: str, flags: int = CLS_METHOD_RD):
    """Decorator: register an async method on a class."""
    def wrap(fn: Callable[["MethodContext", bytes], Awaitable[bytes]]):
        ClassHandler.register_method(class_name, method, flags, fn)
        return fn
    return wrap


class MethodContext:
    """What a class method may do to its target object (cls_cxx_read /
    cls_cxx_write_full / map ops in the reference). Writes are staged;
    the PG applies them atomically after the method returns."""

    def __init__(self, pg, oid: str):
        self.pg = pg
        self.oid = oid
        # staged mutation: None, or ("write_full", bytes) / ("delete",)
        self.staged: tuple | None = None
        self._staged_xattrs: dict[str, bytes] = {}
        self._staged_omap: dict[str, bytes] = {}

    # -- reads ---------------------------------------------------------------

    async def read(self, offset: int = 0, length: int = 0) -> bytes:
        if self.staged and self.staged[0] == "write_full":
            data = self.staged[1]
            end = len(data) if length <= 0 else offset + length
            return data[offset:end]
        if self.staged and self.staged[0] == "delete":
            raise ClassCallError(-2, "ENOENT (deleted in this call)")
        try:
            return await self.pg.backend.execute_read(
                self.oid, offset, length)
        except Exception:
            raise ClassCallError(-2, f"ENOENT: {self.oid}")

    async def exists(self) -> bool:
        if self.staged:
            return self.staged[0] != "delete"
        return await self.pg.backend.object_exists(self.oid)

    def getxattr(self, name: str) -> bytes | None:
        if name in self._staged_xattrs:
            return self._staged_xattrs[name]
        from ceph_tpu_torch.objectstore.store import StoreError
        try:
            return self.pg.host.store.getattr(
                self.pg.backend.coll(), self.pg.backend.ghobject(self.oid),
                "u:" + name)
        except StoreError:
            return None

    def omap_get(self) -> dict[str, bytes]:
        from ceph_tpu_torch.objectstore.store import StoreError
        try:
            cur = self.pg.host.store.omap_get(
                self.pg.backend.coll(),
                self.pg.backend.ghobject(self.oid))
        except StoreError:
            cur = {}
        cur.update(self._staged_omap)
        return cur

    # -- staged writes -------------------------------------------------------

    def write_full(self, data: bytes) -> None:
        self.staged = ("write_full", bytes(data))

    def delete(self) -> None:
        self.staged = ("delete",)

    def setxattr(self, name: str, value: bytes) -> None:
        self._staged_xattrs[name] = bytes(value)

    def omap_set(self, kv: dict[str, bytes]) -> None:
        self._staged_omap.update({k: bytes(v) for k, v in kv.items()})

    @property
    def has_writes(self) -> bool:
        return bool(self.staged or self._staged_xattrs
                    or self._staged_omap)
