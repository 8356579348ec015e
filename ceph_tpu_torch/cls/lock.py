"""cls `lock`: advisory object locking, the reference's most-used
object class (src/cls/lock/cls_lock.cc: lock/unlock/break_lock/
get_info; librbd serializes exclusive-lock ownership through it).

Lockers live in the object's omap under `lock.<name>` as JSON
{cookie, locker}; only exclusive locks in v1.

The port's copy of ceph_tpu/cls/lock.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import json

from ceph_tpu_torch.cls.registry import (CLS_METHOD_RD, CLS_METHOD_WR,
                                         ClassCallError, MethodContext,
                                         cls_method, cls_register)

cls_register("lock")


def _key(name: str) -> str:
    return f"lock.{name}"


def _holder(ctx: MethodContext, name: str) -> dict | None:
    raw = ctx.omap_get().get(_key(name))
    return json.loads(raw) if raw else None


@cls_method("lock", "lock", CLS_METHOD_RD | CLS_METHOD_WR)
async def lock(ctx: MethodContext, indata: bytes) -> bytes:
    req = json.loads(indata)
    name, cookie = req["name"], req["cookie"]
    cur = _holder(ctx, name)
    if cur is not None:
        if cur["cookie"] == cookie and cur["locker"] == req.get("locker"):
            return b"{}"            # re-lock by the same owner: idempotent
        raise ClassCallError(-16, f"EBUSY: {name} held by "
                                  f"{cur['locker']}/{cur['cookie']}")
    if not await ctx.exists():
        ctx.write_full(b"")         # lock implicitly creates (reference)
    ctx.omap_set({_key(name): json.dumps(
        {"cookie": cookie, "locker": req.get("locker", "")}).encode()})
    return b"{}"


@cls_method("lock", "unlock", CLS_METHOD_RD | CLS_METHOD_WR)
async def unlock(ctx: MethodContext, indata: bytes) -> bytes:
    req = json.loads(indata)
    name, cookie = req["name"], req["cookie"]
    cur = _holder(ctx, name)
    if cur is None:
        raise ClassCallError(-2, f"ENOENT: lock {name} not held")
    if cur["cookie"] != cookie:
        raise ClassCallError(-16, f"EBUSY: wrong cookie for {name}")
    ctx.omap_set({_key(name): b""})     # tombstone (empty = free)
    return b"{}"


@cls_method("lock", "break_lock", CLS_METHOD_RD | CLS_METHOD_WR)
async def break_lock(ctx: MethodContext, indata: bytes) -> bytes:
    req = json.loads(indata)
    cur = _holder(ctx, req["name"])
    if cur is None:
        raise ClassCallError(-2, f"ENOENT: lock {req['name']} not held")
    ctx.omap_set({_key(req["name"]): b""})
    return b"{}"


@cls_method("lock", "get_info", CLS_METHOD_RD)
async def get_info(ctx: MethodContext, indata: bytes) -> bytes:
    req = json.loads(indata)
    cur = _holder(ctx, req["name"])
    return json.dumps({"locker": cur}).encode()
