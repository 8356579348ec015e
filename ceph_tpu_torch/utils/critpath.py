"""Critical-path attribution over assembled traces (tracing v2).

Given the spans of one trace — possibly gathered from several OS
processes by the mgr's TraceIndex — compute where the op's wall time
went, bucketed into the attribution-stage taxonomy:

    queue_wait / encode / h2d / kernel / d2h / commit / other

The invariant the acceptance tests hold us to: the stage sums equal
the root span's total, with `other` as the (non-negative) residual.
When the named claims exceed the total (parallel shards can each bank
queue time against one serial root), they are scaled down
proportionally so the identity still holds exactly.

Stage sources:
  * queue_wait — `queue_wait_us` tags (OSD op-queue) plus
    `offload_queue_wait` span durations (the batcher's linger).
  * h2d/kernel/d2h — the profiled splits on device-dispatch spans
    (`offload_batch`, `tpu_*_dispatch`) when `profile_dispatch` was
    on; an UNPROFILED dispatch attributes its whole duration to
    `kernel` (device wall time — the honest aggregate).
  * encode — EC compute spans (`ec_encode`/`ec_decode`/`ec_write`/
    `ec_recover`) minus the offload time nested inside them, plus the
    host staging copies (`copy_us`).
  * commit — the slowest `store_commit` (shards commit in parallel;
    the serial path waits for the slowest).
  * other — everything unnamed: messenger hops, PG bookkeeping,
    scheduling noise.

Also here: the serial critical-path walk (at every node, the child
that finished last is the one that gated completion) and the
waterfall row renderer for `trace get`.

The port's copy of ceph_tpu/utils/critpath.py (jax-free; the port
imports nothing of the JAX package). The dispatch span names keep the
reference's `tpu_` prefix on the port's `cuda` plugin, so traces of
either package bucket alike.
"""
from __future__ import annotations

from typing import Any

STAGES = ("queue_wait", "encode", "h2d", "kernel", "d2h", "commit",
          "other")

#: span names treated as EC compute ("encode" stage)
_ENCODE_SPANS = frozenset({"ec_encode", "ec_decode", "ec_write",
                           "ec_recover"})
#: span names that are device dispatches carrying h2d/kernel/d2h tags
_DISPATCH_SPANS = frozenset({"offload_batch", "tpu_encode_dispatch",
                             "tpu_decode_dispatch"})


def _num(v) -> float:
    return float(v) if isinstance(v, (int, float)) else 0.0


def pick_root(spans: list[dict]) -> dict | None:
    """The trace's root: a parent-less span, preferring the client's
    `rados_op`; on a partial trace (root process never promoted), the
    longest span whose parent is missing from the assembled set."""
    if not spans:
        return None
    ids = {s.get("span_id") for s in spans}
    orphans = [s for s in spans
               if not s.get("parent_id") or s["parent_id"] not in ids]
    pool = orphans or spans
    for s in pool:
        if s.get("name") == "rados_op":
            return s
    return max(pool, key=lambda s: _num(s.get("duration_us")))


def op_class(spans: list[dict]) -> str:
    """Coarse op class for per-class attribution: the first op kind of
    the client root (`ops` tag), else the osd_op desc verb."""
    root = pick_root(spans)
    if root is None:
        return "unknown"
    tags = root.get("tags") or {}
    ops = tags.get("ops")
    if isinstance(ops, str) and ops:
        return ops.split("+", 1)[0]
    desc = tags.get("desc")
    if isinstance(desc, str) and desc.startswith("osd_op("):
        inner = desc[len("osd_op("):]
        return inner.split("+", 1)[0].split(" ", 1)[0] or "unknown"
    return root.get("name") or "unknown"


def client_of(spans: list[dict]) -> str:
    root = pick_root(spans)
    tags = (root.get("tags") or {}) if root else {}
    c = tags.get("client")
    return str(c) if c else ""


def critical_path(spans: list[dict]) -> dict[str, Any]:
    """Stage attribution of one assembled trace. Returns
    {"total_us", "op_class", "client", "stages": {stage: us},
     "top_stage", "path": [span_id, ...]} with
    sum(stages.values()) == total_us exactly."""
    root = pick_root(spans)
    if root is None:
        return {"total_us": 0.0, "op_class": "unknown", "client": "",
                "stages": {s: 0.0 for s in STAGES}, "top_stage": "other",
                "path": []}
    total = _num(root.get("duration_us"))
    claims = {s: 0.0 for s in STAGES}
    commit_max = 0.0
    for s in spans:
        name = s.get("name") or ""
        dur = _num(s.get("duration_us"))
        tags = s.get("tags") or {}
        claims["queue_wait"] += _num(tags.get("queue_wait_us"))
        if name == "offload_queue_wait":
            claims["queue_wait"] += dur
        elif name == "store_commit":
            commit_max = max(commit_max, dur)
        elif name in _DISPATCH_SPANS:
            h2d = _num(tags.get("h2d_us"))
            ker = _num(tags.get("kernel_us"))
            d2h = _num(tags.get("d2h_us"))
            if h2d or ker or d2h:
                claims["h2d"] += h2d
                claims["kernel"] += ker
                claims["d2h"] += d2h
            else:
                claims["kernel"] += dur     # unprofiled: device wall time
            claims["encode"] += _num(tags.get("copy_us"))
        elif name in _ENCODE_SPANS:
            claims["encode"] += dur
    claims["commit"] = commit_max
    # EC compute spans CONTAIN their offload waits/dispatches: remove
    # the nested device time from `encode` so it isn't counted twice
    nested = (claims["h2d"] + claims["kernel"] + claims["d2h"]
              + sum(_num(s.get("duration_us")) for s in spans
                    if s.get("name") == "offload_queue_wait"))
    claims["encode"] = max(0.0, claims["encode"] - nested)
    named = sum(claims.values())
    if named > total > 0.0:
        scale = total / named
        for k in claims:
            claims[k] *= scale
        named = total
    claims["other"] = max(0.0, total - named)
    stages = {k: round(v, 1) for k, v in claims.items()}
    # rounding residue rides `other` so the identity stays exact
    stages["other"] = round(stages["other"]
                            + (total - sum(claims.values())), 1)
    if stages["other"] < 0.0:
        stages["other"] = 0.0
    top = max((k for k in STAGES if k != "other"),
              key=lambda k: stages[k], default="other")
    if stages.get(top, 0.0) <= 0.0:
        top = "other"
    return {"total_us": round(total, 1), "op_class": op_class(spans),
            "client": client_of(spans), "stages": stages,
            "top_stage": top,
            "path": [s["span_id"] for s in _serial_path(spans, root)]}


def _end(s: dict) -> float:
    return _num(s.get("start")) + _num(s.get("duration_us")) / 1e6


def _serial_path(spans: list[dict], root: dict) -> list[dict]:
    """The serial critical path: from the root down, at each node the
    child that *finished last* is the one completion waited on."""
    children: dict[str, list[dict]] = {}
    for s in spans:
        pid = s.get("parent_id")
        if pid:
            children.setdefault(pid, []).append(s)
    path = [root]
    node, seen = root, {id(root)}
    while True:
        kids = [c for c in children.get(node.get("span_id"), ())
                if id(c) not in seen]
        if not kids:
            return path
        node = max(kids, key=_end)
        seen.add(id(node))
        path.append(node)


def waterfall(spans: list[dict]) -> list[dict]:
    """Render-ready waterfall rows (one per span, start-ordered):
    depth via parent chain, offsets relative to the root's wall-clock
    start, process identity carried through for the multi-process
    view."""
    root = pick_root(spans)
    if root is None:
        return []
    t0 = _num(root.get("start"))
    by_id = {s.get("span_id"): s for s in spans}
    crit = {s["span_id"] for s in _serial_path(spans, root)}

    def depth(s: dict) -> int:
        d, cur, hops = 0, s, 0
        while hops < 64:
            pid = cur.get("parent_id")
            parent = by_id.get(pid) if pid else None
            if parent is None:
                return d
            d, cur, hops = d + 1, parent, hops + 1
        return d

    rows = []
    for s in sorted(spans, key=lambda s: _num(s.get("start"))):
        rows.append({
            "span_id": s.get("span_id"),
            "name": s.get("name"),
            "service": s.get("service"),
            "pid": s.get("pid"),
            "boot": s.get("boot"),
            "depth": depth(s),
            "offset_us": round((_num(s.get("start")) - t0) * 1e6, 1),
            "duration_us": _num(s.get("duration_us")),
            "on_critical_path": s.get("span_id") in crit,
            "tags": dict(s.get("tags") or {}),
            "links": list(s.get("links") or ()),
        })
    return rows
