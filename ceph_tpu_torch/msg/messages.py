"""Typed messages — the src/messages/ equivalent.

A Message is (type id, metadata dict, data bytes). On the wire it rides a
MESSAGE frame as three segments: header (seq/type, JSON), payload
(type-specific metadata, JSON), data (raw bytes, untouched — chunk
payloads never pass through JSON). Subclasses declare `TYPE` and carry
their fields in `payload`/`data`; `register_message` fills the decode
registry the way src/messages/MessageFactory.cc maps type ids to
constructors.

JSON for metadata is a deliberate divergence from ceph's dencoder: these
are control-plane fields (a few hundred bytes); the data plane stays raw
bytes. Compact, debuggable, and versionable via key presence.

The port's copy of ceph_tpu/msg/messages.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import json
import time
from typing import Any

from ceph_tpu_torch.utils import copytrack, sanitizer

_REGISTRY: dict[int, type] = {}


def _json_seg(seg) -> Any:
    """json.loads over a frame segment; segments arrive as memoryviews
    (zero-copy rx) and json needs bytes — these are control-plane blobs
    of a few hundred bytes, so the materialization is noise."""
    if not isinstance(seg, (bytes, bytearray, str)):
        seg = bytes(seg)
    return json.loads(seg)


def register_message(cls):
    """Class decorator: register by TYPE for decode."""
    if cls.TYPE in _REGISTRY:
        raise ValueError(f"message type {cls.TYPE} already registered "
                         f"({_REGISTRY[cls.TYPE].__name__})")
    _REGISTRY[cls.TYPE] = cls
    return cls


class Message:
    """Base message. Subclasses set TYPE and may override describe()."""

    TYPE = 0

    #: data-plane message types keep their data segment as a zero-copy
    #: MEMORYVIEW over the receive buffer (frame_rx stays referenced in
    #: the copy ledger); control-plane types materialize bytes — their
    #: handlers (paxos store persistence, latin1 decode, json
    #: re-encode) expect bytes semantics and carry a few hundred bytes
    #: at most, so the copy is noise while the API stays exact.
    DATA_VIEW = False

    def __init__(self, payload: dict[str, Any] | None = None,
                 data: bytes = b""):
        self.payload = payload or {}
        self.data = data
        # transport fields, stamped by the Connection
        self.seq = 0
        # optional trace context ({"t","s"}), stamped at send time when
        # tracing is on; rides a trailing TLV segment (frames.TRACE_MAGIC)
        self.trace: dict | None = None

    # -- wire form -----------------------------------------------------------

    def encode_segments(self) -> list[bytes]:
        header = json.dumps({"type": self.TYPE, "seq": self.seq},
                            separators=(",", ":")).encode()
        payload = json.dumps(self.payload, separators=(",", ":"),
                             sort_keys=True).encode()
        # tx boundary: a forwarded sanitizer-guarded rx view (e.g. the
        # replicated backend fanning client data out as MOSDRepOp)
        # unwraps HERE with its use-after-recycle check — the frame
        # codec and transport take raw buffers
        segments = [header, payload, sanitizer.unwrap(self.data)]
        if self.trace is not None:
            from ceph_tpu_torch.msg.frames import encode_trace_ctx
            segments.append(encode_trace_ctx(self.trace))
        return segments

    @staticmethod
    def decode_segments(segments: list[bytes]) -> "Message":
        if len(segments) not in (3, 4):
            raise ValueError(f"message frame has {len(segments)} segments")
        header = _json_seg(segments[0])
        cls = _REGISTRY.get(header["type"])
        if cls is None:
            raise ValueError(f"unknown message type {header['type']}")
        data = segments[2]
        if not cls.DATA_VIEW and not isinstance(data, (bytes, bytearray)):
            # control-plane type: materialize (and meter) the copy
            t0 = time.perf_counter()
            data = bytes(data)
            copytrack.copied("frame_rx", len(data),
                             time.perf_counter() - t0)
        elif cls.DATA_VIEW and sanitizer.view_guards_active():
            # sanitizer mode: the zero-copy window over the rx body is
            # handed out generation-guarded, so a view that outlives a
            # (future pooled) body recycle raises at the access site
            data = sanitizer.guard_view(data, label="frame_rx")
        msg = cls.__new__(cls)
        Message.__init__(msg, _json_seg(segments[1]), data)
        msg.seq = header["seq"]
        if len(segments) == 4:
            # unknown trailing segments are dropped, not errors: a newer
            # peer's extra TLV must never break this one
            from ceph_tpu_torch.msg.frames import decode_trace_ctx
            msg.trace = decode_trace_ctx(segments[3])
        return msg

    def __repr__(self) -> str:
        keys = {k: v for k, v in self.payload.items()
                if not isinstance(v, (list, dict)) or len(str(v)) < 64}
        return (f"{type(self).__name__}(seq={self.seq}, {keys}, "
                f"data={len(self.data)}B)")


def _simple(type_id: int, name: str, data_view: bool = False):
    """Define + register a Message subclass with no extra behavior.
    `data_view=True` marks a data-plane carrier whose payload stays a
    zero-copy memoryview on receive (see Message.DATA_VIEW)."""
    cls = type(name, (Message,), {"TYPE": type_id, "DATA_VIEW": data_view})
    return register_message(cls)


# -- heartbeat / liveness (MOSDPing, src/messages/MOSDPing.h) ----------------
MPing = _simple(0x10, "MPing")            # payload: {"stamp": float}
MPingReply = _simple(0x11, "MPingReply")

# -- mon client plane (MMon*, src/messages/MMon*.h) --------------------------
MMonGetMap = _simple(0x20, "MMonGetMap")          # {"what": "osdmap"|"monmap",
                                                  #  "have": epoch}
MMonMap = _simple(0x21, "MMonMap")                # {"monmap": {...}}
MOSDMapMsg = _simple(0x22, "MOSDMapMsg")          # {"full": {...}|null,
                                                  #  "incrementals": [...]}
MMonSubscribe = _simple(0x23, "MMonSubscribe")    # {"what": {"osdmap": start}}
MMonCommand = _simple(0x24, "MMonCommand")        # {"cmd": {...}, "tid": n}
MMonCommandAck = _simple(0x25, "MMonCommandAck")  # {"tid", "rc", "out": {...}}
MLog = _simple(0x28, "MLog")                      # daemon -> mon cluster-log
                                                  # entry (MLog.h): {"level":
                                                  #  "WRN"|"ERR", "who",
                                                  #  "message", "stamp"}

# -- mon<->mon quorum plane (MMonElection.h, MMonPaxos.h) --------------------
MMonElection = _simple(0x26, "MMonElection")      # {"op": propose|ack|victory,
                                                  #  "epoch", "rank"}
MMonPaxos = _simple(0x27, "MMonPaxos")            # {"op": collect|last|begin|
                                                  #  accept|commit|lease|...,
                                                  #  "pn", "version", ...};
                                                  # value rides the data seg

# -- osd control plane -------------------------------------------------------
MOSDBoot = _simple(0x30, "MOSDBoot")              # {"osd": id, "addr": str}
# 0x31 reserved: MOSDAlive (up_thru advance) — declared-but-dead wire
# protocol until an up_thru analog exists; see radoslint
# registry-consistency
# {"failed": id, "from": id, "epoch": the reporter's map epoch,
#  "addr": the address that map gives `failed`}
MOSDFailure = _simple(0x32, "MOSDFailure")

# -- client I/O (MOSDOp/MOSDOpReply, src/messages/MOSDOp.h) ------------------
MOSDOp = _simple(0x40, "MOSDOp",  # {"tid", "pg": "pool.ps", "oid",
                 data_view=True)
                                          #  "ops": [{"op": "write"|"read"|...,
                                          #          "off", "len", ...}],
                                          #  "epoch": client map epoch}
MOSDOpReply = _simple(0x41, "MOSDOpReply")  # {"tid", "rc", "out": [...]}
# QoS admission control refusal (the dmclock shed policy): an op the
# OSD would have queued past a tenant's depth cap bounces with an
# EAGAIN-style rc and a pacing hint — the client backs off WITHOUT a
# map refresh (the map is fine; the tenant is over its share) and
# resends the same tid. {"tid", "rc": -11, "retry_after_ms", "epoch"}
MOSDOpThrottle = _simple(0x42, "MOSDOpThrottle")

# -- replication (MOSDRepOp, src/messages/MOSDRepOp.h) -----------------------
MOSDRepOp = _simple(0x50, "MOSDRepOp",       # primary -> replica txn
                    data_view=True)
MOSDRepOpReply = _simple(0x51, "MOSDRepOpReply")

# -- peering / pg info -------------------------------------------------------
MOSDPGQuery = _simple(0x60, "MOSDPGQuery")
MOSDPGInfo = _simple(0x61, "MOSDPGInfo")
MOSDPGLog = _simple(0x62, "MOSDPGLog")
MOSDPGPush = _simple(0x63, "MOSDPGPush",     # recovery object push
                     data_view=True)
MOSDPGPushReply = _simple(0x64, "MOSDPGPushReply")

# -- EC sub-ops (MOSDECSubOpWrite/Read, src/messages/MOSDECSubOp*.h) ---------
MOSDECSubOpWrite = _simple(0x70, "MOSDECSubOpWrite", data_view=True)
MOSDECSubOpWriteReply = _simple(0x71, "MOSDECSubOpWriteReply")
MOSDECSubOpRead = _simple(0x72, "MOSDECSubOpRead")
MOSDECSubOpReadReply = _simple(0x73, "MOSDECSubOpReadReply", data_view=True)

# -- per-peer sub-op coalescing (this framework's jumbo frame; no direct
# reference analog — the reference amortizes per-message cost with
# throttled byte streams, we amortize per-FRAME Python) ----------------------
# A batch is a transport-level envelope: the messenger's write loop
# packs data-plane messages already queued for the same peer into ONE
# frame (one preamble, one crc pass over the concatenated datas, one
# dispatch on the far side), and the receive side unpacks them back
# into the original typed messages BEFORE seq accounting — each inner
# message keeps its own connection seq, so the dup filter, replay after
# reconnect, pg-log and rollback semantics are untouched. The envelope
# itself never enters the replay buffer (its inner messages do).
MOSDECSubOpBatch = _simple(0x74, "MOSDECSubOpBatch", data_view=True)
MOSDECSubOpBatchReply = _simple(0x75, "MOSDECSubOpBatchReply",
                                data_view=True)

#: message types the write loop may coalesce into a batch envelope:
#: the EC data plane (sub-ops + replies), replication sub-ops, recovery
#: pushes, and the client I/O plane. Control-plane traffic (maps,
#: paxos, mgr reports, heartbeats) never batches — a linger window on
#: an osdmap would slow every failure detection for no byte win.
BATCH_REPLY_TYPES = frozenset((
    MOSDECSubOpWriteReply.TYPE, MOSDECSubOpReadReply.TYPE,
    MOSDRepOpReply.TYPE, MOSDPGPushReply.TYPE, MOSDOpReply.TYPE))
BATCHABLE_TYPES = frozenset((
    MOSDECSubOpWrite.TYPE, MOSDECSubOpRead.TYPE, MOSDRepOp.TYPE,
    MOSDPGPush.TYPE, MOSDOp.TYPE)) | BATCH_REPLY_TYPES


def pack_batch(msgs: list) -> Message:
    """Envelope `msgs` (each already seq-stamped) into one batch
    message. Inner payloads/seqs/trace contexts ride the envelope's
    payload; inner datas become a SCATTER data segment (a list the
    frame codec crc-chains and the transport writes without an
    intermediate join — zero-copy all the way to the wire)."""
    entries = []
    datas: list = []
    for m in msgs:
        e = {"t": m.TYPE, "s": m.seq, "p": m.payload, "n": len(m.data)}
        if m.trace is not None:
            # COPY the context: on the local-loopback path the entry
            # dict is handed to the peer as-is, and an aliased inner
            # dict would let either side's later mutation corrupt the
            # other's trace identity (sampled flag included)
            e["tr"] = dict(m.trace)
        entries.append(e)
        if len(m.data):
            # tx boundary (see encode_segments): checked unwrap of any
            # guarded rx view being forwarded into the scatter segment
            datas.append(sanitizer.unwrap(m.data))
    cls = MOSDECSubOpBatchReply \
        if all(m.TYPE in BATCH_REPLY_TYPES for m in msgs) \
        else MOSDECSubOpBatch
    batch = cls({"msgs": entries}, datas)
    # the envelope rides the LAST inner seq so a peer that somehow saw
    # it as a plain message would not regress its dup filter; receivers
    # that know the type do per-inner-message seq accounting instead
    batch.seq = msgs[-1].seq
    return batch


def unpack_batch(msg: Message) -> list:
    """Inner messages of a batch envelope, data segments as zero-copy
    windows over the envelope's data. Undecodable entries (unknown
    type id from a newer peer, malformed record) are dropped
    INDIVIDUALLY — partial-batch error isolation: one bad entry must
    not lose its batch-mates."""
    data = msg.data
    if isinstance(data, list):
        # a locally-packed envelope that never crossed the wire (tests,
        # loopback): its data is still the scatter list
        data = b"".join(bytes(p) for p in data)
    out = []
    off = 0
    for e in msg.payload.get("msgs", ()):
        try:
            n = int(e["n"])
        except (KeyError, TypeError, ValueError):
            break       # data-offset alignment lost: stop, don't guess
        seg = data[off:off + n] if n else b""
        off += n
        try:
            cls = _REGISTRY.get(e["t"])
            if cls is None:
                continue                # unknown type: skip, keep going
            if not cls.DATA_VIEW and not isinstance(seg,
                                                    (bytes, bytearray)):
                t0 = time.perf_counter()
                seg = bytes(seg)
                copytrack.copied("frame_rx", len(seg),
                                 time.perf_counter() - t0)
            m = cls.__new__(cls)
            Message.__init__(m, e["p"], seg)
            m.seq = int(e["s"])
            tr = e.get("tr")
            m.trace = dict(tr) if isinstance(tr, dict) else None
            out.append(m)
        except (KeyError, TypeError, ValueError):
            continue
    return out

# -- watch/notify (MWatchNotify, src/messages/MWatchNotify.h) ----------------
MWatchNotify = _simple(0x90, "MWatchNotify")        # osd -> watcher client:
                                                    # {"oid", "notify_id",
                                                    #  "cookie"}; notifier
                                                    # payload rides data
MWatchNotifyAck = _simple(0x91, "MWatchNotifyAck")  # watcher -> osd on the
                                                    # SAME conn (bypasses the
                                                    # op queue: an ack queued
                                                    # behind the blocking
                                                    # notify would deadlock
                                                    # its shard)

# -- cephfs client<->mds (MClientRequest/MClientReply,
# src/messages/MClientRequest.h) ---------------------------------------------
MClientRequest = _simple(0xA0, "MClientRequest")    # {"tid", "op", "path",
                                                    #  ...op args}
MClientReply = _simple(0xA1, "MClientReply")        # {"tid", "rc", "out"}

# -- mgr report fan-in (MMgrOpen/MMgrConfigure/MMgrReport,
# src/messages/MMgrOpen.h, MMgrConfigure.h, MMgrReport.h) --------------------
MMgrOpen = _simple(0xB0, "MMgrOpen")          # daemon -> mgr session open:
                                              # {"daemon_name": "osd.0",
                                              #  "service": "osd"}
MMgrConfigure = _simple(0xB1, "MMgrConfigure")  # mgr -> daemon: {"period": s}
MMgrReport = _simple(0xB2, "MMgrReport")      # daemon -> mgr periodic:
                                              # {"daemon_name", "service",
                                              #  "schema": {...}|null (once
                                              #  per session), "counters":
                                              #  changed-key deltas,
                                              #  "daemon_status": {...},
                                              #  "health_metrics": {...},
                                              #  "progress": [...], "stamp"}
MMonMgrReport = _simple(0xB3, "MMonMgrReport")  # mgr -> mon aggregated digest
                                                # (src/messages/MMonMgrReport
                                                # .h): {"checks": {...},
                                                #  "progress": [...],
                                                #  "daemons": {name: age}}
MMgrMap = _simple(0xB4, "MMgrMap")              # mon -> subscriber push of the
                                                # replicated mgrmap
                                                # (src/messages/MMgrMap.h):
                                                # {"mgrmap": {"epoch",
                                                #  "active_name",
                                                #  "active_addr"}}

# -- scrub (MOSDRepScrub / replica scrub map, src/messages/MOSDRepScrub.h) ---
MOSDRepScrub = _simple(0x80, "MOSDRepScrub")        # {"pgid", "tid", "from",
                                                    #  "deep": bool,
                                                    #  "range": [lo, hi]}
                                                    # lo/hi None = open end;
                                                    # scan names lo < n <= hi
MOSDRepScrubMap = _simple(0x81, "MOSDRepScrubMap")  # {"pgid", "tid", "from",
                                                    #  "map": {oid: entry}}
MOSDScrubReserve = _simple(0x82, "MOSDScrubReserve")  # remote range
                                                    # reservation handshake
                                                    # (src/messages/
                                                    #  MOSDScrubReserve.h):
                                                    # {"pgid", "tid", "from",
                                                    #  "op": "reserve"|
                                                    #  "grant"|"reject"|
                                                    #  "release"}
