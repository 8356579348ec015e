"""Messenger: asyncio re-creation of AsyncMessenger + ProtocolV2 sessions.

The reference contract this keeps (src/msg/Messenger.h, ProtocolV2.cc):

  * a Messenger per daemon, bound or client-only, with a dispatcher chain
    (`ms_dispatch`, `ms_handle_accept/reset/remote_reset`);
  * Connections with send_message() ordering guarantees and policies —
    lossy (client->server: a drop loses the session, callers resend at a
    higher layer, like Objecter) vs lossless peers (osd<->osd: transport
    faults are invisible; the initiator reconnects and both sides replay
    messages the other hasn't acked);
  * session semantics: cookie identifies a session across TCP transports;
    in_seq/out_seq + ACK frames bound replay; receivers drop duplicates
    by seq (ProtocolV2 reconnect/replay, out-of-order-safe).

Idiomatic divergences: one asyncio event loop per DAEMON (under the
sharded reactor runtime, utils/reactor.py, each daemon's messenger
binds, accepts, and dispatches wholly on its owning shard's loop —
connections between daemons on different shards are ordinary localhost
socket hops, same-shard stays in-loop; a Messenger and its Connections
are loop-bound objects in the loop-affinity sense and must never be
driven from another shard without a threadsafe handoff);
coroutine-per-connection instead of a hand-rolled state machine; the
banner/HELLO exchange carries JSON instead of dencoded structs.
Auth: `none` by default, cephx-lite mutual HMAC when
an auth_key is set; on top of that the handshake can negotiate AES-GCM
secure mode and/or zlib on-wire compression (frames.Onwire), with the
negotiation transcript bound into the auth proofs so a MITM cannot
silently downgrade either mode.

The port's copy of ceph_tpu/msg/messenger.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import asyncio
import collections
import hashlib
import hmac
import json
import os
import threading
import time
from typing import Awaitable, Callable

from ceph_tpu_torch.msg import messages as _messages
from ceph_tpu_torch.msg.frames import BANNER, Frame, FrameError, Tag, Onwire
from ceph_tpu_torch.msg.messages import Message, _json_seg
from ceph_tpu_torch.qa import faultinject, interleave
from ceph_tpu_torch.utils import tracer
from ceph_tpu_torch.utils.async_util import being_cancelled, drain_all, reap, \
    reap_all
from ceph_tpu_torch.utils.dout import dout
from ceph_tpu_torch.utils.perf_counters import (TYPE_HISTOGRAM,
                                                PerfCountersCollection)

# -- per-peer message batching (msgr_batch_*) --------------------------------
# The sub-op fan-out seam: one client EC write fans k+m MOSDECSubOpWrite
# frames out (and k+m replies back), each paying a full preamble +
# crc + dispatch in per-frame Python. Under concurrency, sub-ops bound
# for the SAME peer pile up in a connection's outbound queue faster
# than the write loop drains them — so the write loop coalesces
# consecutive data-plane messages into one batch envelope
# (messages.pack_batch) within a linger window, the offload batcher's
# size-bucket + linger-deadline discipline applied to the wire. Module
# defaults mirror the ec_offload_* pattern: hot-togglable through any
# daemon's config observer, read by every connection per batch decision.

_BATCH_DEFAULTS: dict = {
    "enabled": True,
    "max_bytes": 1 << 20,
    # 0 = greedy: batch whatever is already queued plus two event-loop
    # yields, no timer. MEASURED on the bench container: any timed
    # linger (even 100µs) costs more in wait_for timer churn + added
    # serial latency than the extra coalescing wins at cluster op
    # rates; the knob stays for high-rate or high-latency links.
    "linger_us": 0.0,
}

_msgr_perf_lock = threading.Lock()


def msgr_perf():
    """The process-wide "msgr" perf logger (frame/batch counters),
    created on first use; rides `perf dump`, the MgrClient report
    stream (extra_loggers), and the exporter like any other logger.
    Locked: shard loops race the first-use registration, and a second
    caller must never see a half-added counter set."""
    coll = PerfCountersCollection.instance()
    with _msgr_perf_lock:
        pc = coll.get("msgr")
        if pc is not None:
            return pc
        pc = coll.create("msgr")
        pc.add("frames_tx",
               description="MESSAGE frames written to the wire")
        pc.add("frames_rx",
               description="MESSAGE frames read off the wire")
        pc.add("data_frames_tx",
               description="data-plane MESSAGE frames written (client "
                           "I/O, EC/replication sub-ops + replies, "
                           "recovery pushes, batch envelopes) — the "
                           "numerator of frames-per-client-write")
        pc.add("batches_tx",
               description="batch envelopes written (each replaces N "
                           "data-plane frames with one)")
        pc.add("batched_msgs",
               description="messages that rode a batch envelope "
                           "instead of their own frame")
        pc.add("batch_ops", type=TYPE_HISTOGRAM,
               description="messages coalesced per batch envelope")
        return pc


def MSGR_OPTIONS():
    """The msgr_batch_* option schema (declared per daemon Config)."""
    from ceph_tpu_torch.utils.config import Option
    return [
        Option("msgr_batch_enabled", "bool", _BATCH_DEFAULTS["enabled"],
               "coalesce queued data-plane messages bound for the same "
               "peer into one batch frame (false = one frame per "
               "message)"),
        Option("msgr_batch_max_bytes", "size",
               _BATCH_DEFAULTS["max_bytes"],
               "flush a per-peer message batch at this many payload "
               "bytes", minimum=4096),
        Option("msgr_batch_linger_us", "float",
               _BATCH_DEFAULTS["linger_us"],
               "max time the write loop waits for batch-mates before "
               "the frame ships anyway (µs); 0 = greedy (already-"
               "queued messages plus two event-loop yields, no timer)",
               minimum=0.0),
    ]


def register_config(config) -> None:
    """Declare the msgr_batch_* options on `config` (idempotent) and
    hot-apply changes to the module defaults every connection reads —
    `config set msgr_batch_linger_us 1000` over an admin socket retunes
    the wire batcher live, the ec_offload_* observer pattern."""
    from ceph_tpu_torch.utils.config import ConfigError
    names = []
    for opt in MSGR_OPTIONS():
        names.append(opt.name)
        try:
            config.declare(opt)
        except ConfigError:
            pass                    # another daemon already declared it

    def _on_change(name: str, value) -> None:
        key = name[len("msgr_batch_"):]
        if key in _BATCH_DEFAULTS:
            _BATCH_DEFAULTS[key] = value

    config.add_observer(tuple(names), _on_change)
    diff = config.diff()
    for name in names:
        if name in diff:
            _on_change(name, config.get(name))


def _build_onwire(agreed: dict, role: str,
                  auth_key: bytes | None,
                  cli_nonce: str | None,
                  srv_nonce: str | None) -> Onwire | None:
    """Instantiate the negotiated transform (None = plain crc mode)."""
    secure = bool(agreed.get("secure")) and auth_key is not None \
        and cli_nonce and srv_nonce
    compress = bool(agreed.get("compress"))
    if not secure and not compress:
        return None
    return Onwire(compress=compress,
                  secret=auth_key if secure else None,
                  role=role, nonces=(cli_nonce or "", srv_nonce or ""))


def _auth_proof(key: bytes, role: str, nonce_a: str, nonce_b: str,
                transcript: str = "") -> str:
    """cephx-lite challenge proof: HMAC-SHA256 over both nonces with a
    role prefix so the two legs can never be reflected at each other.
    `transcript` binds the negotiation (requested + agreed onwire
    modes): a MITM editing the plaintext handshake to downgrade secure
    mode breaks both proofs instead of silently succeeding."""
    return hmac.new(key,
                    f"{role}|{nonce_a}|{nonce_b}|{transcript}".encode(),
                    hashlib.sha256).hexdigest()


def _onwire_transcript(requested: dict, agreed: dict) -> str:
    return json.dumps([requested or {}, agreed or {}], sort_keys=True)


class Policy:
    """Connection policy (Messenger::Policy). lossy: faults reset the
    session and drop queued messages (callers resend). lossless: faults
    trigger reconnect+replay; send_message never loses ordering."""

    def __init__(self, lossy: bool):
        self.lossy = lossy

    @classmethod
    def lossy_client(cls) -> "Policy":
        return cls(lossy=True)

    @classmethod
    def lossless_peer(cls) -> "Policy":
        return cls(lossy=False)


class Dispatcher:
    """Callback interface (src/msg/Dispatcher.h). Subclass what you need."""

    async def ms_dispatch(self, conn: "Connection", msg: Message) -> bool:
        """Return True if handled; the chain stops at the first taker."""
        return False

    def ms_handle_accept(self, conn: "Connection") -> None:
        pass

    def ms_handle_reset(self, conn: "Connection") -> None:
        """A lossy session died; queued messages are gone."""

    def ms_handle_remote_reset(self, conn: "Connection") -> None:
        """Peer declared our session stale (RESET); state was dropped."""


class Connection:
    """One logical session with a peer; survives TCP transports when the
    policy is lossless. Created by Messenger.connect (initiator) or by an
    accept (acceptor) — symmetric once established."""

    RECONNECT_BACKOFF = 0.2     # doubles per attempt, capped
    RECONNECT_BACKOFF_MAX = 5.0
    ACK_EVERY = 16              # coalesce acks; also acked when idle
    KEEPALIVE_INTERVAL = 1.0    # lossless peers ping this often when idle
    KEEPALIVE_TIMEOUT = 5.0     # no frames in this long = transport dead
    PARK_TIMEOUT = 30.0         # lossless acceptor gives up waiting for
    #                             the peer's RECONNECT (peer death GC)

    def __init__(self, messenger: "Messenger", peer_addr: tuple[str, int] | None,
                 policy: Policy, initiator: bool):
        self.messenger = messenger
        self.peer_addr = peer_addr          # (host, port) for initiators
        self.peer_name = ""                 # entity name from HELLO
        self.peer_tenant = None             # optional tenant label (HELLO)
        self.policy = policy
        self.initiator = initiator
        self.cookie = int.from_bytes(os.urandom(8), "little") if initiator else 0
        self._onwire: Onwire | None = None   # per-transport, set pre-attach

        self.out_seq = 0                    # last seq stamped
        self.in_seq = 0                     # last seq read (dup filter)
        self._processed_seq = 0             # last seq fully dispatched
        self._last_acked_in = 0
        # decouple dispatch from the transport: the read loop enqueues and
        # keeps reading (so keepalives flow even while a handler blocks),
        # and acks advertise what was PROCESSED, so a handler cancelled by
        # a transport fault is replayed, not lost
        self._dispatch_q: asyncio.Queue = asyncio.Queue()
        self._session_gen = 0               # bumped when seqs restart
        self._sent: collections.deque[Message] = collections.deque()
        self._out: asyncio.Queue = asyncio.Queue()
        self._reader = None
        self._writer = None
        self._gen = 0          # transport generation; bumped per _attach
        self._tasks: set[asyncio.Task] = set()
        self._ack_timer = None     # lazy idle-ack flush (call_later)
        self._closed = False
        self._connected = asyncio.Event()
        self._last_rx = time.monotonic()

    # -- public --------------------------------------------------------------

    def send_message(self, msg: Message) -> None:
        """Queue for ordered delivery. Never blocks; never raises on a
        down transport (lossless replays, lossy drops on reset)."""
        if self._closed:
            return
        if msg.trace is None:
            ctx = tracer.current_context()
            if ctx is not None:
                if ctx["f"] & tracer.FLAG_SAMPLED:
                    # sending-end messenger span: the moment the message
                    # entered the transport, as a child of whatever op is
                    # running; its OWN id rides the wire so the receiving
                    # end nests under it
                    sp = tracer.start_span("ms_send",
                                           self.messenger.entity_name)
                    if sp is not None:
                        sp.set_tag("type", type(msg).__name__)
                        sp.set_tag("peer",
                                   self.peer_name or str(self.peer_addr))
                        sp.set_tag("bytes", len(msg.data))
                        msg.trace = sp.context()
                        sp.finish()
                else:
                    # unsampled (tail-retention regime): a per-message
                    # span is ~1/4 of all spans on the hot path, and the
                    # trace will most likely be discarded — stamp the
                    # running op's own context on the wire instead. The
                    # receive side nests directly under the op span, so
                    # a tail-promoted waterfall stays connected; it just
                    # loses the send-leg timing the head-sampled 1% keep.
                    msg.trace = ctx
        self.out_seq += 1
        msg.seq = self.out_seq
        if not self.policy.lossy:
            self._sent.append(msg)
        self._out.put_nowait(("msg", msg))

    async def close(self) -> None:
        self._closed = True
        if self._ack_timer is not None:
            self._ack_timer.cancel()
            self._ack_timer = None
        tasks = list(self._tasks)   # done-callbacks mutate _tasks
        await reap_all(tasks)
        self._tasks.clear()
        await self._close_transport()

    @property
    def connected(self) -> bool:
        return self._connected.is_set()

    # -- transport lifecycle -------------------------------------------------

    async def _close_transport(self) -> None:
        self._connected.clear()
        writer, self._reader, self._writer = self._writer, None, None
        if writer is not None:
            writer.close()
            try:
                await writer.wait_closed()
            except asyncio.CancelledError:
                # asyncio.streams can cancel the close waiter internally
                # when the transport dies mid-close; only propagate when
                # OUR task is actually being cancelled (being_cancelled
                # degrades safely on 3.10, where Task.cancelling() does
                # not exist — the old direct call raised AttributeError)
                if being_cancelled():
                    raise
            except Exception:
                pass

    def _attach(self, reader, writer) -> None:
        self._reader, self._writer = reader, writer
        self._gen += 1
        self._connected.set()

    def _spawn(self, coro: Awaitable) -> None:
        task = asyncio.get_running_loop().create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    # -- initiator side ------------------------------------------------------

    async def _initiate(self) -> None:
        """Open the first transport and start the session loops."""
        await self._open_transport(reconnect=False)
        self._spawn(self._run())

    async def _open_transport(self, reconnect: bool) -> None:
        host, port = self.peer_addr
        reader, writer = await asyncio.open_connection(host, port)
        try:
            await self._handshake(reader, writer, reconnect)
        except BaseException:
            writer.close()
            raise

    async def _handshake(self, reader, writer, reconnect: bool) -> None:
        writer.write(BANNER)
        hello = {
            "entity": self.messenger.entity_name,
            "cookie": self.cookie,
            "in_seq": self._processed_seq,
            "reconnect": reconnect,
            "lossy": self.policy.lossy,
        }
        if self.messenger.tenant:
            # client identity plane: the tenant label is negotiated ONCE
            # per session here (alongside the entity name) — per-op
            # stamps on MOSDOp are cross-checked against it, never
            # trusted on their own
            hello["tenant"] = self.messenger.tenant
        my_nonce = None
        if self.messenger.auth_key is not None:
            my_nonce = os.urandom(16).hex()
            hello["auth_nonce"] = my_nonce
        hello["onwire"] = {
            "compress": self.messenger.compress,
            "secure": (self.messenger.secure
                       and self.messenger.auth_key is not None)}
        writer.write(Frame(Tag.RECONNECT if reconnect else Tag.HELLO,
                           [json.dumps(hello).encode()]).encode())
        await writer.drain()
        banner = await reader.readexactly(len(BANNER))
        if banner != BANNER:
            raise FrameError(f"bad banner {banner!r}")
        reply = await Frame.read(reader)
        if reply.tag == Tag.RESET:
            # Peer lost our session (restart). Re-stamp the unacked tail
            # into a fresh session IN _sent — not a local — so a failure
            # of the fresh connect below still retries with the messages
            # intact. The peer may have seen some of them: delivery
            # across a session reset is at-least-once and higher layers
            # must tolerate replays (PG log dup detection, idempotent
            # mon commands).
            if not reconnect:
                raise FrameError("RESET in reply to initial HELLO")
            dout("ms", 1, f"{self} remote reset")
            self.out_seq = 0
            for m in self._sent:
                self.out_seq += 1
                m.seq = self.out_seq
            self.in_seq = 0
            self._processed_seq = 0
            self._last_acked_in = 0
            self._session_gen += 1   # queued old-session msgs still run,
            #                          but no longer advance seq state
            self.messenger._notify_remote_reset(self)
            self.cookie = int.from_bytes(os.urandom(8), "little")
            writer.close()
            # fresh session: the HELLO reply's in_seq=0 makes
            # _requeue_for_replay resend all of _sent
            await self._open_transport(reconnect=False)
            return
        if reply.tag in (Tag.HELLO, Tag.RECONNECT_OK):
            info = _json_seg(reply.segments[0])
            agreed = info.get("onwire") or {}
            if self.messenger.auth_key is not None:
                # cephx-lite leg 2: verify the acceptor's proof, then
                # send ours — BEFORE any message flows. The transcript
                # covers what we REQUESTED and what was AGREED, so a
                # stripped/downgraded negotiation fails auth.
                transcript = _onwire_transcript(hello["onwire"], agreed)
                proof = _auth_proof(self.messenger.auth_key, "srv",
                                    my_nonce, info.get("auth_nonce", ""),
                                    transcript)
                if info.get("auth_proof") != proof:
                    raise FrameError("auth failed: acceptor proof "
                                     "missing or wrong (key mismatch or "
                                     "negotiation tampering?)")
                writer.write(Frame(Tag.AUTH, [json.dumps(
                    {"auth_proof": _auth_proof(
                        self.messenger.auth_key, "cli",
                        info.get("auth_nonce", ""), my_nonce,
                        transcript)}
                ).encode()]).encode())
                await writer.drain()
            self.peer_name = info.get("entity", "")
            self._requeue_for_replay(info.get("in_seq", 0))
            self._onwire = _build_onwire(
                agreed, role="cli", auth_key=self.messenger.auth_key,
                cli_nonce=my_nonce, srv_nonce=info.get("auth_nonce"))
            self._attach(reader, writer)
            return
        raise FrameError(f"unexpected handshake tag {reply.tag}")

    def _requeue_for_replay(self, peer_in_seq: int) -> None:
        """Rebuild the outbound queue for a (re)attached transport: drop
        everything queued (lossless messages all live in _sent; acks and
        keepalive replies regenerate) and enqueue the unacked tail in seq
        order, so replays can never be reordered after newer messages that
        were queued while the transport was down."""
        while not self._out.empty():
            try:
                self._out.get_nowait()
            except asyncio.QueueEmpty:
                break
        self._trim_sent(peer_in_seq)
        for m in self._sent:
            self._out.put_nowait(("msg", m))

    # -- shared session loops ------------------------------------------------

    async def _run(self) -> None:
        """Session loop: pump the live transport; on fault, lossy sessions
        die (dispatcher reset callback), lossless initiators reconnect
        with backoff, lossless acceptors park until the peer's RECONNECT
        re-attaches a transport."""
        dispatch = asyncio.get_running_loop().create_task(
            self._dispatch_loop())
        self._tasks.add(dispatch)
        dispatch.add_done_callback(self._tasks.discard)
        try:
            await self._run_inner()
        finally:
            self.messenger._forget(self)
            # the session is over (closed / lossy reset / park timeout):
            # reap the dispatch task HERE — by now the conn is out of
            # every messenger table, so shutdown() can no longer reach
            # it and an unreaped task leaks ("Task was destroyed but it
            # is pending!" at loop teardown)
            await reap(dispatch)

    async def _run_inner(self) -> None:
        backoff = self.RECONNECT_BACKOFF
        while not self._closed:
            if not self.connected:
                if self.policy.lossy:
                    self.messenger._notify_reset(self)
                    return
                if self.initiator:
                    await asyncio.sleep(backoff)
                    backoff = min(backoff * 2, self.RECONNECT_BACKOFF_MAX)
                    try:
                        await self._open_transport(reconnect=True)
                        backoff = self.RECONNECT_BACKOFF
                    except Exception as e:
                        dout("ms", 10, f"{self} reconnect failed: {e}")
                        continue
                else:
                    # parked acceptor: the initiator owns reconnects. If
                    # none arrives the peer is gone — GC the session so a
                    # dead peer can't pin it forever (VERDICT r3 weak #5).
                    try:
                        await asyncio.wait_for(self._connected.wait(),
                                               timeout=self.PARK_TIMEOUT)
                    except asyncio.TimeoutError:
                        dout("ms", 5, f"{self} park timeout; dropping "
                                      "session")
                        self.messenger._notify_reset(self)
                        return
                continue
            gen = self._gen
            try:
                await self._pump()
            except asyncio.CancelledError:
                raise               # session reaped: unwind through _run
            except GeneratorExit:
                return
            except Exception as e:
                dout("ms", 5, f"{self} transport fault: {type(e).__name__} {e}")
            if self._gen == gen:
                # only tear down the transport the fault belongs to — a
                # concurrent RECONNECT accept may have attached a new one
                await self._close_transport()

    async def _pump(self) -> None:
        reader, writer = self._reader, self._writer
        onwire = self._onwire
        self._last_rx = time.monotonic()
        tasks = [asyncio.create_task(self._read_loop(reader, onwire)),
                 asyncio.create_task(self._write_loop(writer, onwire))]
        if not self.policy.lossy:
            tasks.append(asyncio.create_task(self._keepalive_loop()))
        try:
            done, pending = await asyncio.wait(
                tasks, return_when=asyncio.FIRST_EXCEPTION)
        finally:
            await reap_all(tasks)
        for t in done:
            exc = t.exception()
            if exc is not None:
                raise exc

    async def _keepalive_loop(self) -> None:
        """Lossless peers actively probe liveness: send KEEPALIVE on an
        interval and fault the transport when nothing (data, acks, or
        keepalive replies) has arrived within KEEPALIVE_TIMEOUT — the
        reference's keepalive2 + timeout behavior (ProtocolV2)."""
        while True:
            await asyncio.sleep(self.KEEPALIVE_INTERVAL)
            stale = time.monotonic() - self._last_rx
            if stale > self.KEEPALIVE_TIMEOUT:
                raise FrameError(
                    f"keepalive timeout ({stale:.1f}s since last frame)")
            self._out.put_nowait(("keepalive", None))

    async def _read_loop(self, reader, onwire: Onwire | None = None
                         ) -> None:
        perf = self.messenger.perf
        while True:
            frame = await (onwire.read_frame(reader) if onwire
                           else Frame.read(reader))
            self._last_rx = time.monotonic()
            if frame.tag == Tag.MESSAGE:
                perf.inc("frames_rx")
                msg = Message.decode_segments(frame.segments)
                if isinstance(msg, (_messages.MOSDECSubOpBatch,
                                    _messages.MOSDECSubOpBatchReply)):
                    # batch envelope: unpack BEFORE seq accounting —
                    # every inner message carries its own connection
                    # seq, so dup filtering, acks, and replay behave
                    # exactly as if each had arrived on its own frame
                    for m in _messages.unpack_batch(msg):
                        self._rx_message(m)
                else:
                    self._rx_message(msg)
            elif frame.tag == Tag.ACK:
                (seq,) = _json_seg(frame.segments[0])
                self._trim_sent(seq)
            elif frame.tag == Tag.KEEPALIVE:
                self._out.put_nowait(("keepalive_ack", None))
            elif frame.tag == Tag.KEEPALIVE_ACK:
                pass
            else:
                raise FrameError(f"unexpected tag {frame.tag} mid-session")

    def _rx_message(self, msg: Message) -> None:
        """Seq-account and enqueue one received message (whether it
        arrived on its own frame or inside a batch envelope)."""
        if msg.seq <= self.in_seq:
            return                            # replayed duplicate
        self.in_seq = msg.seq
        if faultinject.armed():
            # deterministic fault injection AFTER seq accounting: a
            # dropped message is permanently lost (later dispatches
            # advance the processed-seq ack past it, like real on-path
            # loss); a dup re-enters dispatch twice (the dup-op table's
            # exercise); a delay reorders it behind later arrivals.
            # Runs PER INNER MESSAGE of a batch, so msg-type rules keep
            # their pre-batching semantics.
            act, delay = faultinject.on_message(
                self.messenger.entity_name, msg)
            if act == "drop":
                return
            if act == "dup":
                self._dispatch_q.put_nowait((self._session_gen, msg))
            elif act == "delay":
                self._spawn(self._deliver_delayed(
                    self._session_gen, msg, delay))
                return
        self._dispatch_q.put_nowait((self._session_gen, msg))

    async def _deliver_delayed(self, gen: int, msg: Message,
                               delay: float) -> None:
        """Injected message delay: re-enters the dispatch queue after
        sleeping, so later arrivals overtake it (ms_inject_delay_max
        semantics)."""
        await asyncio.sleep(delay)
        if not self._closed:
            self._dispatch_q.put_nowait((gen, msg))

    async def _dispatch_loop(self) -> None:
        """Consume read messages in order, independent of the transport.
        A dispatcher exception is logged, never treated as a transport
        fault; acks advance only after a handler completes."""
        while not self._closed:
            gen, msg = await self._dispatch_q.get()
            if interleave.armed():
                # schedule explorer: stretch the window between dequeue
                # and handler so reordered completions really interleave
                await interleave.yield_point("msgr_dispatch")
            try:
                if msg.trace is not None and tracer.active():
                    # receiving-end messenger scope: a real ms_dispatch
                    # span for enabled/head-sampled traces, context-only
                    # for unsampled ones; either way handlers' own
                    # spans (PG, EC, store) nest under this context and
                    # the trace stays connected across the socket
                    with tracer.dispatch_scope("ms_dispatch",
                                               self.messenger.entity_name,
                                               parent=msg.trace) as sp:
                        if sp is not None:
                            sp.set_tag("type", type(msg).__name__)
                            sp.set_tag("bytes", len(msg.data))
                        await self.messenger._dispatch(self, msg)
                else:
                    await self.messenger._dispatch(self, msg)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                dout("ms", 0, f"{self} dispatch of {msg!r} failed: "
                              f"{type(e).__name__} {e}")
            if gen == self._session_gen:
                self._processed_seq = msg.seq
                if self._processed_seq - self._last_acked_in >= \
                        self.ACK_EVERY:
                    self._out.put_nowait(("ack", self._processed_seq))
                else:
                    # below the coalesce threshold: arm ONE lazy timer
                    # that flushes the ack if the connection goes quiet
                    # (replaces the old wait_for-per-frame idle timeout
                    # in the write loop — same <=IDLE_ACK_S ack bound,
                    # none of the per-frame timer churn)
                    self._schedule_ack_flush()

    IDLE_ACK_S = 0.5   # flush pending acks when the queue goes quiet

    def _schedule_ack_flush(self) -> None:
        if self._ack_timer is None:
            self._ack_timer = asyncio.get_running_loop().call_later(
                self.IDLE_ACK_S, self._ack_flush)

    def _ack_flush(self) -> None:
        self._ack_timer = None
        if not self._closed and \
                self._processed_seq > self._last_acked_in:
            self._out.put_nowait(("ack", self._processed_seq))

    async def _coalesce(self, msg: Message) -> tuple[Message, tuple | None]:
        """Per-peer message batching (the EC sub-op fan-out seam): with
        `msg` in hand, drain whatever batchable data-plane messages are
        already queued behind it — lingering up to msgr_batch_linger_us
        for stragglers — and envelope them into ONE frame. Returns
        (message to frame, leftover non-batchable item or None). Order
        is preserved: inner messages keep queue (= seq) order, and a
        non-batchable item that ended the drain ships right after."""
        if not _BATCH_DEFAULTS["enabled"] or \
                type(msg).TYPE not in _messages.BATCHABLE_TYPES:
            return msg, None
        # the envelope's concatenated data rides ONE frame segment, so
        # the admission cap must also respect the receiver's segment
        # bound — an operator raising msgr_batch_max_bytes past it
        # would otherwise build frames every peer rejects (and lossless
        # replay would deterministically rebuild them: a livelock)
        max_bytes = min(_BATCH_DEFAULTS["max_bytes"],
                        Frame.MAX_SEGMENT_SIZE)
        linger_s = _BATCH_DEFAULTS["linger_us"] / 1e6
        msgs = [msg]
        nbytes = len(msg.data)
        loop = asyncio.get_running_loop()
        # micro-linger: a couple of plain event-loop yields let tasks
        # that are ALREADY runnable (a PG fan-out mid-send, a handler
        # about to reply) enqueue their messages before the frame
        # ships. sleep(0) costs no timer — the wait_for-per-frame
        # variant of this loop measurably LOST throughput to timer +
        # wrapper-task churn at this op rate.
        yields = 2
        deadline = loop.time() + linger_s if linger_s > 0 else None
        leftover = None
        while nbytes < max_bytes:
            if self._out.empty():
                if yields > 0:
                    yields -= 1
                    await asyncio.sleep(0)
                    continue
                if deadline is None:
                    break
                timeout = deadline - loop.time()
                if timeout <= 0:
                    break
                try:
                    nxt = await asyncio.wait_for(self._out.get(),
                                                 timeout)
                except asyncio.TimeoutError:
                    break
            else:
                nxt = self._out.get_nowait()
            if nxt[0] == "msg" and \
                    type(nxt[1]).TYPE in _messages.BATCHABLE_TYPES and \
                    nbytes + len(nxt[1].data) <= max_bytes:
                # size checked BEFORE admission: a message that would
                # push the envelope past the cap ships on its own frame
                # right after (it is legal there by itself)
                msgs.append(nxt[1])
                nbytes += len(nxt[1].data)
            else:
                leftover = nxt
                break
        if len(msgs) == 1:
            return msg, leftover
        perf = self.messenger.perf
        perf.inc("batches_tx")
        perf.inc("batched_msgs", len(msgs))
        perf.hist_add("batch_ops", len(msgs))
        return _messages.pack_batch(msgs), leftover

    async def _write_loop(self, writer,
                          onwire: Onwire | None = None) -> None:
        perf = self.messenger.perf
        pending: tuple | None = None
        while True:
            if pending is not None:
                item, pending = pending, None
            else:
                # plain get — no wait_for wrapper task + timer per
                # frame (profiled per-frame overhead); idle acks ride
                # the dispatch loop's lazy _schedule_ack_flush timer
                item = await self._out.get()
            kind, arg = item
            if kind == "msg":
                arg, pending = await self._coalesce(arg)
                frame = Frame(Tag.MESSAGE, arg.encode_segments())
                perf.inc("frames_tx")
                if type(arg).TYPE in _messages.BATCHABLE_TYPES or \
                        isinstance(arg, (_messages.MOSDECSubOpBatch,
                                         _messages.MOSDECSubOpBatchReply)):
                    perf.inc("data_frames_tx")
            elif kind == "ack":
                frame = Frame(Tag.ACK, [json.dumps([arg]).encode()])
                self._last_acked_in = arg
            elif kind == "keepalive":
                frame = Frame(Tag.KEEPALIVE, [])
            elif kind == "keepalive_ack":
                frame = Frame(Tag.KEEPALIVE_ACK, [])
            else:  # pragma: no cover
                continue
            if onwire is not None:
                writer.write(onwire.wrap(frame.encode()))
            else:
                # plain crc mode: scatter-write the frame parts — the
                # transport's outbound join is the single tx copy, and
                # data segments (zero-copy views from upper layers)
                # never get assembled into an intermediate blob here
                writer.writelines(frame.encode_parts())
            await writer.drain()

    def _trim_sent(self, acked_seq: int) -> None:
        while self._sent and self._sent[0].seq <= acked_seq:
            self._sent.popleft()

    def __repr__(self) -> str:
        return (f"Connection({self.messenger.entity_name}->"
                f"{self.peer_name or self.peer_addr})")


class Messenger:
    """Endpoint owning connections + dispatcher chain (Messenger::create).

    Usage (daemon):   m = Messenger("osd.1"); m.add_dispatcher(osd);
                      await m.bind("127.0.0.1", 0); ...
    Usage (client):   m = Messenger("client.x");
                      conn = await m.connect(addr, Policy.lossy_client())
    """

    #: process-wide mode defaults (ms_compress_* / ms_secure conf):
    #: daemons build their Messengers internally, so a deployment turns
    #: modes on here (or per-instance via the ctor args)
    DEFAULT_COMPRESS = False
    DEFAULT_SECURE = False

    def __init__(self, entity_name: str, auth_key: bytes | None = None,
                 compress: bool | None = None,
                 secure: bool | None = None,
                 tenant: str | None = None):
        self.entity_name = entity_name
        # optional multi-tenant label carried in every outgoing HELLO:
        # the OSD's per-client accountant groups `client.<id>` entities
        # under it (the reference's rados namespace/auth-entity axis,
        # collapsed to one advisory string)
        self.tenant = tenant
        # negotiated on-wire modes (ProtocolV2 secure mode + on-wire
        # compression): both sides must want a mode for it to engage;
        # secure additionally requires the cephx-lite shared key
        self.compress = self.DEFAULT_COMPRESS if compress is None \
            else compress
        self.secure = self.DEFAULT_SECURE if secure is None else secure
        # cephx-lite: a shared cluster secret. When set, every session
        # (in AND out) must pass mutual HMAC challenge-response before
        # any message is exchanged (the reference's cephx mutual auth
        # collapsed onto one service key). With secure=True the same
        # key also seeds the AES-GCM onwire mode; without it, crc mode
        # (optionally compressed)
        self.auth_key = auth_key
        # frame/batch counters (process-wide "msgr" logger shared by
        # every messenger; the bench reads it for frames-per-write)
        self.perf = msgr_perf()
        self.dispatchers: list[Dispatcher] = []
        self._server: asyncio.base_events.Server | None = None
        self.my_addr: tuple[str, int] | None = None
        self._conns: dict[tuple[str, int], Connection] = {}
        self._accepted: dict[tuple[str, int], Connection] = {}
        # acceptor-side sessions by (entity, cookie) for reconnect matching
        self._sessions: dict[tuple[str, int], Connection] = {}
        self._connect_locks: dict[tuple[str, int], asyncio.Lock] = {}
        # detached close() tasks (superseded-session GC): tracked so
        # shutdown() can await them — an untracked close task spawned
        # during teardown is destroyed while pending and leaks the
        # connection's dispatch loop (the teardown tail spam)
        self._bg_tasks: set[asyncio.Task] = set()
        self._closed = False

    def _spawn_bg(self, coro) -> None:
        task = asyncio.get_running_loop().create_task(coro)
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)

    def add_dispatcher(self, d: Dispatcher) -> None:
        self.dispatchers.append(d)

    # -- server side ---------------------------------------------------------

    async def bind(self, host: str = "127.0.0.1", port: int = 0) -> tuple[str, int]:
        self._server = await asyncio.start_server(self._on_accept, host, port)
        self.my_addr = self._server.sockets[0].getsockname()[:2]
        dout("ms", 10, f"{self.entity_name} listening on {self.my_addr}")
        return self.my_addr

    def _negotiate_onwire(self, info: dict) -> dict:
        """Intersection of the initiator's requested modes and ours
        (ProtocolV2 feature negotiation)."""
        want = info.get("onwire") or {}
        return {"compress": bool(want.get("compress")) and self.compress,
                "secure": (bool(want.get("secure")) and self.secure
                           and self.auth_key is not None
                           and bool(info.get("auth_nonce")))}

    async def _on_accept(self, reader, writer) -> None:
        try:
            writer.write(BANNER)
            banner = await reader.readexactly(len(BANNER))
            if banner != BANNER:
                raise FrameError(f"bad banner {banner!r}")
            frame = await Frame.read(reader)
            if frame.tag not in (Tag.HELLO, Tag.RECONNECT):
                raise FrameError(f"bad handshake tag {frame.tag}")
            info = _json_seg(frame.segments[0])
        except Exception as e:
            dout("ms", 5, f"{self.entity_name} accept failed: {e}")
            writer.close()
            return
        key = (info.get("entity", "?"), info.get("cookie", 0))
        peer_in_seq = info.get("in_seq", 0)

        def _auth_fields(reply: dict,
                         agreed: dict) -> tuple[bool, str | None]:
            """cephx-lite acceptor: add our nonce+proof to the outgoing
            reply; returns (ok, expected initiator proof). The expected
            proof NEVER enters the wire-bound dict. Proofs bind the
            onwire negotiation transcript (anti-downgrade)."""
            if self.auth_key is None:
                return True, None
            peer_nonce = info.get("auth_nonce")
            if not peer_nonce:
                dout("ms", 1, f"{self.entity_name}: rejecting "
                              f"unauthenticated peer {key[0]}")
                writer.close()
                return False, None
            transcript = _onwire_transcript(info.get("onwire"), agreed)
            my_nonce = os.urandom(16).hex()
            reply["auth_nonce"] = my_nonce
            reply["auth_proof"] = _auth_proof(self.auth_key, "srv",
                                              peer_nonce, my_nonce,
                                              transcript)
            return True, _auth_proof(self.auth_key, "cli", my_nonce,
                                     peer_nonce, transcript)

        async def _auth_verify(want: str | None) -> bool:
            if want is None:
                return True
            try:
                proof_frame = await asyncio.wait_for(Frame.read(reader),
                                                     10.0)
                got = _json_seg(proof_frame.segments[0])
            except Exception:
                writer.close()
                return False
            if proof_frame.tag != Tag.AUTH or \
                    got.get("auth_proof") != want:
                dout("ms", 1, f"{self.entity_name}: peer {key[0]} failed "
                              f"auth proof")
                writer.close()
                return False
            return True

        if frame.tag == Tag.RECONNECT:
            conn = self._sessions.get(key)
            if conn is None or conn._closed:
                # stale session: tell the peer to start over
                writer.write(Frame(Tag.RESET, [b"{}"]).encode())
                await writer.drain()
                writer.close()
                return
            # the FULL auth exchange runs on the new socket BEFORE the
            # live session's transport is touched: a keyless peer
            # replaying a sniffed (entity, cookie) must not be able to
            # kill an authenticated session's transport
            reply = {"entity": self.entity_name,
                     "in_seq": conn._processed_seq}
            agreed = self._negotiate_onwire(info)
            reply["onwire"] = agreed
            ok, expect = _auth_fields(reply, agreed)
            if not ok:
                return
            writer.write(Frame(Tag.RECONNECT_OK,
                               [json.dumps(reply).encode()]).encode())
            await writer.drain()
            if not await _auth_verify(expect):
                return
            await conn._close_transport()
            # re-assert the session identity: the entity name is fixed
            # by the (entity, cookie) session key, but a restarted
            # client process may re-tag its tenant
            if "tenant" in info:
                conn.peer_tenant = info.get("tenant")
            conn._requeue_for_replay(peer_in_seq)
            conn._onwire = _build_onwire(
                agreed, role="srv", auth_key=self.auth_key,
                cli_nonce=info.get("auth_nonce"),
                srv_nonce=reply.get("auth_nonce"))
            conn._attach(reader, writer)
            return

        policy = Policy(lossy=bool(info.get("lossy", True)))
        conn = Connection(self, None, policy, initiator=False)
        conn.peer_name = info["entity"]
        conn.peer_tenant = info.get("tenant")
        conn.cookie = info.get("cookie", 0)
        reply = {"entity": self.entity_name, "in_seq": 0}
        agreed = self._negotiate_onwire(info)
        reply["onwire"] = agreed
        ok, expect = _auth_fields(reply, agreed)
        if not ok:
            return
        writer.write(Frame(Tag.HELLO, [json.dumps(reply).encode()]).encode())
        await writer.drain()
        if not await _auth_verify(expect):
            return
        conn._onwire = _build_onwire(
            agreed, role="srv", auth_key=self.auth_key,
            cli_nonce=info.get("auth_nonce"),
            srv_nonce=reply.get("auth_nonce"))
        conn._attach(reader, writer)
        if not policy.lossy:
            # one lossless session per peer entity: a fresh HELLO from an
            # entity supersedes any older session (its cookie is gone on
            # the peer), whose parked _run task would otherwise live forever
            for old_key, old in list(self._sessions.items()):
                if old_key[0] == key[0] and old_key != key:
                    del self._sessions[old_key]
                    self._spawn_bg(old.close())
            self._sessions[key] = conn
        peer = writer.get_extra_info("peername")
        if peer:
            self._accepted[peer[:2]] = conn
        for d in self.dispatchers:
            d.ms_handle_accept(conn)
        conn._spawn(conn._run())

    # -- client side ---------------------------------------------------------

    async def connect(self, addr: tuple[str, int],
                      policy: Policy | None = None) -> Connection:
        addr = tuple(addr)
        lock = self._connect_locks.setdefault(addr, asyncio.Lock())
        async with lock:   # concurrent first-sends must share one session
            conn = self._conns.get(addr)
            if conn is not None and not conn._closed:
                return conn
            conn = Connection(self, addr, policy or Policy.lossy_client(),
                              initiator=True)
            await conn._initiate()
            self._conns[addr] = conn
            return conn

    # -- dispatch ------------------------------------------------------------

    async def _dispatch(self, conn: Connection, msg: Message) -> None:
        for d in self.dispatchers:
            try:
                if await d.ms_dispatch(conn, msg):
                    return
            except Exception as e:
                dout("ms", 0, f"{self.entity_name} dispatcher error on "
                        f"{msg!r}: {type(e).__name__} {e}")
                raise
        dout("ms", 1, f"{self.entity_name} unhandled message {msg!r}")

    def _forget(self, conn: Connection) -> None:
        """Drop a finished connection from every table (its _run ended)."""
        for table in (self._conns, self._accepted, self._sessions):
            for key, c in list(table.items()):
                if c is conn:
                    del table[key]

    def _notify_reset(self, conn: Connection) -> None:
        for d in self.dispatchers:
            d.ms_handle_reset(conn)

    def _notify_remote_reset(self, conn: Connection) -> None:
        for d in self.dispatchers:
            d.ms_handle_remote_reset(conn)

    # -- teardown ------------------------------------------------------------

    async def shutdown(self) -> None:
        self._closed = True
        if self._server is not None:
            self._server.close()
        # connections first: since 3.12 Server.wait_closed() waits for all
        # accepted transports, which only die when we close them
        for conn in list(self._conns.values()) + list(self._accepted.values()) \
                + list(self._sessions.values()):
            await conn.close()
        self._conns.clear()
        self._accepted.clear()
        self._sessions.clear()
        # drain detached close tasks (no cancel: a half-run close() may
        # leave a transport dangling) — every connection task must be
        # DONE when shutdown returns, or loop teardown destroys them
        # pending
        await drain_all(list(self._bg_tasks))
        self._bg_tasks.clear()
        if self._server is not None:
            await self._server.wait_closed()
