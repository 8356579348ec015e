"""Paxos + elections over the messenger (src/mon/Paxos.cc, Elector.cc).

The reference's design, kept faithfully:

  * rank-based elections (lowest live rank wins a majority vote;
    epoch odd = electing, even = stable — ElectionLogic simplified to
    rank priority, without connectivity scoring);
  * one Paxos instance commits a totally-ordered sequence of opaque
    values ("versions"); services batch their state changes into these
    values (PaxosService);
  * leader phases after victory: collect (Paxos.cc:154 — gather promises
    and any uncommitted value, learn newer commits), then active;
  * proposals: begin (:613) -> every quorum peon accepts (:772) ->
    commit_start (:847) -> commit broadcast, then lease extension (:974)
    so peons can serve reads; a peon whose lease expires calls for a new
    election (leader failure detection);
  * proposal numbers are rank-salted (pn = ceil * 100 + rank) so
    competing leaders never collide.

Values are opaque bytes in the message data segment; the Monitor layer
feeds service transactions in and applies them on commit in version
order on every quorum member.

The port's copy of ceph_tpu/mon/paxos.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import asyncio
import time
from typing import Awaitable, Callable

from ceph_tpu_torch.msg.messages import MMonElection, MMonPaxos
from ceph_tpu_torch.msg.messenger import Connection, Messenger, Policy
from ceph_tpu_torch.utils.async_util import reap_all
from ceph_tpu_torch.utils.dout import dout


class NotLeader(Exception):
    """A proposal was made by (or survived into) a non-leader."""


class Paxos:
    ELECTION_TIMEOUT = 0.35     # victory claim after silence from betters
    LEASE_INTERVAL = 0.8        # leader re-extends this often
    LEASE_TIMEOUT = 3.0         # peon calls election when lease this stale
    ACCEPT_TIMEOUT = 2.0        # begin->accept stragglers force election

    def __init__(self, messenger: Messenger, rank: int,
                 peer_addrs: dict[int, tuple[str, int]], store,
                 on_commit: Callable[[int, bytes], None],
                 on_role_change: Callable[[], None] | None = None):
        self.messenger = messenger
        self.rank = rank
        self.peers = dict(peer_addrs)          # rank -> addr, excluding self
        self.store = store
        self.on_commit = on_commit             # (version, value) in order
        self.on_role_change = on_role_change or (lambda: None)
        self.on_sync: Callable[[], None] | None = None  # after sync_full
        self.perf = None           # hosting mon's PerfCounters, if any

        # durable state
        self.last_pn = store.get("paxos", "last_pn", 0)
        self.accepted_pn = store.get("paxos", "accepted_pn", 0)
        self.last_committed = store.get("paxos", "last_committed", 0)
        self.uncommitted: tuple[int, int, bytes] | None = None  # pn, v, value

        # volatile
        self.epoch = store.get("paxos", "election_epoch", 0)
        self.role = "probing"                  # probing|electing|leader|peon
        self.leader: int | None = None
        self.quorum: set[int] = {self.rank}
        self._election_acks: set[int] = set()
        self._collect_acks: set[int] = set()
        self._accept_acks: set[int] = set()
        self._pending_value: bytes | None = None
        self._proposal_queue: list[tuple[bytes, asyncio.Future]] = []
        self._inflight: asyncio.Future | None = None
        self._lease_expiry = 0.0
        self._active = False
        self._tasks: set[asyncio.Task] = set()
        self._started = False

    # ------------------------------------------------------------------ util

    def _spawn(self, coro) -> None:
        t = asyncio.get_running_loop().create_task(coro)
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)

    async def _send(self, rank: int, msg) -> None:
        try:
            conn = await self.messenger.connect(self.peers[rank],
                                                Policy.lossless_peer())
            conn.send_message(msg)
        except Exception as e:
            dout("paxos", 10, f"mon.{self.rank}: send to mon.{rank} "
                              f"failed: {e}")

    def _broadcast(self, make_msg) -> None:
        for r in self.peers:
            self._spawn(self._send(r, make_msg()))

    @property
    def majority(self) -> int:
        return (len(self.peers) + 1) // 2 + 1

    def is_leader(self) -> bool:
        return self.role == "leader"

    def is_active(self) -> bool:
        return self._active

    # ------------------------------------------------------------- lifecycle

    async def start(self) -> None:
        self._started = True
        self._spawn(self._tick())
        self.start_election()

    async def stop(self) -> None:
        self._started = False
        await reap_all(list(self._tasks))

    async def _tick(self) -> None:
        while True:
            await asyncio.sleep(self.LEASE_INTERVAL / 2)
            now = time.monotonic()
            if self.role == "leader" and self._active:
                if self.uncommitted is not None and \
                        now > self._accept_deadline:
                    # a quorum member died mid-proposal: accept acks will
                    # never arrive; bounce into an election so the quorum
                    # shrinks to the live set (Paxos.cc accept timeout)
                    dout("paxos", 5, f"mon.{self.rank}: accept timeout, "
                                     "electing")
                    self.start_election()
                else:
                    self._extend_lease()
            elif self.role == "leader" and not self._active and \
                    now > self._accept_deadline:
                # collect phase stalled the same way (dead quorum member
                # between victory and active): re-elect with the live set
                dout("paxos", 5, f"mon.{self.rank}: collect timeout, "
                                 "electing")
                self.start_election()
            elif self.role == "peon" and now > self._lease_expiry:
                dout("paxos", 5, f"mon.{self.rank}: lease expired, electing")
                self.start_election()
            elif self.role in ("probing", "electing") and \
                    now > self._election_deadline:
                self._finish_election()

    # -------------------------------------------------------------- election

    def start_election(self) -> None:
        self.role = "electing"
        self._active = False
        if self.perf is not None:
            self.perf.inc("election")
        self.epoch += 1 if self.epoch % 2 == 0 else 2
        self.store.put_one("paxos", "election_epoch", self.epoch)
        self._election_acks = {self.rank}
        self._election_deadline = time.monotonic() + self.ELECTION_TIMEOUT
        dout("paxos", 10, f"mon.{self.rank}: election epoch {self.epoch}")
        self._broadcast(lambda: MMonElection(
            {"op": "propose", "epoch": self.epoch, "rank": self.rank}))
        if not self.peers:
            self._finish_election()

    def _finish_election(self) -> None:
        if self.role != "electing":
            return
        if len(self._election_acks) >= self.majority:
            self._declare_victory()
        else:
            # couldn't form quorum: retry
            self._election_deadline = time.monotonic() + self.ELECTION_TIMEOUT
            self._broadcast(lambda: MMonElection(
                {"op": "propose", "epoch": self.epoch, "rank": self.rank}))

    def _declare_victory(self) -> None:
        self.epoch += 1 if self.epoch % 2 == 1 else 2
        self.store.put_one("paxos", "election_epoch", self.epoch)
        self.role = "leader"
        self.leader = self.rank
        self.quorum = set(self._election_acks)
        dout("paxos", 5, f"mon.{self.rank}: leader of {sorted(self.quorum)} "
                         f"epoch {self.epoch}")
        self._broadcast(lambda: MMonElection(
            {"op": "victory", "epoch": self.epoch, "rank": self.rank,
             "quorum": sorted(self.quorum)}))
        self._collect()
        self.on_role_change()

    async def handle_election(self, conn: Connection, msg: MMonElection) -> None:
        op = msg.payload["op"]
        peer_rank = msg.payload["rank"]
        peer_epoch = msg.payload["epoch"]
        if peer_epoch > self.epoch:
            self.epoch = peer_epoch
            self.store.put_one("paxos", "election_epoch", self.epoch)
        if op == "propose":
            if peer_rank < self.rank:
                # they outrank us (lower rank wins): defer
                self.role = "electing" if self.role != "peon" else self.role
                self._active = False
                self._election_deadline = time.monotonic() + \
                    self.LEASE_TIMEOUT
                await self._send(peer_rank, MMonElection(
                    {"op": "ack", "epoch": peer_epoch, "rank": self.rank}))
            else:
                # we outrank them: push our own candidacy
                if self.role in ("leader", "peon") and self._active and \
                        self.leader is not None and self.leader < peer_rank \
                        and peer_rank in self.quorum:
                    # stable quorum under a better leader and the proposer
                    # is already a member (a duplicate/late propose);
                    # re-assert it
                    if self.is_leader():
                        self._broadcast(lambda: MMonElection(
                            {"op": "victory", "epoch": self.epoch,
                             "rank": self.rank,
                             "quorum": sorted(self.quorum)}))
                else:
                    # a rank OUTSIDE the quorum proposing means a mon
                    # booted/rejoined: run a full election so the quorum
                    # grows to include it (the reference joins every
                    # propose; re-asserting the stale quorum would lock
                    # the newcomer out forever)
                    self.start_election()
        elif op == "ack":
            if self.role == "electing" and peer_epoch == self.epoch:
                self._election_acks.add(peer_rank)
                if len(self._election_acks) == len(self.peers) + 1:
                    self._finish_election()   # everyone answered: no wait
        elif op == "victory":
            if peer_rank <= self.rank:
                self.role = "peon"
                self.leader = peer_rank
                self.quorum = set(msg.payload.get("quorum", []))
                self._lease_expiry = time.monotonic() + self.LEASE_TIMEOUT
                self._fail_proposals("lost leadership")
                self.on_role_change()
            else:
                self.start_election()   # a worse rank claims victory: contest

    # --------------------------------------------------------------- collect

    def _new_pn(self) -> int:
        pn = ((max(self.last_pn, self.accepted_pn) // 100) + 1) * 100 \
            + self.rank
        self.last_pn = pn
        self.store.put_one("paxos", "last_pn", pn)
        return pn

    def _collect(self) -> None:
        """Leader phase 1 (Paxos.cc:154): gather promises + stray state."""
        self._active = False
        pn = self._new_pn()
        self.accepted_pn = pn
        self.store.put_one("paxos", "accepted_pn", pn)
        self._collect_acks = {self.rank}
        self._accept_deadline = time.monotonic() + self.ACCEPT_TIMEOUT
        if self.uncommitted and self.uncommitted[1] == self.last_committed + 1:
            self._pending_value = self.uncommitted[2]
        for r in sorted(self.quorum - {self.rank}):
            self._spawn(self._send(r, MMonPaxos(
                {"op": "collect", "pn": pn,
                 "last_committed": self.last_committed})))
        self._maybe_collect_done()

    def _maybe_collect_done(self) -> None:
        if self.role != "leader" or self._active:
            return
        if self._collect_acks >= self.quorum:
            self._active = True
            dout("paxos", 10, f"mon.{self.rank}: collect done, active")
            self._extend_lease()
            if self._pending_value is not None:
                value = self._pending_value
                self._pending_value = None
                self._begin(value)
            else:
                if self._inflight is not None:
                    # we re-won an election but the value we had in flight
                    # wasn't carried into this round (it either committed
                    # through a share or is gone): its outcome is unknown,
                    # so fail the waiter — callers retry and the service
                    # layer dedupes stale epochs
                    if not self._inflight.done():
                        self._inflight.set_exception(NotLeader(
                            "proposal outcome unknown after re-election"))
                    self._inflight = None
                self._kick_queue()

    # --------------------------------------------------------- begin/commit

    def propose(self, value: bytes) -> asyncio.Future:
        """Queue a value; resolves with its committed version (leader only;
        callers check is_leader)."""
        fut = asyncio.get_running_loop().create_future()
        if self.role != "leader":
            fut.set_exception(NotLeader(f"mon.{self.rank} is {self.role}"))
            return fut
        self._proposal_queue.append((value, fut))
        self._kick_queue()
        return fut

    def _fail_proposals(self, why: str) -> None:
        """Fail queued/in-flight proposal futures (leadership lost). The
        in-flight value may still commit through the new leader's collect;
        callers dedupe via service-level stale-epoch skip."""
        for _, fut in self._proposal_queue:
            if not fut.done():
                fut.set_exception(NotLeader(why))
        self._proposal_queue.clear()
        if self._inflight is not None and not self._inflight.done():
            self._inflight.set_exception(NotLeader(why))
        self._inflight = None

    def _kick_queue(self) -> None:
        if (self.role == "leader" and self._active
                and self._inflight is None and self._proposal_queue):
            value, fut = self._proposal_queue.pop(0)
            self._inflight = fut
            self._begin(value)

    def _begin(self, value: bytes) -> None:
        version = self.last_committed + 1
        self.uncommitted = (self.accepted_pn, version, value)
        self.store.put_one("paxos", "uncommitted",
                           [self.accepted_pn, version,
                            value.decode("latin1")])
        self._accept_acks = {self.rank}
        self._accept_deadline = time.monotonic() + self.ACCEPT_TIMEOUT
        for r in sorted(self.quorum - {self.rank}):
            self._spawn(self._send(r, MMonPaxos(
                {"op": "begin", "pn": self.accepted_pn, "version": version},
                value)))
        self._maybe_accepted()

    def _maybe_accepted(self) -> None:
        if self.uncommitted is None or self.role != "leader":
            return
        if self._accept_acks >= self.quorum:
            # whole quorum accepted (Paxos.cc:847 commit_start)
            pn, version, value = self.uncommitted
            self._commit(version, value)
            for r in sorted(self.quorum - {self.rank}):
                self._spawn(self._send(r, MMonPaxos(
                    {"op": "commit", "version": version}, value)))
            self._extend_lease()
            if self._inflight is not None and not self._inflight.done():
                self._inflight.set_result(version)
            self._inflight = None
            self._kick_queue()

    KEEP_VERSIONS = 256   # paxos trim window (mon_max_log_entries analog)

    def _commit(self, version: int, value: bytes) -> None:
        from ceph_tpu_torch.mon.store import MonStoreTxn
        txn = MonStoreTxn()
        txn.put("paxos_values", str(version), value.decode("latin1"))
        txn.put("paxos", "last_committed", version)
        txn.erase("paxos", "uncommitted")
        # trim: keep a bounded version window (reference Paxos::trim) so
        # the store stays O(live state), not O(history)
        first = self.store.get("paxos", "first_committed", 1)
        new_first = version - self.KEEP_VERSIONS + 1
        if new_first > first:
            for v in range(first, new_first):
                txn.erase("paxos_values", str(v))
            txn.put("paxos", "first_committed", new_first)
        self.store.apply_transaction(txn)
        self.last_committed = version
        self.uncommitted = None
        if self.perf is not None:
            self.perf.inc("paxos_commit")
        self.on_commit(version, value)

    def _extend_lease(self) -> None:
        for r in sorted(self.quorum - {self.rank}):
            self._spawn(self._send(r, MMonPaxos(
                {"op": "lease", "last_committed": self.last_committed})))

    # ------------------------------------------------------------- peon side

    async def handle_paxos(self, conn: Connection, msg: MMonPaxos) -> None:
        op = msg.payload["op"]
        if op == "collect":
            pn = msg.payload["pn"]
            reply = {"op": "last", "pn": pn, "rank": self.rank,
                     "last_committed": self.last_committed}
            data = b""
            if pn > self.accepted_pn:
                self.accepted_pn = pn
                self.store.put_one("paxos", "accepted_pn", pn)
                if self.uncommitted:
                    reply["uncommitted_pn"] = self.uncommitted[0]
                    reply["uncommitted_version"] = self.uncommitted[1]
                    data = self.uncommitted[2]
            # share newer commits with a lagging leader regardless of
            # whether we also hold an uncommitted value (Paxos share_state)
            leader_lc = msg.payload.get("last_committed", 0)
            if self.last_committed > leader_lc:
                first = self.store.get("paxos", "first_committed", 1)
                if leader_lc + 1 < first:
                    # the LEADER is behind our trim horizon (it restarted
                    # after a long outage and won on rank): a gappy share
                    # would apply nothing; hand it the whole store instead
                    conn.send_message(MMonPaxos(
                        {"op": "sync_full", "store": self.store.dump(),
                         "last_committed": self.last_committed}))
                    return
                share = self._values_since(leader_lc)
                reply["share"] = [[v, val.decode("latin1")]
                                  for v, val in share]
            conn.send_message(MMonPaxos(reply, data))
        elif op == "last":
            if self.role != "leader":
                return
            peer = msg.payload["rank"]
            # learn newer commits from the peon
            for v, val in msg.payload.get("share", []):
                if v == self.last_committed + 1:
                    self._commit(v, val.encode("latin1"))
            if msg.payload.get("uncommitted_version") == \
                    self.last_committed + 1 and msg.data:
                self._pending_value = msg.data
            # catch a lagging peon up BEFORE counting it into the quorum:
            # ordered lossless delivery means these commits land before
            # any later begin, so the peon can accept version lc+1
            # (Paxos::share_state; without it a lagging peon rejects
            # every begin and the quorum wedges)
            peer_lc = msg.payload.get("last_committed", 0)
            if peer_lc < self.last_committed:
                first = self.store.get("paxos", "first_committed", 1)
                if peer_lc + 1 < first:
                    # beyond our trim horizon: full store sync
                    conn.send_message(MMonPaxos(
                        {"op": "sync_full",
                         "store": self.store.dump(),
                         "last_committed": self.last_committed}))
                else:
                    for v, val in self._values_since(peer_lc):
                        conn.send_message(MMonPaxos(
                            {"op": "commit", "version": v}, val))
            self._collect_acks.add(peer)
            self._maybe_collect_done()
        elif op == "sync_full":
            # we are hopelessly behind (restarted past the peer's trim
            # horizon): adopt the peer's whole store (Monitor sync). This
            # runs on a behind peon (leader caught us up) or on a behind
            # LEADER (a peon refused a gappy share) — a leader re-collects
            # with its recovered state so begins line up with the quorum.
            if msg.payload.get("last_committed", 0) <= self.last_committed:
                return      # stale/duplicate sync
            self.store.load_dump(msg.payload["store"])
            self.last_committed = self.store.get("paxos",
                                                 "last_committed", 0)
            self.accepted_pn = self.store.get("paxos", "accepted_pn", 0)
            self.uncommitted = None
            if self.on_sync is not None:
                self.on_sync()
            if self.role == "leader":
                self._collect()
        elif op == "begin":
            pn = msg.payload["pn"]
            version = msg.payload["version"]
            if pn >= self.accepted_pn and version == self.last_committed + 1:
                self.uncommitted = (pn, version, msg.data)
                self.store.put_one("paxos", "uncommitted",
                                   [pn, version, msg.data.decode("latin1")])
                conn.send_message(MMonPaxos(
                    {"op": "accept", "pn": pn, "version": version,
                     "rank": self.rank}))
        elif op == "accept":
            if self.role == "leader" and \
                    msg.payload["pn"] == self.accepted_pn:
                self._accept_acks.add(msg.payload["rank"])
                self._maybe_accepted()
        elif op == "commit":
            version = msg.payload["version"]
            if version == self.last_committed + 1:
                self._commit(version, msg.data)
            self._lease_expiry = time.monotonic() + self.LEASE_TIMEOUT
        elif op == "lease":
            self._lease_expiry = time.monotonic() + self.LEASE_TIMEOUT
            # catch up if we missed commits (shouldn't happen on lossless)
            conn.send_message(MMonPaxos(
                {"op": "lease_ack", "rank": self.rank,
                 "last_committed": self.last_committed}))
        elif op == "lease_ack":
            pass

    def _values_since(self, version: int) -> list[tuple[int, bytes]]:
        out = []
        for v in range(version + 1, self.last_committed + 1):
            val = self.store.get("paxos_values", str(v))
            if val is not None:
                out.append((v, val.encode("latin1")))
        return out

    # -------------------------------------------------------------- recovery

    def recover_from_store(self) -> None:
        """Reload committed history pointers after restart; the Monitor
        replays service state from its own store keys."""
        unc = self.store.get("paxos", "uncommitted")
        if unc:
            self.uncommitted = (unc[0], unc[1], unc[2].encode("latin1"))

    _election_deadline = float("inf")
    _accept_deadline = float("inf")
