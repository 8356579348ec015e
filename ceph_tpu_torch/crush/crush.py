"""CRUSH: deterministic pseudo-random placement on a weighted hierarchy.

Re-creation of the reference's CRUSH core (src/crush/mapper.c): straw2
bucket selection (`bucket_straw2_choose`, mapper.c:342 — each item draws
ln(hash)/weight and the max wins, giving weight-proportional, minimally-
disruptive placement) and the rule engine (`crush_do_rule`, take →
choose/chooseleaf {firstn|indep} → emit, with collision/failure retries
and R'-style replacement for indep). Device health enters through a
weight vector (reweights, 0 = out) exactly like the reference's
crush_do_rule weight argument.

Deliberate divergence: the hash is a splitmix64-based mix rather than
rjenkins1, and straw2 uses float ln rather than the fixed-point log table
— placements are deterministic and stable across runs/platforms but not
byte-identical to a real ceph cluster's.

The port's copy of ceph_tpu/crush/crush.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable

CRUSH_NONE = -0x7FFFFFFF  # CRUSH_ITEM_NONE: an unfilled (hole) slot

DEVICE = 0  # bucket type id 0 = device (osd)


def _mix(*values: int) -> int:
    """Deterministic 64-bit mix (splitmix64 finalizer over the args)."""
    h = 0x9E3779B97F4A7C15
    for v in values:
        h ^= (v & 0xFFFFFFFFFFFFFFFF) + 0x9E3779B97F4A7C15 + (h << 6) + (h >> 2)
        h &= 0xFFFFFFFFFFFFFFFF
        h ^= h >> 30
        h = (h * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 27
        h = (h * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return h


def _straw2_draw(x: int, item: int, r: int, weight: float) -> float:
    """ln(u)/w draw — the straw2 race (mapper.c:342 semantics)."""
    if weight <= 0:
        return -math.inf
    u = (_mix(x, item, r) & 0xFFFFFFFFFFFF) / float(1 << 48)
    u = max(u, 1e-18)
    return math.log(u) / weight


@dataclasses.dataclass
class Bucket:
    id: int                      # negative for buckets, >= 0 for devices
    type: int                    # 0=device, 1=host, 2=rack, ... (type ids)
    name: str
    items: list[int] = dataclasses.field(default_factory=list)
    weights: list[float] = dataclasses.field(default_factory=list)

    def weight(self) -> float:
        return sum(self.weights)


@dataclasses.dataclass
class Step:
    op: str                      # take | choose | chooseleaf | emit
    num: int = 0                 # replicas to pick (0 = pool size)
    type: int = 0                # bucket type to descend to
    mode: str = "firstn"         # firstn | indep
    arg: str = ""                # take target name


@dataclasses.dataclass
class Rule:
    id: int
    name: str
    steps: list[Step]


class CrushMap:
    def __init__(self):
        self._buckets: dict[int, Bucket] = {}
        self._names: dict[str, int] = {}
        self._rules: dict[int, Rule] = {}
        self._type_names: dict[int, str] = {0: "osd", 1: "host", 2: "rack",
                                            3: "row", 10: "root"}
        self._next_bucket_id = -1
        self._domain_counts: dict[tuple[int, int], int] = {}
        self.tries = 50          # choose_total_tries
        # firstn only: when live failure domains are exhausted, place the
        # remaining replicas on already-used domains (never reusing a
        # device) instead of returning a short result like mapper.c does.
        # Keeps replica count at the cost of domain separation in the
        # degraded case; set False for strict reference semantics, where a
        # short result is what signals degraded placement to the caller.
        self.relax_firstn_on_exhaustion = True

    # -- building ------------------------------------------------------------

    def add_bucket(self, type: int, name: str) -> int:
        if name in self._names:
            raise ValueError(f"bucket {name!r} exists")
        bid = self._next_bucket_id
        self._next_bucket_id -= 1
        self._buckets[bid] = Bucket(bid, type, name)
        self._names[name] = bid
        return bid

    def add_item(self, parent: int | str, item: int, weight: float,
                 name: str | None = None) -> None:
        """Add a device or bucket under `parent` with the given weight."""
        bucket = self._bucket(parent)
        if item in bucket.items:
            raise ValueError(f"item {item} already in {bucket.name}")
        bucket.items.append(item)
        bucket.weights.append(weight)
        self._domain_counts.clear()
        if name is not None:
            self._names[name] = item

    def reweight_item(self, parent: int | str, item: int,
                      weight: float) -> None:
        bucket = self._bucket(parent)
        idx = bucket.items.index(item)
        bucket.weights[idx] = weight

    def _bucket(self, ref: int | str) -> Bucket:
        bid = self._names[ref] if isinstance(ref, str) else ref
        return self._buckets[bid]

    def bucket_of(self, ref: int | str) -> Bucket:
        return self._bucket(ref)

    # -- rules ---------------------------------------------------------------

    def add_rule(self, rule: Rule) -> None:
        if rule.id in self._rules:
            raise ValueError(f"rule {rule.id} exists")
        self._rules[rule.id] = rule

    def make_simple_rule(self, rule_id: int, name: str, root: str,
                         failure_domain_type: int,
                         mode: str = "firstn") -> Rule:
        """replicated/EC default rule: take root; chooseleaf n of domain;
        emit (CrushWrapper::add_simple_rule / ErasureCode::create_rule —
        EC uses mode='indep')."""
        rule = Rule(rule_id, name, [
            Step("take", arg=root),
            Step("chooseleaf", num=0, type=failure_domain_type, mode=mode),
            Step("emit"),
        ])
        self.add_rule(rule)
        return rule

    # -- mapping -------------------------------------------------------------

    def _choose_one(self, bucket: Bucket, x: int, r: int,
                    weights: dict[int, float]) -> int:
        """straw2 winner among bucket items for replica rank r."""
        best, best_draw = CRUSH_NONE, -math.inf
        for item, w in zip(bucket.items, bucket.weights):
            if item >= 0:
                w *= weights.get(item, 1.0)  # reweight/out factor
            draw = _straw2_draw(x, item, r, w)
            if draw > best_draw:
                best, best_draw = item, draw
        return best

    def _descend(self, start: int, x: int, r: int, target_type: int,
                 weights: dict[int, float]) -> int:
        """Walk from `start` down to an item of target_type via straw2."""
        node = start
        for _ in range(32):
            if target_type == DEVICE:
                if node >= 0:
                    return node
            bucket = self._buckets.get(node)
            if bucket is None:
                return CRUSH_NONE
            if bucket.type == target_type:
                return node
            node = self._choose_one(bucket, x, r, weights)
            if node == CRUSH_NONE:
                return CRUSH_NONE
            if node >= 0 and target_type != DEVICE:
                return CRUSH_NONE  # hit a device before the target type
        return CRUSH_NONE

    def _leaf_under(self, node: int, x: int, r: int,
                    weights: dict[int, float]) -> int:
        return self._descend(node, x, r, DEVICE, weights)

    def do_rule(self, rule_id: int, x: int, num_rep: int,
                weights: dict[int, float] | None = None) -> list[int]:
        """Map input x to an ordered list of devices (crush_do_rule).

        firstn: failures are skipped (result may be short).
        indep: failures leave CRUSH_NONE holes at their rank — EC shard
        ranks are positional (mapper.c indep semantics).
        """
        weights = weights or {}
        rule = self._rules[rule_id]
        working: list[int] = []
        out: list[int] = []
        for step in rule.steps:
            if step.op == "take":
                working = [self._names[step.arg]]
            elif step.op in ("choose", "chooseleaf"):
                n = step.num if step.num > 0 else num_rep
                chosen: list[int] = []
                for parent in working:
                    chosen.extend(self._choose_n(
                        parent, x, n, step, weights))
                working = chosen
            elif step.op == "emit":
                out.extend(working)
                working = []
            else:
                raise ValueError(f"unknown step op {step.op!r}")
        return out[:num_rep] if rule.steps[-1].op == "emit" else out

    # -- wire form (ships inside OSDMap; crushtool-style dump) ---------------

    def to_dict(self) -> dict:
        return {
            "buckets": [dataclasses.asdict(b) for b in
                        sorted(self._buckets.values(), key=lambda b: -b.id)],
            "rules": [dataclasses.asdict(r) for r in
                      sorted(self._rules.values(), key=lambda r: r.id)],
            "names": {name: ref for name, ref in self._names.items()},
            "type_names": {str(t): n for t, n in self._type_names.items()},
            "tries": self.tries,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CrushMap":
        cm = cls()
        for bd in d["buckets"]:
            b = Bucket(**bd)
            cm._buckets[b.id] = b
            cm._next_bucket_id = min(cm._next_bucket_id, b.id - 1)
        for rd in d["rules"]:
            rd = dict(rd)   # never mutate the caller's dict: it may be a
            # stored incremental that other appliers will replay
            steps = [Step(**s) for s in rd.pop("steps")]
            cm._rules[rd["id"]] = Rule(steps=steps, **rd)
        cm._names = dict(d["names"])
        cm._type_names = {int(t): n for t, n in d["type_names"].items()}
        cm.tries = d.get("tries", 50)
        return cm

    def _choose_n(self, parent: int, x: int, n: int, step: Step,
                  weights: dict[int, float]) -> list[int]:
        """Pick n items of step.type under parent (crush_choose_{firstn,indep}).

        Two-phase design (deliberate divergence from mapper.c that makes
        indep's positional stability a *guarantee* rather than best-effort):

        Phase A assigns each rank a failure-domain bucket using draws that
        do not look at leaf liveness (bucket straw2 weights are static, and
        `_choose_one` only applies the live-weight vector to devices), with
        domain-level collision checks — mapper.c rejects `out[i] == item`
        at the bucket level too, which is what keeps two replicas off one
        host.  Because these draws ignore device deaths, the assignment is
        bit-identical between a healthy and a degraded run.

        Phase B picks a live leaf under each assigned domain.  A domain
        whose leaves are all dead leaves its rank unfilled — without
        disturbing any other rank, since assignments were already fixed.

        Phase C (repair) retries unfilled ranks attempt-major over domains
        nobody claimed.  In mapper.c the retrying rank re-draws from the
        full pool and can steal a domain that a later surviving rank would
        have kept (observable rank churn under host death); here survivors
        are immovable by construction.

        firstn additionally relaxes domain distinctness once domains are
        exhausted (phase D) so the replica count is met — the reference
        instead returns a short result; we prefer keeping redundancy and
        document the divergence.  indep never relaxes: failed ranks keep
        their CRUSH_NONE hole so EC shard ids stay positional.
        """
        indep = step.mode == "indep"
        domains = [CRUSH_NONE] * n   # assigned failure-domain node per rank
        leaves = [CRUSH_NONE] * n
        claimed: set[int] = set()
        used_leaves: set[int] = set()

        def draw_domain(rank: int, t: int, allow_claimed: bool = False) -> int:
            node = self._descend(parent, x, rank + t * n, step.type, weights)
            if node == CRUSH_NONE or (node in claimed and not allow_claimed):
                return CRUSH_NONE
            if node >= 0 and weights.get(node, 1.0) <= 0:
                return CRUSH_NONE
            return node

        def pick_leaf(rank: int, node: int) -> int:
            if node >= 0:   # domain is a device (choose/chooseleaf type 0)
                return node if node not in used_leaves else CRUSH_NONE
            if step.op == "choose":
                # intermediate bucket: the result IS the bucket; later rule
                # steps descend further (crush_choose without recurse_to_leaf)
                return node if node not in used_leaves else CRUSH_NONE
            for t in range(self.tries):
                leaf = self._leaf_under(node, x, rank + t * n, weights)
                if (leaf != CRUSH_NONE and leaf not in used_leaves
                        and weights.get(leaf, 1.0) > 0):
                    return leaf
            return CRUSH_NONE

        # Phase A: domain assignment. indep is attempt-major (a rank that
        # can place at pass t does so before any rank's pass-t+1 retry);
        # firstn is rank-major like crush_choose_firstn.
        if indep:
            for t in range(self.tries):
                unfilled = [i for i in range(n) if domains[i] == CRUSH_NONE]
                if not unfilled:
                    break
                for rank in unfilled:
                    node = draw_domain(rank, t)
                    if node != CRUSH_NONE:
                        domains[rank] = node
                        claimed.add(node)
        else:
            for rank in range(n):
                for t in range(self.tries):
                    node = draw_domain(rank, t)
                    if node != CRUSH_NONE:
                        domains[rank] = node
                        claimed.add(node)
                        break

        # Phase B: leaf under each assigned domain. Dead domains stay
        # claimed so repair draws don't waste tries re-visiting them.
        for rank in range(n):
            if domains[rank] == CRUSH_NONE:
                continue
            leaf = pick_leaf(rank, domains[rank])
            if leaf != CRUSH_NONE:
                leaves[rank] = leaf
                used_leaves.add(leaf)

        def repair_pass(t_offset: int, allow_claimed: bool) -> None:
            """Attempt-major retries for unfilled ranks."""
            for t in range(self.tries):
                unfilled = [i for i in range(n) if leaves[i] == CRUSH_NONE]
                if not unfilled:
                    return
                for rank in unfilled:
                    node = draw_domain(rank, t_offset + t, allow_claimed)
                    if node == CRUSH_NONE:
                        continue
                    leaf = pick_leaf(rank, node)
                    if leaf == CRUSH_NONE:
                        continue
                    domains[rank] = node
                    leaves[rank] = leaf
                    claimed.add(node)
                    used_leaves.add(leaf)

        # Phase C: repair unfilled ranks over unclaimed domains only —
        # skipped outright when every domain under parent is claimed, so a
        # degraded mapping doesn't burn tries on guaranteed-futile draws.
        if any(leaf == CRUSH_NONE for leaf in leaves) and \
                len(claimed) < self._count_domains(parent, step.type):
            repair_pass(self.tries, allow_claimed=False)

        if indep:
            return leaves  # failed ranks keep their CRUSH_NONE hole

        # Phase D (firstn only): domains exhausted — allow domain reuse but
        # never leaf reuse, then compact.
        if self.relax_firstn_on_exhaustion:
            repair_pass(2 * self.tries, allow_claimed=True)
        return [leaf for leaf in leaves if leaf != CRUSH_NONE]

    def _count_domains(self, parent: int, target_type: int) -> int:
        """Number of distinct items of target_type in the subtree of parent.
        Cached per (parent, type); invalidated when topology changes."""
        key = (parent, target_type)
        cached = self._domain_counts.get(key)
        if cached is not None:
            return cached
        count = 0
        stack = [parent]
        while stack:
            node = stack.pop()
            if target_type == DEVICE:
                if node >= 0:
                    count += 1
                    continue
            bucket = self._buckets.get(node)
            if bucket is None:
                continue
            if bucket.type == target_type:
                count += 1
                continue
            stack.extend(bucket.items)
        self._domain_counts[key] = count
        return count
