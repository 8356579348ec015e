"""Deterministic, seed-reproducible fault injection.

Re-creation of the reference's fault-injection surface — the conf-knob
message faults of src/msg (`ms_inject_socket_failures`,
`ms_inject_delay_*`), the `ceph daemon ... injectargs`/thrasher verbs of
qa/tasks/ceph_manager.py, and the EIO/bit-rot hooks the scrub machinery
is tested against — collapsed onto one process-wide injector that every
layer consults:

  * msg/messenger.py read loop: drop / duplicate / delay incoming
    MESSAGE frames (`fault_inject_msg_*` probabilities, or one-shot
    rules armed per entity/message-type for surgical tests);
  * osd/daemon.py: `inject` admin-socket verbs (crash, hang, bitrot,
    msg, device) so tests and the failure-storm bench drive the same
    code an operator would;
  * osd/ec_backend.py: shard bit-rot after sub-write apply
    (`fault_inject_bitrot`), caught by the per-chunk crc gate;
  * offload/service.py: injected device-dispatch failures
    (`fault_inject_device_fail`), exercising the circuit breaker and
    the bit-identical host fallback.

Determinism: every probabilistic decision is derived from
(seed, site, per-site event counter) — NOT from a shared RNG whose
draw order would depend on cross-site interleaving — so two runs that
consult a site in the same order take identical decisions, and the
recorded injection log is byte-comparable across runs (the
seed-reproducibility contract the qa tier asserts). One-shot rules are
exact by construction.

The port's copy of ceph_tpu/qa/faultinject.py (jax-free; the
port imports nothing of the JAX package).
"""
from __future__ import annotations

import random
import threading
from typing import Any

from ceph_tpu_torch.utils.dout import dout

#: retained injection-log entries (ring; status() serves the tail)
LOG_CAP = 4096

_DEFAULTS: dict[str, Any] = {
    "enabled": False,
    "seed": 0,
    "msg_drop": 0.0,
    "msg_dup": 0.0,
    "msg_delay": 0.0,
    "msg_delay_ms": 10.0,
    "bitrot": 0.0,
    "device_fail": 0.0,
}


class FaultInjector:
    """Process-wide injector: seeded decisions + one-shot rules + log."""

    def __init__(self, seed: int = 0):
        self.enabled = bool(_DEFAULTS["enabled"])
        self.seed = int(seed)
        self.msg_drop = float(_DEFAULTS["msg_drop"])
        self.msg_dup = float(_DEFAULTS["msg_dup"])
        self.msg_delay = float(_DEFAULTS["msg_delay"])
        self.msg_delay_ms = float(_DEFAULTS["msg_delay_ms"])
        self.bitrot = float(_DEFAULTS["bitrot"])
        self.device_fail = float(_DEFAULTS["device_fail"])
        self._device_fail_n = 0         # one-shot device failures
        self._oneshots: list[dict] = []
        self._counts: dict[str, int] = {}
        self.log: list[tuple] = []      # (site, n, action, detail)
        # one-shot/arm state mutates from admin-socket threads while the
        # event loop consults; decisions themselves are lock-cheap
        self._lock = threading.Lock()

    # -- deterministic decisions ---------------------------------------------

    def _draw(self, site: str) -> tuple[float, int]:
        """One uniform draw for event n of `site`, a pure function of
        (seed, site, n): reproducible regardless of how other sites
        interleave with this one."""
        n = self._counts.get(site, 0)
        self._counts[site] = n + 1
        return random.Random(f"{self.seed}:{site}:{n}").random(), n

    def _note(self, site: str, n: int, action: str, detail: str) -> None:
        self.log.append((site, n, action, detail))
        if len(self.log) > LOG_CAP:
            del self.log[: len(self.log) - LOG_CAP]
        dout("inject", 4, f"fault {site}#{n}: {action} ({detail})")
        # every fired fault is a flight event: a post-mortem timeline
        # must show the injected cause next to its observed effects
        # (local import: faultinject loads before most of the tree)
        from ceph_tpu_torch.utils import flight
        flight.record("fault_injected", site, n=n, action=action,
                      detail=detail)

    # -- arming ---------------------------------------------------------------

    def reset(self, seed: int | None = None) -> None:
        with self._lock:
            if seed is not None:
                self.seed = int(seed)
            self._counts.clear()
            self.log.clear()
            self._oneshots.clear()
            self._device_fail_n = 0

    def arm_oneshot(self, entity: str | None = None,
                    msg_type: str | None = None, action: str = "drop",
                    count: int = 1, delay_ms: float | None = None) -> dict:
        """Exact-match message fault: the next `count` MESSAGE frames
        whose receiving entity starts with `entity` (any when None) and
        whose type name equals `msg_type` (any when None) take `action`
        (drop|dup|delay) regardless of probabilities."""
        if action not in ("drop", "dup", "delay"):
            raise ValueError(f"unknown one-shot action {action!r}")
        rule = {"entity": entity, "type": msg_type, "action": action,
                "count": max(1, int(count)),
                "delay_ms": float(delay_ms if delay_ms is not None
                                  else self.msg_delay_ms)}
        with self._lock:
            self._oneshots.append(rule)
        return dict(rule)

    def arm_device_failures(self, count: int = 1) -> int:
        with self._lock:
            self._device_fail_n += max(1, int(count))
            return self._device_fail_n

    # -- consult sites --------------------------------------------------------

    def on_message(self, entity: str, msg) -> tuple[str, float]:
        """Action for one received message: ("deliver"|"drop"|"dup"|
        "delay", delay_seconds)."""
        tname = type(msg).__name__
        with self._lock:
            for rule in self._oneshots:
                if rule["entity"] is not None and \
                        not entity.startswith(rule["entity"]):
                    continue
                if rule["type"] is not None and tname != rule["type"]:
                    continue
                rule["count"] -= 1
                if rule["count"] <= 0:
                    self._oneshots.remove(rule)
                n = self._counts.get("msg_oneshot", 0)
                self._counts["msg_oneshot"] = n + 1
                self._note("msg_oneshot", n, rule["action"],
                           f"{entity}<-{tname}")
                return rule["action"], rule["delay_ms"] / 1000.0
        p_total = self.msg_drop + self.msg_dup + self.msg_delay
        if p_total <= 0.0:
            return "deliver", 0.0
        with self._lock:
            u, n = self._draw("msg")
            if u < self.msg_drop:
                self._note("msg", n, "drop", f"{entity}<-{tname}")
                return "drop", 0.0
            if u < self.msg_drop + self.msg_dup:
                self._note("msg", n, "dup", f"{entity}<-{tname}")
                return "dup", 0.0
            if u < p_total:
                self._note("msg", n, "delay", f"{entity}<-{tname}")
                return "delay", self.msg_delay_ms / 1000.0
        return "deliver", 0.0

    def should_fail_device(self) -> bool:
        with self._lock:
            if self._device_fail_n > 0:
                self._device_fail_n -= 1
                n = self._counts.get("device_oneshot", 0)
                self._counts["device_oneshot"] = n + 1
                self._note("device_oneshot", n, "fail",
                           f"{self._device_fail_n} left")
                return True
            if self.device_fail <= 0.0:
                return False
            u, n = self._draw("device")
            if u < self.device_fail:
                self._note("device", n, "fail", f"p={self.device_fail}")
                return True
        return False

    def maybe_bitrot(self, size: int) -> int | None:
        """Byte offset to corrupt in a just-applied shard blob extent,
        or None. The offset derives from the same (seed, site, n) space
        as the decision, so reruns rot the same byte."""
        if size <= 0 or self.bitrot <= 0.0:
            return None
        with self._lock:
            u, n = self._draw("bitrot")
            if u >= self.bitrot:
                return None
            off = random.Random(
                f"{self.seed}:bitrot_off:{n}").randrange(size)
            self._note("bitrot", n, "flip", f"offset {off}")
            return off

    # -- surfaces -------------------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "seed": self.seed,
                "settings": {"msg_drop": self.msg_drop,
                             "msg_dup": self.msg_dup,
                             "msg_delay": self.msg_delay,
                             "msg_delay_ms": self.msg_delay_ms,
                             "bitrot": self.bitrot,
                             "device_fail": self.device_fail},
                "oneshots": [dict(r) for r in self._oneshots],
                "device_fail_pending": self._device_fail_n,
                "counts": dict(self._counts),
                "injected": len(self.log),
                "log_tail": [list(e) for e in self.log[-50:]],
            }


# -- process-wide instance + hot paths ---------------------------------------

_injector = FaultInjector()
#: mirrored flag so the per-message hook costs one attribute read when
#: injection is off (the overwhelmingly common case)
_armed = False


def get_injector() -> FaultInjector:
    return _injector


def armed() -> bool:
    return _armed


def set_enabled(flag: bool) -> None:
    global _armed
    _injector.enabled = bool(flag)
    _armed = _injector.enabled


def on_message(entity: str, msg) -> tuple[str, float]:
    return _injector.on_message(entity, msg)


def should_fail_device() -> bool:
    return _armed and _injector.should_fail_device()


def maybe_bitrot(size: int) -> int | None:
    if not _armed:
        return None
    return _injector.maybe_bitrot(size)


def arm_oneshot(**kw) -> dict:
    return _injector.arm_oneshot(**kw)


def arm_device_failures(count: int = 1) -> int:
    return _injector.arm_device_failures(count)


def reset(seed: int | None = None) -> None:
    _injector.reset(seed)


def status() -> dict:
    return _injector.status()


# -- config plumbing (fault_inject_* options on every daemon Config) ----------

def FAULT_OPTIONS():
    """The fault_inject_* option schema (declared per daemon Config)."""
    from ceph_tpu_torch.utils.config import Option
    return [
        Option("fault_inject_enabled", "bool", _DEFAULTS["enabled"],
               "arm the deterministic fault injector (msg faults, shard "
               "bit-rot, device failures)"),
        Option("fault_inject_seed", "int", _DEFAULTS["seed"],
               "seed for reproducible injection decisions; changing it "
               "resets the per-site event counters"),
        Option("fault_inject_msg_drop", "float", _DEFAULTS["msg_drop"],
               "per-message probability of dropping a received frame",
               minimum=0.0, maximum=1.0),
        Option("fault_inject_msg_dup", "float", _DEFAULTS["msg_dup"],
               "per-message probability of duplicate dispatch (dup-op "
               "table exercise)", minimum=0.0, maximum=1.0),
        Option("fault_inject_msg_delay", "float", _DEFAULTS["msg_delay"],
               "per-message probability of delayed (reordered) dispatch",
               minimum=0.0, maximum=1.0),
        Option("fault_inject_msg_delay_ms", "float",
               _DEFAULTS["msg_delay_ms"],
               "delay applied to messages picked by fault_inject_msg_delay",
               minimum=0.0),
        Option("fault_inject_bitrot", "float", _DEFAULTS["bitrot"],
               "per-sub-write probability of flipping one stored shard "
               "byte after apply (crc gate exercise)",
               minimum=0.0, maximum=1.0),
        Option("fault_inject_device_fail", "float",
               _DEFAULTS["device_fail"],
               "per-dispatch probability of an injected offload device "
               "failure (circuit-breaker exercise)",
               minimum=0.0, maximum=1.0),
    ]


def register_config(config) -> None:
    """Declare the fault_inject_* options on `config` (idempotent) and
    hot-apply changes to the process-wide injector — `config set
    fault_inject_enabled true` over any daemon's admin socket arms
    injection live, exactly like the ec_offload_* pattern."""
    from ceph_tpu_torch.utils.config import ConfigError
    names = []
    for opt in FAULT_OPTIONS():
        names.append(opt.name)
        try:
            config.declare(opt)
        except ConfigError:
            pass                    # another daemon already declared it

    def _on_change(name: str, value) -> None:
        global _armed
        key = name[len("fault_inject_"):]
        if key in _DEFAULTS:
            _DEFAULTS[key] = value
        if key == "enabled":
            set_enabled(value)
            return
        if key == "seed":
            _injector.reset(int(value))
            return
        setattr(_injector, key, value)

    config.add_observer(tuple(names), _on_change)
    diff = config.diff()
    for name in names:
        if name in diff:
            _on_change(name, config.get(name))
