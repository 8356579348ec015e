"""Config/option system: declarative schema, layered values, observers.

Re-creation of the reference's config machinery (SURVEY §5.6): options are
declared like src/common/options/*.yaml.in entries (type, default, min/max,
enum, description, flags), values are resolved through layers

    compiled default < conf file < mon store < override (cli/env/admin)

(md_config_t, src/common/config.h:150), and components register observers
for hot reload (md_config_obs_t; e.g. BlueStore watching throttle options,
src/os/bluestore/BlueStore.cc:5693).

The port's copy of ceph_tpu/utils/config.py (jax-free; the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import configparser
import threading
from typing import Any, Callable, Iterable

LEVEL_DEFAULT = 0
LEVEL_CONF = 1
LEVEL_MON = 2
LEVEL_OVERRIDE = 3
_LEVELS = (LEVEL_DEFAULT, LEVEL_CONF, LEVEL_MON, LEVEL_OVERRIDE)


class ConfigError(Exception):
    pass


class Option:
    """One declared option (mirrors an options.yaml.in entry)."""

    TYPES = {"str", "int", "float", "bool", "size", "secs"}

    def __init__(self, name: str, type: str, default: Any,
                 description: str = "", minimum=None, maximum=None,
                 enum: Iterable[str] | None = None,
                 services: Iterable[str] = (), flags: Iterable[str] = ()):
        if type not in self.TYPES:
            raise ConfigError(f"option {name}: unknown type {type!r}")
        self.name = name
        self.type = type
        self.description = description
        self.minimum = minimum
        self.maximum = maximum
        self.enum = set(enum) if enum else None
        self.services = tuple(services)
        self.flags = tuple(flags)
        self.default = self.validate(default)

    _SIZE_UNITS = {"": 1, "k": 1 << 10, "m": 1 << 20, "g": 1 << 30,
                   "t": 1 << 40}

    def validate(self, value: Any) -> Any:
        try:
            if self.type == "str":
                value = str(value)
            elif self.type == "int":
                value = int(value)
            elif self.type == "float" or self.type == "secs":
                value = float(value)
            elif self.type == "bool":
                if isinstance(value, str):
                    value = value.lower() in ("true", "1", "yes", "on")
                else:
                    value = bool(value)
            elif self.type == "size":
                if isinstance(value, str):
                    v = value.strip().lower()
                    for suffix, mult in sorted(self._SIZE_UNITS.items(),
                                               key=lambda kv: -len(kv[0])):
                        if suffix and v.endswith(suffix):
                            value = int(float(v[: -len(suffix)]) * mult)
                            break
                    else:
                        value = int(v)
                else:
                    value = int(value)
        except (TypeError, ValueError) as e:
            raise ConfigError(
                f"option {self.name}: {value!r} is not a {self.type}") from e
        if self.enum is not None and value not in self.enum:
            raise ConfigError(
                f"option {self.name}: {value!r} not in {sorted(self.enum)}")
        if self.minimum is not None and value < self.minimum:
            raise ConfigError(
                f"option {self.name}: {value} < min {self.minimum}")
        if self.maximum is not None and value > self.maximum:
            raise ConfigError(
                f"option {self.name}: {value} > max {self.maximum}")
        return value


class Config:
    """Layered option values + observer notification."""

    def __init__(self, schema: Iterable[Option] = ()):
        self._options: dict[str, Option] = {}
        self._values: dict[int, dict[str, Any]] = {lv: {} for lv in _LEVELS}
        self._observers: list[tuple[tuple[str, ...], Callable]] = []
        self._lock = threading.RLock()
        for opt in schema:
            self.declare(opt)

    def declare(self, opt: Option) -> None:
        with self._lock:
            if opt.name in self._options:
                raise ConfigError(f"option {opt.name} already declared")
            self._options[opt.name] = opt

    def schema(self) -> dict[str, Option]:
        return dict(self._options)

    # -- values --------------------------------------------------------------

    def _opt(self, name: str) -> Option:
        opt = self._options.get(name)
        if opt is None:
            raise ConfigError(f"unknown option {name!r}")
        return opt

    def get(self, name: str) -> Any:
        with self._lock:
            opt = self._opt(name)
            for level in reversed(_LEVELS):
                if name in self._values[level]:
                    return self._values[level][name]
            return opt.default

    def set(self, name: str, value: Any,
            level: int = LEVEL_OVERRIDE) -> None:
        if level not in _LEVELS:
            raise ConfigError(f"bad level {level}")
        opt = self._opt(name)
        value = opt.validate(value)
        with self._lock:
            old = self.get(name)
            self._values[level][name] = value
            new = self.get(name)
        if new != old:
            # hot config changes are flight events: a post-mortem
            # timeline must show the knob turn that preceded the
            # behavior change (local import — flight rides on Option
            # for its own knobs, so a module-level import would cycle)
            from ceph_tpu_torch.utils import flight
            flight.record("config_change", name, old=old, new=new)
            self._notify([name])

    def rm(self, name: str, level: int = LEVEL_OVERRIDE) -> None:
        with self._lock:
            self._opt(name)
            old = self.get(name)
            self._values[level].pop(name, None)
            new = self.get(name)
        if new != old:
            self._notify([name])

    def show(self) -> dict[str, Any]:
        """Effective value of every option (admin `config show`)."""
        with self._lock:
            return {name: self.get(name) for name in sorted(self._options)}

    def diff(self) -> dict[str, dict]:
        """Non-default values with their source level (`config diff`)."""
        out = {}
        with self._lock:
            for name, opt in self._options.items():
                effective = self.get(name)
                if effective != opt.default:
                    source = max(lv for lv in _LEVELS
                                 if name in self._values[lv])
                    out[name] = {"default": opt.default,
                                 "value": effective, "level": source}
        return out

    # -- conf file -----------------------------------------------------------

    def load_conf(self, path: str, section: str = "global") -> None:
        """Load an ini-style conf file into the CONF layer."""
        parser = configparser.ConfigParser()
        if not parser.read(path):
            raise ConfigError(f"cannot read conf file {path}")
        changed = []
        for sec in ("global", section):
            if not parser.has_section(sec):
                continue
            for name, raw in parser.items(sec):
                name = name.replace(" ", "_")
                if name in self._options:
                    opt = self._opt(name)
                    with self._lock:
                        old = self.get(name)
                        self._values[LEVEL_CONF][name] = opt.validate(raw)
                        if self.get(name) != old:
                            changed.append(name)
        if changed:
            self._notify(changed)

    # -- observers -----------------------------------------------------------

    def add_observer(self, names: Iterable[str],
                     callback: Callable[[str, Any], None]) -> None:
        """callback(name, new_value) fires on effective-value changes of
        any watched option (md_config_obs_t::handle_conf_change)."""
        names = tuple(names)
        for n in names:
            self._opt(n)
        with self._lock:
            self._observers.append((names, callback))

    def _notify(self, changed: list[str]) -> None:
        with self._lock:
            observers = list(self._observers)
        for names, callback in observers:
            for name in changed:
                if name in names:
                    callback(name, self.get(name))
