"""Erasure-code plugin registry.

Python analog of the reference's dlopen registry
(src/erasure-code/ErasureCodePlugin.{h,cc}): plugins are modules exposing
`__erasure_code_version__` (ABI gate, ErasureCodePlugin.cc:138) and
`__erasure_code_init__(name, directory)` which must register an
ErasureCodePlugin (:145-171). Built-in plugins resolve to
`ceph_tpu_torch.ec.plugin_<name>`; external directories are searched for
`ec_<name>.py` the way the reference searches `libec_<name>.so`. The
port's copy of ceph_tpu/ec/registry.py, with a registry instance of its
own.
"""
from __future__ import annotations

import importlib
import importlib.util
import threading
from pathlib import Path
from typing import Mapping

from ceph_tpu_torch.ec.interface import ErasureCodeError, ErasureCodeInterface

#: version every plugin must declare; mismatch refuses the load
ERASURE_CODE_VERSION = "ceph-tpu-ec-1"


class ErasureCodePlugin:
    """Base plugin: a named factory for code instances."""

    def factory(self, profile: Mapping[str, str],
                directory: str | None = None) -> ErasureCodeInterface:
        raise NotImplementedError


class ErasureCodePluginRegistry:
    _instance: "ErasureCodePluginRegistry | None" = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._plugins: dict[str, ErasureCodePlugin] = {}
        self._lock = threading.RLock()
        self.disable_dlclose = True  # parity with benchmark behavior; no-op here

    @classmethod
    def instance(cls) -> "ErasureCodePluginRegistry":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def add(self, name: str, plugin: ErasureCodePlugin) -> None:
        with self._lock:
            if name in self._plugins:
                raise ErasureCodeError(f"plugin {name} already registered")
            self._plugins[name] = plugin

    def get(self, name: str) -> ErasureCodePlugin | None:
        with self._lock:
            return self._plugins.get(name)

    def remove(self, name: str) -> None:
        with self._lock:
            self._plugins.pop(name, None)

    # -- loading ------------------------------------------------------------

    def load(self, name: str, directory: str | None = None) -> ErasureCodePlugin:
        with self._lock:
            plugin = self._plugins.get(name)
            if plugin is not None:
                return plugin
            module = self._import_module(name, directory)
            version = getattr(module, "__erasure_code_version__", None)
            if version is None:
                raise ErasureCodeError(
                    f"plugin {name}: missing __erasure_code_version__")
            if version != ERASURE_CODE_VERSION:
                raise ErasureCodeError(
                    f"plugin {name}: version {version!r} does not match "
                    f"{ERASURE_CODE_VERSION!r}")
            init = getattr(module, "__erasure_code_init__", None)
            if init is None:
                raise ErasureCodeError(
                    f"plugin {name}: missing __erasure_code_init__ entry point")
            rc = init(name, directory)
            if rc not in (None, 0):
                raise ErasureCodeError(f"plugin {name}: init failed rc={rc}")
            plugin = self._plugins.get(name)
            if plugin is None:
                raise ErasureCodeError(
                    f"plugin {name}: init did not register the plugin")
            return plugin

    @staticmethod
    def _import_module(name: str, directory: str | None):
        if directory:
            path = Path(directory) / f"ec_{name}.py"
            if not path.exists():
                raise ErasureCodeError(f"plugin file not found: {path}")
            spec = importlib.util.spec_from_file_location(f"ec_ext_{name}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)  # type: ignore[union-attr]
            return module
        try:
            return importlib.import_module(f"ceph_tpu_torch.ec.plugin_{name}")
        except ImportError as e:
            raise ErasureCodeError(f"no builtin plugin {name!r}: {e}") from e

    def factory(self, name: str, profile: Mapping[str, str],
                directory: str | None = None) -> ErasureCodeInterface:
        """Build and init a code instance (ErasureCodePlugin.cc:86); verifies
        the instance adopted the profile it was given (:108)."""
        plugin = self.load(name, directory)
        instance = plugin.factory(profile, directory)
        got = instance.get_profile()
        for key, val in profile.items():
            if key == "directory":
                continue
            if str(got.get(key)) != str(val):
                raise ErasureCodeError(
                    f"profile mismatch after init: {key}={got.get(key)!r} "
                    f"!= requested {val!r}")
        return instance

    def preload(self, names: list[str], directory: str | None = None) -> None:
        """Load plugins at daemon start so a broken one fails fast
        (global_init_preload_erasure_code, src/global/global_init.cc:593)."""
        for name in names:
            self.load(name, directory)


def factory(name: str, profile: Mapping[str, str],
            directory: str | None = None) -> ErasureCodeInterface:
    """Module-level convenience mirroring registry().factory()."""
    return ErasureCodePluginRegistry.instance().factory(name, profile, directory)
