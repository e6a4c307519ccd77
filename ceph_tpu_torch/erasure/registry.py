"""Erasure-code plugin registry.

The analog of ErasureCodePluginRegistry
(src/erasure-code/ErasureCodePlugin.h:45,
ErasureCodePlugin.cc:90 factory, :124 load, :132 dlopen, :184 preload):
a process-wide singleton that lazily loads named plugins and asks them to
build codec instances from profiles.

Plugins here are Python modules (import replaces dlopen) that must expose
an entry-point callable `__erasure_code_init__(registry, name)` which
registers an ErasureCodePlugin — the same contract as the reference's
`__erasure_code_init` C symbol (ErasureCodePlugin.h:26), including the
failure modes its test fixtures exercise (missing entry point, entry point
raising, wrong-version plugin, plugin that registers nothing).
"""

from __future__ import annotations

import importlib
import threading
from typing import Callable, Mapping

from .interface import ErasureCodeError, ErasureCodeInterface

# Plugins compiled against a different interface revision are rejected,
# like the reference's version symbol check.
PLUGIN_API_VERSION = 1

ENTRY_POINT = "__erasure_code_init__"

# name -> module path for the built-in set; external plugins can register
# any importable module via load(name, module=...).
_BUILTIN_PLUGINS = {
    "tpu": "ceph_tpu_torch.erasure.plugin_tpu",
    "jerasure": "ceph_tpu_torch.erasure.plugin_jerasure",
    "isa": "ceph_tpu_torch.erasure.plugin_isa",
    "shec": "ceph_tpu_torch.erasure.plugin_shec",
    "lrc": "ceph_tpu_torch.erasure.plugin_lrc",
}

DEFAULT_PRELOAD = ("tpu", "jerasure")


class ErasureCodePlugin:
    """Base class a plugin registers; builds codecs from profiles."""

    version = PLUGIN_API_VERSION

    def factory(self, profile: Mapping[str, str]) -> ErasureCodeInterface:
        raise NotImplementedError


class ErasureCodePluginRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._load_lock = threading.Lock()   # held across a whole load()
        self._plugins: dict[str, ErasureCodePlugin] = {}
        self.disable_dlclose = False  # parity knob; unused in-process
        # device-degrade surface: codecs that fell back to the host
        # matrix-codec path report here; daemons subscribe hooks to
        # raise a cluster health warning (keyed so a restarted daemon
        # replaces, not duplicates, its hook)
        self._health_hooks: dict[str, Callable[[str, str], None]] = {}
        self.degraded: dict[str, str] = {}   # plugin name -> reason

    def add(self, name: str, plugin: ErasureCodePlugin) -> None:
        with self._lock:
            if name in self._plugins:
                raise ErasureCodeError(f"plugin {name} already registered")
            self._plugins[name] = plugin

    def get(self, name: str) -> ErasureCodePlugin | None:
        with self._lock:
            return self._plugins.get(name)

    def load(self, name: str, module: str | None = None) -> ErasureCodePlugin:
        """Import + run the plugin's entry point (idempotent, serialized
        like the reference registry which holds its lock across load)."""
        with self._load_lock:
            return self._load_locked(name, module)

    def _load_locked(self, name: str,
                     module: str | None) -> ErasureCodePlugin:
        plugin = self.get(name)
        if plugin is not None:
            return plugin
        modpath = module or _BUILTIN_PLUGINS.get(name)
        if modpath is None:
            raise ErasureCodeError(f"unknown erasure-code plugin {name!r}")
        try:
            mod = importlib.import_module(modpath)
        except ImportError as e:
            raise ErasureCodeError(f"failed to load plugin {name}: {e}") from e
        entry = getattr(mod, ENTRY_POINT, None)
        if entry is None:
            raise ErasureCodeError(
                f"plugin {name} ({modpath}) has no {ENTRY_POINT} entry point")
        try:
            entry(self, name)
        except ErasureCodeError:
            raise
        except Exception as e:
            raise ErasureCodeError(
                f"plugin {name} entry point failed: {e}") from e
        plugin = self.get(name)
        if plugin is None:
            raise ErasureCodeError(
                f"plugin {name} entry point did not register itself")
        if getattr(plugin, "version", None) != PLUGIN_API_VERSION:
            with self._lock:
                del self._plugins[name]
            raise ErasureCodeError(
                f"plugin {name} version {getattr(plugin, 'version', None)} "
                f"!= expected {PLUGIN_API_VERSION}")
        return plugin

    def factory(self, plugin_name: str,
                profile: Mapping[str, str]) -> ErasureCodeInterface:
        """Build + init a codec: the one-call path daemons use."""
        plugin = self.load(plugin_name)
        codec = plugin.factory(profile)
        codec.init(dict(profile))
        return codec

    def preload(self, names=DEFAULT_PRELOAD) -> None:
        """Boot-time load, like global_init_preload_erasure_code
        (src/ceph_osd.cc:567)."""
        for name in names:
            self.load(name)

    def loaded_plugins(self) -> list[str]:
        with self._lock:
            return sorted(self._plugins)

    # -- degrade / health surface ------------------------------------------

    def add_health_hook(self, key: str,
                        hook: Callable[[str, str], None]) -> None:
        with self._lock:
            self._health_hooks[key] = hook

    def remove_health_hook(self, key: str) -> None:
        with self._lock:
            self._health_hooks.pop(key, None)

    def note_degraded(self, name: str, reason: str) -> None:
        """A codec lost its device path and fell back to the host
        matrix-codec implementation; fan the event out to subscribed
        daemons so it surfaces as a health warning, not an op error."""
        with self._lock:
            self.degraded[name] = reason
            hooks = list(self._health_hooks.values())
        for hook in hooks:
            try:
                hook(name, reason)
            except Exception:
                pass


registry = ErasureCodePluginRegistry()
