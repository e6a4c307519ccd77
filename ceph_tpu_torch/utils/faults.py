"""FaultSet: central, seed-deterministic fault-injection registry.

The part of ``ceph_tpu``'s registry that the erasure layer consults:
the EC device-error rule.  Rules are scoped by device glob and every
decision flows through a named random stream derived from one seed, so
the same seed and call order reproduce the same fault schedule.

Rule type:

  tpu_device_error(prob, device)    EC device dispatch fails; device
                                    "*" degrades the tpu plugin to the
                                    host matrix-codec path + health WARN

The messenger, store and crash-point rules join this module with the
slices that port those layers.

The module-level singleton (``faults.get()``) is what the wired layers
consult; tests that want isolation can swap it with ``set_global()``
or simply ``get().reset()`` between cases.
"""

from __future__ import annotations

import threading
import zlib
from fnmatch import fnmatchcase
from random import Random


def _match(pattern: str, entity: str) -> bool:
    return pattern == "*" or fnmatchcase(entity, pattern)


class FaultRule:
    __slots__ = ("id", "kind", "params", "source", "hits")

    def __init__(self, rid: int, kind: str, params: dict,
                 source: str = "api"):
        self.id = rid
        self.kind = kind
        self.params = params
        self.source = source
        self.hits = 0

    def dump(self) -> dict:
        return {"id": self.id, "kind": self.kind, "source": self.source,
                "hits": self.hits, **self.params}

    def __repr__(self):
        return f"FaultRule({self.id}, {self.kind}, {self.params})"


class FaultSet:
    def __init__(self, seed: int = 0):
        self._lock = threading.RLock()
        self._seed = int(seed)
        self._rules: dict[int, FaultRule] = {}
        self._next_id = 1
        self._streams: dict[str, Random] = {}
        # fast-path flag: the codec consults this on every dispatch, so
        # "no rules installed" must cost one attribute read
        self._have_tpu = False
        # bounded trace of fired faults, for post-mortem + repro checks
        self._trace: list[tuple] = []
        self._trace_cap = 10000

    # -- seeding -----------------------------------------------------------

    @property
    def seed(self) -> int:
        return self._seed

    def reseed(self, seed: int) -> None:
        """Reset all decision streams to a fresh seed (rules stay)."""
        with self._lock:
            self._seed = int(seed)
            self._streams.clear()
            self._trace.clear()

    def reset(self, seed: int | None = None) -> None:
        """Clear every rule and decision stream (test isolation)."""
        with self._lock:
            self._rules.clear()
            self._streams.clear()
            self._trace.clear()
            if seed is not None:
                self._seed = int(seed)
            self._refresh_flags()

    def _stream(self, name: str) -> Random:
        rng = self._streams.get(name)
        if rng is None:
            rng = self._streams[name] = Random(
                (self._seed << 32) ^ zlib.crc32(name.encode()))
        return rng

    def _note(self, *event) -> None:
        if len(self._trace) < self._trace_cap:
            self._trace.append(event)

    def trace(self) -> list[tuple]:
        with self._lock:
            return list(self._trace)

    # -- rule installation -------------------------------------------------

    def _add(self, kind: str, params: dict, source: str = "api") -> int:
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            self._rules[rid] = FaultRule(rid, kind, params, source)
            self._refresh_flags()
            return rid

    def _refresh_flags(self) -> None:
        self._have_tpu = any(r.kind == "tpu_device_error"
                             for r in self._rules.values())

    def tpu_device_error(self, prob: float = 1.0, device: str = "*",
                         source: str = "api") -> int:
        """Fail EC device dispatch; untargeted (device="*") the tpu
        plugin must degrade to the host matrix-codec path, not error
        the op."""
        return self._add("tpu_device_error",
                         {"prob": float(prob), "device": str(device)},
                         source)

    def clear(self, rule_id: int | None = None,
              source: str | None = None) -> int:
        """Remove one rule by id, all rules from a source, or all."""
        with self._lock:
            if rule_id is not None:
                removed = 1 if self._rules.pop(int(rule_id), None) else 0
            elif source is not None:
                victims = [r for r, rule in self._rules.items()
                           if rule.source == source]
                for r in victims:
                    del self._rules[r]
                removed = len(victims)
            else:
                removed = len(self._rules)
                self._rules.clear()
            self._refresh_flags()
            return removed

    def rules(self) -> list[FaultRule]:
        with self._lock:
            return list(self._rules.values())

    def dump(self) -> dict:
        with self._lock:
            return {"seed": self._seed,
                    "rules": [r.dump() for r in self._rules.values()],
                    "fired": len(self._trace)}

    # -- queries -----------------------------------------------------------

    def tpu_error(self, device=None) -> bool:
        """Roll the device-error rules.

        device=None is the untargeted query (the plugin's whole-device
        degrade): only device="*" rules match it.  A device INDEX
        matches both "*" rules and rules targeting that index."""
        if not self._have_tpu:
            return False
        with self._lock:
            for rule in self._rules.values():
                if rule.kind != "tpu_device_error":
                    continue
                pat = rule.params.get("device", "*")
                if device is None:
                    if pat != "*":
                        continue
                elif not _match(pat, str(device)):
                    continue
                if self._stream("tpu").random() < rule.params["prob"]:
                    rule.hits += 1
                    self._note("tpu_device_error", rule.id, device)
                    return True
        return False


_global = FaultSet()


def get() -> FaultSet:
    return _global


def set_global(fs: FaultSet) -> FaultSet:
    global _global
    prev, _global = _global, fs
    return prev
