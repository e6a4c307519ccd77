"""dout-style subsystem logging with an in-memory crash ring.

The analog of common/dout.h + log/Log.h:18 in the reference: per-
subsystem (level, gather) pairs, cheap when disabled, with a bounded
ring of recent entries (at a higher gather level) dumped on crash.
Backed by the stdlib logging module rather than a custom flusher thread
— Python's logging already serializes; the ring is the part worth
keeping.
"""

from __future__ import annotations

import collections
import logging
import sys
import threading
import time

_SUBSYS_LEVELS: dict[str, tuple[int, int]] = {}   # name -> (level, gather)
_DEFAULT = (1, 5)
_ring: collections.deque = collections.deque(maxlen=10000)
_ring_lock = threading.Lock()

_root = logging.getLogger("ceph_tpu_torch")
if not _root.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(message)s", datefmt="%H:%M:%S"))
    _root.addHandler(_h)
    _root.setLevel(logging.DEBUG)
    _root.propagate = False


def set_log_level(subsys: str, level: int, gather: int | None = None) -> None:
    g = gather if gather is not None else max(level, _DEFAULT[1])
    _SUBSYS_LEVELS[subsys] = (level, g)


def get_log_level(subsys: str) -> tuple[int, int]:
    return _SUBSYS_LEVELS.get(subsys, _DEFAULT)


def dump_recent(out=sys.stderr, count: int = 1000) -> None:
    """Crash-dump the ring, like Log::dump_recent."""
    with _ring_lock:
        entries = list(_ring)[-count:]
    out.write(f"--- begin dump of recent events ({len(entries)}) ---\n")
    for ts, subsys, lvl, msg in entries:
        out.write(f"{ts:.6f} {subsys} {lvl} : {msg}\n")
    out.write("--- end dump of recent events ---\n")


class DoutLogger:
    """Per-component logger: self.log = DoutLogger('osd', whoami='osd.3')."""

    def __init__(self, subsys: str, who: str = ""):
        self.subsys = subsys
        self.who = who
        self._py = _root.getChild(subsys if not who else f"{subsys}.{who}")

    def dout(self, level: int, msg: str, *args) -> None:
        show, gather = get_log_level(self.subsys)
        if level > show and level > gather:
            return
        if args:
            msg = msg % args
        if level <= gather:
            with _ring_lock:
                _ring.append((time.time(), self.subsys, level,
                              f"{self.who} {msg}" if self.who else msg))
        if level <= show:
            self._py.debug("%2d %s", level, msg)

    # convenience tiers
    def error(self, msg: str, *args) -> None:
        self.dout(-1, "ERROR: " + msg, *args)

    def warn(self, msg: str, *args) -> None:
        self.dout(0, "WARN: " + msg, *args)

    def info(self, msg: str, *args) -> None:
        self.dout(1, msg, *args)

    def debug(self, msg: str, *args) -> None:
        self.dout(10, msg, *args)

    def trace(self, msg: str, *args) -> None:
        self.dout(20, msg, *args)
