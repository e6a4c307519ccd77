"""Throttles: bounded counters gating admission (common/Throttle.h analog)."""

from __future__ import annotations

import threading


class Throttle:
    """Blocking counting throttle with dynamic max."""

    def __init__(self, name: str, maximum: int = 0):
        self.name = name
        self._max = maximum
        self._count = 0
        self._cond = threading.Condition()

    @property
    def current(self) -> int:
        return self._count

    @property
    def maximum(self) -> int:
        return self._max

    def reset_max(self, maximum: int) -> None:
        with self._cond:
            self._max = maximum
            self._cond.notify_all()

    def _should_wait(self, c: int) -> bool:
        # reference Throttle::_should_wait: an over-max request proceeds
        # once current <= max (no starvation under small-op traffic)
        if self._max <= 0:
            return False
        if c <= self._max:
            return self._count > 0 and self._count + c > self._max
        return self._count > self._max

    def get(self, count: int = 1, timeout: float | None = None) -> bool:
        """Block until `count` fits; returns False on timeout."""
        with self._cond:
            ok = self._cond.wait_for(lambda: not self._should_wait(count),
                                     timeout)
            if not ok:
                return False
            self._count += count
            return True

    def get_or_fail(self, count: int = 1) -> bool:
        with self._cond:
            if self._should_wait(count):
                return False
            self._count += count
            return True

    def take(self, count: int = 1) -> int:
        """Unconditional take (can overshoot), like Throttle::take."""
        with self._cond:
            self._count += count
            return self._count

    def put(self, count: int = 1) -> int:
        with self._cond:
            self._count = max(0, self._count - count)
            self._cond.notify_all()
            return self._count
