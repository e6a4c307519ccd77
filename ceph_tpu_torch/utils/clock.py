"""Injectable time source for every daemon-side timer and timestamp.

The reference drives failure detection, paxos leases and down->out
aging off the wall clock (e.g. OSDMonitor grace math,
src/mon/OSDMonitor.cc:1752; lease stamps,
mon/Paxos.cc:623).  An in-process test cluster cannot use the wall
clock for those: a single first-use kernel build can hold the GIL for
tens of seconds, which reads as "peer silent past grace" and flaps the
map (the round-1 flaky test).  Every daemon therefore takes a Clock;
production uses SystemClock, MiniCluster shares one ManualClock whose
time only moves when the test advances it — heartbeat grace, lease
expiry and down-out intervals become deterministic functions of the
test script, not of scheduler noise.

Only *cluster-logic* time goes through Clock (heartbeats, leases,
elections, failure aging, tick loops).  Transport-level waits (socket
timeouts, condvar waits for in-flight RPCs) stay on the real clock:
they bound real thread/network progress, not simulated time.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable


class TimerHandle:
    """Cancelable handle returned by Clock.timer()."""

    __slots__ = ("_cancel", "cancelled")

    def __init__(self, cancel: Callable[[], None]):
        self._cancel = cancel
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True
        self._cancel()


class SystemClock:
    """Real time: time.time() + threading.Timer."""

    def now(self) -> float:
        return time.time()

    def timer(self, delay: float, fn: Callable) -> TimerHandle:
        t = threading.Timer(delay, fn)
        t.daemon = True
        t.start()
        return TimerHandle(t.cancel)

    def sleep(self, secs: float) -> None:
        time.sleep(secs)


class ManualClock:
    """Virtual time that moves only under advance().

    Timers are kept in a heap; advance(dt) steps now() forward and runs
    every callback that came due, in due-time order, on the advancing
    thread (so a test's advance() call returns only after all cluster
    reactions to the elapsed time have at least been initiated).
    Callbacks may schedule new timers; those fire in the same advance()
    if they fall inside the window.
    """

    def __init__(self, start: float = 1_000_000.0):
        self._t = start
        self._lock = threading.Lock()
        self._timers: list = []          # (due, seq, fn, handle)
        self._seq = itertools.count()

    def now(self) -> float:
        with self._lock:
            return self._t

    def timer(self, delay: float, fn: Callable) -> TimerHandle:
        handle = TimerHandle(lambda: None)
        with self._lock:
            heapq.heappush(self._timers,
                           (self._t + delay, next(self._seq), fn, handle))
        return handle

    def sleep(self, secs: float) -> None:
        """Virtual sleep: returns once now() has advanced past the
        deadline (some other thread must be advancing)."""
        deadline = self.now() + secs
        while self.now() < deadline:
            time.sleep(0.001)

    def advance(self, dt: float) -> None:
        target = self.now() + dt
        while True:
            with self._lock:
                if self._timers and self._timers[0][0] <= target:
                    due, _seq, fn, handle = heapq.heappop(self._timers)
                    self._t = max(self._t, due)
                else:
                    self._t = target
                    return
            if not handle.cancelled:
                fn()
