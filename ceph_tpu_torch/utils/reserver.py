"""AsyncReserver: bounded concurrent recovery grants
(common/AsyncReserver.h reduced to FIFO + a front-of-queue lane).

The reference gates recovery/backfill with reservation slots so
recovery can never starve client I/O (osd/OSD.h:918-971). Here the
grant callback receives a `release` function; releasing hands the
slot to the oldest waiter. release() is idempotent, so a safety
timer can double as the completion path without double-granting.

``request(fn, front=True)`` is the priority-promotion lane the
reference expresses with request priorities: a recovery pull that a
CLIENT OP is blocked on goes to the head of the wait queue, ahead of
every queued background push/backfill round, so serve-during-repair
latency is bounded by one in-flight grant, not the whole repair
backlog.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable


class AsyncReserver:
    def __init__(self, slots: int):
        self._slots = max(1, int(slots))
        self._queue: deque[Callable] = deque()
        self._lock = threading.Lock()

    @property
    def available(self) -> int:
        with self._lock:
            return self._slots

    @property
    def queued(self) -> int:
        with self._lock:
            return len(self._queue)

    def request(self, fn: Callable[[Callable[[], None]], None],
                front: bool = False) -> None:
        """fn(release) runs when a slot frees (immediately if one is
        available).  fn MUST eventually call release() exactly once
        (extra calls are ignored).  front=True queues ahead of every
        FIFO waiter (blocked-op pull promotion)."""
        with self._lock:
            if self._slots > 0:
                self._slots -= 1
                run = True
            else:
                if front:
                    self._queue.appendleft(fn)
                else:
                    self._queue.append(fn)
                run = False
        if run:
            self._fire(fn)

    def _fire(self, fn: Callable) -> None:
        released = [False]

        def release() -> None:
            with self._lock:
                if released[0]:
                    return
                released[0] = True
                nxt = self._queue.popleft() if self._queue else None
                if nxt is None:
                    self._slots += 1
            if nxt is not None:
                self._fire(nxt)

        try:
            fn(release)
        except Exception:
            release()
            raise
