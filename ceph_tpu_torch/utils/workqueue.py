"""Thread pools with per-shard ordering + stuck-thread watchdog.

Analogs of common/WorkQueue.h (ThreadPool, ShardedThreadPool: the OSD's
op execution uses N shards, each single-threaded per ordering domain so
ops for one PG never reorder) and common/HeartbeatMap.h (each worker
carries a grace/suicide deadline; an expired grace flags unhealthy, an
expired suicide aborts the process — crash-to-recover).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Callable

from .faults import CrashPoint


class HeartbeatMap:
    def __init__(self):
        self._lock = threading.Lock()
        self._handles: dict[str, tuple[float, float, float]] = {}
        # name -> (deadline, grace, suicide_deadline)

    def reset_timeout(self, name: str, grace: float,
                      suicide_grace: float = 0.0) -> None:
        now = time.monotonic()
        with self._lock:
            self._handles[name] = (
                now + grace, grace,
                now + suicide_grace if suicide_grace else 0.0)

    def clear_timeout(self, name: str) -> None:
        with self._lock:
            self._handles.pop(name, None)

    def is_healthy(self) -> bool:
        now = time.monotonic()
        healthy = True
        with self._lock:
            for name, (deadline, grace, suicide) in self._handles.items():
                if deadline and now > deadline:
                    healthy = False
                if suicide and now > suicide:
                    # crash-to-recover, like HeartbeatMap suicide_grace
                    os._exit(1)
        return healthy


class QosQueue:
    """A queue.Queue-surface (put/get/task_done/join) whose dequeue
    order is dmClock-scheduled across client classes.

    Items enqueue FIFO per client; each ``get`` runs one dmClock
    service opportunity over the queued clients' heads (see
    utils/dmclock.py): reserved clients are served on their due tags,
    unconstrained work (no spec — internal ops, pools without QoS
    conf) keeps exact FIFO order, and a limit-throttled queue makes
    the worker SLEEP rather than serve above the cap.  The
    ``DmClockState`` is shared across every shard's QosQueue so the
    configured rates are per-daemon truths, not per-shard fractions.
    """

    def __init__(self, state):
        self._state = state
        self._cv = threading.Condition()
        self._qs: dict[str | None, "queue.deque"] = {}
        self._unfinished = 0

    def put(self, item, client: str | None = None,
            cost: float = 1.0) -> None:
        from collections import deque
        import time as _time
        with self._cv:
            q = self._qs.get(client)
            if q is None:
                q = self._qs[client] = deque()
            q.append((item, _time.monotonic(), float(cost)))
            self._unfinished += 1
            self._cv.notify()

    def get(self, timeout: float | None = None):
        import time as _time
        deadline = (_time.monotonic() + timeout) if timeout else None
        with self._cv:
            while True:
                cands = {c: q[0][1] for c, q in self._qs.items() if q}
                now = _time.monotonic()
                wait = None
                if cands:
                    def _key(c):
                        return c if c is not None else "_system"
                    client, _phase, wake = self._state.pick(
                        {_key(c): t for c, t in cands.items()}, now,
                        # bytes-weighted: each candidate's HEAD cost
                        # advances its tags on a grant
                        costs={_key(c): self._qs[c][0][2]
                               for c in cands})
                    if client is not None:
                        key = None if client == "_system" \
                            and None in cands else client
                        item, _t, _cost = self._qs[key].popleft()
                        return item
                    # every queued client over its limit: hold off
                    self._state.note_stall()
                    wait = max(0.001, wake - now)
                if deadline is not None:
                    remain = deadline - now
                    if remain <= 0:
                        raise queue.Empty
                    wait = remain if wait is None else min(wait, remain)
                self._cv.wait(wait)

    def task_done(self) -> None:
        with self._cv:
            self._unfinished -= 1
            if self._unfinished <= 0:
                self._cv.notify_all()

    def join(self) -> None:
        with self._cv:
            while self._unfinished > 0:
                self._cv.wait()

    def qsize(self) -> int:
        with self._cv:
            return sum(len(q) for q in self._qs.values())


class ThreadPool:
    """Simple FIFO pool; work items are callables.  With a
    ``qos_state`` (utils/dmclock.DmClockState) the internal queue is
    a :class:`QosQueue` and ``queue`` accepts a ``qos=`` client tag."""

    def __init__(self, name: str, num_threads: int = 2,
                 hbmap: HeartbeatMap | None = None, grace: float = 60.0,
                 qos_state=None):
        self.name = name
        self._q = QosQueue(qos_state) if qos_state is not None \
            else queue.Queue()
        self._qos = qos_state is not None
        self._stop = False
        self.hbmap = hbmap
        self.grace = grace
        self._threads = [
            threading.Thread(target=self._worker, name=f"{name}-{i}",
                             daemon=True)
            for i in range(num_threads)]

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def queue(self, fn: Callable, *args, qos: str | None = None,
              qos_cost: float = 1.0) -> None:
        if self._qos:
            self._q.put((fn, args), client=qos, cost=qos_cost)
        else:
            self._q.put((fn, args))

    def _worker(self) -> None:
        me = threading.current_thread().name
        while not self._stop:
            try:
                fn, args = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            if self.hbmap:
                self.hbmap.reset_timeout(me, self.grace)
            try:
                fn(*args)
            except Exception as e:  # a work item must never kill its worker
                # a fired crash point unwinds through here by design:
                # the daemon is aborting, the op must die silently
                # (never ack) — not spam a traceback per in-flight op
                if not isinstance(e, CrashPoint):
                    import traceback
                    traceback.print_exc()
            finally:
                if self.hbmap:
                    self.hbmap.clear_timeout(me)
                self._q.task_done()

    def drain(self) -> None:
        self._q.join()

    def stop(self) -> None:
        self._stop = True
        # wake idle workers NOW: they poll the queue at 0.2s, and a
        # daemon stops its pools sequentially, so without a nudge a
        # teardown costs O(pools x poll interval) of pure waiting.
        # The no-op rides the normal item path (executed, task_done),
        # so pending-work semantics at stop are unchanged.
        for t in self._threads:
            if t.is_alive():
                self.queue(_stop_nudge)
        for t in self._threads:
            t.join(timeout=2)


def _stop_nudge() -> None:
    pass


class ShardedThreadPool:
    """N independent single-thread shards; same-key work never reorders.

    The ShardedOpWQ pattern (osd/OSD.cc:8802): work is enqueued by an
    ordering key (e.g. pg id); key -> shard by hash.
    """

    def __init__(self, name: str, num_shards: int = 5,
                 hbmap: HeartbeatMap | None = None, grace: float = 60.0,
                 qos_state=None):
        self.name = name
        self.num_shards = num_shards
        # ONE DmClockState across every shard (when given): rates are
        # daemon-global regardless of how pgids hash across shards
        self.qos_state = qos_state
        self._shards = [ThreadPool(f"{name}-s{i}", 1, hbmap, grace,
                                   qos_state=qos_state)
                        for i in range(num_shards)]

    def start(self) -> None:
        for s in self._shards:
            s.start()

    def queue(self, key, fn: Callable, *args,
              qos: str | None = None, qos_cost: float = 1.0) -> None:
        self._shards[hash(key) % self.num_shards].queue(
            fn, *args, qos=qos, qos_cost=qos_cost)

    def drain(self) -> None:
        for s in self._shards:
            s.drain()

    def stop(self) -> None:
        for s in self._shards:
            s.stop()
