"""Shared epoll event-loop worker pool for the async messenger.

The reference AsyncMessenger (msg/async/Stack.h, Event.cc) runs a fixed
pool of `ms_async_op_threads` workers, each owning one epoll loop; every
connection in the process is multiplexed onto one of those loops, so the
thread count is bounded by the pool size, not by connections or
messenger instances.  This module is that pool: selectors-based event
loops (EpollSelector on Linux) with

  * a wakeup socketpair per worker (EventCenter::wakeup) so foreign
    threads — op shards posting replies, clients queueing sends — can
    hand work to the loop;
  * a monotonic timer heap (EventCenter::create_time_event) for
    backoff, handshake timeouts and injected delays;
  * per-worker stats (registered sockets, loop wakeups) surfaced
    through `perf dump`'s msgr_event block.

Workers are process-wide daemon threads created on first use and keyed
by pool size; they are never torn down (messengers come and go, the
pool persists — shutdown hygiene lives at the messenger/connection
layer, which closes its own sockets deterministically).
"""

from __future__ import annotations

import heapq
import selectors
import socket
import threading
import time
from collections import deque
from typing import Callable

from ..utils.dout import DoutLogger


class TimerHandle:
    """Cancelable handle for EventWorker.call_later."""

    __slots__ = ("fn", "args", "cancelled")

    def __init__(self, fn: Callable, args: tuple):
        self.fn = fn
        self.args = args
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class EventWorker(threading.Thread):
    """One epoll loop; all fd callbacks and timers run on this thread.

    Selector mutations (register/modify/unregister) are NOT thread-safe
    against select(), so every socket operation is funneled onto the
    loop via call()/call_later(); only those two entry points may be
    used from foreign threads.
    """

    def __init__(self, index: int):
        super().__init__(name=f"ms-async-{index}", daemon=True)
        self.index = index
        self.sel = selectors.DefaultSelector()
        self.log = DoutLogger("ms", f"async-worker.{index}")
        self._lock = threading.Lock()
        self._pending: deque[tuple[Callable, tuple]] = deque()
        self._timers: list[tuple[float, int, TimerHandle]] = []
        self._timer_seq = 0
        self._stop = False
        # socks: _Sock instances currently registered on this loop
        # (connection balancing + the per-worker perf-dump view);
        # wakeups: loop iterations that found fd events to service
        self.stats = {"socks": 0, "wakeups": 0}
        # wakeup pipe: any thread writes a byte to pop the loop out of
        # select() after posting to _pending
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self.sel.register(self._wake_r, selectors.EVENT_READ, None)

    # -- cross-thread entry points -------------------------------------

    def call(self, fn: Callable, *args) -> None:
        """Run fn(*args) on the loop thread (soonest iteration)."""
        with self._lock:
            self._pending.append((fn, args))
        if threading.current_thread() is not self:
            self.wake()

    def call_later(self, delay: float, fn: Callable, *args) -> TimerHandle:
        """Run fn(*args) on the loop thread after `delay` seconds."""
        h = TimerHandle(fn, args)
        if threading.current_thread() is self:
            self._arm(delay, h)
        else:
            self.call(self._arm, delay, h)
        return h

    def wake(self) -> None:
        try:
            self._wake_w.send(b"\0")
        except (BlockingIOError, OSError):
            pass                      # pipe full: loop is waking anyway

    # -- loop internals ------------------------------------------------

    def _arm(self, delay: float, h: TimerHandle) -> None:
        self._timer_seq += 1
        heapq.heappush(self._timers,
                       (time.monotonic() + max(0.0, delay),
                        self._timer_seq, h))

    def _sel_set(self, fileobj, mask: int, cb) -> None:
        """Register/modify/unregister (mask=0) in one idempotent call."""
        try:
            registered = self.sel.get_key(fileobj)
        except (KeyError, ValueError):
            registered = None
        if mask == 0:
            if registered is not None:
                self.sel.unregister(fileobj)
        elif registered is None:
            self.sel.register(fileobj, mask, cb)
        else:
            self.sel.modify(fileobj, mask, cb)

    def run(self) -> None:
        while not self._stop:
            with self._lock:
                have_pending = bool(self._pending)
            if have_pending:
                timeout = 0.0
            elif self._timers:
                timeout = max(0.0,
                              self._timers[0][0] - time.monotonic())
            else:
                timeout = 1.0
            try:
                events = self.sel.select(timeout)
            except OSError:
                events = []
            if events:
                self.stats["wakeups"] += 1
            for key, mask in events:
                cb = key.data
                if cb is None:        # wakeup pipe: drain it
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                    continue
                try:
                    cb(mask)
                except Exception as e:
                    self.log.error("event callback failed: %r", e)
            now = time.monotonic()
            while self._timers and self._timers[0][0] <= now:
                _, _, h = heapq.heappop(self._timers)
                if h.cancelled:
                    continue
                try:
                    h.fn(*h.args)
                except Exception as e:
                    self.log.error("timer callback failed: %r", e)
            with self._lock:
                pending, self._pending = self._pending, deque()
            for fn, args in pending:
                try:
                    fn(*args)
                except Exception as e:
                    self.log.error("posted callback failed: %r", e)


class WorkerPool:
    """Fixed set of event workers; connections are placed on the least
    loaded loop at creation (PosixNetworkStack::get_worker)."""

    def __init__(self, n: int):
        self.workers = [EventWorker(i) for i in range(max(1, n))]
        for w in self.workers:
            w.start()

    def __len__(self) -> int:
        return len(self.workers)

    def pick(self) -> EventWorker:
        return min(self.workers,
                   key=lambda w: (w.stats["socks"], w.index))

    def stats(self) -> list[dict]:
        return [{"worker": w.index,
                 "open_sockets": w.stats["socks"],
                 "event_wakeups": w.stats["wakeups"]}
                for w in self.workers]


_pools: dict[int, WorkerPool] = {}
_pools_lock = threading.Lock()


def get_pool(n: int) -> WorkerPool:
    """The process-wide pool for `n` workers (created on first use)."""
    n = max(1, int(n))
    with _pools_lock:
        pool = _pools.get(n)
        if pool is None:
            pool = _pools[n] = WorkerPool(n)
        return pool
