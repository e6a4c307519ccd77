"""AsyncMessenger: the epoll event-loop serving stack (msg/async).

Selected with ms_type=async.  Public surface, wire format, auth,
lossless resend and reconnect semantics are identical to the blocking
Messenger (the wire-corpus and cross-stack tests pin this); what
changes is the execution model:

  * NO thread per messenger: all messengers in the process multiplex
    their connections onto the shared pool of `ms_async_op_threads`
    EventWorkers (ceph_tpu_torch/msg/async_event.py), so daemon/client
    thread count is flat in both connections and sessions;
  * accepts, handshakes, frame reads and gather writes all run on the
    loops via per-connection state machines (async_conn.py);
  * op submission is decoupled from socket I/O: ms_dispatch runs on
    the worker (the OSD hands off to its op shards immediately, so the
    tracked op's `queue` span still anchors at messenger receive) and
    replies from op-shard threads re-enter the owning loop through its
    wakeup pipe (AsyncConnection.send_message).

An accepted socket starts on the least-loaded worker; once the banner
names the peer it migrates to that connection's home loop so all of a
connection's state stays single-threaded.
"""

from __future__ import annotations

import socket
import threading

from ..utils import faults
from .async_conn import AsyncConnection, _BadBanner, _Sock, \
    _accept_hs_gen, _drive
from .message import Message
from .messenger import EntityAddr, Messenger, Policy

_EVENT_READ = 1


class AsyncMessenger(Messenger):
    def __init__(self, name: str, conf=None):
        super().__init__(name, conf)
        from .async_event import get_pool
        self.pool = get_pool(
            int(getattr(self.conf, "ms_async_op_threads", 3) or 3))
        self.home = self.pool.pick()
        self._conn_lock = threading.Lock()
        self._listener: socket.socket | None = None
        self._accepting: set[_Sock] = set()
        self._stopped = False
        self._running = False

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self.perf.set("event_workers", len(self.pool))
        if self.addr is not None:
            host, port = self.addr
            ls = socket.create_server((host, port), backlog=512)
            ls.setblocking(False)
            self.addr = (host, ls.getsockname()[1])
            self._listener = ls
            self.home.call(self.home._sel_set, ls, _EVENT_READ,
                           self._on_accept_ready)

    def shutdown(self) -> None:
        if not self._running or self._stopped:
            return
        self._stopped = True
        # each worker closes its own share (selectors are not thread-
        # safe), then we wait so every fd is really gone on return —
        # the churn drill pins zero-fd-growth on this
        workers = list(self.pool.workers)
        done = threading.Event()
        remaining = [len(workers)]
        rlock = threading.Lock()

        def _per_worker(w):
            if w is self.home and self._listener is not None:
                try:
                    w._sel_set(self._listener, 0, None)
                except Exception:
                    pass
                try:
                    self._listener.close()
                except OSError:
                    pass
                self._listener = None
            for conn in list(self.conns.values()):
                if conn.worker is w:
                    conn._close()
            with self._conn_lock:
                pend = [s for s in self._accepting if s.worker is w]
            for s in pend:
                s.close()
            with rlock:
                remaining[0] -= 1
                if remaining[0] == 0:
                    done.set()
        for w in workers:
            w.call(_per_worker, w)
        if threading.current_thread() not in workers:
            done.wait(5)

    # -- loop helpers --------------------------------------------------

    def _loop_call(self, fn, *args) -> None:
        self.home.call(fn, *args)

    def call_later(self, delay: float, fn, *args):
        """Cancelable timer on the home loop (replaces per-session
        helper threads like the monc subscription renewer)."""
        return self.home.call_later(delay, fn, *args)

    def event_stats(self) -> dict:
        return {"type": "async", "workers": len(self.pool),
                "connections": len(self.conns),
                "per_worker": self.pool.stats()}

    # -- outgoing ------------------------------------------------------

    def get_connection(self, peer_name: str,
                       peer_addr: EntityAddr) -> AsyncConnection:
        with self._conn_lock:
            conn = self.conns.get(peer_name)
            if conn is not None and not conn._closed:
                if conn.peer_addr == peer_addr:
                    return conn
                # peer rebooted at a new address (see Messenger)
                conn.mark_down()
            conn = AsyncConnection(self, peer_name, peer_addr,
                                   self.policy_for(peer_name),
                                   self.pool.pick())
            self.conns[peer_name] = conn
            self._conns_by_addr[peer_addr] = conn
        conn.worker.call(conn._start_out)
        return conn

    def send_message(self, msg: Message, peer_name: str,
                     peer_addr: EntityAddr) -> None:
        if peer_addr == self.addr and peer_name == self.name:
            msg.src = self.name
            self.home.call(self._fast_dispatch_local, msg)
            return
        self.get_connection(peer_name, peer_addr).send_message(msg)

    def _fast_dispatch_local(self, msg: Message) -> None:
        conn = self.conns.get(self.name)
        if conn is None:
            conn = AsyncConnection(self, self.name, self.addr,
                                   Policy.lossless_peer(), self.home)
            self.conns[self.name] = conn
        self._deliver(conn, msg)

    def _conn_reset(self, conn) -> None:
        conn._close()
        super()._conn_reset(conn)

    # -- incoming ------------------------------------------------------

    def _on_accept_ready(self, mask: int) -> None:
        ls = self._listener
        if ls is None:
            return
        while True:
            try:
                raw, _peer = ls.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            if self._stopped:
                raw.close()
                continue
            worker = self.pool.pick()
            worker.call(self._begin_accept, worker, raw)

    def _begin_accept(self, worker, raw: socket.socket) -> None:
        if self._stopped:
            raw.close()
            return
        sock = _Sock(worker, raw,
                     on_resume=lambda: self.perf.inc(
                         "partial_write_resumes"))
        with self._conn_lock:
            self._accepting.add(sock)

        def _exit(result, exc):
            with self._conn_lock:
                self._accepting.discard(sock)
            if exc is not None or result is None:
                if exc is not None and not isinstance(
                        exc, (_BadBanner, ConnectionError, OSError)):
                    self.log.error("accept handshake died: %r", exc)
                sock.close()
                return
            self._finish_accept(sock, *result)
        _drive(sock, _accept_hs_gen(self, sock), _exit)

    def _finish_accept(self, sock: _Sock, peer_name: str,
                       peer_addr: EntityAddr, nonce: int, skey) -> None:
        if self._stopped:
            sock.close()
            return
        if faults.get().partitioned(peer_name, self.name):
            # one-way partitions block the peer->us direction here
            sock.close()
            return
        with self._conn_lock:
            conn = self.conns.get(peer_name)
            if conn is None or conn._closed:
                conn = AsyncConnection(self, peer_name, peer_addr,
                                       self.policy_for(peer_name),
                                       sock.worker)
                self.conns[peer_name] = conn
        if conn.worker is sock.worker:
            conn._attach_accepted(sock, skey, nonce, peer_addr)
        else:
            sock.migrate(conn.worker,
                         lambda: conn._attach_accepted(
                             sock, skey, nonce, peer_addr))
