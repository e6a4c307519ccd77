"""Event-loop connection plane: nonblocking sockets, per-connection
protocol state machines, gather writes.

AsyncConnection is the exact peer-link analog of messenger.Connection —
same incarnation nonce, seq spaces, unsent/unacked queues, lossless
resend and reconnect-backoff semantics, the same two-socket shape (a
lazily dialed out-socket for the frames we send, plus whatever socket
the peer's connect landed on our acceptor) — but it owns no thread.
All of its I/O runs on its home EventWorker:

  * _Sock is the socket state machine: an `expect(n, cb)` read plan
    over an accumulating buffer (a short read resumes on the next
    EPOLLIN) and a FIFO gather-write queue driven by socket.sendmsg
    over the frame iovecs — Message.encode_iov ropes are written
    buffer-by-buffer, never joined; a short write keeps the remaining
    views and resumes on EPOLLOUT (`partial_write_resumes` counts
    those resumes);
  * the wire protocols (banner/auth handshakes, the frame read loop)
    are generators yielding ("read", n) / ("write", iov) /
    ("sleep", s), pumped by _drive() — the same code shape as the
    blocking stack's coroutines, so byte-level semantics stay aligned
    line for line;
  * the send path is an event-driven pump: per-frame fault checks in
    the blocking stack's exact order (partition, socket kill, send
    delay, drop), then sign-at-write and a gather write; a frame stays
    at the queue head until fully flushed, then moves to _sent until
    the peer acks it, so a socket death mid-write resends it.
"""

from __future__ import annotations

import errno
import random
import socket
import threading
import time
from typing import Callable

from ..auth import cephx
from ..utils import faults
from .message import Message
from .messenger import (AuthError, BANNER_MAGIC, Policy, _BANNER,
                        _BANNER_REPLY, _pack_addr, _unpack_addr)

_READ = 1       # selectors.EVENT_READ
_WRITE = 2      # selectors.EVENT_WRITE
_RECV_CHUNK = 65536
_IOV_MAX = 512  # conservative sendmsg iovec cap (Linux IOV_MAX is 1024)


class _Sock:
    """Nonblocking socket on one EventWorker: read plans + gather
    writes with partial resume.  Every method runs on the worker."""

    def __init__(self, worker, sock: socket.socket, *,
                 connecting: bool = False,
                 on_connect: Callable | None = None,
                 on_resume: Callable | None = None):
        self.worker = worker
        self.sock = sock
        sock.setblocking(False)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self.closed = False
        self.on_error: Callable | None = None   # fn(exc), fired once
        self.on_connect = on_connect
        self.on_resume = on_resume              # partial write resumed
        self._connecting = connecting
        self._rbuf = bytearray()
        self._rpos = 0
        self._plans: list[tuple[int, Callable]] = []
        self._draining = False
        # write queue entries are [list-of-memoryviews, on_done]; the
        # head batch may be partially flushed (views already advanced)
        self._wq: list[list] = []
        self._flushing = False
        self._mask = 0
        worker.stats["socks"] += 1
        self._set_mask(_WRITE if connecting else _READ)

    # -- registration --------------------------------------------------

    def _set_mask(self, mask: int) -> None:
        if self.closed or mask == self._mask:
            return
        self._mask = mask
        self.worker._sel_set(self.sock, mask, self._on_event)

    def _on_event(self, mask: int) -> None:
        if self.closed:
            return
        if self._connecting:
            self._finish_connect()
            return
        if mask & _READ:
            self._on_readable()
        if not self.closed and (mask & _WRITE):
            self._on_writable()

    # -- connect -------------------------------------------------------

    def _finish_connect(self) -> None:
        err = self.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
        if err:
            self._fail(OSError(err, "connect failed"))
            return
        self._connecting = False
        self._set_mask(_READ | (_WRITE if self._wq else 0))
        cb, self.on_connect = self.on_connect, None
        if cb is not None:
            cb()
        self._flush()

    # -- reads ---------------------------------------------------------

    def expect(self, n: int, cb: Callable) -> None:
        """Plan to read exactly n bytes, then cb(bytes)."""
        self._plans.append((n, cb))
        self._drain_plans()

    def _on_readable(self) -> None:
        try:
            while True:
                chunk = self.sock.recv(_RECV_CHUNK)
                if not chunk:
                    self._fail(ConnectionResetError("peer closed"))
                    return
                self._rbuf += chunk
                if len(chunk) < _RECV_CHUNK:
                    break
        except (BlockingIOError, InterruptedError):
            pass
        except OSError as e:
            self._fail(e)
            return
        self._drain_plans()

    def _drain_plans(self) -> None:
        # the guard turns nested expect() calls (a plan callback asking
        # for the next field) into iterations of this loop instead of
        # recursion — a deep buffered backlog must not blow the stack
        if self._draining:
            return
        self._draining = True
        try:
            while (not self.closed and self._plans
                   and len(self._rbuf) - self._rpos
                   >= self._plans[0][0]):
                n, cb = self._plans.pop(0)
                data = bytes(self._rbuf[self._rpos:self._rpos + n])
                self._rpos += n
                if self._rpos > _RECV_CHUNK:
                    del self._rbuf[:self._rpos]
                    self._rpos = 0
                cb(data)
        finally:
            self._draining = False

    # -- gather writes -------------------------------------------------

    def send_iov(self, iov: list, on_done: Callable | None = None) -> None:
        """FIFO gather write; on_done fires (possibly synchronously)
        once every byte of the iovec reached the kernel."""
        if self.closed:
            return
        bufs = [memoryview(b) for b in iov if len(b)]
        if not bufs:
            if on_done is not None:
                on_done()
            return
        self._wq.append([bufs, on_done])
        self._flush()

    def _on_writable(self) -> None:
        if self._wq and self.on_resume is not None:
            self.on_resume()          # a partial write resumed by EPOLLOUT
        self._flush()

    def _flush(self) -> None:
        if self._flushing:
            return                    # re-entered from an on_done callback
        self._flushing = True
        try:
            while self._wq and not self.closed:
                bufs, on_done = self._wq[0]
                try:
                    sent = self.sock.sendmsg(bufs[:_IOV_MAX])
                except (BlockingIOError, InterruptedError):
                    sent = 0
                except OSError as e:
                    self._fail(e)
                    return
                while sent:
                    head = bufs[0]
                    if sent >= len(head):
                        sent -= len(head)
                        bufs.pop(0)
                    else:
                        bufs[0] = head[sent:]
                        sent = 0
                if bufs:
                    self._set_mask(_READ | _WRITE)
                    return
                self._wq.pop(0)
                if on_done is not None:
                    on_done()
            if not self.closed:
                self._set_mask(_READ)
        finally:
            self._flushing = False

    # -- teardown ------------------------------------------------------

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self.worker.stats["socks"] -= 1
        try:
            self.worker._sel_set(self.sock, 0, None)
        except Exception:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self._plans.clear()
        self._wq.clear()

    def _fail(self, exc: BaseException) -> None:
        """Close now; emit on_error from a fresh loop iteration so a
        failure inside a protocol step never re-enters the generator
        that is currently executing."""
        if self.closed:
            return
        self.close()
        self.worker.call(self._emit_error, exc)

    def _emit_error(self, exc: BaseException) -> None:
        cb, self.on_error = self.on_error, None
        if cb is not None:
            cb(exc)

    # -- migration -----------------------------------------------------

    def migrate(self, new_worker, then: Callable) -> None:
        """Move this socket to another worker's loop (an accepted
        socket joins its connection's home loop once the peer is
        known).  Runs on the CURRENT worker; `then` fires on the new
        one."""
        self.worker._sel_set(self.sock, 0, None)
        self.worker.stats["socks"] -= 1
        mask, self._mask = self._mask, 0

        def _attach():
            self.worker = new_worker
            new_worker.stats["socks"] += 1
            if not self.closed:
                self._set_mask(mask or _READ)
            then()
        new_worker.call(_attach)


def _drive(sock: _Sock, gen, on_exit: Callable) -> None:
    """Pump a protocol generator over a _Sock.

    The generator yields ("read", n) -> resumes with the bytes,
    ("write", iov) -> resumes once flushed, ("sleep", secs) -> resumes
    after the delay.  A socket failure is thrown into the generator so
    its except/finally clauses run, exactly like a coroutine seeing
    ConnectionError.  on_exit(result, exc) fires exactly once; result
    is the generator's return value on clean exit."""
    done = False
    running = False
    queued: list = []          # resumes that arrived while gen executed
    _MISS = object()

    def finish(result, exc):
        nonlocal done
        if done:
            return
        done = True
        sock.on_error = None
        on_exit(result, exc)

    def step(value=None, exc=None):
        nonlocal running
        if done:
            return
        if running:
            # a callback fired synchronously while the generator was
            # executing (e.g. an error surfacing out of a nested write):
            # queue it for the active frame instead of re-entering
            queued.append((value, exc))
            return
        running = True
        try:
            _run(value, exc)
        finally:
            running = False

    def _run(value, exc):
        while True:
            try:
                if exc is not None:
                    req = gen.throw(exc)
                else:
                    req = gen.send(value)
            except StopIteration as s:
                finish(s.value, None)
                return
            except BaseException as e:
                finish(None, e)
                return
            if queued:
                # an error (or stray resume) landed mid-execution; it
                # supersedes the wait the generator just requested
                value, exc = queued.pop(0)
                continue
            kind = req[0]
            if kind == "read":
                # detect an expect() satisfied from already-buffered
                # bytes in this same stack frame and keep looping
                # instead of recursing into step()
                box = {"v": _MISS, "inline": True}

                def _rd(data, box=box):
                    if box["inline"]:
                        box["v"] = data
                    else:
                        step(data)
                sock.expect(req[1], _rd)
                box["inline"] = False
                if box["v"] is not _MISS:
                    value, exc = box["v"], None
                    continue
                return
            elif kind == "write":
                box = {"v": _MISS, "inline": True}

                def _wr(box=box):
                    if box["inline"]:
                        box["v"] = None
                    else:
                        step()
                sock.send_iov(req[1], on_done=_wr)
                box["inline"] = False
                if box["v"] is not _MISS:
                    value, exc = None, None
                    continue
                return
            elif kind == "sleep":
                sock.worker.call_later(req[1], step)
                return
            else:
                finish(None, RuntimeError(f"bad yield {req!r}"))
                return

    sock.on_error = lambda e: step(exc=e)
    step()


# -- wire protocol generators (the blocking stack's coroutines, same
#    order of reads/writes/checks, driven by _drive) -------------------

class _BadBanner(Exception):
    """Silent close: garbage banner or failed auth (already counted)."""


def _auth_connect_gen(msgr, peer_name: str):
    """Connector side of the cephx-lite handshake (mirrors
    Messenger._auth_connect)."""
    service = peer_name.split(".", 1)[0] if peer_name else ""
    ticket = (msgr.ticket_provider(service)
              if msgr.ticket_provider else None)
    if ticket is not None:
        blob = ticket["blob"]
        key = ticket["key"]
        cn = cephx.make_nonce()
        yield ("write", [b"\x02" + len(blob).to_bytes(2, "big")
                         + blob + cn])
    else:
        key = msgr.auth_key
        cn = cephx.make_nonce()
        yield ("write", [b"\x01" + cn])
    blob2 = yield ("read", cephx.NONCE_LEN + cephx.PROOF_LEN)
    sn, proof_s = blob2[:cephx.NONCE_LEN], blob2[cephx.NONCE_LEN:]
    if proof_s != cephx.proof(key, cn, sn, b"srv"):
        raise AuthError("server proof mismatch")
    yield ("write", [cephx.proof(key, cn, sn, b"cli")])
    return cephx.session_key(key, cn, sn)


def _auth_accept_gen(msgr, peer_name: str):
    """Acceptor side (mirrors Messenger._auth_accept): redeem a ticket
    against the rotating service secrets, or prove/verify the static
    secret."""
    mode = yield ("read", 1)
    if mode == b"\x02":
        ln = int.from_bytes((yield ("read", 2)), "big")
        blob = yield ("read", ln)
        info = None
        for secret in msgr.rotating_keys.values():
            payload = cephx.unseal(secret, blob)
            if payload is not None:
                from ..utils import denc as _denc
                info = _denc.loads(payload)
                break
        if info is None:
            raise AuthError(
                f"ticket from {peer_name} matches no rotating key")
        if info.get("client") != peer_name:
            raise AuthError(
                f"ticket for {info.get('client')!r} presented by "
                f"{peer_name}")
        if float(info.get("expires", 0)) < msgr.ticket_clock():
            raise AuthError(f"expired ticket from {peer_name}")
        key = info["key"]
        msgr.perf.inc("auth_ticket_accepts")
    else:
        key = msgr._key_for(peer_name)
        if key is None:
            raise AuthError(f"no key for {peer_name}")
        msgr.perf.inc("auth_secret_accepts")
    cn = yield ("read", cephx.NONCE_LEN)
    sn = cephx.make_nonce()
    yield ("write", [sn + cephx.proof(key, cn, sn, b"srv")])
    proof_c = yield ("read", cephx.PROOF_LEN)
    if proof_c != cephx.proof(key, cn, sn, b"cli"):
        raise AuthError(f"bad client proof from {peer_name}")
    return cephx.session_key(key, cn, sn)


def _connect_gen(msgr, conn):
    """Out-socket handshake: banner, auth, banner reply.  Returns
    (session_key, peer_in_seq)."""
    name_b = msgr.name.encode()
    addr_b = _pack_addr(msgr.addr)
    yield ("write", [_BANNER.pack(BANNER_MAGIC, conn.nonce,
                                  len(name_b), len(addr_b))
                     + name_b + addr_b])
    skey = None
    if msgr.auth_mode == "cephx":
        skey = yield from _auth_connect_gen(msgr, conn.peer_name)
    rep = yield ("read", _BANNER_REPLY.size)
    magic, peer_in_seq = _BANNER_REPLY.unpack(rep)
    if magic != BANNER_MAGIC:
        raise ConnectionResetError("bad banner reply")
    return skey, peer_in_seq


def _accept_hs_gen(msgr, sock: _Sock):
    """In-socket handshake up to (but excluding) conn registration:
    banner parse + auth.  Returns (peer_name, peer_addr, nonce, skey);
    raises _BadBanner for a silent close."""
    hdr = yield ("read", _BANNER.size)
    magic, nonce, nlen, alen = _BANNER.unpack(hdr)
    if magic != BANNER_MAGIC:
        raise _BadBanner()
    try:
        peer_name = (yield ("read", nlen)).decode()
        peer_addr = _unpack_addr((yield ("read", alen)))
    except (ValueError, UnicodeDecodeError):
        raise _BadBanner()
    skey = None
    if msgr.auth_mode == "cephx":
        # authenticate BEFORE any session state is revealed or mutated
        # (the banner reply carries in_seq); bound it like the blocking
        # stack's wait_for
        tmo = sock.worker.call_later(
            float(msgr.conf.ms_connect_timeout),
            lambda: sock._fail(ConnectionResetError("auth timeout")))
        try:
            skey = yield from _auth_accept_gen(msgr, peer_name)
        except (AuthError, ConnectionError, OSError) as e:
            msgr.perf.inc("auth_failures")
            msgr.log.warn("rejecting %s: auth failed (%s)",
                          peer_name, e)
            raise _BadBanner()
        finally:
            tmo.cancel()
    return peer_name, peer_addr, nonce, skey


def _frames_gen(msgr, conn, sock: _Sock, skey, accepted: bool):
    """The frame read loop — field-for-field the blocking stack's
    _read_frames: header, body, scatter-read segments, signature
    check, partition gate, ack handling, dup suppression, decode,
    injected delay, deliver."""
    recv_label = b"C" if accepted else b"S"
    send_label = b"S" if accepted else b"C"
    hdr_size = Message.header_size()
    while not conn._closed:
        hdr = yield ("read", hdr_size)
        type_id, plen, seq, has_segs = Message.parse_header_any(hdr)
        body = yield ("read", plen)
        segments: list[bytes] = []
        if has_segs:
            seg_lens, payload = Message.parse_seg_table(body)
            for n in seg_lens:
                segments.append((yield ("read", n)))
        else:
            payload = body
        nbytes = hdr_size + plen + sum(len(s) for s in segments)
        msgr.perf.inc("bytes_recv", nbytes)
        if skey is not None:
            sig = yield ("read", cephx.SIG_LEN)
            if not cephx.check_iov(
                    skey, [recv_label, hdr, body, *segments], sig):
                msgr.log.warn("bad frame signature from %s, dropping "
                              "connection", conn.peer_name)
                raise ConnectionResetError("bad signature")
        fs = faults.get()
        if fs.partitioned(conn.peer_name, msgr.name):
            raise ConnectionResetError("partitioned")
        if type_id == msgr.ACK_TYPE:
            conn._handle_ack(seq)
            continue
        ack = msgr._ack_frame(seq)
        if skey is not None:
            ack = ack + cephx.sign(skey, send_label + ack)
        sock.send_iov([ack])          # fire and forget, like writer.write
        if seq <= conn.in_seq:
            continue                  # dup after reconnect
        conn.in_seq = seq
        try:
            msg = Message.decode(type_id, seq, payload, segments)
        except ValueError:
            msgr.log.error("undecodable frame type=%d seq=%d from %s",
                           type_id, seq, conn.peer_name)
            continue
        d = fs.recv_delay(
            conn.peer_name, msgr.name,
            float(msgr.conf.ms_inject_delay_probability),
            float(msgr.conf.ms_inject_delay_max))
        if d > 0:
            yield ("sleep", d)
        msgr._deliver(conn, msg)


class AsyncConnection:
    """One peer link on the event-loop stack; all state mutations run
    on self.worker (its home EventWorker)."""

    def __init__(self, msgr, peer_name: str, peer_addr, policy: Policy,
                 worker):
        self.msgr = msgr
        self.peer_name = peer_name
        self.peer_addr = peer_addr
        self.policy = policy
        self.worker = worker
        # incarnation nonce is per connection (see Connection.__init__)
        self.nonce = random.getrandbits(63) or 1
        self.peer_nonce = 0
        self.out_seq = 0
        self.in_seq = 0
        self._queue: list[tuple[int, list]] = []    # (seq, iovec) unsent
        self._sent: list[tuple[int, list]] = []     # sent, not yet acked
        self._writer = None      # the OPEN out-_Sock (None while down;
        self._closed = False     # MonClient probes this for liveness)
        self.last_active = time.time()
        self._socks: set[_Sock] = set()
        self._out_running = False
        self._backoff = float(msgr.conf.ms_initial_backoff)
        self._cur = None         # (sock, skey) of the open out session
        self._pump_active = False
        self._pump_delayed = False
        self._retry_timer = None
        msgr.perf.inc("open_connections")
        self._counted = True

    # -- sending (thread-safe entry) -----------------------------------

    def send_message(self, msg: Message) -> None:
        # op shards and client threads land here: the message is handed
        # to the owning loop through its wakeup pipe
        if threading.current_thread() is not self.worker:
            self.msgr.perf.inc("event_wakeups")
        self.worker.call(self._queue_msg, msg)

    def _queue_msg(self, msg: Message) -> None:
        if self._closed:
            return
        msg.src = self.msgr.name
        self.out_seq += 1
        frame = msg.encode_iov(self.out_seq)
        self.msgr.perf.inc("msg_send")
        self.msgr.perf.inc("bytes_send", sum(len(b) for b in frame))
        self._queue.append((self.out_seq, frame))
        self._start_out()
        self._pump()

    def _handle_ack(self, seq: int) -> None:
        self._sent = [(s, f) for s, f in self._sent if s > seq]

    def _requeue_sent(self, peer_in_seq: int) -> None:
        if self._sent:
            self._queue[:0] = self._sent
            self._sent = []
        if peer_in_seq:
            self._queue = [(s, f) for s, f in self._queue
                           if s > peer_in_seq]

    def mark_down(self) -> None:
        self.worker.call(self._close)

    def _close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._writer = None
        self._cur = None
        if self._retry_timer is not None:
            self._retry_timer.cancel()
            self._retry_timer = None
        for s in list(self._socks):
            s.close()
        self._socks.clear()
        if self._counted:
            self._counted = False
            self.msgr.perf.dec("open_connections")

    def __repr__(self):
        return (f"AsyncConnection({self.msgr.name}->{self.peer_name}"
                f"@{self.peer_addr})")

    # -- out side: dial, handshake, session, reconnect -----------------

    def _start_out(self) -> None:
        if self._out_running or self._closed or self.peer_addr is None:
            return
        self._out_running = True
        self._backoff = float(self.msgr.conf.ms_initial_backoff)
        self._attempt()

    def _retry(self, delay: float, fn=None) -> None:
        if self._retry_timer is not None:
            self._retry_timer.cancel()
        self._retry_timer = self.worker.call_later(
            delay, fn if fn is not None else self._attempt)

    def _attempt(self) -> None:
        if self._closed:
            self._out_running = False
            return
        msgr = self.msgr
        if faults.get().partitioned(msgr.name, self.peer_name):
            # lossless links poll at the INITIAL backoff (deterministic
            # heal latency); lossy links reset
            if self.policy.lossy:
                msgr._conn_reset(self)
                return
            self._retry(float(msgr.conf.ms_initial_backoff))
            return
        try:
            raw = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            raw.setblocking(False)
            err = raw.connect_ex(self.peer_addr)
        except OSError:
            self._dial_failed(None)
            return
        if err not in (0, errno.EINPROGRESS, errno.EWOULDBLOCK):
            raw.close()
            self._dial_failed(None)
            return
        holder = []
        sock = _Sock(self.worker, raw, connecting=True,
                     on_connect=lambda: self._handshake(holder[0]),
                     on_resume=lambda: msgr.perf.inc(
                         "partial_write_resumes"))
        holder.append(sock)
        sock.on_error = lambda exc: self._dial_failed(sock)
        self._socks.add(sock)

    def _dial_failed(self, sock: _Sock | None) -> None:
        if sock is not None:
            sock.close()
            self._socks.discard(sock)
        if self._closed:
            self._out_running = False
            return
        if self.policy.lossy:
            self.msgr._conn_reset(self)
            return
        self._retry(self._backoff)
        self._backoff = min(self._backoff * 2,
                            float(self.msgr.conf.ms_max_backoff))

    def _handshake(self, sock: _Sock) -> None:
        if self._closed or sock.closed:
            return
        msgr = self.msgr
        tmo = self.worker.call_later(
            float(msgr.conf.ms_connect_timeout),
            lambda: sock._fail(ConnectionResetError(
                "handshake timeout")))

        def _exit(result, exc):
            tmo.cancel()
            if exc is not None:
                if not isinstance(exc, (AuthError, ConnectionError,
                                        OSError)):
                    msgr.log.error("handshake to %s error: %r",
                                   self.peer_name, exc)
                self._dial_failed(sock)
                return
            skey, peer_in_seq = result
            self._session_open(sock, skey, peer_in_seq)
        _drive(sock, _connect_gen(msgr, self), _exit)

    def _session_open(self, sock: _Sock, skey, peer_in_seq: int) -> None:
        if self._closed or sock.closed:
            sock.close()
            self._socks.discard(sock)
            self._out_running = False
            return
        self._backoff = float(self.msgr.conf.ms_initial_backoff)
        self._writer = sock
        self._requeue_sent(peer_in_seq)
        cur = (sock, skey)
        self._cur = cur
        _drive(sock,
               _frames_gen(self.msgr, self, sock, skey, accepted=False),
               lambda result, exc: self._session_dead(cur, exc))
        self._pump()

    def _session_dead(self, cur, exc) -> None:
        sock, _skey = cur
        sock.close()
        self._socks.discard(sock)
        if self._cur is not cur:
            return
        self._cur = None
        self._writer = None
        self._pump_active = False
        self._pump_delayed = False
        msgr = self.msgr
        unexpected = exc is not None and not isinstance(
            exc, (ConnectionError, OSError))
        if unexpected:
            msgr.log.error("conn loop to %s error: %r",
                           self.peer_name, exc)
        if self._closed:
            self._out_running = False
            return

        def _after():
            if self._closed:
                self._out_running = False
                return
            if self.policy.lossy:
                msgr._conn_reset(self)
                return
            msgr.perf.inc("reconnects")
            self._attempt()
        if unexpected:
            delay = self._backoff
            self._backoff = min(self._backoff * 2,
                                float(msgr.conf.ms_max_backoff))
            self._retry(delay, _after)
        else:
            _after()

    # -- the frame pump ------------------------------------------------

    def _pump(self) -> None:
        while True:
            if self._closed or self._pump_active:
                return
            cur = self._cur
            if cur is None:
                return
            sock, skey = cur
            if sock.closed or not self._queue:
                return
            seq, frame = self._queue[0]
            fs = faults.get()
            msgr = self.msgr
            if not self._pump_delayed:
                if fs.partitioned(msgr.name, self.peer_name):
                    sock._fail(ConnectionResetError("partitioned"))
                    return
                if fs.should_kill_socket(
                        msgr.name, self.peer_name,
                        int(msgr.conf.ms_inject_socket_failures)):
                    msgr.log.debug("injecting socket failure to %s",
                                   self.peer_name)
                    sock._fail(ConnectionResetError("injected"))
                    return
                d = fs.send_delay(msgr.name, self.peer_name)
                if d > 0:
                    self._pump_active = True
                    self._pump_delayed = True

                    def _resume(c=cur):
                        if self._cur is not c or self._closed:
                            return
                        self._pump_active = False
                        self._pump()
                    self.worker.call_later(d, _resume)
                    return
            self._pump_delayed = False
            if fs.should_drop(msgr.name, self.peer_name):
                # modeled message loss (see Messenger._drain_queue)
                self._queue.pop(0)
                if not self.policy.lossy:
                    self._sent.append((seq, frame))
                continue
            # sign at write time, store UNSIGNED: a resend re-signs
            # under the new socket's session key; the iovec is gather-
            # written without joining
            iov = frame if skey is None else \
                frame + [cephx.sign_iov(skey, [b"C", *frame])]
            self._pump_active = True

            def _done(s=seq, f=frame, c=cur):
                if self._cur is not c or self._closed:
                    return
                self._pump_active = False
                if self._queue and self._queue[0][0] == s:
                    self._queue.pop(0)
                    if not self.policy.lossy:
                        self._sent.append((s, f))
                self.last_active = time.time()
                self._pump()
            sock.send_iov(iov, on_done=_done)
            return

    # -- in side: adopt an accepted socket -----------------------------

    def _attach_accepted(self, sock: _Sock, skey, nonce: int,
                         peer_addr) -> None:
        """On self.worker: the peer's connect finished its handshake;
        adopt the socket and run the frame loop on it (the tail of
        Messenger._accept)."""
        msgr = self.msgr
        if self._closed:
            sock.close()
            return
        self._socks.add(sock)
        if self.peer_nonce != nonce:
            # new peer incarnation: fresh seq space, maybe new address
            self.peer_nonce = nonce
            self.in_seq = 0
            self.peer_addr = peer_addr
        sock.send_iov([_BANNER_REPLY.pack(BANNER_MAGIC, self.in_seq)])
        msgr.perf.inc("accepts")

        def _exit(result, exc):
            if exc is not None and not isinstance(
                    exc, (ConnectionError, OSError)):
                msgr.log.error("accept loop for %s died: %r",
                               self.peer_name, exc)
            sock.close()
            self._socks.discard(sock)
        _drive(sock,
               _frames_gen(msgr, self, sock, skey, accepted=True),
               _exit)
