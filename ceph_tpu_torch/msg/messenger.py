"""Async messenger: one event-loop thread per daemon, typed dispatch.

Semantics from the reference (msg/Messenger.h, msg/async/):
  * a Messenger binds a listening address and owns Connections;
  * per-peer-class Policy: lossy (client links — drop on failure, peer
    re-establishes) vs lossless (cluster links — auto-reconnect with
    backoff and resend of unacked queued messages, preserving order);
  * Dispatchers get ms_dispatch(conn, msg) on a dispatch thread;
  * sending to your own address short-circuits through loopback fast
    dispatch (no sockets), as OSD self-sends do (osd/ECBackend.cc:1842);
  * fault injection goes through the central FaultSet registry
    (ceph_tpu_torch/utils/faults.py): partitions (symmetric or one-way),
    targeted drops/delays, and socket kills — the legacy
    ms_inject_socket_failures / ms_inject_delay_* knobs still work but
    their randomness now flows through the FaultSet's seeded streams.

Handshake: on connect, the client sends a banner with its entity name +
reply address; the acceptor registers the connection under that name for
reply routing and answers with the highest seq it has received on that
link (in_seq), so the connector resends only frames the peer actually
missed (the reference AsyncMessenger's connect/accept seq exchange,
msg/async/AsyncConnection.cc) — without this, lost acks at socket close
make every reconnect replay the whole backlog and delivery can livelock
under repeated failures.

Auth (auth_cluster_required=cephx): after the banner, both ends run the
cephx-lite challenge-response (ceph_tpu_torch/auth/cephx.py) — the acceptor
proves it holds the connector's keyring secret and vice versa — and
derive a per-socket session key that signs every subsequent frame
(CephxSessionHandler semantics).  A peer without the secret cannot
complete the handshake and a tampered frame fails its signature.
"""

from __future__ import annotations

import asyncio
import random
import struct
import threading
import time
from dataclasses import dataclass
from typing import Callable

from ..auth import cephx
from ..utils import faults
from ..utils.dout import DoutLogger
from .message import Message


class AuthError(Exception):
    pass

_BANNER = struct.Struct("<4sQII")    # magic, nonce, name len, addr-blob len
_BANNER_REPLY = struct.Struct("<4sQ")  # magic, acceptor's in_seq
_ADDR = struct.Struct("<HI")         # host length, port
BANNER_MAGIC = b"CTB2"


def _pack_addr(addr: "EntityAddr") -> bytes:
    host = addr[0].encode("utf-8")
    return _ADDR.pack(len(host), addr[1]) + host


def _unpack_addr(blob: bytes) -> "EntityAddr":
    if len(blob) < _ADDR.size:
        raise ValueError("short addr blob")
    hlen, port = _ADDR.unpack_from(blob)
    if len(blob) != _ADDR.size + hlen:
        raise ValueError("bad addr blob")
    return (blob[_ADDR.size:].decode("utf-8"), port)

EntityAddr = tuple[str, int]         # (host, port)


@dataclass
class Policy:
    lossy: bool = False
    server: bool = False             # accept-only side of lossy links

    @staticmethod
    def lossy_client() -> "Policy":
        return Policy(lossy=True)

    @staticmethod
    def stateless_server() -> "Policy":
        return Policy(lossy=True, server=True)

    @staticmethod
    def lossless_peer() -> "Policy":
        return Policy(lossy=False)


class Dispatcher:
    """Interface daemons implement to receive messages."""

    def ms_dispatch(self, conn: "Connection", msg: Message) -> bool:
        """Return True if handled."""
        raise NotImplementedError

    def ms_handle_reset(self, conn: "Connection") -> None:
        """Peer connection dropped (lossy) or gave up (lossless)."""


class Connection:
    """One peer link; owns an ordered send queue."""

    def __init__(self, msgr: "Messenger", peer_name: str,
                 peer_addr: EntityAddr | None, policy: Policy):
        self.msgr = msgr
        self.peer_name = peer_name          # may be "" until handshake
        self.peer_addr = peer_addr
        self.policy = policy
        # incarnation nonce is PER CONNECTION, not per messenger: a
        # lossy conn recreated by the same process restarts its seq
        # space at 1, and under the old (process-wide) nonce the
        # acceptor kept its stale in_seq and silently dropped every
        # fresh frame as a duplicate (the reference tracks this with
        # connect_seq/global_seq per attempt)
        self.nonce = random.getrandbits(63) or 1
        self.peer_nonce = 0                 # peer incarnation (acceptor side)
        self.out_seq = 0
        self.in_seq = 0
        # frames are IOVECS (lists of buffers from Message.encode_iov):
        # payload segments stay views onto the sender's memory until
        # the gather write — resends reuse the same views
        self._queue: list[tuple[int, list]] = []    # (seq, iovec) unsent
        self._sent: list[tuple[int, list]] = []     # sent, not yet acked
        self._writer: asyncio.StreamWriter | None = None
        self._closed = False
        self._send_event = asyncio.Event()
        self._task: asyncio.Task | None = None
        self.last_active = time.time()
        msgr.perf.inc("open_connections")
        self._counted = True

    # -- sending (thread-safe entry) ---------------------------------------

    def send_message(self, msg: Message) -> None:
        self.msgr._loop_call(self._queue_msg, msg)

    def _queue_msg(self, msg: Message) -> None:
        if self._closed:
            return
        msg.src = self.msgr.name
        self.out_seq += 1
        frame = msg.encode_iov(self.out_seq)
        self.msgr.perf.inc("msg_send")
        self.msgr.perf.inc("bytes_send", sum(len(b) for b in frame))
        self._queue.append((self.out_seq, frame))
        self._send_event.set()
        self.msgr._start_conn(self)   # acceptor-created conns lazily
                                      # grow a writer on first send

    def _handle_ack(self, seq: int) -> None:
        self._sent = [(s, f) for s, f in self._sent if s > seq]

    def _requeue_sent(self, peer_in_seq: int) -> None:
        """Reconnected: unacked frames the peer has not seen go back to
        the front in seq order; anything at or below the peer's in_seq
        was delivered (its ack was lost) and is dropped."""
        if self._sent:
            self._queue[:0] = self._sent
            self._sent = []
        if peer_in_seq:
            self._queue = [(s, f) for s, f in self._queue
                           if s > peer_in_seq]

    def mark_down(self) -> None:
        self.msgr._loop_call(self._close)

    def _close(self) -> None:
        self._closed = True
        self._send_event.set()
        if self._counted:
            self._counted = False
            self.msgr.perf.dec("open_connections")
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass
            self._writer = None

    def __repr__(self):
        return (f"Connection({self.msgr.name}->{self.peer_name}"
                f"@{self.peer_addr})")


class Messenger:
    def __init__(self, name: str, conf=None):
        from ..utils.config import Config
        self.name = name                     # entity name "osd.3"
        self.conf = conf or Config()
        self.addr: EntityAddr | None = None
        self.dispatchers: list[Dispatcher] = []
        self.conns: dict[str, Connection] = {}      # peer name -> conn
        self._conns_by_addr: dict[EntityAddr, Connection] = {}
        self.log = DoutLogger("ms", name)
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._server: asyncio.AbstractServer | None = None
        self._started = threading.Event()
        self._default_policy = Policy.lossless_peer()
        self._policies: dict[str, Policy] = {}      # peer type -> policy

        # perf counters (common/perf_counters.h msgr set) — registered
        # into the owning daemon's collection via register_perf()
        from ..utils.perf_counters import PerfCountersBuilder
        self.perf = (PerfCountersBuilder(f"msgr.{name}")
                     .add_u64_counter("msg_send")
                     .add_u64_counter("msg_recv")
                     .add_u64_counter("bytes_send")
                     .add_u64_counter("bytes_recv")
                     .add_u64_counter("reconnects")
                     .add_u64_counter("auth_failures")
                     .add_u64_counter("auth_ticket_accepts")
                     .add_u64_counter("auth_secret_accepts")
                     # event-loop plane (shared schema across stacks:
                     # the blocking stack reports 1 worker and never
                     # sees a partial write — asyncio hides them)
                     .add_u64("event_workers")
                     .add_u64("open_connections")
                     .add_u64_counter("event_wakeups")
                     .add_u64_counter("partial_write_resumes")
                     .add_u64_counter("accepts")
                     .create_perf_counters())

        # auth: resolved once; _key_for() answers per-entity lookups
        self.auth_mode = str(getattr(self.conf, "auth_cluster_required",
                                     "none") or "none")
        self._keyring = None
        self.auth_key: bytes | None = None
        if self.auth_mode == "cephx":
            import base64
            from ..auth import KeyRing
            key_b64 = str(getattr(self.conf, "key", "") or "")
            ring_path = str(getattr(self.conf, "keyring", "") or "")
            if ring_path:
                self._keyring = KeyRing.from_file(ring_path)
            if key_b64:
                self.auth_key = base64.b64decode(key_b64)
            elif self._keyring is not None:
                self.auth_key = self._keyring.get(self.name)
            if self.auth_key is None:
                raise ValueError(
                    f"auth_cluster_required=cephx but no key for "
                    f"{self.name} (set `key` or `keyring`)")
        # ticket auth (CephxProtocol TGS indirection): a connector
        # with a service ticket presents the sealed blob instead of
        # proving the static keyring secret; an acceptor holding the
        # service's ROTATING secrets (fetched from the mon) redeems
        # it.  Both are provisioned by MonClient.enable_service_auth.
        self.ticket_provider = None        # callable(service)->dict
        self.rotating_keys: dict[int, bytes] = {}
        self.ticket_clock = time.time      # expiry reference

    def _key_for(self, entity: str) -> bytes | None:
        """The secret we expect `entity` to prove knowledge of.

        With a keyring configured, an entity absent from it (and no
        "*" wildcard) is REJECTED — falling back to our own key would
        let any same-key holder impersonate revoked entities.  The
        bare `key=` mode is explicitly the shared-secret deployment.
        """
        if self._keyring is not None:
            return self._keyring.get(entity)
        return self.auth_key

    # -- cephx-lite handshake (per socket) ---------------------------------

    async def _auth_connect(self, peer_name: str, reader,
                            writer) -> bytes:
        """Connector side.  With a service ticket for the peer's
        class, present the sealed blob (mode 2, the TGS path) and
        prove the CONNECTION secret it carries; else run the static
        shared-secret exchange (mode 1)."""
        service = peer_name.split(".", 1)[0] if peer_name else ""
        ticket = (self.ticket_provider(service)
                  if self.ticket_provider else None)
        if ticket is not None:
            blob = ticket["blob"]
            key = ticket["key"]
            cn = cephx.make_nonce()
            writer.write(b"\x02" + len(blob).to_bytes(2, "big")
                         + blob + cn)
        else:
            key = self.auth_key
            cn = cephx.make_nonce()
            writer.write(b"\x01" + cn)
        blob2 = await reader.readexactly(cephx.NONCE_LEN + cephx.PROOF_LEN)
        sn, proof_s = blob2[:cephx.NONCE_LEN], blob2[cephx.NONCE_LEN:]
        if proof_s != cephx.proof(key, cn, sn, b"srv"):
            raise AuthError("server proof mismatch")
        writer.write(cephx.proof(key, cn, sn, b"cli"))
        return cephx.session_key(key, cn, sn)

    async def _auth_accept(self, peer_name: str, reader, writer) -> bytes:
        """Acceptor side: redeem a ticket blob against our rotating
        service secrets (mode 2), or prove/verify the peer's static
        secret (mode 1).  A peer whose entity has no keyring entry is
        rejected."""
        mode = await reader.readexactly(1)
        if mode == b"\x02":
            ln = int.from_bytes(await reader.readexactly(2), "big")
            blob = await reader.readexactly(ln)
            info = None
            for secret in self.rotating_keys.values():
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
            if float(info.get("expires", 0)) < self.ticket_clock():
                raise AuthError(f"expired ticket from {peer_name}")
            key = info["key"]
            self.perf.inc("auth_ticket_accepts")
        else:
            key = self._key_for(peer_name)
            if key is None:
                raise AuthError(f"no key for {peer_name}")
            self.perf.inc("auth_secret_accepts")
        cn = await reader.readexactly(cephx.NONCE_LEN)
        sn = cephx.make_nonce()
        writer.write(sn + cephx.proof(key, cn, sn, b"srv"))
        proof_c = await reader.readexactly(cephx.PROOF_LEN)
        if proof_c != cephx.proof(key, cn, sn, b"cli"):
            raise AuthError(f"bad client proof from {peer_name}")
        return cephx.session_key(key, cn, sn)

    # -- lifecycle ---------------------------------------------------------

    def bind(self, addr: EntityAddr) -> None:
        self.addr = addr

    def set_policy(self, peer_type: str, policy: Policy) -> None:
        """peer_type: entity prefix, e.g. 'client', 'osd', 'mon'."""
        self._policies[peer_type] = policy

    def set_default_policy(self, policy: Policy) -> None:
        self._default_policy = policy

    def policy_for(self, peer_name: str) -> Policy:
        ptype = peer_name.split(".", 1)[0] if peer_name else ""
        return self._policies.get(ptype, self._default_policy)

    def add_dispatcher_head(self, d: Dispatcher) -> None:
        self.dispatchers.insert(0, d)

    def add_dispatcher_tail(self, d: Dispatcher) -> None:
        self.dispatchers.append(d)

    def start(self) -> None:
        self.perf.set("event_workers", 1)     # this stack: one loop thread
        self._thread = threading.Thread(target=self._run,
                                        name=f"ms-{self.name}", daemon=True)
        self._thread.start()
        if not self._started.wait(10):
            raise RuntimeError(f"messenger {self.name} failed to start")

    def _run(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        if self.addr is not None:
            self._loop.run_until_complete(self._bind_server())
        self._started.set()
        try:
            self._loop.run_forever()
        finally:
            pending = asyncio.all_tasks(self._loop)
            for t in pending:
                t.cancel()
            try:
                self._loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True))
            except Exception:
                pass
            self._loop.close()

    async def _bind_server(self) -> None:
        host, port = self.addr
        self._server = await asyncio.start_server(self._accept, host, port)
        if port == 0:     # ephemeral: learn the real port
            sock = self._server.sockets[0]
            self.addr = (host, sock.getsockname()[1])

    def shutdown(self) -> None:
        if self._loop is None:
            return

        def _stop():
            for conn in list(self.conns.values()):
                conn._close()
            if self._server is not None:
                self._server.close()
            self._loop.stop()

        try:
            self._loop.call_soon_threadsafe(_stop)
        except RuntimeError:
            return
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None

    # -- loop helpers ------------------------------------------------------

    def _loop_call(self, fn: Callable, *args) -> None:
        if self._loop is None:
            raise RuntimeError(f"messenger {self.name} not started")
        if threading.current_thread() is not self._thread:
            self.perf.inc("event_wakeups")    # cross-thread loop handoff
        self._loop.call_soon_threadsafe(fn, *args)

    def call_later(self, delay: float, fn: Callable, *args):
        """Cancelable timer on the messenger loop — the async stack has
        the same surface, so components (e.g. the monc subscription
        renewer) can run periodic work without a thread of their own."""
        state = {"cancelled": False, "timer": None}

        def _arm():
            if not state["cancelled"]:
                state["timer"] = self._loop.call_later(delay, _fire)

        def _fire():
            if not state["cancelled"]:
                fn(*args)

        class _Handle:
            def cancel(self_h):
                state["cancelled"] = True
                t = state["timer"]
                if t is not None:
                    try:
                        self._loop.call_soon_threadsafe(t.cancel)
                    except RuntimeError:
                        pass
        self._loop_call(_arm)
        return _Handle()

    def event_stats(self) -> dict:
        """The msgr_event perf-dump block (worker model overview)."""
        return {"type": "blocking", "workers": 1,
                "connections": len(self.conns), "per_worker": []}

    # -- outgoing ----------------------------------------------------------

    def get_connection(self, peer_name: str,
                       peer_addr: EntityAddr) -> Connection:
        """Find or create the (single) connection to a peer."""
        conn = self.conns.get(peer_name)
        if conn is not None and not conn._closed:
            if conn.peer_addr == peer_addr:
                return conn
            # the peer rebooted at a new address (daemons bind
            # ephemeral ports): the old lossless session would
            # reconnect-loop against a dead socket and strand its
            # queue — drop it and dial the new incarnation
            conn.mark_down()
        policy = self.policy_for(peer_name)
        conn = Connection(self, peer_name, peer_addr, policy)
        self.conns[peer_name] = conn
        self._conns_by_addr[peer_addr] = conn
        self._loop_call(self._start_conn, conn)
        return conn

    def send_message(self, msg: Message, peer_name: str,
                     peer_addr: EntityAddr) -> None:
        if peer_addr == self.addr and peer_name == self.name:
            # loopback fast dispatch: no sockets, no serialization
            msg.src = self.name
            self._loop_call(self._fast_dispatch_local, msg)
            return
        self.get_connection(peer_name, peer_addr).send_message(msg)

    def _fast_dispatch_local(self, msg: Message) -> None:
        conn = self.conns.get(self.name)
        if conn is None:
            conn = Connection(self, self.name, self.addr,
                              Policy.lossless_peer())
            self.conns[self.name] = conn
        self._deliver(conn, msg)

    def _start_conn(self, conn: Connection) -> None:
        if conn._task is None or conn._task.done():
            conn._task = self._loop.create_task(self._conn_writer(conn))

    # -- connection coroutines ---------------------------------------------

    async def _conn_writer(self, conn: Connection) -> None:
        backoff = float(self.conf.ms_initial_backoff)
        while not conn._closed:
            if faults.get().partitioned(self.name, conn.peer_name):
                # installed partition: the peer is unreachable.  Lossy
                # links reset (the peer re-establishes after heal);
                # lossless links poll at the INITIAL backoff without
                # growing it, so heal latency stays deterministic
                # instead of riding wherever the exponential curve got
                if conn.policy.lossy:
                    self._conn_reset(conn)
                    return
                await asyncio.sleep(float(self.conf.ms_initial_backoff))
                continue
            try:
                reader, writer = await asyncio.open_connection(
                    *conn.peer_addr)
            except OSError:
                if conn.policy.lossy:
                    self._conn_reset(conn)
                    return
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2,
                              float(self.conf.ms_max_backoff))
                continue
            # banner: our incarnation nonce + who we are + where replies
            # reach us; the acceptor answers with its in_seq for THIS
            # incarnation so we resend only what it actually missed
            name_b = self.name.encode()
            addr_b = _pack_addr(self.addr)
            writer.write(_BANNER.pack(BANNER_MAGIC, conn.nonce,
                                      len(name_b), len(addr_b))
                         + name_b + addr_b)
            try:
                # auth runs BEFORE the acceptor reveals any session
                # state (its banner reply carries in_seq)
                skey = None
                if self.auth_mode == "cephx":
                    skey = await asyncio.wait_for(
                        self._auth_connect(conn.peer_name, reader,
                                           writer),
                        timeout=float(self.conf.ms_connect_timeout))
                # bounded: a peer whose backlog accepted the TCP
                # connection but whose event loop is wedged must not
                # pin this coroutine forever
                rep = await asyncio.wait_for(
                    reader.readexactly(_BANNER_REPLY.size),
                    timeout=float(self.conf.ms_connect_timeout))
                magic, peer_in_seq = _BANNER_REPLY.unpack(rep)
                if magic != BANNER_MAGIC:
                    raise ConnectionResetError("bad banner reply")
            except (AuthError, asyncio.IncompleteReadError,
                    asyncio.TimeoutError, ConnectionError, OSError):
                writer.close()
                if conn.policy.lossy:
                    self._conn_reset(conn)
                    return
                # a wedged peer that accepts but never answers must not
                # be hammered: same exponential backoff as conn refusal
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2,
                              float(self.conf.ms_max_backoff))
                continue
            backoff = float(self.conf.ms_initial_backoff)
            conn._writer = writer
            conn._requeue_sent(peer_in_seq)
            # race reader (notices peer death via EOF) against writer:
            # either side failing tears the socket down and, for
            # lossless links, triggers reconnect + resend of unacked
            reader_t = self._loop.create_task(
                self._read_frames(conn, reader, writer, skey))
            drain_t = self._loop.create_task(
                self._drain_queue(conn, writer, skey))
            done, pending = await asyncio.wait(
                {reader_t, drain_t}, return_when=asyncio.FIRST_COMPLETED)
            for t in pending:
                t.cancel()
            try:
                writer.close()
            except Exception:
                pass
            conn._writer = None
            unexpected = False
            for t in done:
                exc = t.exception()
                if exc is not None and not isinstance(
                        exc, (ConnectionError, OSError)):
                    # never let the writer task die on an unexpected
                    # error: the conn would strand its queue until the
                    # next send restarts it — log and reconnect
                    self.log.error("conn loop to %s error: %r",
                                   conn.peer_name, exc)
                    unexpected = True
            if conn._closed:
                return
            if unexpected:
                # a deterministic error would otherwise spin a tight
                # reconnect/handshake storm (backoff was reset after
                # the successful banner)
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2,
                              float(self.conf.ms_max_backoff))
            if conn.policy.lossy:
                self._conn_reset(conn)
                return
            self.perf.inc("reconnects")
            conn._send_event.set()
            continue   # lossless: reconnect, resend unacked

    async def _drain_queue(self, conn: Connection,
                           writer: asyncio.StreamWriter,
                           skey: bytes | None = None) -> None:
        while not conn._closed:
            while conn._queue:
                seq, frame = conn._queue[0]
                fs = faults.get()
                if fs.partitioned(self.name, conn.peer_name):
                    # partition landed mid-connection: tear the socket
                    # down; the reconnect loop blocks until heal
                    writer.close()
                    raise ConnectionResetError("partitioned")
                if fs.should_kill_socket(
                        self.name, conn.peer_name,
                        int(self.conf.ms_inject_socket_failures)):
                    self.log.debug("injecting socket failure to %s",
                                   conn.peer_name)
                    writer.close()
                    raise ConnectionResetError("injected")
                d = fs.send_delay(self.name, conn.peer_name)
                if d > 0:
                    await asyncio.sleep(d)
                if fs.should_drop(self.name, conn.peer_name):
                    # modeled message loss: the frame is never written.
                    # Lossless links keep it in _sent so the NEXT
                    # reconnect resends it (unless the peer's in_seq
                    # moved past it); higher layers' retries own
                    # end-to-end recovery, as with real packet loss.
                    conn._queue.pop(0)
                    if not conn.policy.lossy:
                        conn._sent.append((seq, frame))
                    continue
                # sign at write time, store UNSIGNED: a resent frame
                # must be re-signed with the new socket's session key.
                # The frame is an iovec — header, seg table, payload,
                # data segments — gather-written as-is; the signature
                # folds the buffers without joining them.
                if skey is None:
                    writer.writelines(frame)
                else:
                    writer.writelines(
                        frame + [cephx.sign_iov(skey, [b"C", *frame])])
                await writer.drain()
                conn._queue.pop(0)
                if not conn.policy.lossy:
                    # lossless: keep until the peer acks the seq
                    conn._sent.append((seq, frame))
                conn.last_active = time.time()
            conn._send_event.clear()
            await conn._send_event.wait()

    def _conn_reset(self, conn: Connection) -> None:
        conn._closed = True
        if conn._counted:
            conn._counted = False
            self.perf.dec("open_connections")
        self.conns.pop(conn.peer_name, None)
        if conn.peer_addr is not None:
            self._conns_by_addr.pop(conn.peer_addr, None)
        for d in self.dispatchers:
            try:
                d.ms_handle_reset(conn)
            except Exception:
                self.log.error("dispatcher reset handler failed")

    # -- incoming ----------------------------------------------------------

    async def _accept(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            hdr = await reader.readexactly(_BANNER.size)
            magic, nonce, nlen, alen = _BANNER.unpack(hdr)
            if magic != BANNER_MAGIC:
                writer.close()
                return
            peer_name = (await reader.readexactly(nlen)).decode()
            peer_addr = _unpack_addr(await reader.readexactly(alen))
        except (asyncio.IncompleteReadError, ConnectionError, OSError,
                ValueError, UnicodeDecodeError):
            writer.close()
            return
        # authenticate BEFORE registering the connection or mutating
        # any session state — an unauthenticated banner must not be
        # able to reset a live peer's in_seq/address or learn in_seq
        skey = None
        if self.auth_mode == "cephx":
            try:
                skey = await asyncio.wait_for(
                    self._auth_accept(peer_name, reader, writer),
                    timeout=float(self.conf.ms_connect_timeout))
            except (AuthError, asyncio.IncompleteReadError,
                    asyncio.TimeoutError, ConnectionError, OSError) as e:
                self.perf.inc("auth_failures")
                self.log.warn("rejecting %s: auth failed (%s)",
                              peer_name, e)
                writer.close()
                return
        if faults.get().partitioned(peer_name, self.name):
            # one-way partitions block the peer->us direction here;
            # our own sends to the peer are gated on the connect side
            writer.close()
            return
        conn = self.conns.get(peer_name)
        if conn is None or conn._closed:
            conn = Connection(self, peer_name, peer_addr,
                              self.policy_for(peer_name))
            self.conns[peer_name] = conn
        if conn.peer_nonce != nonce:
            # new peer incarnation (restarted daemon): its seq space
            # restarts at 0, so a stale in_seq reply would make it drop
            # its first frames; and its reply address may have moved
            conn.peer_nonce = nonce
            conn.in_seq = 0
            conn.peer_addr = peer_addr
        try:
            writer.write(_BANNER_REPLY.pack(BANNER_MAGIC, conn.in_seq))
        except (ConnectionError, OSError):
            writer.close()
            return
        self.perf.inc("accepts")
        try:
            await self._read_frames(conn, reader, writer, skey,
                                    accepted=True)
        except Exception as e:
            # an unexpected error must not ABANDON the socket: leaving
            # it open-but-unread lets the peer write into a black hole
            # forever (its frames sit unacked while it sees a healthy
            # connection) — close it so the peer reconnects + resends
            self.log.error("accept loop for %s died: %r",
                           conn.peer_name, e)
        finally:
            try:
                writer.close()
            except Exception:
                pass

    ACK_TYPE = 1

    def _ack_frame(self, seq: int) -> bytes:
        from .message import _HDR, MAGIC
        return _HDR.pack(MAGIC, self.ACK_TYPE, 0, seq)

    async def _read_frames(self, conn: Connection,
                           reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter | None,
                           skey: bytes | None = None,
                           accepted: bool = False) -> None:
        # Signatures are DIRECTION-BOUND: the connector signs under
        # "C", the acceptor under "S" — without the label a MITM could
        # reflect a side's own signed frame back at it and it would
        # verify (same session key both ways).
        recv_label = b"C" if accepted else b"S"
        send_label = b"S" if accepted else b"C"
        hdr_size = Message.header_size()
        try:
            while not conn._closed:
                hdr = await reader.readexactly(hdr_size)
                type_id, plen, seq, has_segs = \
                    Message.parse_header_any(hdr)
                body = await reader.readexactly(plen)
                segments: list[bytes] = []
                if has_segs:
                    # CTM2: the body is <seg table><denc payload>; the
                    # data segments follow and scatter-read one by one
                    # (never joined with the payload)
                    seg_lens, payload = Message.parse_seg_table(body)
                    for n in seg_lens:
                        segments.append(await reader.readexactly(n))
                else:
                    payload = body
                nbytes = hdr_size + plen + sum(len(s) for s in segments)
                self.perf.inc("bytes_recv", nbytes)
                if skey is not None:
                    sig = await reader.readexactly(cephx.SIG_LEN)
                    if not cephx.check_iov(
                            skey, [recv_label, hdr, body, *segments],
                            sig):
                        self.log.warn("bad frame signature from %s, "
                                      "dropping connection",
                                      conn.peer_name)
                        raise ConnectionResetError("bad signature")
                fs = faults.get()
                if fs.partitioned(conn.peer_name, self.name):
                    # a partition installed mid-connection must stop
                    # delivery too — and BEFORE the ack/in_seq
                    # bookkeeping, so the frame is not acknowledged as
                    # delivered and a lossless peer resends it after
                    # the heal
                    raise ConnectionResetError("partitioned")
                if type_id == self.ACK_TYPE:
                    conn._handle_ack(seq)
                    continue
                if writer is not None:
                    try:
                        ack = self._ack_frame(seq)
                        if skey is not None:
                            ack = ack + cephx.sign(skey,
                                                   send_label + ack)
                        writer.write(ack)
                    except (ConnectionError, OSError):
                        pass
                if seq <= conn.in_seq:
                    continue            # dup after reconnect
                conn.in_seq = seq
                try:
                    msg = Message.decode(type_id, seq, payload, segments)
                except ValueError:
                    # corrupt/hostile frame: data-only decode failed;
                    # skip it (resend would fail identically) but keep
                    # the link and subsequent frames alive
                    self.log.error(
                        "undecodable frame type=%d seq=%d from %s",
                        type_id, seq, conn.peer_name)
                    continue
                d = fs.recv_delay(
                    conn.peer_name, self.name,
                    float(self.conf.ms_inject_delay_probability),
                    float(self.conf.ms_inject_delay_max))
                if d > 0:
                    await asyncio.sleep(d)
                self._deliver(conn, msg)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass

    def _deliver(self, conn: Connection, msg: Message) -> None:
        self.perf.inc("msg_recv")
        for d in self.dispatchers:
            try:
                if d.ms_dispatch(conn, msg):
                    return
            except Exception as e:
                from ..utils.faults import CrashPoint
                if isinstance(e, CrashPoint):
                    # a fired crash point unwinds through dispatch by
                    # design: the daemon is aborting, the op dies
                    # silently (never acked, never nacked)
                    return
                import traceback
                traceback.print_exc()
                self.log.error("dispatch of %r failed", msg)
                return
        self.log.warn("unhandled message %r from %s", msg, conn.peer_name)


def create_messenger(name: str, conf=None) -> Messenger:
    """Messenger::create analog: ms_type selects the serving stack.

    `blocking` is the original one-loop-thread-per-messenger stack;
    `async` multiplexes every connection in the process onto the shared
    `ms_async_op_threads` epoll worker pool (msg/async_messenger.py).
    Both speak the identical wire protocol."""
    from ..utils.config import Config
    conf = conf or Config()
    ms_type = str(getattr(conf, "ms_type", "blocking") or "blocking")
    if ms_type == "async":
        from .async_messenger import AsyncMessenger
        return AsyncMessenger(name, conf)
    if ms_type != "blocking":
        raise ValueError(f"unknown ms_type {ms_type!r}")
    return Messenger(name, conf)
