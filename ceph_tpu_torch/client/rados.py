"""librados-style public API: Rados (cluster handle) + IoCtx (per pool).

Mirrors the reference's librados surface (librados/librados.cc /
pybind rados.pyx): connect, pool ops, synchronous object I/O with the
same call names (write, write_full, append, read, stat, remove,
get/set_xattr, omap).  Errors raise RadosError with the errno.
"""

from __future__ import annotations

import itertools
import threading

from ..mon.client import MonClient
from ..mon.monmap import MonMap
from ..msg import create_messenger
from ..utils.bufferlist import wrap_payload
from ..utils.config import Config
from .objecter import Objecter, ObjecterError


class RadosError(Exception):
    def __init__(self, errno_: int, msg: str = ""):
        super().__init__(msg or f"errno {errno_}")
        self.errno = errno_


class Completion:
    """aio completion handle (librados::AioCompletion)."""

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._exc: Exception | None = None
        self._callback = None
        self._cb_fired = False
        self._lock = threading.Lock()

    def set_callback(self, fn) -> "Completion":
        # lock against _finish: without it the callback can fire from
        # both paths (finish sees it set, then we see the event set)
        with self._lock:
            self._callback = fn
            fire = self._event.is_set() and not self._cb_fired
            if fire:
                self._cb_fired = True
        if fire:
            fn(self)
        return self

    def _finish(self, result=None, exc: Exception | None = None) -> None:
        self._result = result
        self._exc = exc
        with self._lock:
            self._event.set()
            cb = self._callback if not self._cb_fired else None
            if cb is not None:
                self._cb_fired = True
        if cb is not None:
            try:
                cb(self)
            except Exception:
                pass

    def is_complete(self) -> bool:
        return self._event.is_set()

    def wait_for_complete(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)

    def result(self):
        """The op's return value; raises the op's error."""
        self._event.wait()
        if self._exc is not None:
            raise self._exc
        return self._result


class Rados:
    def __init__(self, monmap: MonMap, name: str = "client.admin",
                 conf: Config | None = None):
        self.conf = conf or Config()
        from ..utils.dout import DoutLogger
        self.log = DoutLogger("rados", name)
        self.msgr = create_messenger(name, conf=self.conf)
        self.msgr.bind(("127.0.0.1", 0))
        self.monc: MonClient | None = None
        self.objecter: Objecter | None = None
        self.monmap = monmap
        self._connected = False
        # watch callbacks: (oid, cookie) -> fn(notify_id, payload)->bytes
        self.watches: dict[tuple, object] = {}
        # (oid, cookie) -> pool_id: enough to re-assert registrations
        # after map changes (primaries hold watches in memory only)
        self._watch_pools: dict[tuple, int] = {}
        # aio executor: thread-backed async (the reference's aio is
        # event-driven inside the Objecter; here the sync state machine
        # — with its EAGAIN/resend handling — runs on worker threads,
        # which keeps identical retry semantics for async callers)
        from concurrent.futures import ThreadPoolExecutor
        self._aio_pool = ThreadPoolExecutor(
            max_workers=16, thread_name_prefix=f"aio-{name}")

    def aio_submit(self, fn, *args, **kwargs) -> Completion:
        comp = Completion()

        def run():
            try:
                comp._finish(result=fn(*args, **kwargs))
            except Exception as e:
                comp._finish(exc=e)

        self._aio_pool.submit(run)
        return comp

    def _rewatch_on_map(self, osdmap) -> None:
        """Watches are primary-memory state: a new primary (or a
        restarted one) has never heard of ours, so re-register on every
        map change — the linger-op model, off the delivery thread."""
        if not self._watch_pools:
            return

        def rewatch(attempt: int = 0):
            failed = False
            for (oid, cookie), pool_id in list(self._watch_pools.items()):
                try:
                    self.objecter.op_submit(
                        pool_id, oid, [("watch", cookie)], timeout=10.0)
                except Exception as e:
                    # keep trying THIS one but continue with the rest:
                    # one stuck watch must not starve the others, and a
                    # silent drop loses every future notify
                    failed = True
                    self.log.warn("rewatch %s/%s failed: %s%s",
                                  pool_id, oid, e,
                                  " (will retry)" if attempt < 3 else "")
            if failed and attempt < 3:
                t = threading.Timer(5.0, rewatch,
                                    kwargs={"attempt": attempt + 1})
                t.daemon = True
                t.start()

        threading.Thread(target=rewatch, daemon=True,
                         name="rewatch").start()

    def ms_dispatch(self, conn, msg) -> bool:
        from ..osd.messages import MWatchNotify
        if isinstance(msg, MWatchNotify):
            # callbacks run OFF the messenger delivery loop: a callback
            # that issues rados ops (the cls_lock renew pattern) would
            # otherwise deadlock the thread that delivers its replies
            threading.Thread(
                target=self._run_watch_cb,
                args=(conn.peer_name, conn.peer_addr, msg),
                daemon=True, name="watch-cb").start()
            return True
        return False

    def _run_watch_cb(self, peer_name, peer_addr, msg) -> None:
        from ..osd.messages import MWatchNotifyAck
        cb = self.watches.get((msg.oid, int(msg.cookie)))
        reply = b""
        if cb is not None:
            try:
                reply = cb(msg.notify_id, msg.payload) or b""
            except Exception:
                pass
        self.msgr.send_message(
            MWatchNotifyAck(oid=msg.oid, pgid=msg.pgid,
                            notify_id=msg.notify_id,
                            cookie=msg.cookie, reply=reply),
            peer_name, peer_addr)

    def ms_handle_reset(self, conn) -> None:
        pass

    def connect(self, timeout: float = 30.0) -> None:
        self.msgr.start()
        self.msgr.add_dispatcher_tail(self)
        self.monc = MonClient(self.msgr, self.monmap)
        self.objecter = Objecter(self.msgr, self.monc)
        if self.msgr.auth_mode == "cephx":
            # TGS flow: fetch + renew service tickets for the daemons
            # we dial (CephxClientHandler); the mon channel itself
            # stays on the static keyring secret
            self.monc.enable_service_auth(
                [self.msgr], own_service=None,
                ticket_services=["osd", "mds"])
        self.objecter.on_map_hooks.append(self._rewatch_on_map)
        self.monc.sub_want_osdmap(0)
        self.monc.subscribe({"monmap": 0})   # learn membership changes
        deadline = threading.Event()
        import time
        end = time.time() + timeout
        while time.time() < end and self.monc.osdmap.epoch == 0:
            time.sleep(0.05)
        if self.monc.osdmap.epoch == 0:
            raise RadosError(110, "could not fetch osdmap from monitors")
        self._connected = True

    def shutdown(self) -> None:
        # cancel queued aio: running it against the shut-down messenger
        # would stall atexit's executor join for a full op timeout
        self._aio_pool.shutdown(wait=False, cancel_futures=True)
        if self.monc is not None:
            self.monc.shutdown()
        self.msgr.shutdown()
        self._connected = False

    # -- cluster admin -----------------------------------------------------

    def mon_command(self, cmd: dict, timeout: float = 30.0):
        rv, out, data = self.monc.command(cmd, timeout=timeout)
        return rv, out, data

    def create_pool(self, name: str, pg_num: int = 8, **kw) -> None:
        cmd = {"prefix": "osd pool create", "pool": name,
               "pg_num": pg_num, **kw}
        rv, out, _ = self.mon_command(cmd)
        if rv != 0:
            raise RadosError(-rv if rv < 0 else rv, out)
        self._wait_for_pool(name)

    def create_ec_pool(self, name: str, profile_name: str,
                       profile: dict | None = None, pg_num: int = 8) -> None:
        if profile:
            toks = [f"{k}={v}" for k, v in profile.items()]
            rv, out, _ = self.mon_command({
                "prefix": "osd erasure-code-profile set",
                "name": profile_name, "profile": toks})
            if rv != 0:
                raise RadosError(abs(rv), out)
        rv, out, _ = self.mon_command({
            "prefix": "osd pool create", "pool": name, "pg_num": pg_num,
            "pool_type": "erasure", "erasure_code_profile": profile_name})
        if rv != 0:
            raise RadosError(abs(rv), out)
        self._wait_for_pool(name)

    def _wait_for_pool(self, name: str, timeout: float = 10.0) -> None:
        import time
        end = time.time() + timeout
        while time.time() < end:
            if self.monc.osdmap.pool_by_name(name):
                return
            self.monc.sub_want_osdmap(self.monc.osdmap.epoch + 1)
            time.sleep(0.1)
        raise RadosError(110, f"pool {name} did not appear")

    def delete_pool(self, name: str) -> None:
        rv, out, _ = self.mon_command({"prefix": "osd pool rm",
                                       "pool": name})
        if rv != 0:
            raise RadosError(abs(rv), out)

    def list_pools(self) -> list[str]:
        rv, out, _ = self.mon_command({"prefix": "osd pool ls"})
        return out.split("\n") if out else []

    def open_ioctx(self, pool_name: str) -> "IoCtx":
        pool = self.monc.osdmap.pool_by_name(pool_name)
        if pool is None:
            raise RadosError(2, f"no such pool {pool_name}")
        return IoCtx(self, pool.id, pool_name)

    def status(self) -> str:
        rv, out, _ = self.mon_command({"prefix": "status"})
        return out


class IoCtx:
    def __init__(self, rados: Rados, pool_id: int, pool_name: str):
        self.rados = rados
        self.pool_id = pool_id
        self.pool_name = pool_name
        # self-managed snap context (librados set_snap_context model):
        # writes carry it; the OSD clones the head when it has snaps
        # newer than the object's SnapSet
        self.snap_seq = 0
        self.snaps: list[int] = []

    def _op(self, oid: str, ops: list, timeout: float | None = None,
            snapid=None):
        # timeout None -> the objecter's objecter_op_timeout default
        snapc = (self.snap_seq, list(self.snaps)) if self.snap_seq \
            else None
        try:
            reply = self.rados.objecter.op_submit(self.pool_id, oid, ops,
                                                  timeout, snapc=snapc,
                                                  snapid=snapid)
        except ObjecterError as e:
            raise RadosError(e.errno, str(e)) from e
        if reply.result < 0:
            raise RadosError(-reply.result,
                             f"op on {oid}: errno {-reply.result}")
        return reply

    # -- self-managed snapshots --------------------------------------------

    def set_snap_context(self, seq: int, snaps: list[int]) -> None:
        self.snap_seq = int(seq)
        self.snaps = sorted(int(s) for s in snaps)[::-1]

    def create_selfmanaged_snap(self) -> int:
        """Allocate a snap id AND fold it into the local context."""
        ret, out, data = self.rados.mon_command(
            {"prefix": "osd pool selfmanaged-snap create",
             "pool": self.pool_name})
        if ret != 0:
            raise RadosError(-ret or 5, out)
        snapid = int(out)
        self.set_snap_context(snapid, [snapid] + self.snaps)
        return snapid

    def remove_selfmanaged_snap(self, snapid: int) -> None:
        ret, out, _ = self.rados.mon_command(
            {"prefix": "osd pool selfmanaged-snap rm",
             "pool": self.pool_name, "snapid": int(snapid)})
        if ret != 0:
            raise RadosError(-ret or 5, out)
        self.snaps = [s for s in self.snaps if s != int(snapid)]

    def snap_read(self, oid: str, snapid: int, length: int = 0,
                  offset: int = 0) -> bytes:
        reply = self._op(oid, [("read", offset, length)], snapid=snapid)
        return reply.outdata[0]

    def snap_rollback(self, oid: str, snapid: int) -> None:
        self._op(oid, [("rollback", int(snapid))])

    # -- aio (librados aio_* surface, thread-backed) -----------------------

    def aio_write(self, oid: str, data: bytes, offset: int = 0):
        return self.rados.aio_submit(self.write, oid, data, offset)

    def aio_write_full(self, oid: str, data: bytes):
        return self.rados.aio_submit(self.write_full, oid, data)

    def aio_append(self, oid: str, data: bytes):
        return self.rados.aio_submit(self.append, oid, data)

    def aio_read(self, oid: str, length: int = 0, offset: int = 0):
        return self.rados.aio_submit(self.read, oid, length, offset)

    def aio_remove(self, oid: str):
        return self.rados.aio_submit(self.remove_object, oid)

    def aio_stat(self, oid: str):
        return self.rados.aio_submit(self.stat, oid)

    def aio_execute(self, oid: str, cls: str, method: str,
                    data: bytes = b""):
        return self.rados.aio_submit(self.execute, oid, cls, method,
                                     data)

    # -- striping (libradosstriper surface) --------------------------------

    def striped(self, soid: str, layout=None):
        from .striper import StripedObject
        return StripedObject(self, soid, layout)

    # -- object classes (in-OSD RPC) ---------------------------------------

    def execute(self, oid: str, cls: str, method: str,
                data: bytes = b"") -> bytes | None:
        """Run a registered class method on the object (rados exec)."""
        reply = self._op(oid, [("call", cls, method, bytes(data))])
        return reply.outdata[0] if reply.outdata else None

    # -- watch / notify ----------------------------------------------------

    _cookie_seq = itertools.count(1)    # next() is atomic in CPython

    def watch(self, oid: str, callback) -> int:
        """callback(notify_id, payload) -> optional reply bytes.
        Returns the watch cookie (handle for unwatch)."""
        cookie = next(IoCtx._cookie_seq)
        self.rados.watches[(oid, cookie)] = callback
        self.rados._watch_pools[(oid, cookie)] = self.pool_id
        try:
            self._op(oid, [("watch", cookie)])
        except RadosError:
            self.rados.watches.pop((oid, cookie), None)
            self.rados._watch_pools.pop((oid, cookie), None)
            raise
        return cookie

    def unwatch(self, oid: str, cookie: int) -> None:
        self.rados.watches.pop((oid, cookie), None)
        self.rados._watch_pools.pop((oid, cookie), None)
        self._op(oid, [("unwatch", cookie)])

    def notify(self, oid: str, payload: bytes = b"",
               timeout: float = 5.0) -> dict:
        """Returns {watcher: reply_bytes} gathered from all watchers."""
        reply = self._op(oid, [("notify", bytes(payload), timeout)],
                         timeout=timeout + 10.0)
        return reply.outdata[0] if reply.outdata else {}

    # -- writes ------------------------------------------------------------
    #
    # Payloads ride ZERO-COPY: bytes/memoryview/BufferList pass through
    # untouched all the way to the messenger's gather write (the
    # objecter snapshots only mutable bytearrays).  Build large
    # payloads as a utils.bufferlist.BufferList rope to concatenate
    # and slice without materializing.

    def write(self, oid: str, data, offset: int = 0) -> None:
        self._op(oid, [("write", offset, wrap_payload(data))])

    def write_full(self, oid: str, data) -> None:
        self._op(oid, [("writefull", wrap_payload(data))])

    def append(self, oid: str, data) -> None:
        self._op(oid, [("append", wrap_payload(data))])

    def remove_object(self, oid: str) -> None:
        self._op(oid, [("delete",)])

    def truncate(self, oid: str, size: int) -> None:
        self._op(oid, [("truncate", size)])

    def set_xattr(self, oid: str, name: str, value: bytes) -> None:
        self._op(oid, [("setxattr", name, bytes(value))])

    def set_omap(self, oid: str, kv: dict) -> None:
        self._op(oid, [("omap_set", {k: bytes(v) for k, v in kv.items()})])

    def rm_omap_keys(self, oid: str, keys: list[str]) -> None:
        self._op(oid, [("omap_rm", list(keys))])

    # -- reads -------------------------------------------------------------

    def read(self, oid: str, length: int = 0, offset: int = 0) -> bytes:
        reply = self._op(oid, [("read", offset, length)])
        return reply.outdata[0]

    def stat(self, oid: str) -> dict:
        reply = self._op(oid, [("stat",)])
        return reply.outdata[0]

    def get_xattr(self, oid: str, name: str) -> bytes:
        reply = self._op(oid, [("getxattr", name)])
        return reply.outdata[0]

    def get_omap(self, oid: str) -> dict:
        reply = self._op(oid, [("omap_get",)])
        return reply.outdata[0]

    def get_omap_keys(self, oid: str, keys: list[str]) -> dict:
        """Only the named keys (omap_get_vals_by_keys): O(requested),
        not O(omap)."""
        reply = self._op(oid, [("omap_get_keys", list(keys))])
        return reply.outdata[0]

    def get_omap_vals(self, oid: str, start_after: str = "",
                      prefix: str = "", max_return: int = 0) -> dict:
        """Ordered omap slice (omap_get_vals): keys strictly after
        start_after, prefix-filtered, bounded — the pagination
        primitive bucket listings ride."""
        reply = self._op(oid, [("omap_get_vals", start_after, prefix,
                                int(max_return))])
        return reply.outdata[0]

    def list_objects(self) -> list[str]:
        """Scan every pg of the pool (pool listing = union of pg scans)."""
        from ..osd.osdmap import PgId
        seen = set()
        m = self.rados.monc.osdmap
        pool = m.pools[self.pool_id]
        for seed in range(pool.pg_num):
            pgid = PgId(self.pool_id, seed)
            try:
                reply = self.rados.objecter.op_submit(
                    self.pool_id, "", [("list",)], pgid=pgid)
            except ObjecterError:
                continue
            if reply.result == 0:
                seen.update(reply.outdata[0])
        return sorted(seen)
