"""CephFS client: POSIX-ish file API over MDS metadata + striped data
(client/Client.{h,cc} + libcephfs.cc reduced).

Metadata ops go to the active MDS (discovered from the osdmap, where
the FSMap is folded in); file DATA goes straight to the data pool,
striped by inode number — the same client/MDS split as the reference
(Client::make_request for metadata, Objecter/Filer for data).
"""

from __future__ import annotations

import itertools
import threading
import time

from ..client.rados import RadosError
from ..client.striper import Layout, file_to_extents
from ..msg import Dispatcher
from .messages import (MClientCaps, MClientCapsAck, MClientReply,
                       MClientRequest)


class FsError(RadosError):
    pass


def data_oid(ino: int, object_no: int) -> str:
    return f"{ino:x}.{object_no:08x}"


SUBTREES_OID = "mds_subtrees"


def subtree_rank(table: dict, norm: str) -> int:
    """Longest-prefix authority lookup — the ONE definition shared by
    client routing and MDS authority checks (divergence here would
    make them disagree on who owns a path)."""
    best, bestlen = 0, -1
    for p, r in table.items():
        if (p == "/" or norm == p
                or norm.startswith(p + "/")) and len(p) > bestlen:
            best, bestlen = r, len(p)
    return best


MUTATES_PARENT = frozenset(
    {"mkdir", "create", "unlink", "rmdir", "setattr", "rename"})


def route_path(op: str, norm: str) -> str:
    """The path whose subtree authority serves this op: ops that
    mutate the parent directory's omap route by the parent; snapshot
    ops route by the snapped dir.  Shared by client and MDS so both
    sides always agree."""
    parts = [p for p in norm.strip("/").split("/") if p]
    if ".snap" in parts:
        i = parts.index(".snap")
        return "/" + "/".join(parts[:i]) if i else "/"
    if op in MUTATES_PARENT:
        return norm.rsplit("/", 1)[0] or "/"
    return norm


def load_subtree_table(io) -> dict | None:
    """Read the authoritative subtree table from the metadata pool;
    None when unreadable (caller keeps its cache)."""
    from ..utils import denc
    try:
        raw = io.get_omap(SUBTREES_OID)
    except Exception:
        return None
    return {p: denc.loads(v) for p, v in raw.items()} if raw else None


class CephFS(Dispatcher):
    """Mounted filesystem handle (libcephfs ceph_mount analog)."""

    _tid_seq = itertools.count(1)     # shared across mounts
    # messenger id -> weakrefs of live mounts on it: a caps revoke
    # must reach EVERY sibling mount sharing the messenger, not just
    # whichever dispatcher sits first (see ms_dispatch).  Weakrefs:
    # a mount dropped without unmount() must not leak forever
    _mounts: dict[int, list] = {}

    def __init__(self, rados, data_pool: str = "cephfs_data",
                 metadata_pool: str = "cephfs_metadata"):
        self.rados = rados
        self.data_pool_name = data_pool
        self.metadata_pool_name = metadata_pool
        self.data = None
        # subtree-root path -> auth rank (multi-rank routing table,
        # cached from the SUBTREES_OID omap; refreshed on ESTALE)
        self._subtrees: dict[str, int] = {"/": 0}
        # tids are PROCESS-global: several CephFS mounts can share one
        # rados handle (one messenger), and per-instance counters
        # starting at 1 would collide — the wrong mount would claim
        # the reply
        self._tid = CephFS._tid_seq
        self._pending: dict[int, dict] = {}
        self._lock = threading.Lock()
        self.mounted = False
        # capability-backed caches (client/Client.h:251 inode/dentry
        # cache model): entries exist exactly while we hold the cap —
        # an MDS revoke drops them
        self._attr_cache: dict[str, dict] = {}
        self._dir_cache: dict[str, dict] = {}
        self._write_caps: set[str] = set()
        self._dirty_size: dict[str, int] = {}   # buffered attr state
        self.rpcs = 0        # MDS round trips (cache-hit observability)
        rados.msgr.add_dispatcher_tail(self)
        import weakref
        CephFS._mounts.setdefault(id(rados.msgr), []).append(
            weakref.ref(self))

    # -- mds rpc -----------------------------------------------------------

    def _subtree_rank(self, path: str) -> int:
        return subtree_rank(self._subtrees, self._norm(path))

    def _refresh_subtrees(self) -> None:
        try:
            io = self.rados.open_ioctx(self.metadata_pool_name)
        except Exception:
            return
        table = load_subtree_table(io)
        if table:
            self._subtrees = table

    def _mds_addr(self, path: str = "/"):
        m = self.rados.monc.osdmap
        ranks = getattr(m, "mds_ranks", None) or {}
        ent = ranks.get(self._subtree_rank(path))
        if ent is not None:
            return f"mds.{ent[0]}", tuple(ent[1])
        if not getattr(m, "mds_addr", None):
            raise FsError(107, "no active mds")     # ENOTCONN
        return f"mds.{m.mds_name}", tuple(m.mds_addr)

    def ms_dispatch(self, conn, msg) -> bool:
        if isinstance(msg, MClientReply):
            with self._lock:
                slot = self._pending.get(msg.tid)
                if slot is not None:
                    slot["reply"] = msg
                    slot["event"].set()
            # not ours -> let a sibling mount on this messenger see it
            return slot is not None
        if isinstance(msg, MClientCaps):
            # fan out to EVERY sibling mount on this messenger (they
            # all cache under the same client entity) and answer with
            # ONE ack carrying the merged buffered-size flushes
            flushes: dict[str, int] = {}
            refs = CephFS._mounts.get(id(self.rados.msgr), [])
            mounts = [m for r in refs if (m := r()) is not None]
            refs[:] = [r for r in refs if r() is not None]
            for mount in (mounts or [self]):
                flushes.update(mount._collect_revoke(msg))
            self.rados.msgr.send_message(
                MClientCapsAck(ack_id=msg.ack_id, flushes=flushes),
                conn.peer_name, conn.peer_addr)
            return True
        return False

    def _collect_revoke(self, msg) -> dict[str, int]:
        """MDS pulled our caps: drop the caches beneath each path and
        surface buffered sizes for the ack (the MDS applies them
        before the conflicting op runs)."""
        flushes: dict[str, int] = {}
        with self._lock:
            for path in msg.paths:
                for cache in (self._attr_cache, self._dir_cache):
                    for key in [k for k in cache
                                if k == path
                                or k.startswith(path + "/")]:
                        del cache[key]
                for key in [k for k in self._write_caps
                            if k == path or k.startswith(path + "/")]:
                    self._write_caps.discard(key)
                    if key in self._dirty_size:
                        flushes[key] = self._dirty_size.pop(key)
        return flushes

    @staticmethod
    def _norm(path: str) -> str:
        return "/" + "/".join(p for p in path.strip("/").split("/")
                              if p)

    def _invalidate_local(self, path: str, prefix: bool = False) -> None:
        """Our own mutation: drop our stale cache entries (the MDS
        only revokes OTHER clients)."""
        p = self._norm(path)
        parent = p.rsplit("/", 1)[0] or "/"
        for cache in (self._attr_cache, self._dir_cache):
            cache.pop(p, None)
            cache.pop(parent, None)
            if prefix:
                for key in [k for k in cache
                            if k.startswith(p + "/")]:
                    del cache[key]

    def _request(self, op: str, path: str, timeout: float = 30.0,
                 **kw):
        """One metadata op, multi-rank aware: ESTALE re-targets via a
        refreshed subtree table (the MDS names the right rank in the
        reply), EAGAIN waits out an in-flight subtree export."""
        deadline = time.time() + timeout
        while True:
            reply = self._request_once(op, path, timeout, kw)
            if reply.result == -116:      # wrong rank: re-target
                hint = (reply.data or {}).get("rank") \
                    if isinstance(reply.data, dict) else None
                self._refresh_subtrees()
                if hint is not None:
                    # key the pin by the ROUTE path — that is what the
                    # retry's longest-prefix lookup consults
                    self._subtrees[route_path(op, self._norm(path))] \
                        = int(hint)
                time.sleep(0.1)   # hinted rank may be mid-(re)beacon:
                # without backoff this spins at wire RTT for the whole
                # deadline when the target rank is down
            elif reply.result == -11:     # frozen: export in flight
                time.sleep(0.1)
            else:
                break
            if time.time() > deadline:
                raise FsError(110, f"{op} {path}: retries timed out")
        if reply.result < 0:
            raise FsError(-reply.result, f"{op} {path}: errno "
                                         f"{-reply.result}")
        return self._absorb_reply(op, reply)

    def _request_once(self, op: str, path: str, timeout: float,
                      kw: dict):
        tid = next(self._tid)
        slot = {"event": threading.Event(), "reply": None}
        with self._lock:
            self._pending[tid] = slot
        self.rpcs += 1
        try:
            entity, addr = self._mds_addr(route_path(op, self._norm(path)))
            req = MClientRequest(tid=tid, op=op, path=path,
                                 size=kw.get("size"),
                                 new_path=kw.get("new_path"))
            self.rados.msgr.send_message(req, entity, addr)
            if not slot["event"].wait(timeout):
                raise FsError(110, f"mds op {op} timed out")
            return slot["reply"]
        finally:
            with self._lock:
                self._pending.pop(tid, None)

    def _absorb_reply(self, op: str, reply):
        # adopt the data pool's snap context (SnapClient model): our
        # writes after a snapshot must carry the new snapc so the
        # OSDs copy-on-write the pre-snapshot data
        snapc = getattr(reply, "snapc", None)
        if snapc is not None and self.data is not None:
            want = (snapc[0],
                    sorted((int(x) for x in snapc[1]), reverse=True))
            if want != (self.data.snap_seq, self.data.snaps):
                # covers removal too: rmdir .snap/x shrinks the snap
                # list without bumping seq — keeping the stale context
                # would COW-clone to deleted snaps forever
                self.data.set_snap_context(*snapc)
        # granted caps let us cache what this reply carries
        for grant in getattr(reply, "grants", None) or []:
            p = grant["path"]
            with self._lock:
                if op in ("getattr", "lookup", "create", "setattr") \
                        and isinstance(reply.data, dict) \
                        and "ino" in reply.data:
                    self._attr_cache[p] = dict(reply.data)
                elif op == "readdir":
                    self._dir_cache[p] = dict(reply.data)
                if "w" in grant["caps"]:
                    self._write_caps.add(p)
        return reply.data

    # -- mount -------------------------------------------------------------

    def mount(self, timeout: float = 30.0) -> "CephFS":
        end = time.time() + timeout
        while time.time() < end:
            try:
                self._request("getattr", "/", timeout=5.0)
                break
            except FsError:
                time.sleep(0.5)
        else:
            raise FsError(110, "mount timed out (no mds?)")
        self.data = self.rados.open_ioctx(self.data_pool_name)
        self.mounted = True
        return self

    def unmount(self) -> None:
        self.mounted = False
        peers = CephFS._mounts.get(id(self.rados.msgr))
        if peers:
            peers[:] = [r for r in peers
                        if r() is not None and r() is not self]
            if not peers:
                CephFS._mounts.pop(id(self.rados.msgr), None)

    # -- namespace ops -----------------------------------------------------

    def mkdir(self, path: str) -> None:
        self._request("mkdir", path)
        with self._lock:
            self._invalidate_local(path)

    def mkdirs(self, path: str) -> None:
        parts = [p for p in path.strip("/").split("/") if p]
        cur = ""
        for part in parts:
            cur = f"{cur}/{part}"
            try:
                self.mkdir(cur)     # NOT _request: the local cache
            except FsError as e:    # invalidation must ride along
                if e.errno != 17:
                    raise

    def listdir(self, path: str) -> list[str]:
        p = self._norm(path)
        with self._lock:
            cached = self._dir_cache.get(p)
            if cached is not None:
                return sorted(cached)   # cap held: no MDS round trip
        return sorted(self._request("readdir", path))

    def stat(self, path: str) -> dict:
        p = self._norm(path)
        with self._lock:
            cached = self._attr_cache.get(p)
            if cached is not None:
                out = dict(cached)      # cap held: no MDS round trip
                if p in self._dirty_size:
                    out["size"] = max(out["size"],
                                      self._dirty_size[p])
                return out
        return self._request("getattr", path)

    def unlink(self, path: str) -> None:
        self._flush_dirty(path)
        inode = self._request("unlink", path)
        with self._lock:
            self._invalidate_local(path)
        self._purge_data(inode)

    def rmdir(self, path: str) -> None:
        self._request("rmdir", path)
        with self._lock:
            self._invalidate_local(path, prefix=True)

    def rename(self, src: str, dst: str) -> None:
        self._flush_dirty(src)
        result = self._request("rename", src, new_path=dst)
        with self._lock:
            self._invalidate_local(src, prefix=True)
            self._invalidate_local(dst, prefix=True)
        replaced = (result or {}).get("replaced")
        if replaced:
            self._purge_data(replaced)   # atomically-replaced file

    def _flush_dirty(self, path: str) -> None:
        """Push a buffered size update to the MDS (cap flush)."""
        p = self._norm(path)
        with self._lock:
            size = self._dirty_size.pop(p, None)
        if size is not None:
            self._request("setattr", path, size=size)

    def _purge_data(self, inode: dict) -> None:
        lo = Layout(**inode["layout"])
        objects = (inode["size"] + lo.object_size - 1) // lo.object_size
        comps = [self.data.aio_remove(data_oid(inode["ino"], i))
                 for i in range(objects)]
        for c in comps:
            c.wait_for_complete()

    # -- file I/O ----------------------------------------------------------

    def open(self, path: str, mode: str = "r") -> "File":
        if ".snap" in path.split("/") and (
                "w" in mode or "a" in mode or "+" in mode):
            raise FsError(30, "snapshots are read-only")     # EROFS
        if "w" in mode or "a" in mode or "+" in mode:
            inode = self._request("create", path)
            with self._lock:
                # our own create: drop our cached parent listing (the
                # MDS only revokes OTHER clients' caps)
                parent = self._norm(path).rsplit("/", 1)[0] or "/"
                self._dir_cache.pop(parent, None)
            if "w" in mode and inode["size"]:
                self._purge_data(inode)
                inode = self._request("setattr", path, size=0)
        else:
            inode = self._request("getattr", path)
            if inode["type"] != "file":
                raise FsError(21, f"{path} is a directory")
        return File(self, path, inode, mode)


class File:
    """An open file (Fh analog): pread/pwrite through the striper."""

    def __init__(self, fs: CephFS, path: str, inode: dict, mode: str):
        self.fs = fs
        self.path = path
        self.inode = inode
        self.mode = mode
        self.layout = Layout(**inode["layout"])
        self._pos = inode["size"] if "a" in mode else 0

    @property
    def ino(self) -> int:
        return self.inode["ino"]

    def size(self) -> int:
        return self.inode["size"]

    def write(self, data: bytes, offset: int | None = None) -> int:
        if self.inode.get("snapid") is not None:
            raise FsError(30, "snapshots are read-only")    # EROFS
        if not any(m in self.mode for m in "wa+"):
            raise FsError(9, "file not open for writing")   # EBADF
        data = bytes(data)
        off = self._pos if offset is None else offset
        comps = []
        for ext in file_to_extents(self.layout, off, len(data)):
            chunk = data[ext.logical_offset - off:
                         ext.logical_offset - off + ext.length]
            comps.append(self.fs.data.aio_write(
                data_oid(self.ino, ext.object_no), chunk,
                offset=ext.offset))
        for c in comps:
            c.wait_for_complete()
        for c in comps:
            c.result()
        end = off + len(data)
        if offset is None:
            self._pos = end
        if end > self.inode["size"]:
            p = self.fs._norm(self.path)
            with self.fs._lock:
                buffered = p in self.fs._write_caps
                if buffered:
                    # write-buffering cap (Fw): the size update stays
                    # client-side until close or a cap revoke flushes
                    # it — no MDS round trip per write
                    self.inode = dict(self.inode, size=end)
                    self.fs._dirty_size[p] = end
                    if p in self.fs._attr_cache:
                        self.fs._attr_cache[p]["size"] = end
            if not buffered:
                self.inode = self.fs._request("setattr", self.path,
                                              size=end)
        return len(data)

    def read(self, length: int = -1, offset: int | None = None) -> bytes:
        off = self._pos if offset is None else offset
        size = self.inode["size"]
        if length < 0 or off + length > size:
            length = max(0, size - off)
        if length == 0:
            return b""
        snapid = self.inode.get("snapid")
        comps = []
        for ext in file_to_extents(self.layout, off, length):
            if snapid is not None:
                # snapshot read: the pool resolves the clone (or the
                # unchanged head) covering this snapid
                comps.append((ext, self.fs.data.rados.aio_submit(
                    self.fs.data.snap_read,
                    data_oid(self.ino, ext.object_no), snapid,
                    ext.length, ext.offset)))
                continue
            comps.append((ext, self.fs.data.aio_read(
                data_oid(self.ino, ext.object_no), length=ext.length,
                offset=ext.offset)))
        buf = bytearray(length)
        for ext, c in comps:
            c.wait_for_complete()
            try:
                piece = c.result()
            except RadosError as e:
                if e.errno != 2:
                    raise
                piece = b""
            lo = ext.logical_offset - off
            buf[lo: lo + len(piece)] = piece
        if offset is None:
            self._pos = off + length
        return bytes(buf)

    def seek(self, pos: int) -> None:
        self._pos = pos

    def close(self) -> None:
        self.fs._flush_dirty(self.path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
