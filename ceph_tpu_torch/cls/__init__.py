"""Object classes: in-OSD RPC methods (objclass/objclass.h analog).

The reference loads .so classes via ClassHandler::open_class
(osd/ClassHandler.cc:143) and methods register with
cls_register_cxx_method (objclass/objclass.h:73,137); a client's
CEPH_OSD_OP_CALL executes the method INSIDE the OSD against the target
object.  Here classes are python modules registered at import, and a
method receives a MethodContext bound to the object: reads hit the
store directly, writes append to the op's transaction so they
replicate exactly like any other mutation.

Method flags mirror the reference: RD (reads object state) and WR
(mutates it) — WR methods run on the write path and their transaction
fans out to replicas.
"""

from __future__ import annotations

from typing import Callable

RD = 1
WR = 2


class ClsError(Exception):
    def __init__(self, errno_: int, msg: str = ""):
        super().__init__(msg or f"errno {errno_}")
        self.errno = errno_


class MethodContext:
    """What a class method may do to its object (cls_cxx_* surface)."""

    def __init__(self, pg, txn, oid: str, inp: bytes):
        self._pg = pg
        self._txn = txn              # None for RD methods
        self._store = pg.osd.store
        self.oid = oid
        self.input = inp
        self.removed = False         # method removed its object

    # -- reads -------------------------------------------------------------

    def now(self) -> float:
        """Daemon time through the injectable Clock — cls methods run
        inside the OSD and must stay deterministic under ManualClock."""
        return self._pg.osd.clock.now()

    def exists(self) -> bool:
        return self._store.exists(self._pg.cid, self.oid)

    def read(self, offset: int = 0, length: int = 0) -> bytes:
        from ..store.objectstore import StoreError
        try:
            return self._store.read(self._pg.cid, self.oid, offset, length)
        except StoreError as e:
            raise ClsError(e.errno, str(e))

    def stat(self) -> dict:
        from ..store.objectstore import StoreError
        try:
            return self._store.stat(self._pg.cid, self.oid)
        except StoreError as e:
            raise ClsError(e.errno, str(e))

    def getxattr(self, name: str) -> bytes | None:
        from ..store.objectstore import StoreError
        try:
            return self._store.getattr(self._pg.cid, self.oid,
                                       "u." + name)
        except StoreError:
            return None

    def omap_get(self, keys=None) -> dict:
        from ..store.objectstore import StoreError
        try:
            omap = self._store.omap_get(self._pg.cid, self.oid)
        except StoreError:
            return {}
        if keys is None:
            return omap
        return {k: omap[k] for k in keys if k in omap}

    # -- writes (WR methods only) ------------------------------------------

    def _wr(self):
        if self._txn is None:
            raise ClsError(30, "write from RD method")     # EROFS

    def create(self) -> None:
        self._wr()
        self._txn.touch(self._pg.cid, self.oid)

    def write(self, offset: int, data: bytes) -> None:
        self._wr()
        self._txn.write(self._pg.cid, self.oid, offset, bytes(data))

    def write_full(self, data: bytes) -> None:
        self._wr()
        self._txn.truncate(self._pg.cid, self.oid, 0)
        self._txn.write(self._pg.cid, self.oid, 0, bytes(data))

    def truncate(self, size: int) -> None:
        self._wr()
        self._txn.truncate(self._pg.cid, self.oid, size)

    def remove(self) -> None:
        self._wr()
        self._txn.remove(self._pg.cid, self.oid)
        self.removed = True

    def setxattr(self, name: str, value: bytes) -> None:
        self._wr()
        self._txn.setattr(self._pg.cid, self.oid, "u." + name,
                          bytes(value))

    def omap_set(self, kv: dict) -> None:
        self._wr()
        self._txn.omap_setkeys(self._pg.cid, self.oid, kv)

    def omap_rm(self, keys) -> None:
        self._wr()
        self._txn.omap_rmkeys(self._pg.cid, self.oid, list(keys))


def page_omap(omap: dict, marker: str, hi: str,
              limit: int) -> dict:
    """Shared marker-paged listing over an omap snapshot (used by the
    log and timeindex classes): entries strictly after `marker` and
    below `hi`, meta (\x00-prefixed) keys excluded."""
    from ..utils import denc
    keys = sorted(k for k in omap
                  if not k.startswith("\x00")
                  and k > marker and k < hi)
    page = keys[:limit]
    return {
        "entries": [dict(denc.loads(omap[k]), marker=k)
                    for k in page],
        "marker": page[-1] if page else marker,
        "truncated": len(keys) > limit,
    }


class ClassRegistry:
    """ClassHandler + per-class method tables."""

    def __init__(self):
        self._methods: dict[tuple[str, str], tuple[Callable, int]] = {}

    def register(self, cls: str, method: str, flags: int,
                 fn: Callable[[MethodContext], bytes | None]) -> None:
        self._methods[(cls, method)] = (fn, flags)

    def get(self, cls: str, method: str):
        return self._methods.get((cls, method))

    def is_write(self, cls: str, method: str) -> bool:
        ent = self._methods.get((cls, method))
        return bool(ent and ent[1] & WR)

    def classes(self) -> list[str]:
        return sorted({c for c, _m in self._methods})


registry = ClassRegistry()


def cls_method(cls: str, method: str, flags: int):
    """Decorator: the cls_register_cxx_method analog."""
    def wrap(fn):
        registry.register(cls, method, flags, fn)
        return fn
    return wrap


# built-in classes (the reference preloads its cls .so set at OSD boot)
from . import (hello, kvstore, lock, log, numops, rbd,  # noqa: E402,F401
               refcount, timeindex, version)  # noqa: E402,F401
