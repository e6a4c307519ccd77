"""MemStore: all-in-RAM ObjectStore (os/memstore/MemStore.h:32 analog).

The fast backend for tests and single-process clusters; also the model
every other backend's conformance is checked against.
"""

from __future__ import annotations

import threading
from typing import Iterable

from .objectstore import (EEXIST, ENOENT, ObjectStore, StoreError,
                          Transaction)


class _Obj:
    __slots__ = ("data", "xattrs", "omap")

    def __init__(self):
        self.data = bytearray()
        self.xattrs: dict[str, bytes] = {}
        self.omap: dict[str, bytes] = {}

    def clone(self) -> "_Obj":
        o = _Obj()
        o.data = bytearray(self.data)
        o.xattrs = dict(self.xattrs)
        o.omap = dict(self.omap)
        return o


class MemStore(ObjectStore):
    def __init__(self, inject_eio_probability: float = 0.0):
        super().__init__()
        self._colls: dict[str, dict[str, _Obj]] = {}
        self._lock = threading.RLock()
        self.inject_eio_probability = inject_eio_probability

    # -- transaction application ------------------------------------------

    def _get(self, cid: str, oid: str, create: bool = False) -> _Obj:
        coll = self._colls.get(cid)
        if coll is None:
            raise StoreError(ENOENT, f"no collection {cid}")
        obj = coll.get(oid)
        if obj is None:
            if not create:
                raise StoreError(ENOENT, f"no object {cid}/{oid}")
            obj = coll[oid] = _Obj()
        return obj

    def _do_transaction(self, txn: Transaction) -> None:
        with self._lock:
            for op in txn.ops:
                self._do_op(op)

    def _do_op(self, op: tuple) -> None:
        kind = op[0]
        if kind == "mkcoll":
            if op[1] in self._colls:
                raise StoreError(EEXIST, f"collection {op[1]} exists")
            self._colls[op[1]] = {}
        elif kind == "rmcoll":
            self._colls.pop(op[1], None)
        elif kind == "touch":
            self._get(op[1], op[2], create=True)
        elif kind == "write":
            _, cid, oid, offset, data = op
            obj = self._get(cid, oid, create=True)
            end = offset + len(data)
            if len(obj.data) < end:
                obj.data.extend(b"\x00" * (end - len(obj.data)))
            obj.data[offset:end] = data
        elif kind == "zero":
            _, cid, oid, offset, length = op
            obj = self._get(cid, oid, create=True)
            end = offset + length
            if len(obj.data) < end:
                obj.data.extend(b"\x00" * (end - len(obj.data)))
            obj.data[offset:end] = b"\x00" * length
        elif kind == "truncate":
            _, cid, oid, size = op
            obj = self._get(cid, oid, create=True)
            if len(obj.data) > size:
                del obj.data[size:]
            else:
                obj.data.extend(b"\x00" * (size - len(obj.data)))
        elif kind == "remove":
            coll = self._colls.get(op[1])
            if coll is None or op[2] not in coll:
                raise StoreError(ENOENT, f"remove {op[1]}/{op[2]}")
            del coll[op[2]]
        elif kind == "try_remove":
            coll = self._colls.get(op[1])
            if coll is not None:
                coll.pop(op[2], None)
        elif kind == "clone":
            _, cid, src, dst = op
            obj = self._get(cid, src)
            self._colls[cid][dst] = obj.clone()
        elif kind == "try_clone":
            _, cid, src, dst = op
            coll = self._colls.get(cid)
            if coll is not None and src in coll:
                coll[dst] = coll[src].clone()
        elif kind == "move":
            _, scid, soid, dcid, doid = op
            obj = self._get(scid, soid)
            if dcid not in self._colls:
                raise StoreError(ENOENT, f"no collection {dcid}")
            self._colls[dcid][doid] = obj
            del self._colls[scid][soid]
        elif kind == "setattr":
            _, cid, oid, name, value = op
            self._get(cid, oid, create=True).xattrs[name] = value
        elif kind == "rmattr":
            self._get(op[1], op[2]).xattrs.pop(op[3], None)
        elif kind == "omap_set":
            self._get(op[1], op[2], create=True).omap.update(op[3])
        elif kind == "omap_rm":
            omap = self._get(op[1], op[2]).omap
            for k in op[3]:
                omap.pop(k, None)
        elif kind == "omap_clear":
            self._get(op[1], op[2]).omap.clear()
        else:
            raise StoreError(EEXIST, f"unknown op {kind}")

    # -- reads -------------------------------------------------------------

    def read(self, cid: str, oid: str, offset: int = 0,
             length: int = 0) -> bytes:
        self._maybe_eio(oid)
        with self._lock:
            obj = self._get(cid, oid)
            if length == 0:
                return bytes(obj.data[offset:])
            return bytes(obj.data[offset:offset + length])

    def stat(self, cid: str, oid: str) -> dict:
        with self._lock:
            obj = self._get(cid, oid)
            return {"size": len(obj.data)}

    def exists(self, cid: str, oid: str) -> bool:
        with self._lock:
            return oid in self._colls.get(cid, {})

    def getattr(self, cid: str, oid: str, name: str) -> bytes:
        with self._lock:
            obj = self._get(cid, oid)
            if name not in obj.xattrs:
                raise StoreError(ENOENT, f"no xattr {name}")
            return obj.xattrs[name]

    def getattrs(self, cid: str, oid: str) -> dict[str, bytes]:
        with self._lock:
            return dict(self._get(cid, oid).xattrs)

    def omap_get(self, cid: str, oid: str) -> dict[str, bytes]:
        with self._lock:
            return dict(self._get(cid, oid).omap)

    def omap_get_values(self, cid: str, oid: str,
                        keys: Iterable[str]) -> dict[str, bytes]:
        with self._lock:
            omap = self._get(cid, oid).omap
            return {k: omap[k] for k in keys if k in omap}

    def list_collections(self) -> list[str]:
        with self._lock:
            return sorted(self._colls)

    def collection_exists(self, cid: str) -> bool:
        with self._lock:
            return cid in self._colls

    def collection_list(self, cid: str, start: str = "",
                        max_count: int = 0) -> list[str]:
        with self._lock:
            if cid not in self._colls:
                raise StoreError(ENOENT, f"no collection {cid}")
            names = sorted(n for n in self._colls[cid] if n > start)
        return names[:max_count] if max_count else names
