"""KStore: the all-in-KV object store (os/kstore/KStore.cc analog; the
BlueStore-family "metadata and data both live in the KV tier" model).

Layout in the KeyValueDB, one prefix per kind (the reference's
PREFIX_SUPER/COLL/OBJ/DATA/OMAP discipline):

  C  <cid>                      -> b"1"            collection exists
  O  <cid>/<oid>                -> denc {size, xattrs}   object head
  D  <cid>/<oid>/<block#:016x>  -> raw bytes       data, fixed blocks
  M  <cid>/<oid>/<key>          -> raw bytes       omap

Data is chunked into fixed blocks so partial writes touch only the
blocks they cover — the extent-blob model at its simplest.  Every
ObjectStore Transaction becomes ONE KV transaction, so the atomicity
contract is the KV engine's (Sqlite journal on disk, dict swap in
memory); there is no separate WAL because the KV commit IS the
durability point (BlueStore's kv_sync_thread collapsed).
"""

from __future__ import annotations

import threading

from ..kv.keyvaluedb import KeyValueDB
from ..kv.memdb import MemDB
from ..kv.sqlitedb import SqliteDB
from ..utils import denc
from .objectstore import (EEXIST, ENOENT, ObjectStore, StoreError,
                          Transaction)

BLOCK = 64 * 1024

P_COLL = "C"
P_OBJ = "O"
P_DATA = "D"
P_OMAP = "M"


def _okey(cid: str, oid: str) -> str:
    return f"{cid}/{oid}"


def _dkey(cid: str, oid: str, block: int) -> str:
    return f"{cid}/{oid}/{block:016x}"


class KStore(ObjectStore):
    def __init__(self, path: str = ""):
        super().__init__()
        self.path = path
        self.db: KeyValueDB = SqliteDB(f"{path}/kstore.db") if path \
            else MemDB()
        self._lock = threading.RLock()

    # -- lifecycle ---------------------------------------------------------

    def mkfs(self) -> None:
        if self.path:
            import os
            os.makedirs(self.path, exist_ok=True)
            self.db = SqliteDB(f"{self.path}/kstore.db")
        self.db.open()

    def mount(self) -> None:
        if self.path:
            import os
            if not os.path.exists(f"{self.path}/kstore.db"):
                raise FileNotFoundError(f"{self.path}/kstore.db")
        self.db.open()

    def umount(self) -> None:
        self.db.close()

    # -- head helpers ------------------------------------------------------

    def _head(self, cid: str, oid: str) -> dict:
        blob = self.db.get(P_OBJ, _okey(cid, oid))
        if blob is None:
            raise StoreError(ENOENT, f"no object {cid}/{oid}")
        return denc.loads(blob)

    def _head_or_new(self, st: dict, cid: str, oid: str,
                     create: bool) -> dict:
        heads = st["heads"]
        key = _okey(cid, oid)
        if key in heads:
            head = heads[key]
            if head is None:
                if not create:
                    raise StoreError(ENOENT, f"no object {cid}/{oid}")
                head = heads[key] = {"size": 0, "xattrs": {}}
            return head
        blob = self.db.get(P_OBJ, key)
        if blob is None:
            if not create:
                raise StoreError(ENOENT, f"no object {cid}/{oid}")
            if cid not in st["new_colls"] and \
                    self.db.get(P_COLL, cid) is None:
                raise StoreError(ENOENT, f"no collection {cid}")
            head = {"size": 0, "xattrs": {}}
        else:
            head = denc.loads(blob)
        heads[key] = head
        return head

    # -- data block rmw ----------------------------------------------------

    def _read_block(self, datas: dict, cid: str, oid: str,
                    block: int) -> bytes:
        key = _dkey(cid, oid, block)
        if key in datas:
            return datas[key] or b""
        return self.db.get(P_DATA, key) or b""

    def _write_span(self, datas: dict, cid: str, oid: str, offset: int,
                    data: bytes) -> None:
        pos = 0
        while pos < len(data):
            block = (offset + pos) // BLOCK
            boff = (offset + pos) % BLOCK
            take = min(len(data) - pos, BLOCK - boff)
            cur = bytearray(self._read_block(datas, cid, oid, block))
            if len(cur) < boff + take:
                cur.extend(b"\x00" * (boff + take - len(cur)))
            cur[boff: boff + take] = data[pos: pos + take]
            datas[_dkey(cid, oid, block)] = bytes(cur)
            pos += take

    # -- transaction application ------------------------------------------

    def _do_transaction(self, txn: Transaction) -> None:
        with self._lock:
            self._check_frozen()     # crashed: nothing reaches the KV
            kvt = self.db.transaction()
            st = {"heads": {}, "new_colls": set(), "omaps": {}}
            datas: dict[str, bytes | None] = {}   # pending data blocks
            for op in txn.ops:
                self._apply_op(op, st, datas, kvt)
            for key, head in st["heads"].items():
                if head is None:
                    kvt.rmkey(P_OBJ, key)
                else:
                    kvt.set(P_OBJ, key, denc.dumps(head))
            for key, blob in datas.items():
                if blob is None:
                    kvt.rmkey(P_DATA, key)
                else:
                    kvt.set(P_DATA, key, blob)
            for key, val in st["omaps"].items():
                if val is None:
                    kvt.rmkey(P_OMAP, key)
                else:
                    kvt.set(P_OMAP, key, val)
            self.db.submit_transaction(kvt, sync=True)

    def _omap_items(self, st: dict, cid: str, oid: str):
        """Committed omap entries overlaid with this txn's staged
        writes — later ops (remove/clone) must see earlier ones."""
        prefix = f"{cid}/{oid}/"
        out = {}
        for key, val in self.db.iterate(P_OMAP, prefix):
            if not key.startswith(prefix):
                break
            out[key[len(prefix):]] = val
        for key, val in st["omaps"].items():
            if key.startswith(prefix):
                k = key[len(prefix):]
                if val is None:
                    out.pop(k, None)
                else:
                    out[k] = val
        return out

    def _apply_op(self, op, st, datas, kvt) -> None:
        heads = st["heads"]
        kind = op[0]
        if kind == "mkcoll":
            _, cid = op
            if self.db.get(P_COLL, cid) is not None:
                raise StoreError(EEXIST, f"collection {cid} exists")
            st["new_colls"].add(cid)
            kvt.set(P_COLL, cid, b"1")
        elif kind == "rmcoll":
            _, cid = op
            kvt.rmkey(P_COLL, cid)
            st["new_colls"].discard(cid)
            for prefix_kind in (P_OBJ, P_DATA, P_OMAP):
                for key, _v in list(self.db.iterate(prefix_kind,
                                                    f"{cid}/")):
                    if not key.startswith(f"{cid}/"):
                        break
                    kvt.rmkey(prefix_kind, key)
            # staged state from earlier ops in this SAME txn must die
            # too, or it resurrects objects into the removed collection
            for key in list(st["omaps"]):
                if key.startswith(f"{cid}/"):
                    st["omaps"][key] = None
            for key in list(heads):
                if key.startswith(f"{cid}/"):
                    heads[key] = None
            for key in list(datas):
                if key.startswith(f"{cid}/"):
                    datas[key] = None
        elif kind == "touch":
            _, cid, oid = op
            self._head_or_new(st, cid, oid, create=True)
        elif kind == "write":
            _, cid, oid, offset, data = op
            head = self._head_or_new(st, cid, oid, create=True)
            self._write_span(datas, cid, oid, offset, data)
            head["size"] = max(head["size"], offset + len(data))
        elif kind == "zero":
            _, cid, oid, offset, length = op
            head = self._head_or_new(st, cid, oid, create=True)
            self._write_span(datas, cid, oid, offset, b"\x00" * length)
            head["size"] = max(head["size"], offset + length)
        elif kind == "truncate":
            _, cid, oid, size = op
            head = self._head_or_new(st, cid, oid, create=True)
            old = head["size"]
            if size < old:
                first_dead = (size + BLOCK - 1) // BLOCK
                for b in range(first_dead, (old + BLOCK - 1) // BLOCK):
                    datas[_dkey(cid, oid, b)] = None
                if size % BLOCK:
                    b = size // BLOCK
                    cur = self._read_block(datas, cid, oid, b)
                    datas[_dkey(cid, oid, b)] = cur[: size % BLOCK]
            head["size"] = size
        elif kind in ("remove", "try_remove"):
            _, cid, oid = op
            key = _okey(cid, oid)
            exists = heads.get(key) is not None if key in heads \
                else self.db.get(P_OBJ, key) is not None
            if not exists:
                if kind == "remove":
                    raise StoreError(ENOENT, f"remove {cid}/{oid}")
                return
            self._purge(st, datas, kvt, cid, oid)
        elif kind in ("clone", "try_clone"):
            _, cid, src, dst = op
            skey = _okey(cid, src)
            if skey in heads:
                src_head = heads[skey]
            else:
                blob = self.db.get(P_OBJ, skey)
                src_head = denc.loads(blob) if blob else None
            if src_head is None:
                if kind == "try_clone":
                    return
                raise StoreError(ENOENT, f"clone src {cid}/{src}")
            self._purge(st, datas, kvt, cid, dst)
            heads[_okey(cid, dst)] = {"size": src_head["size"],
                                      "xattrs": dict(src_head["xattrs"])}
            for b in range((src_head["size"] + BLOCK - 1) // BLOCK):
                blob = self._read_block(datas, cid, src, b)
                if blob:
                    datas[_dkey(cid, dst, b)] = blob
            for k, val in self._omap_items(st, cid, src).items():
                st["omaps"][f"{cid}/{dst}/{k}"] = val
        elif kind == "move":
            _, scid, soid, dcid, doid = op
            skey = _okey(scid, soid)
            if skey in heads:
                src_head = heads[skey]
            else:
                blob = self.db.get(P_OBJ, skey)
                src_head = denc.loads(blob) if blob else None
            if src_head is None:
                raise StoreError(ENOENT, f"move src {scid}/{soid}")
            if dcid not in st["new_colls"] and \
                    self.db.get(P_COLL, dcid) is None:
                raise StoreError(ENOENT, f"no collection {dcid}")
            self._purge(st, datas, kvt, dcid, doid)
            heads[_okey(dcid, doid)] = {
                "size": src_head["size"],
                "xattrs": dict(src_head["xattrs"])}
            for b in range((src_head["size"] + BLOCK - 1) // BLOCK):
                blob = self._read_block(datas, scid, soid, b)
                if blob:
                    datas[_dkey(dcid, doid, b)] = blob
            for k, val in self._omap_items(st, scid, soid).items():
                st["omaps"][f"{dcid}/{doid}/{k}"] = val
            self._purge(st, datas, kvt, scid, soid)
        elif kind == "setattr":
            _, cid, oid, name, value = op
            head = self._head_or_new(st, cid, oid, create=True)
            head["xattrs"][name] = value
        elif kind == "rmattr":
            _, cid, oid, name = op
            head = self._head_or_new(st, cid, oid, create=False)
            head["xattrs"].pop(name, None)
        elif kind == "omap_set":
            _, cid, oid, kvs = op
            self._head_or_new(st, cid, oid, create=True)
            for k, v in kvs.items():
                st["omaps"][f"{cid}/{oid}/{k}"] = v
        elif kind == "omap_rm":
            _, cid, oid, keys = op
            for k in keys:
                st["omaps"][f"{cid}/{oid}/{k}"] = None
        elif kind == "omap_clear":
            _, cid, oid = op
            for k in self._omap_items(st, cid, oid):
                st["omaps"][f"{cid}/{oid}/{k}"] = None
        else:
            raise StoreError(22, f"kstore: unknown op {kind!r}")

    def _purge(self, st, datas, kvt, cid: str, oid: str) -> None:
        heads = st["heads"]
        key = _okey(cid, oid)
        blob = self.db.get(P_OBJ, key)
        size = 0
        if key in heads and heads[key] is not None:
            size = heads[key]["size"]
        elif blob is not None:
            size = denc.loads(blob)["size"]
        heads[key] = None
        for b in range((size + BLOCK - 1) // BLOCK):
            datas[_dkey(cid, oid, b)] = None
        for k in self._omap_items(st, cid, oid):
            st["omaps"][f"{cid}/{oid}/{k}"] = None

    # -- reads -------------------------------------------------------------

    def read(self, cid: str, oid: str, offset: int = 0,
             length: int = 0) -> bytes:
        self._maybe_eio(oid)
        with self._lock:
            head = self._head(cid, oid)
            size = head["size"]
            end = size if length == 0 else min(size, offset + length)
            if offset >= end:
                return b""
            out = bytearray(end - offset)
            pos = offset
            while pos < end:
                block = pos // BLOCK
                boff = pos % BLOCK
                take = min(end - pos, BLOCK - boff)
                blob = self.db.get(P_DATA, _dkey(cid, oid, block)) \
                    or b""
                piece = blob[boff: boff + take]
                out[pos - offset: pos - offset + len(piece)] = piece
                pos += take
            return bytes(out)

    def stat(self, cid: str, oid: str) -> dict:
        with self._lock:
            return {"size": self._head(cid, oid)["size"]}

    def exists(self, cid: str, oid: str) -> bool:
        return self.db.get(P_OBJ, _okey(cid, oid)) is not None

    def getattr(self, cid: str, oid: str, name: str) -> bytes:
        head = self._head(cid, oid)
        if name not in head["xattrs"]:
            raise StoreError(61, f"no xattr {name}")    # ENODATA
        return head["xattrs"][name]

    def getattrs(self, cid: str, oid: str) -> dict[str, bytes]:
        return dict(self._head(cid, oid)["xattrs"])

    def omap_get(self, cid: str, oid: str) -> dict[str, bytes]:
        with self._lock:
            self._head(cid, oid)
            prefix = f"{cid}/{oid}/"
            out = {}
            for key, val in self.db.iterate(P_OMAP, prefix):
                if not key.startswith(prefix):
                    break
                out[key[len(prefix):]] = val
            return out

    def omap_get_values(self, cid: str, oid: str, keys) -> dict:
        omap = self.omap_get(cid, oid)
        return {k: omap[k] for k in keys if k in omap}

    def list_collections(self) -> list[str]:
        return sorted(k for k, _v in self.db.iterate(P_COLL))

    def collection_exists(self, cid: str) -> bool:
        return self.db.get(P_COLL, cid) is not None

    def collection_list(self, cid: str, start: str = "",
                        max_count: int = 0) -> list[str]:
        with self._lock:
            if not self.collection_exists(cid):
                raise StoreError(ENOENT, f"no collection {cid}")
            prefix = f"{cid}/"
            names = []
            # seed the iterator at the cursor: rescanning the whole
            # collection per page would make paging O(N^2/k)
            for key, _v in self.db.iterate(P_OBJ, prefix + start):
                if not key.startswith(prefix):
                    break
                name = key[len(prefix):]
                if start and name <= start:
                    continue       # start is exclusive
                names.append(name)
                if max_count and len(names) >= max_count:
                    break
            return sorted(names)
