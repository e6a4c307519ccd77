"""ObjectStore: transactional local object storage (os/ analog).

Objects (data + xattrs + omap) live in collections; all mutations go
through Transactions applied atomically via queue_transactions with
async commit callbacks (os/ObjectStore.h:1453 semantics).  Backends:
MemStore (in-RAM, tests/fast OSDs) and JournalFileStore (write-ahead
journal + files + sqlite omap, the FileStore analog).
"""

from .objectstore import (ObjectStore, Transaction, StoreError, CrashPoint,
                          ENOENT, EEXIST)
from .memstore import MemStore
from .filestore import JournalFileStore


def create(kind: str, path: str = "", **kw) -> ObjectStore:
    """ObjectStore::create factory (os/ObjectStore.h:83)."""
    if kind == "memstore":
        return MemStore()
    if kind in ("filestore", "journalfilestore"):
        return JournalFileStore(path, **kw)
    if kind == "kstore":
        from .kstore import KStore
        return KStore(path)
    if kind == "blockstore":
        from .blockstore import BlockStore
        return BlockStore(path, **kw)
    raise ValueError(f"unknown objectstore {kind!r}")


__all__ = ["ObjectStore", "Transaction", "StoreError", "CrashPoint",
           "MemStore", "JournalFileStore", "create", "ENOENT", "EEXIST"]
