"""Transactional key/value abstraction (kv/KeyValueDB.h analog).

Backends: MemDB (sorted in-memory, tests + MemStore omap) and SqliteDB
(durable, the RocksDB stand-in for mon stores and file-store omap —
sqlite3 is in the stdlib; the interface is the contract, the engine is
swappable).
"""

from .keyvaluedb import KeyValueDB, KVTransaction
from .memdb import MemDB
from .sqlitedb import SqliteDB

__all__ = ["KeyValueDB", "KVTransaction", "MemDB", "SqliteDB"]
