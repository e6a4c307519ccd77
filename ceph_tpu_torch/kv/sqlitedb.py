"""Durable KV over sqlite3 (the RocksDBStore stand-in).

Same KeyValueDB contract; WAL-mode sqlite gives atomic batched writes
and ordered iteration.  Used by MonitorDBStore and file-store omap.
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Iterator

from .keyvaluedb import KeyValueDB, KVTransaction


class SqliteDB(KeyValueDB):
    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._conn: sqlite3.Connection | None = None

    def open(self) -> None:
        if getattr(self, "_conn", None) is not None:
            self._conn.close()     # mkfs-then-mount must not leak one
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS kv ("
            " prefix TEXT NOT NULL, key TEXT NOT NULL, value BLOB,"
            " PRIMARY KEY (prefix, key))")
        self._conn.commit()

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def submit_transaction(self, txn: KVTransaction,
                           sync: bool = False) -> None:
        with self._lock:
            cur = self._conn.cursor()
            if sync:
                cur.execute("PRAGMA synchronous=FULL")
            try:
                for op, prefix, key, value in txn.ops:
                    if op == "set":
                        cur.execute(
                            "INSERT OR REPLACE INTO kv VALUES (?,?,?)",
                            (prefix, key, value))
                    elif op == "rm":
                        cur.execute(
                            "DELETE FROM kv WHERE prefix=? AND key=?",
                            (prefix, key))
                    elif op == "rm_prefix":
                        cur.execute("DELETE FROM kv WHERE prefix=?",
                                    (prefix,))
                self._conn.commit()
            finally:
                if sync:
                    cur.execute("PRAGMA synchronous=NORMAL")

    def get(self, prefix: str, key: str) -> bytes | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM kv WHERE prefix=? AND key=?",
                (prefix, key)).fetchone()
        return bytes(row[0]) if row else None

    def prefixes(self) -> list[str]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT DISTINCT prefix FROM kv").fetchall()
        return [r[0] for r in rows]

    def iterate(self, prefix: str, start: str = "",
                end: str | None = None) -> Iterator[tuple[str, bytes]]:
        with self._lock:
            if end is None:
                rows = self._conn.execute(
                    "SELECT key, value FROM kv WHERE prefix=? AND key>=?"
                    " ORDER BY key", (prefix, start)).fetchall()
            else:
                rows = self._conn.execute(
                    "SELECT key, value FROM kv WHERE prefix=? AND key>=?"
                    " AND key<? ORDER BY key", (prefix, start, end)).fetchall()
        for k, v in rows:
            yield k, bytes(v)
