"""In-memory sorted KV (kv/MemDB.cc analog); the test/MemStore backend."""

from __future__ import annotations

import threading
from typing import Iterator

from .keyvaluedb import KeyValueDB, KVTransaction


class MemDB(KeyValueDB):
    def __init__(self):
        self._data: dict[str, dict[str, bytes]] = {}
        self._lock = threading.Lock()

    def open(self) -> None:
        pass

    def close(self) -> None:
        pass

    def submit_transaction(self, txn: KVTransaction,
                           sync: bool = False) -> None:
        with self._lock:
            for op, prefix, key, value in txn.ops:
                space = self._data.setdefault(prefix, {})
                if op == "set":
                    space[key] = value
                elif op == "rm":
                    space.pop(key, None)
                elif op == "rm_prefix":
                    space.clear()

    def get(self, prefix: str, key: str) -> bytes | None:
        with self._lock:
            return self._data.get(prefix, {}).get(key)

    def prefixes(self) -> list[str]:
        with self._lock:
            return [p for p, space in self._data.items() if space]

    def iterate(self, prefix: str, start: str = "",
                end: str | None = None) -> Iterator[tuple[str, bytes]]:
        with self._lock:
            items = sorted(self._data.get(prefix, {}).items())
        for k, v in items:
            if k < start:
                continue
            if end is not None and k >= end:
                break
            yield k, v
