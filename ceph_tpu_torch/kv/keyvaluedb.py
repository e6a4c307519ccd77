"""Uniform transactional KV API.

Mirrors kv/KeyValueDB.h semantics: keys live in (prefix, key) namespaces,
writes are batched in transactions submitted atomically, iteration is
ordered within a prefix.
"""

from __future__ import annotations

import abc
from typing import Iterable, Iterator


class KVTransaction:
    """A write batch: (op, prefix, key, value) entries."""

    __slots__ = ("ops",)

    def __init__(self):
        self.ops: list[tuple] = []

    def set(self, prefix: str, key: str, value: bytes) -> None:
        self.ops.append(("set", prefix, key, bytes(value)))

    def rmkey(self, prefix: str, key: str) -> None:
        self.ops.append(("rm", prefix, key, b""))

    def rmkeys_by_prefix(self, prefix: str) -> None:
        self.ops.append(("rm_prefix", prefix, "", b""))

    def merge(self, other: "KVTransaction") -> None:
        self.ops.extend(other.ops)


class KeyValueDB(abc.ABC):
    @abc.abstractmethod
    def open(self) -> None: ...

    @abc.abstractmethod
    def close(self) -> None: ...

    def transaction(self) -> KVTransaction:
        return KVTransaction()

    @abc.abstractmethod
    def submit_transaction(self, txn: KVTransaction,
                           sync: bool = False) -> None:
        """Apply atomically; sync=True -> durable before return."""

    @abc.abstractmethod
    def get(self, prefix: str, key: str) -> bytes | None: ...

    def get_multi(self, prefix: str, keys: Iterable[str]) -> dict[str, bytes]:
        out = {}
        for k in keys:
            v = self.get(prefix, k)
            if v is not None:
                out[k] = v
        return out

    @abc.abstractmethod
    def iterate(self, prefix: str, start: str = "",
                end: str | None = None) -> Iterator[tuple[str, bytes]]:
        """Ordered (key, value) pairs with start <= key < end."""

    @abc.abstractmethod
    def prefixes(self) -> list[str]:
        """All namespaces with at least one key (store-sync dumps)."""
