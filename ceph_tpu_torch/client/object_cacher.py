"""ObjectCacher: client-side object data cache (osdc/ObjectCacher.cc
reduced).

The reference's write-back page cache sits between librbd/the fs
client and the Objecter: reads are served from cached extents, writes
buffer as dirty extents flushed asynchronously, bounded by dirty/clean
byte budgets.  This keeps that shape with simpler machinery:

  * per-object sorted extent map (offset -> bytearray), adjacent and
    overlapping runs merged on insert;
  * reads call `fetch` only for the gaps, then serve one contiguous
    buffer; a fetch's result is inserted clean;
  * writes overlay dirty extents; flush() pushes dirty runs through
    the `writer` callback in offset order and marks them clean;
  * byte-budget LRU across objects evicts CLEAN extents only — dirty
    data never silently drops (BufferHead states reduced to
    clean/dirty).

Consistency contract (same as the reference's librbd usage): one
writer at a time — librbd guards the cache with the exclusive lock,
snapshots/flatten flush first.  Shared concurrent writers must run
uncached.
"""

from __future__ import annotations

import threading
from typing import Callable


class _Object:
    __slots__ = ("extents", "dirty")

    def __init__(self):
        self.extents: dict[int, bytearray] = {}   # start -> bytes
        self.dirty: set[tuple[int, int]] = set()  # (start, len) runs


class ObjectCacher:
    def __init__(self, max_size: int = 32 << 20,
                 max_dirty: int = 16 << 20,
                 writer: Callable[[str, int, bytes], None] | None = None):
        self.max_size = max_size
        self.max_dirty = max_dirty
        self.writer = writer
        self._objects: dict[str, _Object] = {}    # insertion = LRU
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0

    # -- bookkeeping -------------------------------------------------------

    def _obj(self, oid: str) -> _Object:
        obj = self._objects.pop(oid, None)
        if obj is None:
            obj = _Object()
        self._objects[oid] = obj                  # move to MRU end
        return obj

    def _size_of(self, obj: _Object) -> int:
        return sum(len(b) for b in obj.extents.values())

    def size(self) -> int:
        with self._lock:
            return sum(self._size_of(o) for o in self._objects.values())

    def dirty_bytes(self) -> int:
        with self._lock:
            return sum(ln for o in self._objects.values()
                       for (_s, ln) in o.dirty)

    # -- extent algebra ----------------------------------------------------

    @staticmethod
    def _insert(obj: _Object, off: int, data: bytes) -> None:
        """Overlay [off, off+len) and merge touching runs."""
        start, buf = off, bytearray(data)
        merged = True
        while merged:
            merged = False
            for s in list(obj.extents):
                b = obj.extents[s]
                e, be = start + len(buf), s + len(b)
                if be < start or e < s:
                    continue                       # disjoint
                del obj.extents[s]
                ns = min(s, start)
                nb = bytearray(max(be, e) - ns)
                nb[s - ns: s - ns + len(b)] = b
                nb[start - ns: start - ns + len(buf)] = buf
                start, buf = ns, nb
                merged = True
                break
        obj.extents[start] = buf

    @staticmethod
    def _covered(obj: _Object, off: int, length: int) -> bool:
        for s, b in obj.extents.items():
            if s <= off and off + length <= s + len(b):
                return True
        return False

    @staticmethod
    def _read_cached(obj: _Object, off: int, length: int) -> bytes:
        for s, b in obj.extents.items():
            if s <= off and off + length <= s + len(b):
                return bytes(b[off - s: off - s + length])
        raise KeyError(off)

    # -- public API --------------------------------------------------------

    def try_read(self, oid: str, off: int,
                 length: int) -> bytes | None:
        """Cache-only probe: the bytes on a hit, None on a miss."""
        with self._lock:
            obj = self._obj(oid)
            if self._covered(obj, off, length):
                self.hits += 1
                return self._read_cached(obj, off, length)
            self.misses += 1
            return None

    def insert_clean(self, oid: str, off: int, data: bytes,
                     length: int) -> bytes:
        """Install fetched bytes (padded to `length`) WITHOUT
        clobbering dirty overlays — buffered writes always win over
        whatever the fetch returned.  Returns the post-merge bytes."""
        with self._lock:
            obj = self._obj(oid)
            end = off + length
            overlays = []
            for (s, ln) in obj.dirty:
                if s < end and s + ln > off:
                    try:
                        overlays.append(
                            (s, self._read_cached(obj, s, ln)))
                    except KeyError:
                        pass     # trimmed by a racing discard
            self._insert(obj, off, bytes(data).ljust(length, b"\0"))
            for s, b in overlays:
                self._insert(obj, s, b)
            out = self._read_cached(obj, off, length)
            self._evict_clean()
            return out

    def read(self, oid: str, off: int, length: int,
             fetch: Callable[[int, int], bytes]) -> bytes:
        """Serve [off, off+length); `fetch(off, length)` fills the
        whole range on a miss (fetch granularity is the caller's —
        librbd fetches the full extent, so one miss warms the run)."""
        got = self.try_read(oid, off, length)
        if got is not None:
            return got
        return self.insert_clean(oid, off, fetch(off, length), length)

    def write(self, oid: str, off: int, data: bytes) -> None:
        """Buffer a dirty extent (write-back).  Flushes synchronously
        through `writer` when the dirty budget is exceeded."""
        with self._lock:
            obj = self._obj(oid)
            self._insert(obj, off, data)
            obj.dirty.add((off, len(data)))
            over = self.dirty_bytes() > self.max_dirty
        if over:
            self.flush()

    def flush(self, oid: str | None = None) -> int:
        """Push dirty runs through `writer` in offset order."""
        if self.writer is None:
            raise RuntimeError("no writer wired; cache is read-only")
        flushed = 0
        with self._lock:
            targets = [oid] if oid is not None else list(self._objects)
            work = []
            for o in targets:
                obj = self._objects.get(o)
                if obj is None or not obj.dirty:
                    continue
                work.append((o, obj, sorted(obj.dirty)))
        for o, obj, runs in work:
            for s, ln in runs:
                with self._lock:
                    try:
                        data = self._read_cached(obj, s, ln)
                    except KeyError:
                        obj.dirty.discard((s, ln))
                        continue     # discard raced; gone
                # a run stays DIRTY until its write succeeds: a
                # transient writer failure must retry on the next
                # flush, not silently launder the data clean
                self.writer(o, s, data)
                with self._lock:
                    obj.dirty.discard((s, ln))
                flushed += ln
        return flushed

    def discard(self, oid: str, off: int | None = None,
                length: int | None = None) -> None:
        """Drop cached state (dirty included — the caller just
        truncated/removed the backing object)."""
        with self._lock:
            if off is None:
                self._objects.pop(oid, None)
                return
            obj = self._objects.get(oid)
            if obj is None:
                return
            end = off + (length or 0)
            for s in list(obj.extents):
                b = obj.extents[s]
                if s + len(b) <= off or (length is not None and s >= end):
                    continue
                del obj.extents[s]
                if s < off:
                    obj.extents[s] = b[: off - s]
                if length is not None and s + len(b) > end:
                    obj.extents[end] = b[end - s:]
            # trim straddling dirty runs instead of dropping them —
            # the un-discarded portion is still unflushed data
            new_dirty: set[tuple[int, int]] = set()
            for (s, ln) in obj.dirty:
                e = s + ln
                if e <= off or (length is not None and s >= end):
                    new_dirty.add((s, ln))
                    continue
                if s < off:
                    new_dirty.add((s, off - s))
                if length is not None and e > end:
                    new_dirty.add((end, e - end))
            obj.dirty = new_dirty

    def invalidate_all(self) -> None:
        with self._lock:
            self._objects.clear()

    def _evict_clean(self) -> None:
        """LRU-evict CLEAN objects past the byte budget (dirty data is
        never dropped; flush first)."""
        total = sum(self._size_of(o) for o in self._objects.values())
        if total <= self.max_size:
            return
        for oid in list(self._objects):
            obj = self._objects[oid]
            if obj.dirty:
                continue
            total -= self._size_of(obj)
            del self._objects[oid]
            if total <= self.max_size:
                return
