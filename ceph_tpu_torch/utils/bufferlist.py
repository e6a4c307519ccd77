"""BufferList: a zero-copy byte rope (the reference's bufferlist).

The analog of include/buffer.h's ``bufferlist``: an ordered list of
buffer views over memory someone else owns.  ``append`` and ``slice``
never copy — they add or narrow ``memoryview`` segments — so a payload
can traverse client -> striper -> objecter -> messenger -> OSD -> EC
fan-out -> store while its bytes are materialized at most once (the
encode staging buffer / the WAL append; see utils/copyaudit.py).

Accepted segment sources: ``bytes``, ``bytearray``, ``memoryview``,
C-contiguous uint8 ``numpy`` arrays, and other ``BufferList``s (their
segments are shared, not copied).  Views hold a reference to the
exporting object, so lifetime is safe; the flip side is the usual
bufferlist contract — callers must not mutate a buffer they handed in
while the rope (or anything it was sent to) is still in flight.

``crc32c(seed)`` folds segment-by-segment with the chained-seed model
(``bufferlist::crc32c``); ``iov()`` exposes the segments for
gather-write; ``to_bytes()`` is the explicit flatten (audited).
"""

from __future__ import annotations

from typing import Iterable, Iterator

from . import copyaudit

_BYTES_LIKE = (bytes, bytearray, memoryview)


def _as_view(data) -> memoryview:
    """A flat uint8 memoryview over `data`, without copying."""
    if isinstance(data, memoryview):
        mv = data
    else:
        # covers bytes/bytearray and any C-contiguous buffer exporter
        # (numpy uint8 arrays included)
        mv = memoryview(data)
    if mv.ndim != 1 or mv.format not in ("B", "b", "c"):
        mv = mv.cast("B")
    return mv


class BufferList:
    """Zero-copy rope of byte segments."""

    __slots__ = ("_segs", "_len")

    def __init__(self, data=None):
        self._segs: list[memoryview] = []
        self._len = 0
        if data is not None:
            self.append(data)

    # -- building ----------------------------------------------------------

    def append(self, data) -> "BufferList":
        """Add a segment (no copy).  Accepts bytes-likes, uint8 numpy
        arrays, and other BufferLists (segment lists are shared)."""
        if isinstance(data, BufferList):
            self._segs.extend(data._segs)
            self._len += data._len
            return self
        mv = _as_view(data)
        if len(mv):
            self._segs.append(mv)
            self._len += len(mv)
        return self

    # -- geometry ----------------------------------------------------------

    def __len__(self) -> int:
        return self._len

    @property
    def num_segments(self) -> int:
        return len(self._segs)

    def is_contiguous(self) -> bool:
        return len(self._segs) <= 1

    # -- slicing (zero-copy) ----------------------------------------------

    def slice(self, off: int, length: int | None = None) -> "BufferList":
        """A sub-rope of [off, off+length) as narrowed views."""
        if off < 0:
            raise ValueError("negative offset")
        if length is None:
            length = self._len - off
        length = max(0, min(length, self._len - off))
        out = BufferList()
        pos = 0
        need = length
        for seg in self._segs:
            if need <= 0:
                break
            seg_len = len(seg)
            if pos + seg_len <= off:
                pos += seg_len
                continue
            start = max(0, off - pos)
            take = min(seg_len - start, need)
            out._segs.append(seg[start:start + take])
            out._len += take
            need -= take
            pos += seg_len
        return out

    def __getitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(self._len)
            if step != 1:
                raise ValueError("BufferList slices must be contiguous")
            return self.slice(start, stop - start)
        if key < 0:
            key += self._len
        if not 0 <= key < self._len:
            raise IndexError("BufferList index out of range")
        pos = 0
        for seg in self._segs:
            if key < pos + len(seg):
                return seg[key - pos]
            pos += len(seg)
        raise IndexError("BufferList index out of range")

    # -- consuming ---------------------------------------------------------

    def iov(self) -> list[memoryview]:
        """The segments, for gather-write / per-segment staging."""
        return list(self._segs)

    def __iter__(self) -> Iterator[memoryview]:
        return iter(self._segs)

    def to_bytes(self) -> bytes:
        """Flatten to one bytes object — THE copy, audited."""
        if not self._segs:
            return b""
        if len(self._segs) == 1:
            # a single segment still materializes a new bytes object
            copyaudit.note("bufferlist.flatten", self._len)
            return bytes(self._segs[0])
        copyaudit.note("bufferlist.flatten", self._len)
        return b"".join(self._segs)

    def __bytes__(self) -> bytes:
        return self.to_bytes()

    def crc32c(self, seed: int = 0) -> int:
        """Chained per-segment CRC32C — no flatten (bufferlist::crc32c)."""
        from ..ops import crc32c as crc_mod
        crc = seed
        for seg in self._segs:
            crc = crc_mod.crc32c(crc, seg)
        return crc

    # -- comparison (no flatten) -------------------------------------------

    def __eq__(self, other) -> bool:
        if isinstance(other, BufferList):
            if other._len != self._len:
                return False
            other = other.iov()
        elif isinstance(other, _BYTES_LIKE):
            if len(other) != self._len:
                return False
            other = [_as_view(other)]
        else:
            return NotImplemented
        # walk both segment lists without materializing either side
        mine = self._segs
        i = j = oi = oj = 0
        while i < len(mine) and oi < len(other):
            a, b = mine[i], _as_view(other[oi])
            n = min(len(a) - j, len(b) - oj)
            if a[j:j + n] != b[oj:oj + n]:
                return False
            j += n
            oj += n
            if j == len(a):
                i, j = i + 1, 0
            if oj == len(b):
                oi, oj = oi + 1, 0
        return True

    def __hash__(self):
        raise TypeError("BufferList is unhashable (mutable rope)")

    def __repr__(self):
        return (f"BufferList(len={self._len}, "
                f"segments={len(self._segs)})")


# ---------------------------------------------------------------------------
# payload helpers shared by the data-path layers
# ---------------------------------------------------------------------------


def wrap_payload(data):
    """Normalize a user payload for zero-copy transport.

    ``bytes``/``memoryview``/``BufferList`` pass through untouched
    (immutable or caller-owned views).  A mutable ``bytearray`` is
    snapshotted — the old ``bytes(data)`` defense, now the only place
    it happens — so callers cannot mutate an in-flight op's payload.
    """
    if isinstance(data, bytearray):
        copyaudit.note("payload.snapshot", len(data))
        return bytes(data)
    if isinstance(data, (bytes, memoryview, BufferList)):
        return data
    # exotic buffer exporters (numpy etc.): wrap as a view
    return _as_view(data)


def iov_of(data) -> list:
    """The gather-write segments of any payload type (no copy)."""
    if isinstance(data, BufferList):
        return data.iov()
    if isinstance(data, _BYTES_LIKE):
        return [data] if len(data) else []
    return [_as_view(data)]


def as_buffer(data):
    """One contiguous buffer for store/denc consumers.

    Single-segment ropes and plain bytes-likes come back as-is (no
    copy); only a fragmented rope flattens (audited inside
    ``to_bytes``)."""
    if isinstance(data, BufferList):
        if data.num_segments == 1:
            return data.iov()[0]
        return data.to_bytes()
    return data


def concat(parts: Iterable) -> BufferList:
    """Rope concatenation: shares every part's segments."""
    out = BufferList()
    for p in parts:
        out.append(p)
    return out
