"""Message model + wire format.

Counterpart of msg/Message.h + the 131 concrete types in messages/ (the
concrete types live next to their subsystems here: mon/messages.py,
osd/messages.py, ...).  Wire format: fixed header (magic, type id,
payload length, seq) + denc-encoded payload fields — an explicit,
versioned, data-only encoding (utils/denc.py), so decoding a hostile or
corrupt frame raises cleanly and can never execute code.

Data segments (CTM2): large byte fields do NOT ride inside the denc
payload.  At encode time the field tree is walked and every bytes-like
leaf >= SEG_THRESHOLD (bytes, bytearray, memoryview, BufferList) is
replaced by a tiny ``_SegRef`` placeholder; the raw bytes ride
out-of-band AFTER the denc payload as an iovec of segments, described
by a segment table between the fixed header and the payload:

    CTM2 header (magic=CTM2, type, body_len, seq)
    u32 nsegs, nsegs * u64 seg length      }  body_len covers the
    denc payload (with _SegRef leaves)     }  table + the payload
    seg 0 bytes ... seg n-1 bytes              (segments follow)

The sender never copies a segment — ``encode_iov`` returns the header,
table, payload and the segment views for a gather write — and the
receiver scatter-reads each segment straight off the socket, so a
payload crosses the messenger without ever being denc-copied into the
field dict and re-joined per send.  Frames with no large fields keep
the CTM1 layout byte-identical (the wire corpus pins it), and decode is
magic-gated: a CTM1 peer's frames always parse.
"""

from __future__ import annotations

import struct
from typing import ClassVar

from ..utils import copyaudit, denc
from ..utils.bufferlist import BufferList

_HDR = struct.Struct("<4sIQQ")        # magic, type, payload_len, seq
MAGIC = b"CTM1"
MAGIC2 = b"CTM2"
_SEG_COUNT = struct.Struct("<I")
_SEG_LEN = struct.Struct("<Q")

# bytes-like fields at or above this size ride out-of-band; below it
# the denc copy is cheaper than a segment-table entry.  Must stay above
# every wire-corpus sample payload so CTM1 framing stays pinned.
SEG_THRESHOLD = 4096
# inline fields at or above this size count as msg.inline host copies
# (below it they are control-field noise, not payload)
_INLINE_AUDIT_FLOOR = 512

_SEG_MAX = 4096            # segments per frame (sanity bound on decode)


@denc.denc_type
class _SegRef:
    """Placeholder a segmented bytes field leaves in the denc tree.
    Needs a real __dict__ (no __slots__): denc encodes instances by
    walking __dict__."""

    def __init__(self, i: int):
        self.i = i

    def __repr__(self):
        return f"_SegRef({self.i})"


def _extract_segments(obj, segs: list):
    """Walk a field tree; large bytes-like leaves move to `segs` and
    are replaced by _SegRef placeholders.  Returns the (possibly
    rebuilt) tree — untouched sub-trees are shared, not copied."""
    if isinstance(obj, BufferList):
        if len(obj) >= SEG_THRESHOLD and len(segs) < _SEG_MAX:
            segs.append(obj)
            return _SegRef(len(segs) - 1)
        return obj.to_bytes()       # small rope: inline (audited)
    if isinstance(obj, (bytes, bytearray, memoryview)):
        if len(obj) >= SEG_THRESHOLD and len(segs) < _SEG_MAX:
            segs.append(obj)
            return _SegRef(len(segs) - 1)
        if len(obj) >= _INLINE_AUDIT_FLOOR:
            # payload-ish field below the segment threshold: it will
            # be denc-copied into the frame — visible to the audit
            # plane (tiny control fields stay unaudited noise)
            copyaudit.note("msg.inline", len(obj))
        return obj
    if isinstance(obj, list):
        out = None
        for i, v in enumerate(obj):
            nv = _extract_segments(v, segs)
            if nv is not v:
                if out is None:
                    out = list(obj)
                out[i] = nv
        return out if out is not None else obj
    if isinstance(obj, tuple):
        items = [_extract_segments(v, segs) for v in obj]
        if any(n is not o for n, o in zip(items, obj)):
            return tuple(items)
        return obj
    if isinstance(obj, dict):
        out = None
        for k, v in obj.items():
            nv = _extract_segments(v, segs)
            if nv is not v:
                if out is None:
                    out = dict(obj)
                out[k] = nv
        return out if out is not None else obj
    return obj


def _substitute_segments(obj, segs: list):
    """Decode-side inverse: _SegRef leaves become the scatter-read
    segment bytes.  Untouched sub-trees are shared, not copied, so
    segment-free messages pass through at walk cost only.

    A _SegRef is attacker-encodable (it is a registered denc type), so
    its index is VALIDATED: out-of-range (or any ref in a frame that
    carried no segments) raises ValueError — the corrupt-frame error
    the messenger's decode handler skips cleanly — and negative
    indices can never silently alias another segment."""
    if isinstance(obj, _SegRef):
        # getattr: denc decodes the raw instance __dict__, so a
        # hostile frame can omit the attribute entirely
        i = getattr(obj, "i", None)
        if not isinstance(i, int) or not 0 <= i < len(segs):
            raise ValueError(
                f"segment ref {i!r} outside {len(segs)} segments")
        return segs[i]
    if isinstance(obj, list):
        out = None
        for i, v in enumerate(obj):
            nv = _substitute_segments(v, segs)
            if nv is not v:
                if out is None:
                    out = list(obj)
                out[i] = nv
        return out if out is not None else obj
    if isinstance(obj, tuple):
        items = [_substitute_segments(v, segs) for v in obj]
        if any(n is not o for n, o in zip(items, obj)):
            return tuple(items)
        return obj
    if isinstance(obj, dict):
        out = None
        for k, v in obj.items():
            nv = _substitute_segments(v, segs)
            if nv is not v:
                if out is None:
                    out = dict(obj)
                out[k] = nv
        return out if out is not None else obj
    return obj


class MessageRegistry:
    _types: dict[int, type] = {}

    @classmethod
    def register(cls, type_id: int, klass: type) -> None:
        existing = cls._types.get(type_id)
        if existing is not None and existing is not klass:
            raise ValueError(
                f"message type {type_id} already bound to {existing}")
        cls._types[type_id] = klass

    @classmethod
    def get(cls, type_id: int) -> type | None:
        return cls._types.get(type_id)


def register_message(klass: type) -> type:
    """Class decorator: requires a TYPE class attr."""
    MessageRegistry.register(klass.TYPE, klass)
    return klass


class Message:
    """Base message: subclasses set TYPE and carry picklable attrs."""

    TYPE: ClassVar[int] = 0

    def __init__(self, **fields):
        self.__dict__.update(fields)
        self.src: str = ""          # entity name, e.g. "osd.3"
        self.seq: int = 0

    # -- wire --------------------------------------------------------------

    def encode_iov(self, seq: int = 0) -> list:
        """Gather-write buffers for this message: [hdr, payload] for a
        segment-free frame (CTM1, byte-identical to the old format) or
        [hdr, segtable, payload, seg...] (CTM2).  Segment buffers are
        the caller's own views — never copied here.

        Underscore-prefixed attrs are LOCAL annotations (a daemon's
        live ``_trk`` TrackedOp, cache-tier ``_cache_internal`` /
        ``_internal_done`` continuations) and never ride the wire —
        they are unencodable live objects, and a trace handle leaking
        into a frame would be a cross-daemon aliasing bug, not data."""
        seg_holders: list = []
        fields = _extract_segments(
            {k: v for k, v in self.__dict__.items()
             if k != "seq" and not k.startswith("_")},
            seg_holders)
        payload = denc.dumps(fields)
        if not seg_holders:
            return [_HDR.pack(MAGIC, self.TYPE, len(payload), seq),
                    payload]
        from ..utils.bufferlist import iov_of
        seg_bufs: list = []
        lens: list[int] = []
        for holder in seg_holders:
            lens.append(len(holder))
            seg_bufs.extend(iov_of(holder))
        table = _SEG_COUNT.pack(len(seg_holders)) + b"".join(
            _SEG_LEN.pack(n) for n in lens)
        hdr = _HDR.pack(MAGIC2, self.TYPE,
                        len(table) + len(payload), seq)
        return [hdr, table, payload, *seg_bufs]

    def encode(self, seq: int = 0) -> bytes:
        """One joined frame (tests/corpus; the messenger gather-writes
        encode_iov instead)."""
        return b"".join(bytes(b) for b in self.encode_iov(seq))

    @staticmethod
    def header_size() -> int:
        return _HDR.size

    @staticmethod
    def parse_header(buf: bytes) -> tuple[int, int, int]:
        """CTM1 header parse (acks, legacy frames)."""
        magic, type_id, plen, seq = _HDR.unpack(buf)
        if magic != MAGIC:
            raise ValueError("bad message magic")
        return type_id, plen, seq

    @staticmethod
    def parse_header_any(buf: bytes) -> tuple[int, int, int, bool]:
        """Magic-gated header parse: (type, body_len, seq, has_segs).
        CTM1 frames parse exactly as before; CTM2 marks the body as
        carrying a segment table."""
        magic, type_id, plen, seq = _HDR.unpack(buf)
        if magic == MAGIC:
            return type_id, plen, seq, False
        if magic == MAGIC2:
            return type_id, plen, seq, True
        raise ValueError("bad message magic")

    @staticmethod
    def parse_seg_table(body: bytes) -> tuple[list[int], bytes]:
        """Split a CTM2 body into (segment lengths, denc payload)."""
        if len(body) < _SEG_COUNT.size:
            raise ValueError("truncated segment table")
        (nsegs,) = _SEG_COUNT.unpack_from(body)
        if nsegs > _SEG_MAX:
            raise ValueError(f"absurd segment count {nsegs}")
        off = _SEG_COUNT.size
        end = off + nsegs * _SEG_LEN.size
        if len(body) < end:
            raise ValueError("truncated segment table")
        lens = [_SEG_LEN.unpack_from(body, off + i * _SEG_LEN.size)[0]
                for i in range(nsegs)]
        return lens, body[end:]

    @staticmethod
    def decode(type_id: int, seq: int, payload: bytes,
               segments: list | None = None) -> "Message":
        klass = MessageRegistry.get(type_id)
        if klass is None:
            raise ValueError(f"unknown message type {type_id}")
        fields = denc.loads(payload)
        if not isinstance(fields, dict):
            raise denc.DencError("message payload must be a field dict")
        # ALWAYS walk: a frame that encodes _SegRef placeholders but
        # carries no (or too few) segments must be rejected here, not
        # leak placeholder objects into message fields
        fields = _substitute_segments(fields, segments or [])
        msg = klass.__new__(klass)
        msg.__dict__.update(fields)
        msg.seq = seq
        return msg

    @staticmethod
    def decode_frame(frame: bytes) -> "Message":
        """Parse one joined frame of either wire version (tools/tests;
        the messenger scatter-reads instead of joining)."""
        hdr = frame[:_HDR.size]
        type_id, plen, seq, has_segs = Message.parse_header_any(hdr)
        body = frame[_HDR.size:_HDR.size + plen]
        if not has_segs:
            return Message.decode(type_id, seq, body)
        lens, payload = Message.parse_seg_table(body)
        segs = []
        off = _HDR.size + plen
        for n in lens:
            segs.append(frame[off:off + n])
            off += n
        return Message.decode(type_id, seq, payload, segs)

    def __repr__(self):
        fields = {k: v for k, v in self.__dict__.items()
                  if k not in ("src", "seq") and not k.startswith("_")}
        inner = ", ".join(f"{k}={v!r}" for k, v in list(fields.items())[:6])
        return f"{type(self).__name__}({inner})"
