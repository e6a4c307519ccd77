"""Abstract erasure-code API + chunking base class.

Semantics follow the reference's ErasureCodeInterface
(src/erasure-code/ErasureCodeInterface.h:171 — init,
get_chunk_count, get_data_chunk_count, get_coding_chunk_count,
get_chunk_size, get_chunk_mapping, minimum_to_decode(_with_cost),
encode/encode_chunks, decode/decode_chunks, decode_concat) and the
chunk-math base class ErasureCode
(src/erasure-code/ErasureCode.cc:75,112 —
encode_prepare pads/aligns, default minimum_to_decode picks the first k
available chunks, decode reconstructs every requested chunk).

Differences, shared with ceph_tpu so chunk layouts interchange:
  * alignment is CHUNK_ALIGN = 128 bytes instead of the reference's
    SIMD_ALIGN = 32 (ceph_tpu chose the TPU lane width; the port keeps
    it so shard files and CRCs are byte-identical);
  * encode/decode accept and return numpy uint8 arrays; bytes are
    accepted for convenience.
"""

from __future__ import annotations

import abc
from typing import Iterable, Mapping, Sequence

import numpy as np

# chunk alignment, identical to ceph_tpu's so layouts interchange
CHUNK_ALIGN = 128


class ErasureCodeError(Exception):
    """Raised for invalid profiles, undecodable chunk sets, bad sizes."""


def _as_u8(buf) -> np.ndarray:
    """uint8 array over `buf` — a VIEW whenever the input is already
    contiguous (bytes, bytearray, memoryview, single-segment
    BufferList); only a fragmented rope gathers (audited)."""
    if isinstance(buf, np.ndarray):
        return np.ascontiguousarray(buf, dtype=np.uint8)
    from ..utils.bufferlist import BufferList
    if isinstance(buf, BufferList):
        if buf.num_segments <= 1:
            segs = buf.iov()
            return (np.frombuffer(segs[0], dtype=np.uint8) if segs
                    else np.empty(0, dtype=np.uint8))
        from ..utils import copyaudit
        out = np.empty(len(buf), dtype=np.uint8)
        off = 0
        for seg in buf:
            out[off: off + len(seg)] = np.frombuffer(seg, dtype=np.uint8)
            off += len(seg)
        copyaudit.note("ec.gather", len(buf))
        return out
    return np.frombuffer(buf, dtype=np.uint8)


class ErasureCodeInterface(abc.ABC):
    """Abstract erasure code: k data + m coding chunks per object."""

    @abc.abstractmethod
    def init(self, profile: Mapping[str, str]) -> None:
        """Initialize from a profile (string key/value map).

        Raises ErasureCodeError on invalid parameters — the analog of the
        reference's nonzero return + error stream.
        """

    @abc.abstractmethod
    def get_chunk_count(self) -> int:
        """k + m."""

    @abc.abstractmethod
    def get_data_chunk_count(self) -> int:
        """k."""

    def get_coding_chunk_count(self) -> int:
        return self.get_chunk_count() - self.get_data_chunk_count()

    @abc.abstractmethod
    def get_chunk_size(self, object_size: int) -> int:
        """Bytes per chunk for an object of `object_size` bytes (padded)."""

    def get_chunk_mapping(self) -> list[int]:
        """chunk index -> shard position; empty list = identity."""
        return []

    @abc.abstractmethod
    def minimum_to_decode(self, want_to_read: Iterable[int],
                          available: Iterable[int]) -> list[int]:
        """Minimum chunk ids needed from `available` to read `want_to_read`.

        Raises ErasureCodeError if impossible.
        """

    def minimum_to_decode_with_cost(self, want_to_read: Iterable[int],
                                    available: Mapping[int, int]) -> list[int]:
        """Like minimum_to_decode but `available` maps chunk -> fetch cost."""
        return self.minimum_to_decode(want_to_read, available.keys())

    @abc.abstractmethod
    def encode(self, want_to_encode: Iterable[int],
               data) -> dict[int, np.ndarray]:
        """Split `data` into k chunks + m parity; return the wanted subset."""

    @abc.abstractmethod
    def encode_chunks(self, data_chunks: np.ndarray) -> np.ndarray:
        """(k, L) uint8 -> (m, L) uint8 parity (L already aligned)."""

    @abc.abstractmethod
    def decode(self, want_to_read: Iterable[int],
               chunks: Mapping[int, np.ndarray],
               chunk_size: int) -> dict[int, np.ndarray]:
        """Reconstruct the wanted chunk ids from the available `chunks`."""

    @abc.abstractmethod
    def decode_chunks(self, want_to_read: Sequence[int],
                      chunks: Mapping[int, np.ndarray]) -> dict[int, np.ndarray]:
        """Low-level reconstruction without size checks."""

    def decode_concat(self, chunks: Mapping[int, np.ndarray]):
        """Reconstruct the k data chunks and return them CONCATENATED
        as a zero-copy BufferList of chunk views (includes padding).
        Intact chunks contribute views over the caller's buffers;
        only rebuilt chunks are fresh arrays — the read-side twin of
        the write path's view discipline (``bytes(rope)`` flattens
        explicitly when a consumer genuinely needs contiguity)."""
        from ..utils.bufferlist import BufferList
        k = self.get_data_chunk_count()
        chunk_size = len(next(iter(chunks.values())))
        out = self.decode(range(k), chunks, chunk_size)
        rope = BufferList()
        for i in range(k):
            rope.append(memoryview(np.ascontiguousarray(out[i])))
        return rope

    # -- what the OSD's EC path sends to the device ------------------------

    def device_backend(self):
        """The TorchBackend whose measured routing serves this codec's
        own region math (the OSD's perf dump reports it), None when the
        codec runs on the host only."""
        return None

    def device_shapes(self, stripes: Iterable[int], unit: int) -> list:
        """Every device call the OSD's EC path can make with this codec
        at chunks of `unit` bytes, for whole objects of each stripe
        count in `stripes`, as matrix_codec.DeviceShape entries (what
        the OSD's `ec warm` warms).  Here the path of this base class:
        encode_stripes_with_crcs encodes stripe by stripe and
        ecutil.decode_object decodes stripe by stripe, up to m lost."""
        return self.stripe_encode_shapes(unit) + self.decode_shapes(
            unit, range(1, self.get_coding_chunk_count() + 1))

    def stripe_encode_shapes(self, unit: int) -> list:
        """The device calls of encode_chunks on one (k, unit) stripe."""
        return []

    def decode_shapes(self, unit: int, lost: Iterable[int]) -> list:
        """The device calls of decode_chunks rebuilding r chunks of one
        stripe of `unit`-byte chunks, for each r in `lost`."""
        return []

    # -- stripe batch API (ECUtil::encode per-stripe loop, collapsed) -----

    def stat_counters(self) -> dict:
        """Encode/decode pass counters, keyed by execution path.  The
        OSD asserts the device path actually ran (observability of the
        north-star claim, not just a perf nicety)."""
        s = getattr(self, "_stat_counters", None)
        if s is None:
            s = self._stat_counters = {
                "host_stripe_passes": 0, "device_stripe_passes": 0}
        return s

    def encode_stripes_with_crcs(
            self, stripes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(S, k, L) data stripes -> ((S, k+m, L) chunks, (S, k+m) crcs).

        The batched analog of ECUtil::encode's per-stripe_width loop
        (src/osd/ECUtil.cc:99-138) with the per-shard
        CRC32C fold of HashInfo::append (ECUtil.cc:140-154) fused in.
        Base implementation runs on host one stripe at a time; codecs
        with a device backend override with one fused pass.
        """
        stripes = np.ascontiguousarray(stripes, dtype=np.uint8)
        if stripes.ndim != 3:
            raise ErasureCodeError(f"want (S, k, L), got {stripes.shape}")
        outs = []
        for s in range(stripes.shape[0]):
            parity = np.asarray(self.encode_chunks(stripes[s]))
            outs.append(np.concatenate([stripes[s], parity], axis=0))
        allc = np.stack(outs)
        return self._finish_host_stripes(allc)

    def _finish_host_stripes(
            self, allc: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Shared host tail: batched per-chunk CRC fold + counter bump."""
        from ..ops import crc32c as crc_mod
        S, C, L = allc.shape
        crcs = crc_mod.crc32c_batch(
            np.ascontiguousarray(allc).reshape(S * C, L)).reshape(S, C)
        self.stat_counters()["host_stripe_passes"] += 1
        return allc, crcs


class ErasureCode(ErasureCodeInterface):
    """Chunk-math base class: padding, shuffling, default decode planning.

    Subclasses set self.k / self.m in init() and implement
    encode_chunks / decode_chunks.
    """

    k: int = 0
    m: int = 0

    # --- profile helpers -------------------------------------------------

    @staticmethod
    def profile_int(profile: Mapping[str, str], key: str, default: int) -> int:
        v = profile.get(key, default)
        try:
            return int(v)
        except (TypeError, ValueError):
            raise ErasureCodeError(f"profile {key}={v!r} is not an integer")

    # --- geometry --------------------------------------------------------

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_alignment(self) -> int:
        """Encode input must pad to k * per-chunk alignment."""
        return self.k * CHUNK_ALIGN

    def get_chunk_size(self, object_size: int) -> int:
        alignment = self.get_alignment()
        padded = -(-object_size // alignment) * alignment
        return padded // self.k

    # --- planning --------------------------------------------------------

    def _have_enough(self, available: set[int]) -> bool:
        return len(available) >= self.k

    def minimum_to_decode(self, want_to_read, available) -> list[int]:
        want = set(want_to_read)
        avail = set(available)
        if want <= avail:
            return sorted(want)
        if not self._have_enough(avail):
            raise ErasureCodeError(
                f"cannot decode {sorted(want)} from {sorted(avail)}")
        # First k available, by chunk id — matches the reference default
        # (ErasureCode::minimum_to_decode picks available data chunks first
        # then fills with coding chunks in id order).
        data = sorted(c for c in avail if c < self.k)
        coding = sorted(c for c in avail if c >= self.k)
        picked = (data + coding)[: self.k]
        return sorted(picked)

    # --- encode / decode -------------------------------------------------

    def encode_prepare(self, data) -> np.ndarray:
        """Pad `data` to k * chunk_size and reshape to (k, chunk_size)."""
        raw = _as_u8(data)
        chunk_size = self.get_chunk_size(raw.size)
        padded = np.zeros(self.k * chunk_size, dtype=np.uint8)
        padded[: raw.size] = raw
        return padded.reshape(self.k, chunk_size)

    def encode(self, want_to_encode, data) -> dict[int, np.ndarray]:
        # allc is chunk-id ordered (data 0..k-1, then parity).  Codecs
        # with a non-identity chunk mapping (LRC) override encode; the
        # base class deliberately does not apply the mapping here.
        chunks = self.encode_prepare(data)
        parity = self.encode_chunks(chunks)
        allc = np.concatenate([chunks, np.asarray(parity)], axis=0)
        out: dict[int, np.ndarray] = {}
        for i in want_to_encode:
            if not 0 <= i < self.get_chunk_count():
                raise ErasureCodeError(f"chunk id {i} out of range")
            out[i] = allc[i]
        return out

    def decode(self, want_to_read, chunks, chunk_size) -> dict[int, np.ndarray]:
        want = list(want_to_read)
        have = {int(i): _as_u8(b) for i, b in chunks.items()}
        for i, b in have.items():
            if b.size != chunk_size:
                raise ErasureCodeError(
                    f"chunk {i} size {b.size} != {chunk_size}")
        missing_want = [i for i in want if i not in have]
        if not missing_want:
            return {i: have[i] for i in want}
        return self.decode_chunks(want, have)
