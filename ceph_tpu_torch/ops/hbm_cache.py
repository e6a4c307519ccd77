"""HBM-resident EC stripe cache: bytes cross the host<->device
boundary at most once per object lifetime.

Counterpart of ``ceph_tpu/ops/hbm_cache.py``.  An OSD's EC working set
is written once and then re-touched by deep scrub (CRC folds over the
same shard bytes) and recovery (decodes of the same stripes) — so after
the write's single H2D upload the encoded stripes simply STAY in the
card's memory:

  * the pipeline stages an entry at collect time (tensor slices of the
    uploaded data and the computed parity — no extra transfer, both are
    already on the card) keyed (pg collection, oid);
  * the producer COMMITS the entry once the shard bytes landed in the
    object store, so the cache can never be ahead of disk;
  * deep scrub serves shard CRCs from the entry's per-stripe chunk
    CRCs (a host-side carry-less fold of 4-byte values — ZERO bytes
    re-uploaded, zero device dispatches);
  * recovery/degraded reads fetch the wanted shard rows D2H straight
    from the cached tensors — no shard gather, no decode, no H2D.

Entries are CUDA tensors produced on a pipeline lane's stream.  Each
entry keeps an event recorded on that stream after the producing work:
a fetch from any other thread first makes its own stream wait on that
event, so a read can never race the kernel that wrote the bytes.
Fetches copy D2H into fresh pinned memory (counted in ``bytes_d2h``).
On a CPU package device the entries are CPU tensors and the same code
runs without streams.

Coherence is enforced at the OBJECT STORE layer, not by trusting
producers: every applied transaction is scanned
(:func:`note_store_txn`) and any data mutation of a cached object's
shard files invalidates the entry — UNLESS the same transaction
attests the entry's exact version via the per-shard version xattr
(the EC write fan-out and recovery pushes of the same version are the
cached content landing on more shards, not new content).  A raw
store write with no version attestation — silent bitrot, a test
poking corruption in, a rollback stash restore — always invalidates,
so a cache hit is as trustworthy as the disk read it replaces and
deep scrub keeps catching real corruption.

Quarantine-aware eviction: entries are pinned to the pipeline lane
whose card holds them; when a lane quarantines (device error, real or
injected) its entries drop immediately — a redrain re-uploads from host
rather than ever serving shards from a card in an unknown state.

A mesh dispatch's entries are MESH-RESIDENT: their stripes stay split
across the plane's members (:class:`~ceph_tpu_torch.ops.ec_kernels.MeshRows`,
each chunk front-padded by the plane's chunk pad), they are pinned to
the tuple of member lanes, and a quarantine of any member drops them.
Their reads gather the members' slices and cut the pad; they do no
append-through.

Capacity is bounded by ``osd_ec_hbm_cache_bytes`` (LRU on committed
entries); 0 disables the cache entirely.
"""

from __future__ import annotations

import ast
import threading
from collections import OrderedDict

import numpy as np
import torch

from ..utils import optracker
from .ec_kernels import MeshRows

DEFAULT_CAPACITY = 64 << 20
MAX_PENDING = 64

# per-shard version xattr (osd/pglog.py VER_KEY): the store-txn
# coherence scan parses it to recognize same-version fan-out writes.
# Duplicated here because the ops layer must not import the osd layer.
_VER_ATTR = "_v"


def _base_name(name: str) -> str:
    """Base object of a shard/stash file name: 'oid.s3@1.7' -> 'oid'."""
    base = name.split("@", 1)[0]
    stem, _, sfx = base.rpartition(".s")
    if sfx.isdigit():
        return stem
    return base


def _parse_ver(blob: bytes) -> tuple | None:
    try:
        ev = ast.literal_eval(blob.decode())
    except (ValueError, SyntaxError, UnicodeDecodeError, AttributeError):
        return None
    return tuple(ev) if isinstance(ev, tuple) else None


def _on_lane(entry_lane, lane: int) -> bool:
    """Whether an entry is resident on `lane`: a mesh-resident entry
    pins the tuple of its member lanes, and losing any one of them loses
    a slice of its stripes."""
    if isinstance(entry_lane, tuple):
        return lane in entry_lane
    return entry_lane == lane


def _ready_event(t: torch.Tensor, stream) -> "torch.cuda.Event | None":
    """An event on `stream` (default: the current stream of t's device)
    after the work queued so far: readers wait on it."""
    if t.device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(stream if stream is not None
              else torch.cuda.current_stream(t.device))
    return ev


def to_host(tensors, ready=None) -> tuple:
    """D2H of device tensors into fresh pinned memory on the current
    stream, after it waited on `ready` (an event of the producing
    stream), with one wait for all the copies; CPU tensors come back as
    their numpy views."""
    host = []
    for t in tensors:
        if t.device.type != "cuda":
            host.append(t.numpy())
            continue
        stream = torch.cuda.current_stream(t.device)
        if ready is not None:
            stream.wait_event(ready)
        u32 = t.dtype == torch.uint32
        src = (t.view(torch.int32) if u32 else t).contiguous()
        dst = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        dst.copy_(src, non_blocking=True)
        host.append((dst, u32, stream))
    for stream in {h[2] for h in host if isinstance(h, tuple)}:
        stream.synchronize()
    return tuple(h if isinstance(h, np.ndarray)
                 else (h[0].numpy().view(np.uint32) if h[1]
                       else h[0].numpy())
                 for h in host)


class CacheIntent:
    """Producer-side tag riding a pipeline submission: 'if this encode
    runs on a device, keep its stripes on the card under this key'."""

    __slots__ = ("cid", "oid", "version", "size", "chunk_size")

    def __init__(self, cid: str, oid: str, version: tuple,
                 size: int, chunk_size: int):
        self.cid = cid
        self.oid = oid
        self.version = tuple(version)
        self.size = int(size)
        self.chunk_size = int(chunk_size)


class CacheEntry:
    """One object's encoded stripes, device-resident.

    dev_data (S, k, L) is the uploaded data batch, dev_parity
    (S, m, L) the on-device encode output — both uint8 tensors still on
    the lane's card; crcs (S, k+m) uint32 are the fused kernel's
    per-stripe chunk CRCs (host-side, 4 bytes per chunk).  `ready` is
    an event of the producing stream after both tensors were written.
    A mesh dispatch's entry holds both as :class:`MeshRows` across the
    plane's members, `lane` is the tuple of member lanes and `pad` the
    zero bytes each chunk was front-padded with (the mesh run waited
    for its members, so it needs no event)."""

    __slots__ = ("cid", "oid", "version", "size", "chunk_size", "k",
                 "m", "dev_data", "dev_parity", "crcs", "lane", "pad",
                 "ready", "nbytes", "committed", "lane_dropped")

    def __init__(self, intent: CacheIntent, lane, dev_data,
                 dev_parity, crcs: np.ndarray, stream=None,
                 pad: int = 0):
        self.cid = intent.cid
        self.oid = intent.oid
        self.version = intent.version
        self.size = intent.size
        self.chunk_size = intent.chunk_size
        mesh = isinstance(dev_data, MeshRows)
        self.dev_data = dev_data if mesh else torch.as_tensor(dev_data)
        self.dev_parity = dev_parity if mesh \
            else torch.as_tensor(dev_parity)
        self.k = int(self.dev_data.shape[1])
        self.m = int(self.dev_parity.shape[1])
        self.crcs = np.asarray(crcs, dtype=np.uint32)
        self.lane = lane
        self.pad = int(pad)
        self.ready = None if mesh else _ready_event(self.dev_data, stream)
        self.nbytes = (self.dev_data.numel() + self.dev_parity.numel()
                       + self.crcs.nbytes)
        self.committed = False
        # set when the entry's lane quarantined and the cache dropped
        # it: the card's memory is in an unknown state, so a failed
        # fetch from it is the expected "gone", not an error to raise
        self.lane_dropped = False

    @property
    def stripes(self) -> int:
        return int(self.crcs.shape[0])

    def shard_size(self) -> int:
        return self.stripes * self.chunk_size

    def _fetch(self, src: torch.Tensor) -> np.ndarray | None:
        """`src` copied D2H, or None when the fetch failed because the
        entry is gone (its lane quarantined and the cache dropped it).
        Any other device error raises: the caller must not quietly
        serve the store instead of reporting a broken card."""
        try:
            if isinstance(src, MeshRows):
                arr = src.to_host()
            else:
                (arr,) = to_host((src,), self.ready)
        except RuntimeError:
            if self.lane_dropped:
                return None
            raise
        get().count_d2h(arr.nbytes)
        return arr

    def data_bytes(self):
        """The logical object payload, fetched D2H from the cached
        data stripes (None if the entry is gone, see `_fetch`).
        Returns a zero-copy BufferList VIEW over the fetched array —
        the D2H fetch is the only materialization a cache-served read
        pays."""
        arr = self._fetch(self.dev_data)
        if arr is None:
            return None
        if self.pad:
            # cutting each chunk's front pad leaves a strided view, and
            # one rope needs it contiguous: a host copy on the read path
            arr = np.ascontiguousarray(arr[:, :, self.pad:])
            from ..utils import copyaudit
            copyaudit.note("cache.mesh_unpad", arr.nbytes)
        else:
            arr = np.ascontiguousarray(arr)
        from ..utils.bufferlist import BufferList
        rope = BufferList(memoryview(arr.reshape(-1))[: self.size])
        get().count_read_hit_bytes(self.size)
        return rope

    def shard_bytes(self, shard: int) -> bytes | None:
        """One shard file's bytes (chunk `shard` of every stripe),
        fetched D2H — only this shard's rows cross the boundary (None
        if the entry is gone, see `_fetch`)."""
        if isinstance(self.dev_data, MeshRows):
            src = self.dev_data.select(shard) if shard < self.k \
                else self.dev_parity.select(shard - self.k)
        else:
            src = self.dev_data[:, shard] if shard < self.k \
                else self.dev_parity[:, shard - self.k]
        arr = self._fetch(src)
        return None if arr is None else arr[:, self.pad:].tobytes()


class HbmStripeCache:
    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple, CacheEntry] = OrderedDict()
        self._pending: OrderedDict[tuple, CacheEntry] = OrderedDict()
        self._bases: set[tuple] = set()     # committed + pending keys
        self._bytes = 0                     # committed entries
        self._pbytes = 0                    # pending (staged) entries
        self._c = {"hit": 0, "miss": 0, "evict": 0, "insert": 0,
                   "invalidate": 0, "lane_drops": 0, "bytes_d2h": 0,
                   "read_bytes_served": 0, "append_throughs": 0}

    # -- accounting (entry fetches call back in) ---------------------------

    def count_d2h(self, n: int) -> None:
        with self._lock:
            self._c["bytes_d2h"] += int(n)

    def count_read_hit_bytes(self, n: int) -> None:
        """Logical payload bytes a read served from the cache (the
        bench's read_cache_gbs numerator)."""
        with self._lock:
            self._c["read_bytes_served"] += int(n)

    # -- write path --------------------------------------------------------

    def stage(self, intent: CacheIntent, lane, dev_data,
              dev_parity, crcs: np.ndarray, stream=None,
              pad: int = 0) -> None:
        """Pipeline collect-time staging: the entry exists but is NOT
        servable until the producer commits it (shard bytes on disk).
        `stream` is the stream that produced the tensors (default: the
        caller's current stream).  A mesh dispatch passes the tuple of
        member lanes as `lane`, :class:`MeshRows` and the chunk pad."""
        if self.capacity <= 0:
            return
        try:
            ent = CacheEntry(intent, lane, dev_data, dev_parity, crcs,
                             stream=stream, pad=pad)
        except (TypeError, ValueError, IndexError, RuntimeError):
            return
        if ent.nbytes > self.capacity:
            return
        key = (ent.cid, ent.oid)
        with self._lock:
            old = self._pending.pop(key, None)
            if old is not None:
                self._pbytes -= old.nbytes
            self._pending[key] = ent
            self._pbytes += ent.nbytes
            self._bases.add(key)
            # pending entries pin device memory just like committed
            # ones: bound the TOTAL resident bytes by the configured
            # budget (an orphaned stage — producer died before commit —
            # must not overcommit the card).  Committed LRU victims go
            # first — commit() would evict exactly them on promotion
            # anyway; staler pendings go after
            while self._bytes + self._pbytes > self.capacity and \
                    self._entries:
                k2, old = self._entries.popitem(last=False)
                self._bytes -= old.nbytes
                self._c["evict"] += 1
                if k2 not in self._pending:
                    self._bases.discard(k2)
            while self._pending and (
                    len(self._pending) > MAX_PENDING or
                    self._bytes + self._pbytes > self.capacity):
                old_key, old = self._pending.popitem(last=False)
                self._pbytes -= old.nbytes
                if old_key not in self._entries:
                    self._bases.discard(old_key)

    def append_through(self, cid: str, oid: str, old_version: tuple,
                       new_version: tuple, new_size: int,
                       chunk_size: int, full_before: int,
                       tail_data, tail_parity,
                       tail_crcs: np.ndarray) -> bool:
        """APPEND write-through: derive the appended object's entry
        from the resident whole-object stripes plus the tail encode's
        (S_tail, k, L) data / (S_tail, m, L) parity stripes (host
        arrays) — only the tail is uploaded, and ``torch.cat`` joins it
        to the untouched full-stripe prefix on the entry's device, so
        the prefix never leaves the card.  Stages a PENDING entry at
        `new_version` (the producer commits once the shard tail bytes
        are on disk, the same contract as a whole-object write); the
        store-txn scan then drops the old committed entry (its version
        is not attested) while the attested pending one survives.

        Returns False — after invalidating, so a stale whole-object
        entry can never outlive the append — when there is no
        resident entry at exactly `old_version` with this geometry,
        or the device-side concatenation fails; the caller loses
        nothing but the write-through."""
        key = (cid, oid)
        with self._lock:
            ent = self._entries.get(key) or self._pending.get(key)
        if self.capacity <= 0:
            return False
        if ent is None or ent.version != tuple(old_version) or \
                ent.chunk_size != chunk_size or \
                ent.stripes < full_before or \
                isinstance(ent.lane, tuple) or ent.pad:
            # mesh-resident entries do no append-through: the tail would
            # have to be split across the members again; the next whole
            # write stages the object anew
            self.invalidate(cid, oid)
            return False
        try:
            dev = ent.dev_data.device
            stream = None
            if dev.type == "cuda":
                stream = torch.cuda.current_stream(dev)
                if ent.ready is not None:
                    stream.wait_event(ent.ready)
                # the prefix tensors were allocated on the lane's
                # stream: keep their memory from being handed out again
                # before this stream's reads of them are done
                ent.dev_data.record_stream(stream)
                ent.dev_parity.record_stream(stream)
            td = torch.from_numpy(np.ascontiguousarray(
                tail_data, dtype=np.uint8)).to(dev)
            tp = torch.from_numpy(np.ascontiguousarray(
                tail_parity, dtype=np.uint8)).to(dev)
            new_d = torch.cat([ent.dev_data[:full_before], td]) \
                if full_before else td
            new_p = torch.cat([ent.dev_parity[:full_before], tp]) \
                if full_before else tp
            new_crcs = np.concatenate(
                [ent.crcs[:full_before],
                 np.asarray(tail_crcs, dtype=np.uint32)])
        except (RuntimeError, ValueError, TypeError):
            self.invalidate(cid, oid)
            return False
        intent = CacheIntent(cid, oid, tuple(new_version),
                             int(new_size), chunk_size)
        self.stage(intent, ent.lane, new_d, new_p, new_crcs, stream=stream)
        with self._lock:
            self._c["append_throughs"] += 1
        return True

    def commit(self, cid: str, oid: str, version: tuple) -> bool:
        """Promote the staged entry for (cid, oid) at `version`: the
        producer's store transaction applied, disk and HBM now agree."""
        key = (cid, oid)
        version = tuple(version)
        with optracker.span("ec.cache_commit"), self._lock:
            ent = self._pending.get(key)
            if ent is None or ent.version != version:
                return False
            del self._pending[key]
            self._pbytes -= ent.nbytes
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            ent.committed = True
            self._entries[key] = ent
            self._bases.add(key)
            self._bytes += ent.nbytes
            self._c["insert"] += 1
            while self._bytes > self.capacity and self._entries:
                k2, old = self._entries.popitem(last=False)
                self._bytes -= old.nbytes
                self._c["evict"] += 1
                if k2 not in self._pending:
                    self._bases.discard(k2)
            return True

    # -- read path ---------------------------------------------------------

    def lookup(self, cid: str, oid: str,
               version: tuple | None = None) -> CacheEntry | None:
        key = (cid, oid)
        with self._lock:
            ent = self._entries.get(key)
            if ent is None or (version is not None
                               and ent.version != tuple(version)):
                self._c["miss"] += 1
                return None
            self._entries.move_to_end(key)
            self._c["hit"] += 1
            return ent

    # -- invalidation ------------------------------------------------------

    def _drop_locked(self, key: tuple) -> None:
        ent = self._entries.pop(key, None)
        if ent is not None:
            self._bytes -= ent.nbytes
            self._c["invalidate"] += 1
        pend = self._pending.pop(key, None)
        if pend is not None:
            self._pbytes -= pend.nbytes
            if ent is None:
                self._c["invalidate"] += 1
        self._bases.discard(key)

    def invalidate(self, cid: str, oid: str) -> None:
        with self._lock:
            self._drop_locked((cid, oid))

    def invalidate_cid(self, cid: str) -> None:
        with self._lock:
            for key in [k for k in self._bases if k[0] == cid]:
                self._drop_locked(key)

    def note_mutation(self, cid: str, base: str,
                      attested: set[tuple]) -> None:
        """A store transaction mutated shard data of (cid, base).
        Keep the entry only when the txn attested the entry's exact
        version (same-version fan-out / recovery push of the cached
        content); anything else — corruption, rewind, a newer write —
        invalidates."""
        key = (cid, base)
        with self._lock:
            # committed and pending are judged INDEPENDENTLY: an
            # overwrite's txn attests the NEW version, which must keep
            # the fresh pending entry (its commit follows) while
            # dropping the stale committed one
            dropped = False
            ent = self._entries.get(key)
            if ent is not None and ent.version not in attested:
                del self._entries[key]
                self._bytes -= ent.nbytes
                dropped = True
            pend = self._pending.get(key)
            if pend is not None and pend.version not in attested:
                del self._pending[key]
                self._pbytes -= pend.nbytes
                dropped = True
            if dropped:
                self._c["invalidate"] += 1
            if key not in self._entries and key not in self._pending:
                self._bases.discard(key)

    def drop_lane(self, lane: int) -> None:
        """Quarantine-aware eviction: a quarantined card's entries are
        gone — redrain re-uploads from host, never serves stale memory.
        Only entries RESIDENT on that lane drop; the same object's
        committed/pending counterpart on a healthy lane survives."""
        with self._lock:
            dropped = 0
            for key in [k for k, e in self._entries.items()
                        if _on_lane(e.lane, lane)]:
                ent = self._entries.pop(key)
                ent.lane_dropped = True
                self._bytes -= ent.nbytes
                dropped += 1
                if key not in self._pending:
                    self._bases.discard(key)
            for key in [k for k, e in self._pending.items()
                        if _on_lane(e.lane, lane)]:
                pend = self._pending.pop(key)
                pend.lane_dropped = True
                self._pbytes -= pend.nbytes
                dropped += 1
                if key not in self._entries:
                    self._bases.discard(key)
            if dropped:
                self._c["lane_drops"] += dropped

    def drop_cids(self, cids) -> None:
        """Crash/abort of a daemon: every entry of its pg collections
        goes — a restarted daemon starts COLD, and in-process replicas
        of the same pg share the cid key, so the conservative drop is
        the only one that can never serve stripes whose backing store
        just lost its tail."""
        wanted = set(cids)
        if not wanted:
            return
        with self._lock:
            for key in [k for k in self._bases if k[0] in wanted]:
                self._drop_locked(key)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._pending.clear()
            self._bases.clear()
            self._bytes = 0
            self._pbytes = 0

    # -- store-txn coherence scan ------------------------------------------

    _DATA_OPS = {"write": 2, "zero": 2, "truncate": 2, "remove": 2,
                 "try_remove": 2, "clone": 3, "try_clone": 3}

    def note_txn_ops(self, ops: list[tuple]) -> None:
        """Scan one applied transaction's ops for mutations of cached
        objects' shard files (see module docstring for the
        version-attestation rule).  Cheap when nothing relevant is
        cached: one set lookup per mutating op.

        Ops targeting rollback STASH objects ('@' in the name — the
        same rule the scrubber skips them by) are not shard-file
        mutations: stashing a copy aside or trimming an acked stash
        never changes the current shard bytes (every EC write would
        otherwise self-invalidate at stash-trim time).  A stash
        RESTORE writes to the shard file itself and is caught by its
        destination name."""
        touched: dict[tuple, set] = {}
        mutated: set[tuple] = set()
        for op in ops:
            kind = op[0]
            idx = self._DATA_OPS.get(kind)
            if idx is not None:
                if "@" in op[idx]:
                    continue
                key = (op[1], _base_name(op[idx]))
                if key in self._bases:
                    mutated.add(key)
                    touched.setdefault(key, set())
            elif kind == "move":
                for cid, name in ((op[1], op[2]), (op[3], op[4])):
                    if "@" in name:
                        continue
                    key = (cid, _base_name(name))
                    if key in self._bases:
                        mutated.add(key)
                        touched.setdefault(key, set())
            elif kind == "setattr" and op[3] == _VER_ATTR:
                key = (op[1], _base_name(op[2]))
                if key in self._bases:
                    ver = _parse_ver(op[4])
                    if ver is not None:
                        touched.setdefault(key, set()).add(ver)
            elif kind == "rmcoll":
                if any(k[0] == op[1] for k in self._bases):
                    self.invalidate_cid(op[1])
        for key in mutated:
            self.note_mutation(key[0], key[1], touched.get(key, set()))

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._c)
            out["entries"] = len(self._entries)
            out["pending"] = len(self._pending)
            out["bytes"] = self._bytes
            out["pending_bytes"] = self._pbytes
            out["capacity"] = self.capacity
        return out

    def shrink_to_capacity(self) -> None:
        """LRU-evict committed (then oldest pending) entries until the
        resident bytes fit the current capacity — a runtime capacity
        DECREASE takes effect immediately, not at the next commit."""
        with self._lock:
            while self._bytes + self._pbytes > self.capacity and \
                    self._entries:
                key, old = self._entries.popitem(last=False)
                self._bytes -= old.nbytes
                self._c["evict"] += 1
                if key not in self._pending:
                    self._bases.discard(key)
            while self._bytes + self._pbytes > self.capacity and \
                    self._pending:
                key, old = self._pending.popitem(last=False)
                self._pbytes -= old.nbytes
                if key not in self._entries:
                    self._bases.discard(key)


# ---------------------------------------------------------------------------
# Process-wide singleton (the pipeline, every OSD in the process and
# the object stores all see one cache — same sharing model as the
# dispatch pipeline itself).
# ---------------------------------------------------------------------------

_global: HbmStripeCache | None = None
_glock = threading.Lock()


def get() -> HbmStripeCache:
    global _global
    if _global is None:
        with _glock:
            if _global is None:
                _global = HbmStripeCache()
    return _global


def configure(capacity_bytes: int | None = None) -> HbmStripeCache:
    c = get()
    if capacity_bytes is not None:
        c.capacity = int(capacity_bytes)
        if c.capacity <= 0:
            c.clear()
        else:
            c.shrink_to_capacity()
    return c


def note_store_txn(ops: list[tuple]) -> None:
    """Object-store hook: called for every applied transaction.  No-op
    (one attribute read) until something is cached."""
    c = _global
    if c is None or not c._bases:
        return
    try:
        c.note_txn_ops(ops)
    except Exception:
        # coherence scan must never fail a store apply; drop the whole
        # cache instead of risking a stale entry
        c.clear()


def stats() -> dict:
    return get().stats()
