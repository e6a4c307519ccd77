"""BlockStore: raw-block ObjectStore — the BlueStore analog.

Model follows os/bluestore/BlueStore.cc semantics re-designed small:
object data lives in a single raw block file at allocator-assigned
extents; ALL metadata (onodes with per-block extent maps + checksums,
omap, collections, the free list, the deferred-write WAL) lives in the
KV tier (os/bluestore/BlueStore.h:413 Onode/Blob/Extent collapsed to a
min_alloc-granularity block map).  The KV commit is the transaction's
durability point, exactly like BlueStore's _kv_sync_thread:

  * big writes go copy-on-write to freshly allocated blocks, the device
    is flushed, THEN the KV commit swaps onode + freelist atomically —
    a crash in between leaves the old onode intact and the new blocks
    still free (no WAL needed, BlueStore's "new allocation" fast path);
  * small writes (<= deferred_max bytes) ride the KV commit itself as a
    deferred-WAL record (BlueStore.h:1169 TransContext STATE_WAL_QUEUED
    analog) and are applied to the block device after commit; mount
    replays any pending records (idempotent pwrites);
  * every min_alloc block carries a crc32c verified on read
    (BlueStore's per-blob csum); mismatch surfaces StoreError(EIO).

Divergence from the reference: clone copies blocks instead of
refcounting shared blobs (correctness-equivalent; COW sharing is a
space optimization), and the freelist is persisted as one coalesced
blob per commit rather than BitmapFreelistManager key-ranges — at this
store's scale the blob is tiny and the swap is atomic by construction.

Crash points (FaultSet `crash <prob> <site>` rules, seed-
deterministic, the ALICE torn-write model applied to KV commits and
extent writes):

  alloc.mid_cow       power loss partway through the COW extent
                      writes: a seeded prefix of one freshly
                      allocated block lands torn.  The committed
                      onode still points at the OLD block, so a
                      remount reads old content whole — never an
                      interleave.
  wal.pre_kv_commit   the KV commit itself is torn: a seeded prefix
                      (or, with an fsync_reorder rule armed, a
                      seeded SUBSET) of the KV transaction's ops
                      land.  Mount verifies freelist-vs-onode
                      consistency and repairs overlaps.
  wal.post_kv_commit  KV commit durable, the deferred-write device
                      applies never ran; mount replays the WAL
                      records (this replaces the old
                      debug_skip_deferred_apply test hook).
  wal.mid_apply       power loss partway through applying deferred
                      WAL writes to the device (one extent torn
                      mid-block); replay rewrites them whole.
  wal.pre_trim        applied + fsync'd, crash before the WAL
                      records are removed from the KV; replay is
                      idempotent.

With an `fsync_reorder` FaultSet rule armed, a crash additionally
rolls back a seeded SUBSET of the device writes buffered since the
last fsync barrier (deferred WAL applies ride un-fsync'd for up to
WAL_FLUSH_EVERY commits) — durable B, lost earlier A — and mount
replay must still repair every acked write bit-exact.
"""

from __future__ import annotations

import os
import threading
from typing import Iterable

from ..kv.keyvaluedb import KeyValueDB, KVTransaction
from ..kv.memdb import MemDB
from ..kv.sqlitedb import SqliteDB
from ..ops.crc32c import crc32c
from ..utils import denc
from .objectstore import (EEXIST, EIO, ENOENT, ObjectStore, StoreError,
                          Transaction)

MIN_ALLOC = 4096               # bluestore_min_alloc_size
DEFERRED_MAX = 64 * 1024       # writes at or under this ride the KV WAL
GROW = 256 * MIN_ALLOC         # device growth increment (1 MiB)
WAL_FLUSH_EVERY = 16           # applied WAL records kept before trim

P_SUPER = "S"
P_COLL = "C"
P_ONODE = "O"
P_OMAP = "M"
P_WAL = "W"


def _okey(cid: str, oid: str) -> str:
    return f"{cid}/{oid}"


class ExtentAllocator:
    """Coalesced free-extent list with first-fit block allocation
    (StupidAllocator's role, os/bluestore/StupidAllocator.cc)."""

    def __init__(self, extents: list[list[int]] | None = None):
        # sorted, non-adjacent [offset, length] runs
        self.free: list[list[int]] = [list(e) for e in (extents or [])]

    def dump(self) -> list[list[int]]:
        return [list(e) for e in self.free]

    def total_free(self) -> int:
        return sum(l for _, l in self.free)

    def allocate(self, nbytes: int) -> list[tuple[int, int]]:
        """Take nbytes (MIN_ALLOC-aligned) of space, possibly split
        across runs; raises if the device must grow first."""
        assert nbytes % MIN_ALLOC == 0
        got: list[tuple[int, int]] = []
        need = nbytes
        i = 0
        while need and i < len(self.free):
            off, length = self.free[i]
            take = min(length, need)
            got.append((off, take))
            need -= take
            if take == length:
                self.free.pop(i)
            else:
                self.free[i][0] += take
                self.free[i][1] -= take
                i += 1
        if need:
            # put partial grabs back and fail up to the caller (grow)
            self.release(got)
            raise MemoryError(f"allocator short {need} bytes")
        return got

    def allocate_at(self, off: int, length: int) -> bool:
        """Carve a SPECIFIC range out of the free list (mount-time
        freelist repair); False if the range is not wholly free."""
        for i, (roff, rlen) in enumerate(self.free):
            if roff <= off and off + length <= roff + rlen:
                self.free.pop(i)
                if off > roff:
                    self._insert(roff, off - roff)
                if off + length < roff + rlen:
                    self._insert(off + length, roff + rlen - off - length)
                return True
        return False

    def release(self, extents: Iterable[tuple[int, int]]) -> None:
        for off, length in extents:
            if not length:
                continue
            self._insert(off, length)

    def _insert(self, off: int, length: int) -> None:
        lo, hi = 0, len(self.free)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.free[mid][0] < off:
                lo = mid + 1
            else:
                hi = mid
        self.free.insert(lo, [off, length])
        # coalesce with neighbours
        if lo + 1 < len(self.free) and \
                self.free[lo][0] + self.free[lo][1] == self.free[lo + 1][0]:
            self.free[lo][1] += self.free[lo + 1][1]
            self.free.pop(lo + 1)
        if lo > 0 and \
                self.free[lo - 1][0] + self.free[lo - 1][1] == self.free[lo][0]:
            self.free[lo - 1][1] += self.free[lo][1]
            self.free.pop(lo)


class _Device:
    """The raw block "device": a file (or a bytearray for path-less
    test stores), pread/pwrite/flush — KernelDevice.cc's role."""

    def __init__(self, path: str):
        self.path = path
        self._f = None
        self._mem = bytearray() if not path else None
        self.size = 0

    def create(self) -> None:
        if self.path:
            with open(self.path, "wb"):
                pass
        self.open()

    def open(self) -> None:
        if self.path:
            if self._f is not None:
                self._f.close()    # mkfs-then-mount must not leak one
            self._f = open(self.path, "r+b")
            self._f.seek(0, os.SEEK_END)
            self.size = self._f.tell()
        else:
            self.size = len(self._mem)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def grow(self, new_size: int) -> None:
        if new_size <= self.size:
            return
        if self._f is not None:
            self._f.truncate(new_size)
        else:
            self._mem.extend(b"\x00" * (new_size - len(self._mem)))
        self.size = new_size

    def pwrite(self, off: int, data: bytes) -> None:
        if self._f is not None:
            self._f.seek(off)
            self._f.write(data)
        else:
            self._mem[off: off + len(data)] = data

    def pread(self, off: int, length: int) -> bytes:
        if self._f is not None:
            self._f.seek(off)
            return self._f.read(length)
        return bytes(self._mem[off: off + length])

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()
            os.fsync(self._f.fileno())


class BlockStore(ObjectStore):
    """Onode format (P_ONODE, denc): {"size", "xattrs",
    "blocks": {block#: [poff, crc32c]}} — absent block# = hole."""

    def __init__(self, path: str = "", deferred_max: int = DEFERRED_MAX):
        super().__init__()
        self.path = path
        self.deferred_max = deferred_max
        self.db: KeyValueDB = SqliteDB(f"{path}/db") if path else MemDB()
        self.dev = _Device(f"{path}/block" if path else "")
        self.alloc = ExtentAllocator()
        self._lock = threading.RLock()
        self._wal_seq = 0
        self._wal_applied: list[str] = []   # applied, not yet trimmed
        self._wal_poffs: set[int] = set()   # extents those records target
        # device writes since the last fsync barrier, with pre-images,
        # recorded only while crash rules are installed: the
        # fsync-reordering model rolls a seeded subset of them back at
        # crash time (durable B, lost earlier A)
        self._unflushed: list[tuple[int, bytes]] = []
        self.counters = {
            "wal_records_replayed": 0,
            "wal_torn_extent_repairs": 0,
            "freelist_repairs": 0,
            "fsync_reorder_windows": 0,
        }

    def journal_stats(self) -> dict:
        return dict(self.counters)

    def crash_sites(self) -> list[str]:
        return ["wal.pre_kv_commit", "wal.post_kv_commit",
                "wal.mid_apply", "wal.pre_trim", "alloc.mid_cow",
                "store.pre_apply", "store.post_apply", "pglog.append"]

    # -- lifecycle ---------------------------------------------------------

    def mkfs(self) -> None:
        if self.path:
            os.makedirs(self.path, exist_ok=True)
            self.db = SqliteDB(f"{self.path}/db")
        self.db.open()
        self.dev.create()
        kvt = self.db.transaction()
        kvt.set(P_SUPER, "super", denc.dumps(
            {"min_alloc": MIN_ALLOC, "dev_size": 0}))
        kvt.set(P_SUPER, "freelist", denc.dumps([]))
        self.db.submit_transaction(kvt, sync=True)

    def mount(self) -> None:
        if self.path and not os.path.exists(f"{self.path}/db"):
            raise FileNotFoundError(f"{self.path}/db")
        self.db.open()
        blob = self.db.get(P_SUPER, "super")
        if blob is None:
            raise StoreError(EIO, "no blockstore superblock")
        super_ = denc.loads(blob)
        self.dev.open()
        # the file may be shorter than the committed dev_size if a grow
        # raced a crash; extend (zeros are fine, blocks are COW)
        self.dev.grow(super_["dev_size"])
        self.alloc = ExtentAllocator(
            denc.loads(self.db.get(P_SUPER, "freelist")))
        self._replay_wal()
        self._verify_freelist()

    def umount(self) -> None:
        if not self.frozen:
            self._flush_deferred()
        self.dev.close()
        self.db.close()

    # -- crash plane -------------------------------------------------------

    def _crash_tracking(self) -> bool:
        from ..utils import faults
        return faults.get().crash_tracking_armed(self.owner)

    def _dev_write(self, poff: int, data: bytes) -> None:
        """All device mutation funnels through here so the reordering
        model can roll un-fsync'd writes back at crash time."""
        if self._crash_tracking():
            self._unflushed.append(
                (poff, self.dev.pread(poff, len(data))))
        self.dev.pwrite(poff, data)

    def _dev_flush(self) -> None:
        """fsync barrier: everything buffered is durable now."""
        self.dev.flush()
        self._unflushed = []

    def _panic(self, site: str) -> None:
        """On simulated power loss, first settle which un-fsync'd
        device writes actually survived: with an fsync_reorder rule
        armed, a seeded SUBSET survives (out-of-order durability) —
        the rest are rolled back to their pre-images."""
        self._apply_crash_reorder()
        super()._panic(site)

    def _apply_crash_reorder(self) -> None:
        from ..utils import faults
        fs = faults.get()
        if not self._unflushed or not fs.reorder_armed(self.owner):
            self._unflushed = []
            return
        mask = fs.torn_survivors(self.owner, len(self._unflushed))
        for (poff, pre), survives in zip(self._unflushed, mask):
            if not survives:
                self.dev.pwrite(poff, pre)
        self.dev.flush()
        self._unflushed = []
        self.counters["fsync_reorder_windows"] += 1

    def _torn_extent_crash(self, site: str,
                           writes: dict[int, bytes]) -> None:
        """Power loss mid-way through a batch of extent writes: a
        seeded number of them land whole, one more lands TORN (a
        prefix of the block), the rest never reach the device."""
        from ..utils import faults
        fs = faults.get()
        items = list(writes.items())
        k = int(fs.torn_keep_fraction(self.owner) * len(items))
        for poff, data in items[:k]:
            self._dev_write(poff, data)
        if k < len(items):
            poff, data = items[k]
            keep = int(fs.torn_keep_fraction(self.owner) * len(data))
            self._dev_write(poff, data[:keep])
        self._panic(site)

    def _maybe_crash_torn_kv(self, site: str, kvt: KVTransaction) -> None:
        """The ALICE torn-write model applied to the KV commit: a
        seeded prefix (or, under the reordering model, a seeded
        subset) of the transaction's ops land as a committed torn
        transaction, then the store dies.  Mount-time freelist
        verification repairs the inconsistent window."""
        from ..utils import faults
        fs = faults.get()
        if not fs.should_crash(self.owner, site):
            return
        ops, reordered = fs.torn_ops(self.owner, kvt.ops)
        if reordered:
            self.counters["fsync_reorder_windows"] += 1
        part = self.db.transaction()
        part.ops = ops
        self.db.submit_transaction(part, sync=True)
        self._panic(site)

    # -- deferred WAL ------------------------------------------------------

    def _replay_wal(self) -> None:
        """Re-apply every pending deferred write (idempotent: targets
        are extents owned by the committed onodes).  A target whose
        on-disk bytes don't already match the record — torn mid-apply,
        lost to an fsync-reorder window, or never applied at all — is
        a repair and counted."""
        pending = list(self.db.iterate(P_WAL, ""))
        for _key, blob in pending:
            for poff, data in denc.loads(blob)["writes"]:
                if self.dev.pread(poff, len(data)) != data:
                    self.counters["wal_torn_extent_repairs"] += 1
                self.dev.pwrite(poff, data)
            self.counters["wal_records_replayed"] += 1
        if pending:
            self.dev.flush()
            kvt = self.db.transaction()
            for key, _ in pending:
                kvt.rmkey(P_WAL, key)
            self.db.submit_transaction(kvt, sync=True)
        self._wal_applied = []
        self._wal_poffs = set()
        self._unflushed = []

    def _verify_freelist(self) -> None:
        """Mount-time consistency pass: a torn KV commit can land an
        onode without its freelist swap (or vice versa), leaving a
        block both referenced and free — the next allocation would
        then overwrite live data.  Carve every referenced extent out
        of the free list (count repairs); leaked-but-unreferenced
        blocks are merely lost space, never corruption."""
        referenced: set[int] = set()
        for _key, blob in self.db.iterate(P_ONODE, ""):
            for poff, _csum in denc.loads(blob)["blocks"].values():
                referenced.add(poff)
        overlaps = [poff for poff in sorted(referenced)
                    if self._freelist_contains(poff)]
        for poff in overlaps:
            ext = self.alloc.allocate_at(poff, MIN_ALLOC)
            if ext:
                self.counters["freelist_repairs"] += 1
        if overlaps:
            kvt = self.db.transaction()
            kvt.set(P_SUPER, "freelist", denc.dumps(self.alloc.dump()))
            self.db.submit_transaction(kvt, sync=True)

    def _freelist_contains(self, poff: int) -> bool:
        for off, length in self.alloc.free:
            if off <= poff < off + length:
                return True
        return False

    def _flush_deferred(self) -> None:
        """fsync the device, then drop applied WAL records — they are
        no longer needed for crash recovery."""
        if not self._wal_applied:
            return
        self._dev_flush()
        # crash site: device durable, WAL records not yet trimmed —
        # mount must replay them idempotently
        self._maybe_crash("wal.pre_trim")
        kvt = self.db.transaction()
        for key in self._wal_applied:
            kvt.rmkey(P_WAL, key)
        self.db.submit_transaction(kvt, sync=True)
        self._wal_applied = []
        self._wal_poffs = set()

    # -- transaction application ------------------------------------------

    def _do_transaction(self, txn: Transaction) -> None:
        with self._lock:
            st = {
                "onodes": {},       # okey -> head dict | None
                "omaps": {},        # "cid/oid/k" -> bytes | None
                "new_colls": set(),
                "kvt": self.db.transaction(),
                "pending": {},      # poff -> block bytes (this txn)
                "direct": {},       # poff -> data, write-before-commit
                "wal": {},          # poff -> data, rides the KV commit
                "allocated": [],    # rollback on failure
                "freed": [],        # released only at commit
            }
            try:
                for op in txn.ops:
                    self._apply_op(op, st)
            except BaseException:
                self.alloc.release(st["allocated"])
                raise
            self._commit(st)

    def _commit(self, st: dict) -> None:
        self._check_frozen()     # crashed: no device or KV write lands
        # traced: the wal span covers COW extent writes + the KV
        # commit + deferred applies — the BlockStore durability cost
        # a write pays, the journal-span analog for this backend
        from ..utils import optracker
        with optracker.span("wal"):
            self._commit_traced(st)

    def _commit_traced(self, st: dict) -> None:
        kvt: KVTransaction = st["kvt"]
        # If a freed extent is still the target of an untrimmed WAL
        # record, trim the WAL first — otherwise a crash after the
        # extent is reused would replay stale bytes over live data
        # (BlueStore sequences deferred txns against reuse the same way).
        if any(off in self._wal_poffs for off, _l in st["freed"]):
            self._flush_deferred()
        # frees take effect with this commit; no further allocations
        # happen in this txn, so in-memory release is safe now
        self.alloc.release(st["freed"])
        if st["direct"]:
            # crash site: power loss mid-way through the COW extent
            # writes — one block lands torn, but the committed onode
            # still points at the old block (old-or-new, never a mix)
            from ..utils import faults
            if faults.get().should_crash(self.owner, "alloc.mid_cow"):
                self._torn_extent_crash("alloc.mid_cow", st["direct"])
            for poff, data in st["direct"].items():
                self._dev_write(poff, data)
            self._dev_flush()
        wal_key = None
        if st["wal"]:
            self._wal_seq += 1
            wal_key = f"{self._wal_seq:016x}"
            kvt.set(P_WAL, wal_key,
                    denc.dumps(
                        {"writes": [[o, d] for o, d in st["wal"].items()]}))
        for okey, head in st["onodes"].items():
            if head is None:
                kvt.rmkey(P_ONODE, okey)
            else:
                kvt.set(P_ONODE, okey, denc.dumps(head))
        for key, val in st["omaps"].items():
            if val is None:
                kvt.rmkey(P_OMAP, key)
            else:
                kvt.set(P_OMAP, key, val)
        kvt.set(P_SUPER, "freelist", denc.dumps(self.alloc.dump()))
        kvt.set(P_SUPER, "super", denc.dumps(
            {"min_alloc": MIN_ALLOC, "dev_size": self.dev.size}))
        # crash site: the KV commit itself tears — a seeded prefix (or
        # reordered subset) of its ops land; mount repairs
        self._maybe_crash_torn_kv("wal.pre_kv_commit", kvt)
        self.db.submit_transaction(kvt, sync=True)
        # ---- commit point ----
        if st["wal"]:
            # crash site: KV durable (the txn is committed), deferred
            # device applies never run — mount replays the WAL record
            self._maybe_crash("wal.post_kv_commit")
            from ..utils import faults
            if faults.get().should_crash(self.owner, "wal.mid_apply"):
                # crash site: power loss partway through the deferred
                # applies, one extent torn mid-block; replay rewrites
                self._torn_extent_crash("wal.mid_apply", st["wal"])
            for poff, data in st["wal"].items():
                self._dev_write(poff, data)
            self._wal_applied.append(wal_key)
            self._wal_poffs.update(st["wal"])
            if len(self._wal_applied) >= WAL_FLUSH_EVERY:
                self._flush_deferred()

    # -- allocation helpers ------------------------------------------------

    def _allocate_block(self, st: dict) -> int:
        try:
            ext = self.alloc.allocate(MIN_ALLOC)
        except MemoryError:
            new_size = self.dev.size + GROW
            self.alloc.release([(self.dev.size, GROW)])
            self.dev.grow(new_size)
            ext = self.alloc.allocate(MIN_ALLOC)
        st["allocated"].extend(ext)
        return ext[0][0]

    # -- onode helpers -----------------------------------------------------

    def _load_onode(self, st: dict, cid: str, oid: str):
        okey = _okey(cid, oid)
        if okey in st["onodes"]:
            return st["onodes"][okey]
        blob = self.db.get(P_ONODE, okey)
        head = denc.loads(blob) if blob is not None else None
        st["onodes"][okey] = head
        return head

    def _onode(self, st: dict, cid: str, oid: str, create: bool) -> dict:
        head = self._load_onode(st, cid, oid)
        if head is None:
            if not create:
                raise StoreError(ENOENT, f"no object {cid}/{oid}")
            if cid not in st["new_colls"] and \
                    self.db.get(P_COLL, cid) is None:
                raise StoreError(ENOENT, f"no collection {cid}")
            head = {"size": 0, "xattrs": {}, "blocks": {}}
            st["onodes"][_okey(cid, oid)] = head
        return head

    def _read_block_raw(self, st: dict, head: dict, blk: int) -> bytes:
        """Current content of a logical block through the txn overlay.
        Device reads ARE csum-verified: an RMW merge over silently
        corrupt bytes would otherwise re-seal them under a fresh valid
        crc and launder the corruption past every future read."""
        ent = head["blocks"].get(blk)
        if ent is None:
            return b""
        poff, csum = ent
        if poff in st["pending"]:
            return st["pending"][poff]
        data = self.dev.pread(poff, MIN_ALLOC)
        if crc32c(0, data) != csum:
            raise StoreError(EIO, f"csum mismatch reading block {blk} "
                                  f"at {poff:#x} for rmw")
        return data

    def _put_block(self, st: dict, head: dict, blk: int,
                   data: bytes, deferred: bool) -> None:
        """COW one logical block: allocate, stage the device write,
        point the onode at it, free the old block."""
        assert len(data) <= MIN_ALLOC
        old = head["blocks"].get(blk)
        if old is not None:
            self._free_block(st, old[0])
        if len(data) < MIN_ALLOC:
            data = data + b"\x00" * (MIN_ALLOC - len(data))
        poff = self._allocate_block(st)
        head["blocks"][blk] = [poff, crc32c(0, data)]
        st["pending"][poff] = data
        (st["wal"] if deferred else st["direct"])[poff] = data

    def _free_block(self, st: dict, poff: int) -> None:
        st["freed"].append((poff, MIN_ALLOC))
        st["pending"].pop(poff, None)
        st["direct"].pop(poff, None)    # a same-txn write to a block we
        st["wal"].pop(poff, None)       # just freed must not hit disk

    def _drop_block(self, st: dict, head: dict, blk: int) -> None:
        ent = head["blocks"].pop(blk, None)
        if ent is not None:
            self._free_block(st, ent[0])

    def _write_span(self, st: dict, head: dict, offset: int,
                    data: bytes, zero: bool = False) -> None:
        deferred = len(data) <= self.deferred_max
        pos = 0
        while pos < len(data):
            blk = (offset + pos) // MIN_ALLOC
            boff = (offset + pos) % MIN_ALLOC
            take = min(len(data) - pos, MIN_ALLOC - boff)
            chunk = data[pos: pos + take]
            if zero and take == MIN_ALLOC:
                self._drop_block(st, head, blk)     # punch a hole
            else:
                if take == MIN_ALLOC:
                    merged = chunk
                else:
                    cur = bytearray(self._read_block_raw(st, head, blk))
                    if len(cur) < boff + take:
                        cur.extend(b"\x00" * (boff + take - len(cur)))
                    cur[boff: boff + take] = chunk
                    merged = bytes(cur)
                if zero and not any(merged):
                    self._drop_block(st, head, blk)
                else:
                    self._put_block(st, head, blk, merged, deferred)
            pos += take

    def _purge(self, st: dict, cid: str, oid: str) -> None:
        head = self._load_onode(st, cid, oid)
        if head is not None:
            for blk in list(head["blocks"]):
                self._drop_block(st, head, blk)
        st["onodes"][_okey(cid, oid)] = None
        for k in self._omap_items(st, cid, oid):
            st["omaps"][f"{cid}/{oid}/{k}"] = None

    def _copy_object(self, st: dict, src_head: dict, dcid: str,
                     doid: str, omap: dict[str, bytes]) -> None:
        self._purge(st, dcid, doid)
        new = {"size": src_head["size"],
               "xattrs": dict(src_head["xattrs"]), "blocks": {}}
        st["onodes"][_okey(dcid, doid)] = new
        # deferred-vs-direct follows the TOTAL copied size, or a large
        # clone would smuggle its whole body into one KV WAL record
        deferred = src_head["size"] <= self.deferred_max
        for blk in sorted(src_head["blocks"]):
            data = self._read_block_raw(st, src_head, blk)
            self._put_block(st, new, blk, data, deferred=deferred)
        for k, val in omap.items():
            st["omaps"][f"{dcid}/{doid}/{k}"] = val

    def _omap_items(self, st: dict, cid: str, oid: str) -> dict[str, bytes]:
        prefix = f"{cid}/{oid}/"
        out = {}
        for key, val in self.db.iterate(P_OMAP, prefix):
            if not key.startswith(prefix):
                break
            out[key[len(prefix):]] = val
        for key, val in st["omaps"].items():
            if key.startswith(prefix):
                k = key[len(prefix):]
                if val is None:
                    out.pop(k, None)
                else:
                    out[k] = val
        return out

    # -- op dispatch -------------------------------------------------------

    def _apply_op(self, op: tuple, st: dict) -> None:
        kind = op[0]
        if kind == "mkcoll":
            _, cid = op
            if self.db.get(P_COLL, cid) is not None or \
                    cid in st["new_colls"]:
                raise StoreError(EEXIST, f"collection {cid} exists")
            st["new_colls"].add(cid)
            st["kvt"].set(P_COLL, cid, b"1")
        elif kind == "rmcoll":
            _, cid = op
            st["kvt"].rmkey(P_COLL, cid)
            st["new_colls"].discard(cid)
            # committed objects
            for key, _v in list(self.db.iterate(P_ONODE, f"{cid}/")):
                if not key.startswith(f"{cid}/"):
                    break
                oid = key[len(cid) + 1:]
                self._purge(st, cid, oid)
            # objects staged earlier in this same txn
            for key in [k for k, h in st["onodes"].items()
                        if h is not None and k.startswith(f"{cid}/")]:
                self._purge(st, cid, key[len(cid) + 1:])
        elif kind == "touch":
            self._onode(st, op[1], op[2], create=True)
        elif kind == "write":
            _, cid, oid, offset, data = op
            head = self._onode(st, cid, oid, create=True)
            self._write_span(st, head, offset, data)
            head["size"] = max(head["size"], offset + len(data))
        elif kind == "zero":
            _, cid, oid, offset, length = op
            head = self._onode(st, cid, oid, create=True)
            self._write_span(st, head, offset, b"\x00" * length, zero=True)
            head["size"] = max(head["size"], offset + length)
        elif kind == "truncate":
            _, cid, oid, size = op
            head = self._onode(st, cid, oid, create=True)
            if size < head["size"]:
                first_dead = (size + MIN_ALLOC - 1) // MIN_ALLOC
                for blk in [b for b in head["blocks"] if b >= first_dead]:
                    self._drop_block(st, head, blk)
                if size % MIN_ALLOC:
                    blk = size // MIN_ALLOC
                    if blk in head["blocks"]:
                        cur = self._read_block_raw(st, head, blk)
                        kept = cur[: size % MIN_ALLOC]
                        if any(kept):
                            self._put_block(
                                st, head, blk, kept,
                                deferred=len(kept) <= self.deferred_max)
                        else:
                            self._drop_block(st, head, blk)
            head["size"] = size
        elif kind in ("remove", "try_remove"):
            _, cid, oid = op
            if self._load_onode(st, cid, oid) is None:
                if kind == "remove":
                    raise StoreError(ENOENT, f"remove {cid}/{oid}")
                return
            self._purge(st, cid, oid)
        elif kind in ("clone", "try_clone"):
            _, cid, src, dst = op
            src_head = self._load_onode(st, cid, src)
            if src_head is None:
                if kind == "try_clone":
                    return
                raise StoreError(ENOENT, f"clone src {cid}/{src}")
            omap = self._omap_items(st, cid, src)
            self._copy_object(st, src_head, cid, dst, omap)
        elif kind == "move":
            _, scid, soid, dcid, doid = op
            src_head = self._load_onode(st, scid, soid)
            if src_head is None:
                raise StoreError(ENOENT, f"move src {scid}/{soid}")
            if dcid not in st["new_colls"] and \
                    self.db.get(P_COLL, dcid) is None:
                raise StoreError(ENOENT, f"no collection {dcid}")
            omap = self._omap_items(st, scid, soid)
            self._copy_object(st, src_head, dcid, doid, omap)
            self._purge(st, scid, soid)
        elif kind == "setattr":
            _, cid, oid, name, value = op
            self._onode(st, cid, oid, create=True)["xattrs"][name] = value
        elif kind == "rmattr":
            _, cid, oid, name = op
            self._onode(st, cid, oid, create=False)["xattrs"].pop(name, None)
        elif kind == "omap_set":
            _, cid, oid, kvs = op
            self._onode(st, cid, oid, create=True)
            for k, v in kvs.items():
                st["omaps"][f"{cid}/{oid}/{k}"] = v
        elif kind == "omap_rm":
            _, cid, oid, keys = op
            self._onode(st, cid, oid, create=False)
            for k in keys:
                st["omaps"][f"{cid}/{oid}/{k}"] = None
        elif kind == "omap_clear":
            _, cid, oid = op
            self._onode(st, cid, oid, create=False)
            for k in self._omap_items(st, cid, oid):
                st["omaps"][f"{cid}/{oid}/{k}"] = None
        else:
            raise StoreError(22, f"blockstore: unknown op {kind!r}")

    # -- reads -------------------------------------------------------------

    def _committed_onode(self, cid: str, oid: str) -> dict:
        blob = self.db.get(P_ONODE, _okey(cid, oid))
        if blob is None:
            raise StoreError(ENOENT, f"no object {cid}/{oid}")
        return denc.loads(blob)

    def read(self, cid: str, oid: str, offset: int = 0,
             length: int = 0) -> bytes:
        self._maybe_eio(oid)
        with self._lock:
            head = self._committed_onode(cid, oid)
            size = head["size"]
            if length == 0:
                length = max(0, size - offset)
            end = min(offset + length, size)
            if end <= offset:
                return b""
            out = bytearray()
            pos = offset
            while pos < end:
                blk = pos // MIN_ALLOC
                boff = pos % MIN_ALLOC
                take = min(end - pos, MIN_ALLOC - boff)
                ent = head["blocks"].get(blk)
                if ent is None:
                    out.extend(b"\x00" * take)
                else:
                    poff, csum = ent
                    data = self.dev.pread(poff, MIN_ALLOC)
                    if crc32c(0, data) != csum:
                        raise StoreError(
                            EIO, f"csum mismatch {cid}/{oid} block {blk}")
                    out.extend(data[boff: boff + take])
                pos += take
            return bytes(out)

    def stat(self, cid: str, oid: str) -> dict:
        with self._lock:
            return {"size": self._committed_onode(cid, oid)["size"]}

    def exists(self, cid: str, oid: str) -> bool:
        with self._lock:
            return self.db.get(P_ONODE, _okey(cid, oid)) is not None

    def getattr(self, cid: str, oid: str, name: str) -> bytes:
        with self._lock:
            xattrs = self._committed_onode(cid, oid)["xattrs"]
            if name not in xattrs:
                raise StoreError(ENOENT, f"no xattr {name}")
            return xattrs[name]

    def getattrs(self, cid: str, oid: str) -> dict[str, bytes]:
        with self._lock:
            return dict(self._committed_onode(cid, oid)["xattrs"])

    def omap_get(self, cid: str, oid: str) -> dict[str, bytes]:
        with self._lock:
            self._committed_onode(cid, oid)
            prefix = f"{cid}/{oid}/"
            out = {}
            for key, val in self.db.iterate(P_OMAP, prefix):
                if not key.startswith(prefix):
                    break
                out[key[len(prefix):]] = val
            return out

    def omap_get_values(self, cid: str, oid: str,
                        keys: Iterable[str]) -> dict[str, bytes]:
        omap = self.omap_get(cid, oid)
        return {k: omap[k] for k in keys if k in omap}

    def list_collections(self) -> list[str]:
        with self._lock:
            return sorted(k for k, _ in self.db.iterate(P_COLL, ""))

    def collection_exists(self, cid: str) -> bool:
        with self._lock:
            return self.db.get(P_COLL, cid) is not None

    def collection_list(self, cid: str, start: str = "",
                        max_count: int = 0) -> list[str]:
        with self._lock:
            if self.db.get(P_COLL, cid) is None:
                raise StoreError(ENOENT, f"no collection {cid}")
            prefix = f"{cid}/"
            names = []
            # seed the iterator at the resume point, or paging a big
            # collection (backfill/scrub) rescans from the front each
            # page — O(N^2/k) over the whole scan
            for key, _v in self.db.iterate(P_ONODE, prefix + start):
                if not key.startswith(prefix):
                    break
                name = key[len(prefix):]
                if name > start:
                    names.append(name)
                    if max_count and len(names) >= max_count:
                        break
            return names
