"""JournalFileStore: write-ahead journal + MemStore state + disk image.

The FileStore analog (os/filestore/FileStore.cc:2048 semantics):
queue_transactions appends the serialized transaction batch to a
write-ahead journal (fsync'd), applies to the in-memory state, and acks
commit once journaled — a crash replays the journal over the last
snapshot on mount (FileJournal + "journal writeahead" mode).  A
background committer periodically snapshots state to disk and trims the
journal (the "sync/commit interval").

Data layout under `path/`:
  journal      append-only record stream; each record is
               <u64 len><u64 seq><u32 crc32c(payload)><payload>
               (FileJournal entry_header_t reduced: the crc makes a
               bit-flipped or bad-length record detectable, the seq
               makes a reordered/resurrected one detectable)
  snapshot     CSN2 <u32 crc32c(body)> <compressed denc state>; the
               state records the journal offset AND the next record
               seq it covers

Recovery contract (the ALICE torn-write findings, OSDI '14, applied):
replay stops cleanly at the first torn or corrupt record, discards the
tail ON DISK (truncate to the last valid record, so later appends
extend a parseable journal), and counts what it dropped
(journal_torn_tail_discards / journal_bad_record_halts).  A corrupt or
truncated snapshot — bad magic, bad crc, failed decompress — falls
back to full-journal replay with a counter and a warning, never a
crash and never silently.

Crash points (FaultSet `crash <prob> <site>` rules, seed-
deterministic): journal.pre_fsync (record written but not fsync'd —
an arbitrary seeded prefix survives, the torn-write model),
journal.post_fsync (durable but unacked), journal.mid_apply,
snapshot.mid_write (torn tmp file), snapshot.pre_rename (complete tmp,
old snapshot still live).  A fired point freezes the store and aborts
the owning daemon without acking.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Callable

from ..ops.crc32c import crc32c
from ..utils import copyaudit, denc
from ..utils.dout import DoutLogger
from ..utils.faults import CrashPoint
from .memstore import MemStore
from .objectstore import StoreError, Transaction

_REC = struct.Struct("<QQI")     # record header: len, seq, payload crc
_SNAP_CRC = struct.Struct("<I")
MAGIC = b"CTJ2"
SNAP_MAGIC = b"CSN2"

# consecutive checkpoint failures before the daemon surfaces a
# HEALTH_WARN (the committer keeps retrying regardless)
CHECKPOINT_WARN_AFTER = 3


class JournalFileStore(MemStore):
    compression = "zlib"     # snapshot codec (compressor registry)

    def __init__(self, path: str, commit_interval: float = 0.2):
        super().__init__()
        self.path = path
        self.commit_interval = commit_interval
        self._journal_path = os.path.join(path, "journal")
        self._snap_path = os.path.join(path, "snapshot")
        self._jf = None
        self._jlock = threading.Lock()
        self._committer: threading.Thread | None = None
        self._stop = threading.Event()
        # a valid journal is never shorter than its magic; an umount
        # before any mount (mkfs-only stores) checkpoints this value,
        # so it must never point a snapshot at offset 0
        self._journal_len = len(MAGIC)
        self._next_seq = 1
        self._ckpt_fails = 0          # consecutive
        self.log = DoutLogger("filestore", path or "?")
        self.counters = {
            "journal_records_replayed": 0,
            "journal_torn_tail_discards": 0,
            "journal_bad_record_halts": 0,
            "journal_tail_bytes_discarded": 0,
            "snapshot_corrupt_fallbacks": 0,
            "journal_checkpoint_errors": 0,
            "journal_checkpoints": 0,
            "fsync_reorder_windows": 0,
        }

    def journal_stats(self) -> dict:
        return dict(self.counters)

    def crash_sites(self) -> list[str]:
        return ["journal.pre_fsync", "journal.post_fsync",
                "journal.mid_apply", "snapshot.mid_write",
                "snapshot.pre_rename", "pglog.append"]

    def health_warning(self) -> str | None:
        n = self._ckpt_fails
        if n >= CHECKPOINT_WARN_AFTER:
            return f"{n} consecutive journal checkpoint failures"
        return None

    # -- lifecycle ---------------------------------------------------------

    def mkfs(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        with open(self._journal_path, "wb") as f:
            f.write(MAGIC)
        self._write_snapshot(len(MAGIC), 1)

    def mount(self) -> None:
        if not os.path.exists(self._journal_path):
            raise FileNotFoundError(f"{self.path} not mkfs'd")
        self.log = DoutLogger("filestore", self.owner or self.path)
        # a stray snapshot.tmp is a checkpoint interrupted mid-write
        # or pre-rename: never read, never trusted — drop it
        try:
            os.unlink(self._snap_path + ".tmp")
        except OSError:
            pass
        self._replay()
        self._jf = open(self._journal_path, "ab")
        self._journal_len = self._jf.tell()
        self._stop.clear()
        self._committer = threading.Thread(target=self._commit_loop,
                                           daemon=True)
        self._committer.start()

    def umount(self) -> None:
        self._stop.set()
        if self._committer:
            self._committer.join(timeout=5)
            self._committer = None
        if not self.frozen:
            try:
                self._checkpoint()
            except CrashPoint:
                pass
        with self._jlock:
            if self._jf:
                self._jf.close()
                self._jf = None

    # -- journaling --------------------------------------------------------

    def queue_transactions(self, txns: list[Transaction],
                           on_commit: Callable | None = None) -> None:
        self._check_frozen()
        # THE write-path flatten: shard views/ropes serialize into one
        # contiguous WAL record here — by design the only place the
        # data path materializes payload bytes (audited)
        batch = denc.dumps([t.ops for t in txns])
        copyaudit.note("journal.append", len(batch))
        from ..ops import hbm_cache
        from ..utils import optracker
        with self._jlock:
            self._check_frozen()
            # traced: the journal span covers lock-held append+fsync
            # (the durability cost a client write pays here); a crash
            # point unwinding through it leaves the span open — the
            # flight recorder then shows the op dead mid-journal
            with optracker.span("journal", bytes=len(batch)):
                # the seq is claimed INSIDE the lock: two racing
                # writers stamping the same seq would read as
                # corruption on replay (wrong-seq halt) and truncate
                # the tail — every acked write behind it would vanish
                record = _REC.pack(len(batch), self._next_seq,
                                   crc32c(0, batch)) + batch
                self._jf.write(record)
                self._jf.flush()
                # crash site: bytes handed to the OS but not fsync'd —
                # a power loss keeps an arbitrary (seeded) prefix
                self._crash_torn_tail("journal.pre_fsync", len(record))
                os.fsync(self._jf.fileno())
                self._next_seq += 1
                self._journal_len = self._jf.tell()
                # crash site: record durable, ack not yet sent
                self._maybe_crash("journal.post_fsync")
            # apply NESTED inside the journal lock: the committer's
            # snapshot cut (_jlock + _apply_lock) must never observe
            # a journal offset past a record whose effects are not in
            # _colls yet — a crash after such a checkpoint replays
            # from past the record and silently drops an acked write.
            # Nesting also pins apply order to journal order, the
            # invariant replay reconstructs state by.  (HBM stripe
            # cache coherence scan runs before the apply; see
            # ObjectStore.queue_transactions for that rationale.)
            with self._apply_lock, optracker.span("store_apply"):
                self._check_frozen()
                for t in txns:
                    hbm_cache.note_store_txn(t.ops)
                for i, t in enumerate(txns):
                    self._do_transaction(t)
                    if i == 0:
                        # crash site: journaled, partially applied to
                        # the (volatile) state, never acked — replay
                        # restores
                        self._maybe_crash("journal.mid_apply")
                # post-apply bump (see ObjectStore.queue_transactions:
                # a pre-apply listing must never cache under the
                # post-apply tick)
                self.mutation_tick += 1
        # journaled == durable: ack applied+committed now
        for t in txns:
            for cb in t.on_applied:
                cb()
            for cb in t.on_commit:
                cb()
        if on_commit:
            on_commit()

    def _crash_torn_tail(self, site: str, rec_len: int) -> None:
        """Roll the crash rules for a torn-write site; on a hit keep a
        seeded prefix of the un-fsync'd record and panic.  With an
        fsync_reorder rule armed, the record's 4 KiB pages instead
        persist as a seeded SUBSET — sectors of one un-fsync'd write
        can land out of order (ALICE's reordering window), so a LATER
        page may be durable while an earlier one reads back as zeros.
        Replay must still honor the prefix promise: it halts at the
        first damaged page (crc/seq) and discards everything after,
        including pages that physically survived."""
        from ..utils import faults
        fs = faults.get()
        if not fs.should_crash(self.owner, site):
            return
        if fs.reorder_armed(self.owner):
            page = 4096
            npages = (rec_len + page - 1) // page
            mask = fs.torn_survivors(self.owner, npages)
            self._jf.flush()
            with open(self._journal_path, "r+b") as f:
                for i, keep in enumerate(mask):
                    if keep:
                        continue
                    start = self._journal_len + i * page
                    end = min(self._journal_len + rec_len, start + page)
                    f.seek(start)
                    f.write(b"\x00" * (end - start))
                f.flush()
                os.fsync(f.fileno())
            self.counters["fsync_reorder_windows"] += 1
        else:
            keep = int(fs.torn_keep_fraction(self.owner) * rec_len)
            self._jf.truncate(self._journal_len + keep)
            self._jf.flush()
            os.fsync(self._jf.fileno())
        self._panic(site)

    # -- recovery ----------------------------------------------------------

    def _load_snapshot(self) -> dict | None:
        """Parse + verify the snapshot; None -> full-journal replay
        (absent on a fresh mkfs is normal; corrupt counts + warns)."""
        if not os.path.exists(self._snap_path):
            return None

        def corrupt(why: str) -> None:
            self.counters["snapshot_corrupt_fallbacks"] += 1
            self.log.warn("snapshot %s %s: falling back to full-journal "
                          "replay", self._snap_path, why)

        with open(self._snap_path, "rb") as f:
            raw = f.read()
        if not raw.startswith(SNAP_MAGIC) or \
                len(raw) < len(SNAP_MAGIC) + _SNAP_CRC.size:
            corrupt("has bad magic")
            return None
        (want_crc,) = _SNAP_CRC.unpack_from(raw, len(SNAP_MAGIC))
        body = raw[len(SNAP_MAGIC) + _SNAP_CRC.size:]
        if crc32c(0, body) != want_crc:
            corrupt("failed its crc")
            return None
        try:
            from ..compressor import decompress_any
            snap = denc.loads(decompress_any(body))
            snap["journal_offset"] = int(snap["journal_offset"])
            snap["journal_seq"] = int(snap.get("journal_seq", 1))
            snap["colls"]
        except Exception as e:
            corrupt(f"failed to decode ({type(e).__name__})")
            return None
        return snap

    def _replay(self) -> None:
        """Load snapshot (or fall back), then re-apply journal records
        past it, halting cleanly at the first torn/corrupt record and
        discarding the unparseable tail on disk."""
        start = len(MAGIC)
        next_seq = 1
        snap = self._load_snapshot()
        self._colls.clear()
        if snap is not None:
            # never below the magic: a snapshot pointing into (or at)
            # the header would make replay parse the magic bytes as a
            # record and truncate them away as an unparseable tail
            start = max(snap["journal_offset"], len(MAGIC))
            next_seq = snap["journal_seq"]
            from .memstore import _Obj
            for cid, objs in snap["colls"].items():
                coll = self._colls[cid] = {}
                for oid, (data, xattrs, omap) in objs.items():
                    o = _Obj()
                    o.data = bytearray(data)
                    o.xattrs = dict(xattrs)
                    o.omap = dict(omap)
                    coll[oid] = o
        with open(self._journal_path, "rb") as f:
            head = f.read(len(MAGIC))
            if head != MAGIC:
                raise IOError(f"bad journal magic in {self._journal_path}")
            f.seek(0, os.SEEK_END)
            journal_end = f.tell()
            f.seek(start)
            good_end = start
            while True:
                hdr = f.read(_REC.size)
                if not hdr:
                    break                      # clean end
                if len(hdr) < _REC.size:
                    self.counters["journal_torn_tail_discards"] += 1
                    break                      # torn header
                blen, seq, want_crc = _REC.unpack(hdr)
                if blen > journal_end - f.tell():
                    # promises more bytes than the file holds: a torn
                    # write OR a corrupted length — either way the
                    # tail is unusable past this point
                    self.counters["journal_torn_tail_discards"] += 1
                    break
                blob = f.read(blen)
                if crc32c(0, blob) != want_crc:
                    self.counters["journal_bad_record_halts"] += 1
                    self.log.warn("journal record seq=%d at %d failed "
                                  "its crc; discarding the tail",
                                  seq, good_end)
                    break
                if seq != next_seq:
                    self.counters["journal_bad_record_halts"] += 1
                    self.log.warn("journal record at %d has seq %d, "
                                  "expected %d; discarding the tail",
                                  good_end, seq, next_seq)
                    break
                for ops in denc.loads(blob):
                    t = Transaction()
                    t.ops = ops
                    try:
                        self._do_transaction(t)
                    except StoreError:
                        # the journal is a WAL: a txn that failed at
                        # LIVE apply time (e.g. a client remove of a
                        # never-created object NACKed with ENOENT)
                        # was still journaled first.  Replay must end
                        # in the same state the live run did — applied
                        # up to the failing op, rest of this record's
                        # batch abandoned — not refuse to mount.
                        break
                self.counters["journal_records_replayed"] += 1
                next_seq = seq + 1
                good_end = f.tell()
        if good_end < journal_end:
            # discard the unparseable tail ON DISK: a later append
            # must extend a valid record stream, not bury garbage
            # mid-journal where the next replay would halt again
            self.counters["journal_tail_bytes_discarded"] += \
                journal_end - good_end
            self.log.warn("discarding %d unparseable journal tail "
                          "bytes past offset %d",
                          journal_end - good_end, good_end)
            os.truncate(self._journal_path, good_end)
        self._next_seq = next_seq

    # -- committer ---------------------------------------------------------

    def _write_snapshot(self, journal_offset: int,
                        journal_seq: int) -> None:
        self._check_frozen()
        state = {
            "journal_offset": journal_offset,
            "journal_seq": journal_seq,
            "colls": {
                cid: {oid: (bytes(o.data), o.xattrs, o.omap)
                      for oid, o in objs.items()}
                for cid, objs in self._colls.items()
            },
        }
        # snapshots are large whole-file blobs: compression cuts the
        # checkpoint's disk footprint and fsync time (the BlueStore
        # blob-compression analog at this store's granularity)
        from ..compressor import create as compressor_create
        body = compressor_create(
            self.compression).compress(denc.dumps(state))
        blob = SNAP_MAGIC + _SNAP_CRC.pack(crc32c(0, body)) + body
        tmp = self._snap_path + ".tmp"
        from ..utils import faults
        fs = faults.get()
        with open(tmp, "wb") as f:
            if fs.should_crash(self.owner, "snapshot.mid_write"):
                if fs.reorder_armed(self.owner):
                    # fsync-reorder window on the CHECKPOINT itself:
                    # the un-fsync'd snapshot pages land as a seeded
                    # SUBSET while the rename metadata commits first —
                    # mount finds a renamed-in snapshot whose body
                    # fails its crc and MUST fall back to full-journal
                    # replay (counted), never trust the torn state
                    page = 4096
                    npages = (len(blob) + page - 1) // page
                    mask = fs.torn_survivors(self.owner, npages)
                    torn = bytearray(blob)
                    for i, keep in enumerate(mask):
                        if not keep:
                            torn[i * page:(i + 1) * page] = \
                                b"\x00" * (min(len(blob),
                                               (i + 1) * page)
                                           - i * page)
                    f.write(torn)      # bytearray: no flatten copy
                    f.flush()
                    os.fsync(f.fileno())
                    f.close()
                    os.replace(tmp, self._snap_path)
                    self.counters["fsync_reorder_windows"] += 1
                    self._panic("snapshot.mid_write")
                # torn tmp: a seeded prefix lands, the rename never
                # happens — the previous snapshot stays authoritative
                keep = int(fs.torn_keep_fraction(self.owner) * len(blob))
                f.write(blob[:keep])
                f.flush()
                os.fsync(f.fileno())
                self._panic("snapshot.mid_write")
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        # crash site: tmp complete+durable but not yet renamed in —
        # mount still reads the OLD snapshot + the full journal
        self._maybe_crash("snapshot.pre_rename")
        os.replace(tmp, self._snap_path)

    def _checkpoint(self) -> None:
        with self._jlock, self._apply_lock, self._lock:
            self._check_frozen()
            self._write_snapshot(self._journal_len, self._next_seq)
            self.counters["journal_checkpoints"] += 1

    def _commit_loop(self) -> None:
        while not self._stop.wait(self.commit_interval):
            try:
                self._checkpoint()
                self._ckpt_fails = 0
            except CrashPoint:
                return         # simulated power loss: die with the store
            except Exception as e:
                # never swallow silently: count, log, and keep the
                # consecutive-failure tally the daemon turns into a
                # HEALTH_WARN after CHECKPOINT_WARN_AFTER in a row
                self.counters["journal_checkpoint_errors"] += 1
                self._ckpt_fails += 1
                self.log.warn("journal checkpoint failed "
                              "(%d consecutive): %s: %s",
                              self._ckpt_fails, type(e).__name__, e)
