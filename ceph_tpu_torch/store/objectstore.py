"""Transaction model + abstract ObjectStore.

Transaction op set follows os/ObjectStore.h:1041 ff (touch, write, zero,
truncate, remove, setattrs, rmattr, clone, omap ops, collection ops);
queue_transactions (:1453) applies asynchronously and fires on_applied /
on_commit callbacks, apply_transactions (:1429) is the synchronous
wrapper.  Object identity is (collection, object-name); sort order of
object names is the PG-scan order used by backfill and scrub.
"""

from __future__ import annotations

import abc
import threading
from typing import Callable, Iterable

from ..utils.bufferlist import as_buffer
from ..utils.faults import CrashPoint

ENOENT = 2
EEXIST = 17
EIO = 5


class StoreError(Exception):
    def __init__(self, errno_: int, msg: str = ""):
        super().__init__(msg or f"errno {errno_}")
        self.errno = errno_


class Transaction:
    """An ordered list of mutations applied atomically."""

    def __init__(self):
        self.ops: list[tuple] = []
        self.on_applied: list[Callable] = []
        self.on_commit: list[Callable] = []

    # -- collection ops ----------------------------------------------------

    def create_collection(self, cid: str) -> "Transaction":
        self.ops.append(("mkcoll", cid))
        return self

    def remove_collection(self, cid: str) -> "Transaction":
        self.ops.append(("rmcoll", cid))
        return self

    # -- object data ops ---------------------------------------------------

    def touch(self, cid: str, oid: str) -> "Transaction":
        self.ops.append(("touch", cid, oid))
        return self

    def write(self, cid: str, oid: str, offset: int,
              data) -> "Transaction":
        """`data` may be bytes, a memoryview (e.g. a shard view over
        the EC encode output), or a BufferList rope — kept AS A VIEW:
        backends consume the buffer protocol directly, and journaled
        stores flatten exactly once at WAL-append time (the denc
        serialize).  A multi-segment rope is the only case that
        flattens here (audited)."""
        self.ops.append(("write", cid, oid, offset, as_buffer(data)))
        return self

    def zero(self, cid: str, oid: str, offset: int,
             length: int) -> "Transaction":
        self.ops.append(("zero", cid, oid, offset, length))
        return self

    def truncate(self, cid: str, oid: str, size: int) -> "Transaction":
        self.ops.append(("truncate", cid, oid, size))
        return self

    def remove(self, cid: str, oid: str) -> "Transaction":
        self.ops.append(("remove", cid, oid))
        return self

    def clone(self, cid: str, src: str, dst: str) -> "Transaction":
        self.ops.append(("clone", cid, src, dst))
        return self

    def try_clone(self, cid: str, src: str, dst: str) -> "Transaction":
        """Clone if src exists, else no-op (EC rollback stashes: a
        behind shard may legitimately lack the object)."""
        self.ops.append(("try_clone", cid, src, dst))
        return self

    def try_remove(self, cid: str, oid: str) -> "Transaction":
        self.ops.append(("try_remove", cid, oid))
        return self

    def collection_move_rename(self, src_cid: str, src_oid: str,
                               dst_cid: str, dst_oid: str) -> "Transaction":
        self.ops.append(("move", src_cid, src_oid, dst_cid, dst_oid))
        return self

    # -- xattr / omap ops --------------------------------------------------

    def setattr(self, cid: str, oid: str, name: str,
                value: bytes) -> "Transaction":
        self.ops.append(("setattr", cid, oid, name, bytes(value)))
        return self

    def rmattr(self, cid: str, oid: str, name: str) -> "Transaction":
        self.ops.append(("rmattr", cid, oid, name))
        return self

    def omap_setkeys(self, cid: str, oid: str,
                     kv: dict[str, bytes]) -> "Transaction":
        self.ops.append(("omap_set", cid, oid,
                         {k: bytes(v) for k, v in kv.items()}))
        return self

    def omap_rmkeys(self, cid: str, oid: str,
                    keys: Iterable[str]) -> "Transaction":
        self.ops.append(("omap_rm", cid, oid, list(keys)))
        return self

    def omap_clear(self, cid: str, oid: str) -> "Transaction":
        self.ops.append(("omap_clear", cid, oid))
        return self

    def append(self, other: "Transaction") -> "Transaction":
        self.ops.extend(other.ops)
        self.on_applied.extend(other.on_applied)
        self.on_commit.extend(other.on_commit)
        return self

    def register_on_applied(self, cb: Callable) -> None:
        self.on_applied.append(cb)

    def register_on_commit(self, cb: Callable) -> None:
        self.on_commit.append(cb)

    @property
    def empty(self) -> bool:
        return not self.ops


class ObjectStore(abc.ABC):
    """Abstract store; all writes via queue_transactions."""

    def __init__(self):
        self._apply_lock = threading.Lock()
        # entity name of the owning daemon ("osd.3"); lets targeted
        # FaultSet store_eio rules select exactly this store
        self.owner = ""
        self.inject_eio_probability = 0.0
        # monotonically bumped on every applied transaction batch: a
        # cheap store-wide version for listing caches (backfill's
        # scan_range keeps its sorted base listing while this tick is
        # unchanged, instead of re-listing the collection per batch)
        self.mutation_tick = 0
        # crash-consistency plane: a fired crash point (or an abrupt
        # daemon abort) freezes the store — no further mutation
        # reaches disk, simulating the instant after power loss
        self.frozen = False
        self.crash_site = ""
        self.crash_callback: Callable | None = None

    def _maybe_eio(self, oid: str = "") -> None:
        """Fault hook every backend's read path consults: targeted
        FaultSet store_eio rules plus the legacy probability knob."""
        from ..utils import faults
        if faults.get().should_store_eio(self.owner, oid,
                                         self.inject_eio_probability):
            raise StoreError(EIO, f"injected EIO on {oid or '?'}")

    # -- crash plane -------------------------------------------------------

    def freeze(self) -> None:
        """Stop all disk mutation (simulated power loss / kill -9).
        Reads may keep working during teardown; every write path
        raises CrashPoint from here on."""
        self.frozen = True

    def _check_frozen(self) -> None:
        if self.frozen:
            raise CrashPoint(
                f"{self.owner or '?'}: store frozen (crashed"
                f"{' at ' + self.crash_site if self.crash_site else ''})")

    def _maybe_crash(self, site: str) -> None:
        """Named crash point: consult the FaultSet crash rules and, on
        a hit, freeze + abort (via _panic)."""
        from ..utils import faults
        if faults.get().should_crash(self.owner, site):
            self._panic(site)

    def _panic(self, site: str) -> None:
        """A crash point fired: freeze the store, notify the owning
        daemon (it aborts from a separate thread), and unwind the
        calling op without ever acking."""
        self.frozen = True
        self.crash_site = site
        cb = self.crash_callback
        if cb is not None:
            try:
                cb(site)
            except Exception:
                pass
        raise CrashPoint(f"{self.owner or '?'} crashed at {site}")

    def journal_stats(self) -> dict:
        """Recovery/journal counters (journaled backends override)."""
        return {}

    def crash_sites(self) -> list[str]:
        """The named crash points this backend threads through its
        write path (surfaced in `perf dump` crash block)."""
        return ["store.pre_apply", "store.post_apply", "pglog.append"]

    def health_warning(self) -> str | None:
        """A store-level condition worth a cluster HEALTH_WARN (e.g.
        repeated checkpoint failures); None when healthy."""
        return None

    # -- lifecycle ---------------------------------------------------------

    def mkfs(self) -> None:
        pass

    def mount(self) -> None:
        pass

    def umount(self) -> None:
        pass

    # -- write path --------------------------------------------------------

    @abc.abstractmethod
    def _do_transaction(self, txn: Transaction) -> None:
        """Apply every op or raise (partial application is a store bug)."""

    def queue_transactions(self, txns: list[Transaction],
                           on_commit: Callable | None = None) -> None:
        """Apply + schedule commit callbacks.

        Base implementation is apply-synchronous, commit-asynchronous-
        immediate; journaled backends override commit scheduling.

        Every applied transaction is reported to the EC HBM stripe
        cache's coherence scan (ops.hbm_cache.note_store_txn): a data
        mutation of a cached object's shard files invalidates its
        entry unless the txn attests the entry's exact version — the
        cache can therefore never serve bytes the store no longer
        holds, no matter which path (client write, recovery push,
        rewind, injected corruption) mutated them.
        """
        from ..ops import hbm_cache
        from ..utils import optracker
        with self._apply_lock, optracker.span("store_apply"):
            self._check_frozen()
            self._maybe_crash("store.pre_apply")
            # coherence scan BEFORE the mutation applies: a concurrent
            # scrub/recovery lookup during the apply window must miss
            # (conservative), never serve an entry whose shard files
            # are mid-rewrite.  The keep/drop decision depends only on
            # the txn's ops, so scanning early is always safe.
            for t in txns:
                hbm_cache.note_store_txn(t.ops)
            for t in txns:
                self._do_transaction(t)
            # tick bumps AFTER the apply: a concurrent listing taken
            # mid-apply carries the OLD tick and is invalidated by
            # this bump — bumping first would let a pre-apply listing
            # cache under the post-apply tick and go permanently
            # stale (a backfill scan could then miss the new object
            # forever)
            self.mutation_tick += 1
            # post-apply, pre-ack: the durability point has passed but
            # the commit callbacks (the client ack) have not fired
            self._maybe_crash("store.post_apply")
        for t in txns:
            for cb in t.on_applied:
                cb()
            for cb in t.on_commit:
                cb()
        if on_commit:
            on_commit()

    def queue_transaction(self, txn: Transaction,
                          on_commit: Callable | None = None) -> None:
        self.queue_transactions([txn], on_commit)

    def apply_transactions(self, txns: list[Transaction]) -> None:
        done = threading.Event()
        self.queue_transactions(txns, on_commit=done.set)
        done.wait()

    def apply_transaction(self, txn: Transaction) -> None:
        self.apply_transactions([txn])

    # -- read path ---------------------------------------------------------

    @abc.abstractmethod
    def read(self, cid: str, oid: str, offset: int = 0,
             length: int = 0) -> bytes:
        """length == 0 -> to EOF.  Raises StoreError(ENOENT)."""

    @abc.abstractmethod
    def stat(self, cid: str, oid: str) -> dict: ...

    @abc.abstractmethod
    def exists(self, cid: str, oid: str) -> bool: ...

    @abc.abstractmethod
    def getattr(self, cid: str, oid: str, name: str) -> bytes: ...

    @abc.abstractmethod
    def getattrs(self, cid: str, oid: str) -> dict[str, bytes]: ...

    @abc.abstractmethod
    def omap_get(self, cid: str, oid: str) -> dict[str, bytes]: ...

    @abc.abstractmethod
    def omap_get_values(self, cid: str, oid: str,
                        keys: Iterable[str]) -> dict[str, bytes]: ...

    def omap_get_vals(self, cid: str, oid: str, start_after: str = "",
                      prefix: str = "",
                      max_return: int = 0) -> dict[str, bytes]:
        """Ordered slice of an omap (ObjectStore omap_get_vals
        semantics): keys strictly after `start_after`, filtered by
        `prefix`, at most `max_return` (0 = unlimited).  Backends
        with sorted storage may override; this default slices the
        full map."""
        omap = self.omap_get(cid, oid)
        out: dict[str, bytes] = {}
        for k in sorted(omap):
            if start_after and k <= start_after:
                continue
            if prefix and not k.startswith(prefix):
                continue
            out[k] = omap[k]
            if max_return and len(out) >= max_return:
                break
        return out

    @abc.abstractmethod
    def list_collections(self) -> list[str]: ...

    @abc.abstractmethod
    def collection_exists(self, cid: str) -> bool: ...

    @abc.abstractmethod
    def collection_list(self, cid: str, start: str = "",
                        max_count: int = 0) -> list[str]:
        """Sorted object names > start (the backfill/scrub scan order)."""
