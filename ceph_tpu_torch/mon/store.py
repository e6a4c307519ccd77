"""MonitorDBStore: versioned service state over a KV backend.

The mon/MonitorDBStore.h analog: every PaxosService keeps
(service, version) -> blob entries plus scalar markers
(first_committed, last_committed, latest full snapshots), all written
through atomic KV transactions so a commit is all-or-nothing.

Crash plane (Protocol-Aware Recovery, Alagappan et al., FAST '18):
the paxos commit path threads named crash points through this store
(`paxos.pre_commit`, `paxos.mid_commit`, `paxos.post_accept_pre_ack`),
and `paxos.mid_commit` applies the ALICE torn-write model to the
commit transaction itself — a seeded prefix (or, with an fsync_reorder
rule armed, a seeded subset) of its ops land.  Every commit seals
itself with a `commit_seal` record written as the LAST op of the
commit transaction: (version, crc32c(value)).  At mount,
`check_integrity` compares the seal against the claimed
`last_committed` and the stored value blob — a torn commit is
DETECTED (seal missing/behind/ahead, or blob missing/crc-failing) and
the store rolls its claim back to the sealed floor so the quorum
repairs it by re-sharing commits, rather than the mon silently
adopting (or serving) a half-applied transaction.
"""

from __future__ import annotations

from typing import Callable

from ..kv import KeyValueDB, KVTransaction, MemDB, SqliteDB
from ..ops.crc32c import crc32c
from ..utils import denc
from ..utils.dout import DoutLogger
from ..utils.faults import CrashPoint

SVC = "paxos"


def _vkey(version: int) -> str:
    return f"{version:020d}"


class MonitorDBStore:
    def __init__(self, path: str = ""):
        self.db: KeyValueDB = SqliteDB(path) if path else MemDB()
        # crash plane: mirrors ObjectStore's — a fired crash point
        # freezes the store (nothing later reaches disk) and aborts
        # the owning monitor without acking
        self.owner = ""
        self.frozen = False
        self.crash_site = ""
        self.crash_callback: Callable | None = None
        self.log = DoutLogger("monstore", path or "mem")
        self.counters = {
            "paxos_torn_commit_repairs": 0,
            "fsync_reorder_windows": 0,
        }

    def open(self) -> None:
        self.db.open()

    def close(self) -> None:
        self.db.close()

    def transaction(self) -> KVTransaction:
        return self.db.transaction()

    # -- crash plane -------------------------------------------------------

    def freeze(self) -> None:
        self.frozen = True

    def _check_frozen(self) -> None:
        if self.frozen:
            raise CrashPoint(
                f"{self.owner or '?'}: mon store frozen (crashed"
                f"{' at ' + self.crash_site if self.crash_site else ''})")

    def _panic(self, site: str) -> None:
        self.frozen = True
        self.crash_site = site
        cb = self.crash_callback
        if cb is not None:
            try:
                cb(site)
            except Exception:
                pass
        raise CrashPoint(f"{self.owner or '?'} crashed at {site}")

    def maybe_crash(self, site: str) -> None:
        from ..utils import faults
        if faults.get().should_crash(self.owner, site):
            self._panic(site)

    def apply_transaction(self, txn: KVTransaction,
                          torn_site: str | None = None) -> None:
        """Submit atomically; when `torn_site` names an armed crash
        point, the transaction TEARS instead: a seeded prefix (or
        reordered subset) of its ops land and the store dies — the
        window `check_integrity` must detect at the next mount."""
        self._check_frozen()
        if torn_site is not None:
            from ..utils import faults
            fs = faults.get()
            if fs.should_crash(self.owner, torn_site):
                ops, reordered = fs.torn_ops(self.owner, txn.ops)
                if reordered:
                    self.counters["fsync_reorder_windows"] += 1
                part = self.db.transaction()
                part.ops = ops
                self.db.submit_transaction(part, sync=True)
                self._panic(torn_site)
        self.db.submit_transaction(txn, sync=True)

    # -- commit seal + torn-commit detection -------------------------------

    def seal_commit(self, txn: KVTransaction, version: int,
                    value: bytes) -> None:
        """Append the commit seal as the transaction's LAST op: any
        prefix tear lacks it, any subset tear mismatches it."""
        txn.set(SVC, "commit_seal",
                denc.dumps((int(version), crc32c(0, bytes(value)))))

    def check_integrity(self) -> int:
        """Detect (and locally contain) a torn paxos commit: verify
        the seal matches `last_committed` and that the claimed head
        version's value blob is present and crc-clean.  On damage,
        roll `last_committed` back to the last version that passes
        verification — the partial ops the torn transaction did land
        stay in place and are overwritten verbatim when the quorum
        re-shares the commits (every paxos value is an idempotent op
        list).  Returns the number of versions rolled back."""
        last = self.get_int(SVC, "last_committed")
        if last == 0:
            return 0
        seal = self.get(SVC, "commit_seal")
        seal_v, seal_crc = (denc.loads(seal) if seal is not None
                            else (None, None))
        first = max(1, self.get_int(SVC, "first_committed", 1))

        def version_ok(v: int) -> bool:
            blob = self.get_version(SVC, v)
            if blob is None:
                return False
            if seal_v == v and crc32c(0, bytes(blob)) != seal_crc:
                return False
            return True

        if seal_v == last and version_ok(last):
            # seal and head blob verify — but a reordered subset tear
            # can land the seal while dropping SERVICE ops of the same
            # transaction.  Every paxos value is an idempotent KV op
            # list, so re-applying the head version's blob heals that
            # window unconditionally (no-op on a clean store).
            self._reapply_version(last)
            return 0
        # torn: walk back to a verifiable floor (the seal's version if
        # its blob checks out, else the newest version whose blob is
        # present — versions below first_committed are trimmed, never
        # reachable)
        floor = last
        while floor >= first and not (version_ok(floor) and
                                      (seal_v is None or
                                       floor <= (seal_v or 0))):
            floor -= 1
        if floor < first:
            floor = 0 if first <= 1 else first - 1
        rolled = last - floor
        self.counters["paxos_torn_commit_repairs"] += 1
        self.log.warn(
            "torn paxos commit detected (claimed v%d, seal %s): "
            "rolling back to v%d for quorum repair", last,
            seal_v if seal is not None else "absent", floor)
        txn = self.transaction()
        self.put_int(txn, SVC, "last_committed", floor)
        self.db.submit_transaction(txn, sync=True)
        if floor >= first:
            # restore the floor version's full effects (idempotent op
            # list) so the local state is exactly "commit `floor` just
            # applied cleanly"; the quorum re-shares floor+1.. onward
            self._reapply_version(floor)
        return rolled

    def _reapply_version(self, v: int) -> None:
        """Restore version v's full effects.  Only ops whose target
        keys currently DIFFER are submitted, so a clean mount is
        write-free — the synced rewrite happens exactly when there is
        damage to heal."""
        blob = self.get_version(SVC, v)
        if blob is None:
            return
        txn = self.transaction()
        for op in denc.loads(blob):
            kind, prefix, key = op[0], op[1], op[2]
            cur = self.db.get(prefix, key)
            if kind == "set" and cur == op[3]:
                continue
            if kind == "rm" and cur is None:
                continue
            txn.ops.append(op)
        if txn.ops:
            self.seal_commit(txn, v, blob)
            self.db.submit_transaction(txn, sync=True)

    # -- typed helpers -----------------------------------------------------

    def put(self, txn: KVTransaction, service: str, key: str,
            value: bytes) -> None:
        txn.set(service, key, value)

    def put_version(self, txn: KVTransaction, service: str, version: int,
                    value: bytes) -> None:
        txn.set(service, _vkey(version), value)

    def get(self, service: str, key: str) -> bytes | None:
        return self.db.get(service, key)

    def get_version(self, service: str, version: int) -> bytes | None:
        return self.db.get(service, _vkey(version))

    def get_int(self, service: str, key: str, default: int = 0) -> int:
        v = self.db.get(service, key)
        return int(v.decode()) if v is not None else default

    def put_int(self, txn: KVTransaction, service: str, key: str,
                value: int) -> None:
        txn.set(service, key, str(value).encode())

    def erase_version_range(self, txn: KVTransaction, service: str,
                            first: int, last: int) -> None:
        for v in range(first, last):
            txn.rmkey(service, _vkey(v))

    # -- full store sync (Monitor::sync_* analog) --------------------------

    def dump_all(self) -> list[tuple[str, str, bytes]]:
        """Every (service, key, value) — the payload a mon behind the
        paxos trim point needs to rejoin."""
        out = []
        for prefix in self.db.prefixes():
            for key, value in self.db.iterate(prefix):
                out.append((prefix, key, value))
        return out

    def restore_all(self, entries: list) -> None:
        """Replace the whole store with `entries` atomically."""
        txn = self.transaction()
        for prefix in self.db.prefixes():
            txn.rmkeys_by_prefix(prefix)
        for prefix, key, value in entries:
            txn.set(prefix, key, value)
        self.apply_transaction(txn)
