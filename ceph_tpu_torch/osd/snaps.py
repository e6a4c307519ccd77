"""Snapshots on replicated pools: SnapSet COW clones, snap reads,
snap trim (osd/ReplicatedPG.cc make_writeable, osd/SnapMapper.h:98,
osd/osd_types.h SnapSet — see the section comment below).

Mixed into PG (pg.py).
"""

from __future__ import annotations

from ..store.objectstore import ENOENT, StoreError, Transaction
from ..utils import denc
from .pglog import SNAPSET_KEY, clone_oid, snapdir_oid


class SnapOps:
    # ---- snapshots (replicated pools) ------------------------------------
    #
    # make_writeable / SnapSet semantics (osd/ReplicatedPG.cc
    # make_writeable, osd/SnapMapper.h:98, osd/osd_types.h SnapSet):
    # a write under a snap context newer than the object's SnapSet seq
    # first CLONES the head to <oid>@<snapid>; reads at a snap resolve
    # to the oldest clone covering it; deleting a head with clones
    # leaves a snapdir object carrying the SnapSet.

    def _load_snapset(self, oid: str) -> dict:
        store = self.osd.store
        for name in (oid, snapdir_oid(oid)):
            try:
                return denc.loads(store.getattr(self.cid, name,
                                                SNAPSET_KEY))
            except StoreError:
                continue
        return {"seq": 0, "clones": []}      # clones: [[snapid, size]]

    def _make_writeable(self, txn: Transaction, oid: str,
                        snapc) -> dict | None:
        """Pre-mutation COW: clone the head if the snap context has
        snaps newer than the last clone.  Returns the updated SnapSet
        (still pending in `txn`) for later ops in the same sequence."""
        if not snapc:
            return None
        seq, snaps = int(snapc[0]), [int(s) for s in snapc[1]]
        ss = self._load_snapset(oid)
        store = self.osd.store
        exists = store.exists(self.cid, oid)
        newest = max(snaps) if snaps else seq
        if exists and snaps and ss["seq"] < newest:
            size = store.stat(self.cid, oid)["size"]
            txn.clone(self.cid, oid, clone_oid(oid, newest))
            # the clone is the sole backing for EVERY snap taken since
            # the previous clone (SnapSet.clone_snaps): record them so
            # trim only deletes it once ALL of them are removed
            covered = sorted(s for s in snaps if s > ss["seq"])
            ss["clones"].append([newest, size, covered])
        elif not exists:
            # (re)creation: snaps older than this never saw the new
            # head — reads at them must NOT fall through to it
            ss["head_since"] = max(ss.get("head_since", 0), seq, newest)
        ss["seq"] = max(ss["seq"], seq, newest)
        txn.setattr(self.cid, oid, SNAPSET_KEY, denc.dumps(ss))
        txn.try_remove(self.cid, snapdir_oid(oid))
        return ss

    def _resolve_snap(self, oid: str, snapid: int) -> tuple[str, int | None]:
        """Object name (+ size clamp) serving reads at `snapid`."""
        ss = self._load_snapset(oid)
        pool = self.pool
        removed = set(pool.removed_snaps if pool else [])
        if snapid in removed:
            raise StoreError(ENOENT, f"snap {snapid} removed")
        for entry in sorted(ss["clones"]):
            cid_, size = entry[0], entry[1]
            if cid_ >= snapid:
                return clone_oid(oid, cid_), size
        if snapid <= ss.get("head_since", 0):
            # snaps at or before the head's (re)creation seq predate
            # it: the object did not exist when they were taken
            raise StoreError(ENOENT,
                             f"{oid} did not exist at snap {snapid}")
        return oid, None

    def _snap_delete_txn(self, txn: Transaction, oid: str,
                         ss: dict | None = None) -> None:
        """Head removal preserving clones via a snapdir object.  `ss`
        carries the snapset updated earlier in this txn (the store's
        copy is stale until the txn applies)."""
        if ss is None:
            ss = self._load_snapset(oid)
        if ss["clones"]:
            txn.touch(self.cid, snapdir_oid(oid))
            txn.setattr(self.cid, snapdir_oid(oid), SNAPSET_KEY,
                        denc.dumps(ss))

    def snap_trim(self, removed: set[int]) -> int:
        """Drop clones whose snap was removed (snap_trimmer analog).

        Removals are grouped per base object and the SnapSet rewritten
        ONCE — per-clone reloads would read pre-txn state and leave
        the last write still referencing another trimmed clone.
        """
        store = self.osd.store
        trimmed = 0
        pool = self.pool
        # cumulative: a clone dies only when EVERY snap it backs is
        # gone, which may span several removal epochs
        removed = set(removed) | set(pool.removed_snaps if pool else [])
        with self.lock:
            try:
                names = store.collection_list(self.cid)
            except StoreError:
                return 0
            txn = Transaction()
            dirty = False
            per_base: dict[str, set[int]] = {}
            # a clone backs every snap in its covered list: it can go
            # only when ALL of them are removed (SnapSet.clone_snaps)
            for name in names:
                if "@" not in name or name.endswith("@dir"):
                    continue
                base, _, snap = name.rpartition("@")
                if not snap.isdigit():
                    continue
                per_base.setdefault(base, set())
            for base in per_base:
                ss = self._load_snapset(base)
                keep = []
                for entry in ss["clones"]:
                    cid_, size = entry[0], entry[1]
                    covered = set(entry[2] if len(entry) > 2 else [cid_])
                    live = covered - removed
                    if live:
                        keep.append([cid_, size, sorted(live)])
                    else:
                        txn.try_remove(self.cid, clone_oid(base, cid_))
                        trimmed += 1
                if keep == ss["clones"]:
                    continue
                dirty = True
                ss["clones"] = keep
                if store.exists(self.cid, base):
                    txn.setattr(self.cid, base, SNAPSET_KEY,
                                denc.dumps(ss))
                elif store.exists(self.cid, snapdir_oid(base)):
                    if ss["clones"]:
                        txn.setattr(self.cid, snapdir_oid(base),
                                    SNAPSET_KEY, denc.dumps(ss))
                    else:
                        txn.try_remove(self.cid, snapdir_oid(base))
            if dirty:
                try:
                    store.apply_transaction(txn)
                except StoreError:
                    pass
        return trimmed

