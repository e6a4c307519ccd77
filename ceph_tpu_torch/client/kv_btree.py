"""KvFlatBtree: a distributed, concurrent-client-safe B-tree over RADOS.

The key_value_store/kv_flat_btree_async.{h,cc} analog: keys live in
LEAF objects' omaps; one INDEX object's omap maps each leaf's key-range
upper bound to the leaf and carries "prefix" markers for in-flight
structural ops.  Order `k` follows the reference's thresholds
(kv_flat_btree_async.h:573, .cc:585 rebalance): a leaf with >= 2k
entries splits; a leaf dropping below k entries merges with a neighbor
(or the pair redistributes evenly when the merged load would itself
split).

Concurrency model (the reference's assert-version scheme, redesigned on
cls guards):
  * every leaf mutation is an in-OSD `put_guarded`/`rm_guarded` cls
    call that checks the leaf's version cell — a structural op bumps
    the version AND sets a dead marker, so a racing writer's guard
    fails and it re-walks the index;
  * index transitions (the commit point of a split/merge) are one
    atomic `update_index` cls call that checks the expected pre-image
    of every touched index entry — two racing splitters cannot both
    commit;
  * before committing, the structural op records a PREFIX marker in
    the index entry (timestamped, with the planned new state); a
    client that finds a stale marker heals it — roll FORWARD when the
    new leaves are all in place, roll BACK otherwise — so a client
    killed mid-split never wedges the tree.
"""

from __future__ import annotations

import time
import uuid

from ..utils import denc
from .rados import RadosError

INF = "\x7f~inf"                 # index bound sorting after any user key
VER_KEY = "\x00ver"              # leaf meta: version cell (bytes of int)
DEAD_KEY = "\x00dead"            # leaf meta: structural op killed it
PREFIX_TIMEOUT = 2.0             # seconds before a marker is "stale"


def _bound_key(user_key: str) -> str:
    return "k" + user_key


class KvFlatBtree:
    def __init__(self, ioctx, name: str, k: int = 2,
                 prefix_timeout: float = PREFIX_TIMEOUT):
        if k < 2:
            raise ValueError("order k must be >= 2")
        self.io = ioctx
        self.name = name
        self.k = k
        self.prefix_timeout = prefix_timeout
        self.index_oid = f"{name}.kvb.index"
        self._ensure_root()

    # -- layout helpers ----------------------------------------------------

    def _leaf_oid(self) -> str:
        return f"{self.name}.kvb.leaf.{uuid.uuid4().hex[:12]}"

    def _read_index(self) -> dict[str, dict]:
        try:
            raw = self.io.get_omap(self.index_oid)
        except RadosError:
            return {}
        return {k: denc.loads(v) for k, v in raw.items()}

    def _ensure_root(self) -> None:
        if self._read_index():
            return
        leaf = self._leaf_oid()
        try:
            self.io.execute(self.index_oid, "kvstore", "update_index",
                            denc.dumps({
                                "expect": {INF: None},
                                "set": {INF: denc.dumps(
                                    {"oid": leaf, "ver": 1})},
                            }))
            self.io.execute(leaf, "kvstore", "put_guarded", denc.dumps(
                {"kv": {VER_KEY: b"1"}, "guard": {}}))
        except RadosError as e:
            if e.errno != 125:            # lost the race: root exists
                raise

    def _find_entry(self, key: str) -> tuple[str, dict]:
        """(bound, entry) of the leaf covering `key`; heals stale
        prefix markers it trips over."""
        bk = _bound_key(key)
        while True:
            idx = self._read_index()
            if not idx:
                self._ensure_root()
                continue
            bound = min((b for b in idx if b >= bk or b == INF),
                        key=lambda b: (b == INF, b))
            entry = idx[bound]
            pfx = entry.get("prefix")
            if pfx is None:
                return bound, entry
            if time.time() - pfx["ts"] > self.prefix_timeout:
                self._heal(bound, entry)
            else:
                time.sleep(0.05)          # in-flight op: let it land

    # -- leaf I/O ----------------------------------------------------------

    def _leaf_items(self, oid: str) -> dict[str, bytes] | None:
        try:
            raw = self.io.get_omap(oid)
        except RadosError:
            return None
        if DEAD_KEY in raw:
            return None
        return raw

    @staticmethod
    def _user_items(raw: dict) -> dict[str, bytes]:
        return {k: v for k, v in raw.items() if not k.startswith("\x00")}

    # -- public API --------------------------------------------------------

    def set(self, key: str, value: bytes) -> None:
        if key.startswith("\x00") or _bound_key(key) >= INF:
            raise ValueError(f"invalid key {key!r}")
        while True:
            bound, entry = self._find_entry(key)
            try:
                out = self.io.execute(
                    entry["oid"], "kvstore", "put_guarded",
                    denc.dumps({
                        "kv": {key: bytes(value)},
                        "guard": {VER_KEY: str(entry["ver"]).encode(),
                                  DEAD_KEY: None},
                    }))
            except RadosError as e:
                if e.errno in (125, 2):   # split/merged under us
                    continue
                raise
            size = denc.loads(out)        # meta cells already excluded
            if size >= 2 * self.k:
                self._split(bound, entry)
            return

    def get(self, key: str) -> bytes:
        while True:
            _bound, entry = self._find_entry(key)
            raw = self._leaf_items(entry["oid"])
            if raw is None:
                continue                  # structural op won; re-walk
            if key not in raw:
                raise KeyError(key)
            return raw[key]

    def remove(self, key: str) -> None:
        while True:
            bound, entry = self._find_entry(key)
            try:
                out = self.io.execute(
                    entry["oid"], "kvstore", "rm_guarded",
                    denc.dumps({
                        "keys": [key],
                        "guard": {VER_KEY: str(entry["ver"]).encode(),
                                  DEAD_KEY: None},
                    }))
            except RadosError as e:
                if e.errno == 125:
                    continue
                if e.errno == 2:
                    # leaf vanished (merge) OR key truly absent
                    raw = self._leaf_items(entry["oid"])
                    if raw is None:
                        continue
                    raise KeyError(key)
                raise
            size = denc.loads(out)        # meta cells already excluded
            if size < self.k:
                self._rebalance(bound, entry)
            return

    def items(self) -> dict[str, bytes]:
        out: dict[str, bytes] = {}
        for _bound, entry in sorted(self._read_index().items()):
            raw = self._leaf_items(entry["oid"])
            if raw:
                out.update(self._user_items(raw))
        return out

    # -- structural ops ----------------------------------------------------

    def _mark_prefix(self, expect: dict[str, dict],
                     plan: dict) -> dict | None:
        """CAS the prefix marker onto every touched index entry.
        Returns the marked entries, or None if someone beat us."""
        marked = {}
        sets = {}
        exp = {}
        for bound, entry in expect.items():
            if entry.get("prefix"):
                return None
            new = dict(entry)
            new["prefix"] = {"ts": time.time(), **plan}
            marked[bound] = new
            exp[bound] = denc.dumps(entry)
            sets[bound] = denc.dumps(new)
        try:
            self.io.execute(self.index_oid, "kvstore", "update_index",
                            denc.dumps({"expect": exp, "set": sets}))
        except RadosError as e:
            if e.errno == 125:
                return None
            raise
        return marked

    def _kill_leaf(self, oid: str, ver: int) -> dict | None:
        """Bump the version and set the dead marker; returns the
        leaf's content (pre-image) or None if the guard lost."""
        raw = self._leaf_items(oid)
        if raw is None:
            return None
        try:
            self.io.execute(oid, "kvstore", "put_guarded", denc.dumps({
                "kv": {DEAD_KEY: b"1",
                       VER_KEY: str(ver + 1).encode()},
                "guard": {VER_KEY: str(ver).encode(), DEAD_KEY: None},
            }))
        except RadosError as e:
            if e.errno == 125:
                return None
            raise
        # the guard serialized us against every writer; the pre-image
        # plus nothing (writers now fail) is the authoritative content
        raw = self.io.get_omap(oid)
        return {k: v for k, v in raw.items()
                if not k.startswith("\x00")}

    def _write_leaf(self, oid: str, items: dict[str, bytes]) -> None:
        kv = {VER_KEY: b"1"}
        kv.update(items)
        self.io.execute(oid, "kvstore", "put_guarded", denc.dumps(
            {"kv": kv, "guard": {}}))

    def _stamp_final(self, marked: dict, final_sets: dict,
                     final_rm: list) -> dict | None:
        """Phase 2: atomically record the exact index transition in
        every marked entry.  From here on the op is roll-FORWARD-only;
        a healer that finds the stamp applies it verbatim."""
        exp = {}
        sets = {}
        stamped = {}
        final = {"set": dict(final_sets), "rm": list(final_rm)}
        for b, e in marked.items():
            ne = dict(e)
            ne["prefix"] = dict(e["prefix"])
            ne["prefix"]["final"] = final
            exp[b] = denc.dumps(e)
            sets[b] = denc.dumps(ne)
            stamped[b] = ne
        try:
            self.io.execute(self.index_oid, "kvstore", "update_index",
                            denc.dumps({"expect": exp, "set": sets}))
        except RadosError as e:
            if e.errno == 125:
                return None               # healer took over
            raise
        return stamped

    def _apply_final(self, stamped: dict, old_oids: list) -> None:
        """Phase 3: the commit point — swap the index to the recorded
        final state (clearing every marker) and delete the old
        leaves."""
        final = next(iter(stamped.values()))["prefix"]["final"]
        sets = {b: bytes(v) for b, v in final["set"].items()}
        rm = [b for b in final["rm"] if b not in sets]
        try:
            self.io.execute(self.index_oid, "kvstore", "update_index",
                            denc.dumps({
                                "expect": {b: denc.dumps(e)
                                           for b, e in stamped.items()},
                                "set": sets,
                                "rm": rm,
                            }))
        except RadosError as e:
            if e.errno != 125:
                raise
            return                        # healer finished it
        self._rm_objects(old_oids)

    def _rollback_all(self, marked: dict) -> None:
        for b, e in marked.items():
            orig = dict(e)
            orig.pop("prefix", None)
            self._rollback(b, e, orig)

    def _split(self, bound: str, entry: dict) -> None:
        """Split entry's leaf into two (kv_flat_btree_async.cc split:
        read, halve, write two, swap the index, delete the old)."""
        plan_new = [self._leaf_oid(), self._leaf_oid()]
        marked = self._mark_prefix(
            {bound: entry}, {"op": "split", "new": plan_new,
                             "old": [entry["oid"]],
                             "bounds": [bound]})
        if marked is None:
            return                        # someone else is on it
        content = self._kill_leaf(entry["oid"], entry["ver"])
        if content is None or len(content) < 2 * self.k:
            # raced shrink (or lost the kill): roll the marker back
            self._rollback_all(marked)
            return
        keys = sorted(content)
        half = len(keys) // 2
        self._write_leaf(plan_new[0],
                         {k: content[k] for k in keys[:half]})
        self._write_leaf(plan_new[1],
                         {k: content[k] for k in keys[half:]})
        lo_bound = _bound_key(keys[half - 1])
        stamped = self._stamp_final(marked, {
            lo_bound: denc.dumps({"oid": plan_new[0], "ver": 1}),
            bound: denc.dumps({"oid": plan_new[1], "ver": 1}),
        }, [])
        if stamped is not None:
            self._apply_final(stamped, [entry["oid"]])

    def _neighbor(self, idx: dict, bound: str) -> str | None:
        bounds = sorted(idx, key=lambda b: (b == INF, b))
        i = bounds.index(bound)
        if i + 1 < len(bounds):
            return bounds[i + 1]
        if i > 0:
            return bounds[i - 1]
        return None

    def _rebalance(self, bound: str, entry: dict) -> None:
        """Merge a thin leaf with a neighbor, or redistribute when the
        pair would immediately re-split (the reference's rebalance)."""
        idx = self._read_index()
        if idx.get(bound, {}).get("oid") != entry.get("oid"):
            return                        # stale view
        nbound = self._neighbor(idx, bound)
        if nbound is None:
            return                        # single leaf: nothing to do
        nentry = idx[nbound]
        if nentry.get("prefix") or idx[bound].get("prefix"):
            return
        lob, hib = sorted([bound, nbound],
                          key=lambda b: (b == INF, b))
        plan_new = [self._leaf_oid(), self._leaf_oid()]
        old_oids = [idx[bound]["oid"], nentry["oid"]]
        marked = self._mark_prefix(
            {bound: idx[bound], nbound: nentry},
            {"op": "merge", "new": plan_new, "old": old_oids,
             "bounds": [bound, nbound]})
        if marked is None:
            return
        c1 = self._kill_leaf(idx[bound]["oid"], idx[bound]["ver"])
        if c1 is None:
            self._rollback_all(marked)
            return
        c2 = self._kill_leaf(nentry["oid"], nentry["ver"])
        if c2 is None:
            # rollback resurrects the already-dead first leaf at a
            # fresh oid and clears both markers
            self._rollback_all(marked)
            return
        merged = {**c1, **c2}
        sets: dict[str, bytes] = {}
        rm: list[str] = []
        if len(merged) >= 2 * self.k:
            # redistribute: two fresh leaves, even halves
            keys = sorted(merged)
            half = len(keys) // 2
            self._write_leaf(plan_new[0],
                             {k: merged[k] for k in keys[:half]})
            self._write_leaf(plan_new[1],
                             {k: merged[k] for k in keys[half:]})
            sets[_bound_key(keys[half - 1])] = denc.dumps(
                {"oid": plan_new[0], "ver": 1})
            sets[hib] = denc.dumps({"oid": plan_new[1], "ver": 1})
            if lob != _bound_key(keys[half - 1]):
                rm.append(lob)
        else:
            self._write_leaf(plan_new[0], merged)
            sets[hib] = denc.dumps({"oid": plan_new[0], "ver": 1})
            rm.append(lob)
        stamped = self._stamp_final(marked, sets, rm)
        if stamped is not None:
            self._apply_final(stamped, old_oids)

    # -- crash healing -----------------------------------------------------

    def _rollback(self, bound: str, marked_entry: dict,
                  orig: dict) -> None:
        """Clear a marker, restoring the original entry.  If the old
        leaf was already killed, resurrect its content at a new oid."""
        entry = dict(orig)
        entry.pop("prefix", None)
        raw = self._leaf_items(entry["oid"])
        if raw is None:
            dead = self.io.get_omap(entry["oid"]) \
                if self._exists(entry["oid"]) else {}
            content = {k: v for k, v in dead.items()
                       if not k.startswith("\x00")}
            oid = self._leaf_oid()
            self._write_leaf(oid, content)
            old_oid = entry["oid"]
            entry = {"oid": oid, "ver": 1}
        else:
            old_oid = None
        try:
            self.io.execute(self.index_oid, "kvstore", "update_index",
                            denc.dumps({
                                "expect": {bound: denc.dumps(
                                    marked_entry)},
                                "set": {bound: denc.dumps(entry)},
                            }))
        except RadosError as e:
            if e.errno != 125:
                raise
            return
        if old_oid:
            self._rm_objects([old_oid])

    def _heal(self, bound: str, entry: dict) -> None:
        """A stale prefix marker.  The marker group (plan["bounds"])
        is gathered as one unit: if the final transition was stamped
        (phase 2 happened — atomic across the group) the op is past
        its point of no return and rolls FORWARD verbatim; otherwise
        every marked entry rolls BACK, resurrecting any killed leaf."""
        pfx = entry["prefix"]
        idx = self._read_index()
        group = {}
        for b in pfx.get("bounds", [bound]):
            e = idx.get(b)
            if (e is None or not e.get("prefix")
                    or e["prefix"].get("new") != pfx.get("new")):
                return                    # already resolved; re-walk
            group[b] = e
        if any(e["prefix"].get("final") for e in group.values()):
            self._apply_final(group, pfx.get("old", []))
        else:
            self._rollback_all(group)

    # -- misc --------------------------------------------------------------

    def _exists(self, oid: str) -> bool:
        try:
            self.io.stat(oid)
            return True
        except RadosError:
            return False

    def _rm_objects(self, oids) -> None:
        for oid in oids:
            try:
                self.io.remove_object(oid)
            except RadosError:
                pass

    # -- invariants (for tests / fsck) -------------------------------------

    def check_invariants(self) -> dict[str, int]:
        """Walk the tree; raise AssertionError on a broken invariant.
        Returns {leaves, entries}."""
        idx = self._read_index()
        assert idx, "index lost"
        assert INF in idx, "missing infinity bound"
        bounds = sorted((b for b in idx if b != INF))
        seen: set[str] = set()
        total = 0
        prev = ""
        for b in bounds + [INF]:
            entry = idx[b]
            assert entry.get("prefix") is None, \
                f"stale prefix marker on {b!r}"
            raw = self._leaf_items(entry["oid"])
            assert raw is not None, f"index points at dead leaf {b!r}"
            items = self._user_items(raw)
            assert not (set(items) & seen), "key in two leaves"
            seen |= set(items)
            total += len(items)
            if len(idx) > 1:
                assert len(items) <= 2 * self.k, \
                    f"leaf over 2k: {len(items)}"
            for k in sorted(items):
                bk = _bound_key(k)
                # prev carries ACROSS leaves: every key must sort after
                # the previous leaf's maximum or the global ordering
                # the bound index promises is broken
                assert bk > _bound_key(prev) or prev == "", \
                    f"key {k!r} out of order after {prev!r}"
                assert b == INF or bk <= b, \
                    f"key {k!r} outside its bound {b!r}"
                prev = k
        return {"leaves": len(idx), "entries": total}
