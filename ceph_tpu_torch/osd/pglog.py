"""PG log + object naming helpers (osd/PGLog.{h,cc} and the
hobject_t naming conventions reduced).

Split out of pg.py along the reference's file boundary: the log is a
standalone value type the OSD, the backends and the tools all consume.
"""

from __future__ import annotations

from ..utils import denc

HINFO_KEY = "_hinfo"        # per-shard cumulative crc xattr (EC)
VER_KEY = "_v"              # per-object version xattr
SNAPSET_KEY = "_snapset"    # head/snapdir snapshot metadata (SnapSet)
WHITEOUT_KEY = "_wo"        # cache tier: object logically deleted here
DIRTY_KEY = "_dirty"        # cache tier: differs from the base copy


def clone_oid(oid: str, snapid: int) -> str:
    """Clone object for state as of snap `snapid` (hobject_t snap)."""
    return f"{oid}@{snapid}"


def snapdir_oid(oid: str) -> str:
    """Holds the SnapSet once the head is deleted but clones remain."""
    return f"{oid}@dir"

ZERO_EV = (0, 0)


def shard_oid(oid: str, shard: int) -> str:
    return f"{oid}.s{shard}"


def _parse_ev(blob: bytes) -> tuple | None:
    """Parse a VER_KEY xattr (repr of an (epoch, v) tuple)."""
    import ast
    try:
        ev = ast.literal_eval(blob.decode())
    except (ValueError, SyntaxError, UnicodeDecodeError):
        return None
    return tuple(ev) if isinstance(ev, tuple) else None


# _pgmeta attrs shared by the OSD (pg.py persistence) and the offline
# tools (pglog_dump): ONE encoding, one decoder
BACKFILL_ATTR = "backfilling"   # "@<name>" watermark; legacy b"1" = ""
LES_ATTR = "les"                # last_epoch_started stamp


def encode_backfill_attr(watermark: str) -> bytes:
    return b"@" + watermark.encode()


def decode_backfill_attr(blob: bytes) -> str:
    """Watermark from the persisted attr (legacy b"1" flag reads as
    "nothing restored yet")."""
    return (blob[1:].decode("utf-8", "replace")
            if blob.startswith(b"@") else "")


def stash_oid(soid: str, ev: tuple) -> str:
    """Rollback stash name for a shard object at a given version.

    The '@' marker keeps stashes out of listings/scrubs — the analog of
    the reference's rollback generations (osd/ECTransaction.h:201:
    generate_transactions emits stash/rename ops whose objects carry a
    generation suffix)."""
    return f"{soid}@{ev[0]}.{ev[1]}"


class PGLog:
    """Bounded per-PG op log + object version index (osd/PGLog.{h,cc}).

    Entries are dicts:
      {"ev": (epoch, v), "oid": str, "op": "modify"|"delete",
       "prior": (epoch, v) | None,      # object's previous version
       "rollback": {"type": "stash"} | None,   # EC: how to undo
       "shard": int | None}             # EC: local shard at apply time

    Versions are eversion_t analogs (osd/osd_types.h): (epoch of the
    primary's interval, per-pg counter), compared lexicographically —
    entries minted by primaries of different intervals order correctly
    and same-counter divergence is detectable.

    The log is BOUNDED: `entries` covers the ev range (tail, head].
    Trimming advances `tail`; peering exchanges only (head, tail) and
    on-demand entry deltas (entries_since), never whole object maps —
    the reference's core scaling property (osd/PGLog.h:1: delta
    recovery from a bounded log; peers behind `tail` must backfill).
    `objects`/`deleted` remain as the LOCAL have-index only.

    `missing` is the pg_missing_t analog: objects whose log entry is
    CLAIMED here (merged from an auth log, or re-exposed by a
    divergent rewind that could not restore bytes locally) but whose
    data has not landed yet — recovery pulls exactly this set and
    `record_recovered` retires it.
    """

    MAX_ENTRIES = 2000

    def __init__(self, max_entries: int | None = None):
        self.entries: list[dict] = []
        self.objects: dict[str, tuple] = {}             # oid -> ev
        self.deleted: dict[str, tuple] = {}             # oid -> ev
        self.missing: dict[str, tuple] = {}             # oid -> needed ev
        self.tail: tuple = ZERO_EV      # entries cover (tail, head]
        self.max_entries = int(max_entries or self.MAX_ENTRIES)

    def add(self, entry: dict) -> None:
        ev = tuple(entry["ev"])
        oid = entry["oid"]
        entry = dict(entry)
        entry["ev"] = ev
        if entry.get("prior") is not None:
            entry["prior"] = tuple(entry["prior"])
        if self.entries and ev < self.entries[-1]["ev"]:
            # late delivery (sub-op resend raced a newer op): insert
            # in ev order — an appended stale entry would regress head
            # (the peering last_update vote) and break the monotonic
            # iteration _trim_rollback and _already_applied rely on
            idx = len(self.entries)
            while idx > 0 and self.entries[idx - 1]["ev"] > ev:
                idx -= 1
            self.entries.insert(idx, entry)
        else:
            self.entries.append(entry)
        # the version index tracks the NEWEST op per object; a stale
        # entry must not clobber it
        if entry["op"] == "delete":
            if ev > self.deleted.get(oid, ZERO_EV):
                self.deleted[oid] = ev
            if ev >= self.objects.get(oid, ZERO_EV):
                self.objects.pop(oid, None)
            if ev >= self.missing.get(oid, ZERO_EV):
                self.missing.pop(oid, None)   # pull superseded by delete
        else:
            if ev >= self.objects.get(oid, ZERO_EV) and \
                    ev > self.deleted.get(oid, ZERO_EV):
                self.objects[oid] = ev
                self.deleted.pop(oid, None)
        if len(self.entries) > self.max_entries:
            cut = len(self.entries) - self.max_entries
            self.tail = max(self.tail, self.entries[cut - 1]["ev"])
            self.entries = self.entries[cut:]

    def entries_since(self, ev: tuple) -> list[dict] | None:
        """Entries strictly newer than `ev`, oldest first — the
        peering log delta.  None when `ev` predates the tail: the
        delta is unknowable and the peer must backfill."""
        ev = tuple(ev)
        if ev < self.tail:
            return None
        return [e for e in self.entries if e["ev"] > ev]

    def contains(self, ev: tuple) -> bool:
        """True when `ev` names a point in OUR history: an entry at
        exactly ev, the tail boundary itself, or anything below the
        tail (trimmed history is committed history).  A peer whose
        last_update fails this check sits on a DIVERGENT branch — its
        log suffix was minted by a primary whose interval this log
        never merged."""
        ev = tuple(ev)
        if ev <= self.tail:
            return True
        return any(e["ev"] == ev for e in self.entries)

    # -- authoritative-log election (PG::find_best_info) -------------------

    @staticmethod
    def find_best_info(cands: dict) -> object | None:
        """Elect the authoritative log holder over exchanged bounds.

        `cands`: id -> {"last_update": ev, "log_tail": ev,
        "last_epoch_started": int, "in_up": bool}.  The reference's
        ordering (osd/PG.cc find_best_info), reduced:

          1. max last_epoch_started — a peer that actually SERVED a
             later interval beats any stray higher version minted on a
             partitioned branch (the pg_temp race killer: max(lu)
             alone elects the stale branch);
          2. then max last_update;
          3. then the LONGER log tail (smaller tail ev) — more history
             means more peers delta-recover instead of backfilling;
          4. then prefer a member of `up` over an acting-only
             (pg_temp) member, so authority converges onto the copy
             that will survive the pin release;
          5. then the smallest id, for determinism.
        """
        best = None
        best_key = None
        for cid in sorted(cands, key=lambda c: str(c)):
            info = cands[cid]
            key = (int(info.get("last_epoch_started", 0) or 0),
                   tuple(info.get("last_update", ZERO_EV)),
                   # negate the tail ordering: longer log == smaller
                   # tail ev must score HIGHER
                   tuple(-x for x in tuple(
                       info.get("log_tail", ZERO_EV))),
                   bool(info.get("in_up", True)))
            if best_key is None or key > best_key:
                best, best_key = cid, key
        return best

    # -- divergence (PGLog::merge_log / rewind_divergent_log math) ---------

    @staticmethod
    def divergence_point(ref_entries: list[dict],
                         cand_entries: list[dict],
                         ref_tail: tuple) -> tuple[tuple, list[dict]]:
        """Compare a candidate log window against the authoritative
        reference: returns (rewind_to, divergent) where `divergent`
        are the candidate's entries on a branch the reference never
        merged (newest first) and `rewind_to` is the newest shared
        point — truncating the candidate to it drops exactly the
        divergent suffix.  Candidate entries at or below `ref_tail`
        are trusted as committed history (the reference trimmed
        them)."""
        ref_evs = {tuple(e["ev"]) for e in ref_entries}
        ref_tail = tuple(ref_tail)
        shared = ref_tail
        divergent: list[dict] = []
        for e in cand_entries:
            ev = tuple(e["ev"])
            if ev <= ref_tail or ev in ref_evs:
                if ev > shared:
                    shared = ev
            else:
                divergent.append(e)
        if divergent:
            # the rewind point must sit BELOW every divergent ev so
            # truncate_to drops them all; shared entries always do
            # (divergence is a suffix property: once a branch forks,
            # the forked copy can never have merged a later ref entry)
            first_div = min(tuple(e["ev"]) for e in divergent)
            if shared >= first_div:
                # defensive: an interleaved (corrupt) window — rewind
                # below the whole suspect range rather than keeping a
                # mixed history
                shared = max((ev for ev in ref_evs | {ref_tail}
                              if ev < first_div), default=ZERO_EV)
        return shared, list(reversed(sorted(
            divergent, key=lambda e: tuple(e["ev"]))))

    def find_divergence(self, peer_entries: list[dict]
                        ) -> tuple[tuple, list[dict]]:
        """A PEER's divergence vs our (authoritative) log: the rewind
        point we should send it and its divergent entries."""
        return self.divergence_point(self.entries, peer_entries,
                                     self.tail)

    # -- merge (PGLog::merge_log: adopt the auth log's claims) -------------

    def merge_log(self, entries: list[dict],
                  shard: int | None = None) -> dict[str, tuple]:
        """Merge authoritative log entries into this log (the GetLog
        authority proof's second half): every entry is CLAIMED — the
        index advances and modify targets enter `missing` until their
        data lands via recovery.  Returns {oid: ev} of the pulls
        (newest modify per object; deletes apply via the caller's
        store txn and never pull)."""
        pulls: dict[str, tuple] = {}
        # membership set built ONCE: a per-entry contains() scan would
        # make a full-window merge O(len(log) * len(auth)) inside
        # pg.lock — exactly the peering path the flatness gate times
        have = {e["ev"] for e in self.entries}
        for e in entries:
            e = dict(e)
            ev = tuple(e["ev"])
            e["ev"] = ev
            if e.get("prior") is not None:
                e["prior"] = tuple(e["prior"])
            e["shard"] = shard
            if ev <= self.tail or ev in have:
                continue          # already ours (idempotent re-merge)
            have.add(ev)
            self.add(e)
            oid = e["oid"]
            if e["op"] == "delete":
                pulls.pop(oid, None)
                self.missing.pop(oid, None)
            else:
                pulls[oid] = ev
                self.missing[oid] = ev
        return pulls

    # -- divergent rewind (PGLog::rewind_divergent_log) --------------------

    def rewind(self, ev: tuple, on_divergent=None) -> list[dict]:
        """Drop every entry newer than `ev` and repair the version
        index — THE shared divergence core (replicated and EC peering
        both reconcile through here; the reference's
        PGLog::rewind_divergent_log).

        For each divergent entry (newest first) `on_divergent(entry)`
        — the backend's store-level undo — is called and must return
        True when it restored the prior bytes locally (EC rollback
        stash).  When it cannot (replicated pools have no stash), an
        entry with a prior version re-enters `missing` at that prior:
        recovery pulls the authoritative copy.  Returns the divergent
        entries, newest first."""
        ev = tuple(ev)
        divergent = self.truncate_to(ev)
        for e in divergent:
            oid, prior = e["oid"], e.get("prior")
            restored = bool(on_divergent(e)) if on_divergent else False
            if prior is not None:
                self.objects[oid] = prior
                if e["op"] == "delete":
                    self.deleted.pop(oid, None)
                if not restored:
                    self.missing[oid] = prior
            else:
                # divergent create: the object never existed at the
                # rewind point — delete-or-rollback resolves to delete
                self.objects.pop(oid, None)
                self.missing.pop(oid, None)
        # invariant sweep: no index claim may outlive the new head
        for idx in (self.objects, self.deleted):
            for oid in [o for o, v in idx.items() if v > ev]:
                idx.pop(oid, None)
        for oid in [o for o, v in self.missing.items() if v > ev]:
            self.missing.pop(oid, None)
        return divergent

    def note(self, ev: tuple, oid: str, op: str,
             prior: tuple | None = None, rollback: dict | None = None,
             shard: int | None = None) -> dict:
        entry = {"ev": tuple(ev), "oid": oid, "op": op, "prior": prior,
                 "rollback": rollback, "shard": shard}
        self.add(entry)
        return entry

    @property
    def head(self) -> tuple:
        return self.entries[-1]["ev"] if self.entries else ZERO_EV

    def record_recovered(self, ev: tuple, oid: str,
                         shard: int | None = None) -> None:
        """Note an object landed by recovery (push/rebuild) WITHOUT
        regressing the log: recovered versions are usually older than
        head, and appending them would make entries non-monotonic and
        head (our peering last_update vote) lie backwards."""
        ev = tuple(ev)
        if self.deleted.get(oid, ZERO_EV) > ev:
            return    # a stale push must not resurrect a deleted object
        if ev >= self.missing.get(oid, ZERO_EV):
            self.missing.pop(oid, None)
        if ev > self.head:
            self.note(ev, oid, "modify", shard=shard)
            return
        if ev >= self.objects.get(oid, ZERO_EV):
            self.objects[oid] = ev
            self.deleted.pop(oid, None)

    def truncate_to(self, ev: tuple) -> list[dict]:
        """Drop (and return, newest first) entries newer than ev.
        Index fixups are the caller's job — it is applying rollbacks."""
        ev = tuple(ev)
        divergent = [e for e in self.entries if e["ev"] > ev]
        self.entries = [e for e in self.entries if e["ev"] <= ev]
        return list(reversed(divergent))

    def encode(self) -> bytes:
        return denc.dumps((self.entries, self.objects, self.deleted,
                           self.tail, self.missing))

    @staticmethod
    def decode(blob: bytes,
               max_entries: int | None = None) -> "PGLog":
        log = PGLog(max_entries=max_entries)
        fields = denc.loads(blob)
        entries, objects, deleted = fields[0], fields[1], fields[2]
        if len(fields) > 3:
            log.tail = tuple(fields[3])
        elif len(entries) >= PGLog.MAX_ENTRIES:
            # legacy 3-field blob at the old cap: the log WAS trimmed
            # but the boundary was not recorded — claim a conservative
            # tail so entries_since never reports a delta that spans
            # the lost range (forcing backfill is safe; a silent gap
            # is not)
            log.tail = tuple(entries[0]["ev"])
        else:
            log.tail = ZERO_EV
        log.entries = []
        for e in entries:
            e = dict(e)
            e["ev"] = tuple(e["ev"])
            if e.get("prior") is not None:
                e["prior"] = tuple(e["prior"])
            log.entries.append(e)
        log.objects = {o: tuple(v) for o, v in objects.items()}
        log.deleted = {o: tuple(v) for o, v in deleted.items()}
        if len(fields) > 4:
            log.missing = {o: tuple(v) for o, v in fields[4].items()}
        return log

