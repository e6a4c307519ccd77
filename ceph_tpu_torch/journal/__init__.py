"""Client-side distributed journal (journal/ analog: Journaler,
JournalRecorder, JournalPlayer, ObjectRecorder/Player, trimmer).

The reference's journal library — the substrate under rbd-mirror —
records entries into a ring of RADOS objects ("splay" objects) with
commit positions tracked in a metadata object's omap, so a remote
player can tail the journal and a trimmer can drop fully-committed
object sets.  Reduced here to the load-bearing core:

  * metadata object <prefix>.meta: omap holds the static layout
    (splay_width, entries_per_object) and each client's commit
    position;
  * entry objects <prefix>.<objnum>: POSITION-TAGGED length-prefixed
    records — concurrent appenders may interleave arrival order
    within an object, so every record carries its position and the
    player indexes by it rather than by arrival order;
  * position allocation is a compare-and-swap through the kvstore
    object class (in-OSD serialization), so two recorders can never
    claim the same position;
  * Journaler.append / replay(from_pos) / commit(pos) / trim().

Entry objects are slot-bounded (entries_per_object records each), not
byte-bounded: trim granularity is a whole splay set.
"""

from __future__ import annotations

import struct

from ..client.rados import RadosError
from ..utils import denc

_REC = struct.Struct("<QI")     # position, payload length


class JournalError(RadosError):
    pass


def meta_oid(prefix: str) -> str:
    return f"{prefix}.meta"


def entry_oid(prefix: str, objnum: int) -> str:
    return f"{prefix}.{objnum:08x}"


class Journaler:
    """Recorder + player + trimmer over one journal (Journaler.cc)."""

    def __init__(self, ioctx, prefix: str, client_id: str = "main"):
        self.io = ioctx
        self.prefix = prefix
        self.client_id = client_id
        self.meta: dict | None = None

    # -- lifecycle ---------------------------------------------------------

    def create(self, splay_width: int = 4,
               entries_per_object: int = 256) -> None:
        if splay_width < 1 or entries_per_object < 1:
            raise JournalError(22, "bad layout")
        try:
            self.io.stat(meta_oid(self.prefix))
            raise JournalError(17, f"journal {self.prefix} exists")
        except RadosError as e:
            if e.errno != 2:
                raise
        self.io.set_omap(meta_oid(self.prefix), {
            "layout": denc.dumps({
                "splay_width": splay_width,
                "entries_per_object": entries_per_object}),
        })
        self.meta = {"splay_width": splay_width,
                     "entries_per_object": entries_per_object}

    def open(self) -> "Journaler":
        try:
            omap = self.io.get_omap(meta_oid(self.prefix))
        except RadosError as e:
            raise JournalError(e.errno,
                               f"no journal {self.prefix}") from e
        blob = omap.get("layout")
        if blob is None:
            raise JournalError(2, f"no journal {self.prefix}")
        self.meta = denc.loads(blob)
        return self

    def register_client(self, client_id: str) -> None:
        """Start tracking a consumer; a RE-registration is a no-op —
        resetting an existing commit position to 0 would stall trim
        and make the client replay past trimmed sets."""
        try:
            self.io.execute(meta_oid(self.prefix), "kvstore", "cas",
                            denc.dumps({"key": f"commit.{client_id}",
                                        "expect": None,
                                        "value": denc.dumps(0)}))
        except RadosError as e:
            if e.errno != 125:      # ECANCELED = already registered
                raise

    def remove(self) -> None:
        if self.meta is None:
            self.open()
        total = self._entry_count()
        width = self.meta["splay_width"]
        per_obj = self.meta["entries_per_object"]
        sets = total // (width * per_obj) + 2
        for objnum in range(sets * width):
            try:
                self.io.remove_object(entry_oid(self.prefix, objnum))
            except RadosError:
                pass
        self.io.remove_object(meta_oid(self.prefix))

    # -- positions ---------------------------------------------------------

    def _entry_count(self) -> int:
        omap = self.io.get_omap(meta_oid(self.prefix))
        blob = omap.get("entries")
        return denc.loads(blob) if blob else 0

    def _commit_positions(self) -> dict[str, int]:
        omap = self.io.get_omap(meta_oid(self.prefix))
        out = {}
        for key, blob in omap.items():
            if key.startswith("commit."):
                out[key[len("commit."):]] = denc.loads(blob)
        return out

    def commit(self, position: int) -> None:
        """Entries below `position` are consumed by THIS client."""
        self.io.set_omap(meta_oid(self.prefix),
                         {f"commit.{self.client_id}":
                          denc.dumps(int(position))})

    def _objnum_for(self, entry_no: int) -> int:
        width = self.meta["splay_width"]
        per_obj = self.meta["entries_per_object"]
        setno = entry_no // (width * per_obj)
        return setno * width + entry_no % width

    # -- recorder ----------------------------------------------------------

    def _alloc_position(self) -> int:
        """CAS the entries counter in-OSD: concurrent recorders never
        claim the same position (JournalMetadata allocation)."""
        while True:
            omap = self.io.get_omap(meta_oid(self.prefix))
            cur = omap.get("entries")
            n = denc.loads(cur) if cur else 0
            try:
                self.io.execute(
                    meta_oid(self.prefix), "kvstore", "cas",
                    denc.dumps({"key": "entries", "expect": cur,
                                "value": denc.dumps(n + 1)}))
                return n
            except RadosError as e:
                if e.errno != 125:      # ECANCELED = lost the race
                    raise

    def append(self, entry: bytes) -> int:
        """Record one entry; returns its position (entry number)."""
        if self.meta is None:
            self.open()
        entry = bytes(entry)
        n = self._alloc_position()
        objnum = self._objnum_for(n)
        self.io.append(entry_oid(self.prefix, objnum),
                       _REC.pack(n, len(entry)) + entry)
        return n

    # -- player ------------------------------------------------------------

    def replay(self, from_position: int = 0):
        """Yield (position, entry_bytes) from from_position onward.

        Entry objects are read per splay SET and evicted once the
        cursor leaves the set — memory is bounded by one set, not the
        journal (JournalPlayer's prefetch window).
        """
        if self.meta is None:
            self.open()
        total = self._entry_count()
        width = self.meta["splay_width"]
        per_obj = self.meta["entries_per_object"]
        cache: dict[int, dict[int, bytes]] = {}
        cur_set = None
        for n in range(from_position, total):
            setno = n // (width * per_obj)
            if setno != cur_set:
                cache.clear()              # evict the finished set
                cur_set = setno
            objnum = self._objnum_for(n)
            if objnum not in cache:
                cache[objnum] = self._read_entries(objnum)
            if n not in cache[objnum]:
                raise JournalError(5, f"journal truncated at {n}")
            yield n, cache[objnum][n]

    def _read_entries(self, objnum: int) -> dict[int, bytes]:
        try:
            blob = self.io.read(entry_oid(self.prefix, objnum))
        except RadosError as e:
            if e.errno == 2:
                return {}
            raise
        out: dict[int, bytes] = {}
        pos = 0
        while pos + _REC.size <= len(blob):
            position, ln = _REC.unpack_from(blob, pos)
            pos += _REC.size
            if pos + ln > len(blob):
                break                  # torn tail
            out[position] = blob[pos: pos + ln]
            pos += ln
        return out

    # -- trimmer -----------------------------------------------------------

    def trim(self) -> int:
        """Drop entry objects wholly below every client's commit
        position (JournalTrimmer); a persisted floor marker keeps each
        call O(newly dead sets), not O(history)."""
        if self.meta is None:
            self.open()
        positions = self._commit_positions()
        if not positions:
            return 0
        floor = min(positions.values())
        width = self.meta["splay_width"]
        per_obj = self.meta["entries_per_object"]
        dead_sets = floor // (width * per_obj)
        omap = self.io.get_omap(meta_oid(self.prefix))
        start = denc.loads(omap["trimmed_sets"]) \
            if "trimmed_sets" in omap else 0
        removed = 0
        for setno in range(start, dead_sets):
            for i in range(width):
                try:
                    self.io.remove_object(
                        entry_oid(self.prefix, setno * width + i))
                    removed += 1
                except RadosError:
                    pass
        if dead_sets > start:
            self.io.set_omap(meta_oid(self.prefix),
                             {"trimmed_sets": denc.dumps(dead_sets)})
        return removed
