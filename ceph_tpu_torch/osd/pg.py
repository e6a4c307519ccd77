"""Placement groups: the per-PG core — identity, op dispatch,
client reads/writes, watch/notify, scrub entry.

The osd/PG.h + ReplicatedPG tier, split along the reference's file
seams (osd/PGBackend.cc:314 factory boundary):

  * pg.py (this file): PG state + client op execution (do_op: the
    CEPH_OSD_OP_* switch analog, osd/ReplicatedPG.cc:4325 do_osd_ops).
  * pglog.py: PGLog + object naming (osd/PGLog.{h,cc}).
  * backend.py: shared backend machinery — ordered sub-op apply,
    dup/superseded detection, commit gather (osd/PGBackend.{h,cc}).
  * backend_rep.py: ReplicatedBackend (osd/ReplicatedBackend.cc).
  * backend_ec.py: ECBackend + ECTransaction semantics
    (osd/ECBackend.{h,cc}, osd/ECTransaction.h).
  * cache_tier.py: cache tiering agent (ReplicatedPG agent_work).
  * snaps.py: SnapSet COW clones + trim (make_writeable, SnapMapper).
  * peering.py: peering + recovery orchestration (PG statechart
    region, osd/PG.h:195).

EC pools take whole-object writes (writefull/append), the same
append-only discipline the reference enforces (no overwrites,
osd/ECTransaction.h) reduced to its simplest correct form.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import TYPE_CHECKING

from ..crush.map import ITEM_NONE
from ..store.objectstore import StoreError, Transaction
from ..utils import denc
from ..utils.dout import DoutLogger
from .backend import PGBackendBase
from .backend_ec import ECBackend
from .backend_rep import ReplicatedBackend
from .cache_tier import CacheTier
from .messages import MOSDOpReply
from .osdmap import PgId
from .peering import Peering
from .pglog import (DIRTY_KEY, HINFO_KEY, SNAPSET_KEY, VER_KEY,
                    WHITEOUT_KEY, ZERO_EV, PGLog, clone_oid,
                    shard_oid, snapdir_oid, stash_oid)
from .snaps import SnapOps

if TYPE_CHECKING:
    from .daemon import OSDDaemon

__all__ = [
    "PG", "PGLog", "ZERO_EV", "HINFO_KEY", "VER_KEY", "SNAPSET_KEY",
    "WHITEOUT_KEY", "DIRTY_KEY", "clone_oid", "snapdir_oid",
    "shard_oid", "stash_oid",
]


class PG(ReplicatedBackend, ECBackend, CacheTier, SnapOps, Peering,
         PGBackendBase):
    def __init__(self, osd: "OSDDaemon", pgid: PgId):
        self.osd = osd
        self.pgid = pgid
        self.cid = f"pg_{pgid}"
        self.log = DoutLogger("pg", f"osd.{osd.whoami} {pgid}")
        self.pglog = PGLog(
            max_entries=int(osd.conf.osd_pg_log_max_entries))
        self.version = 0                  # counter half of the eversion
        self.interval_epoch = 0           # epoch half (current interval)
        self.last_complete = ZERO_EV      # all acks in for <= this; EC
                                          # shards may trim rollback state
        # newest interval this copy KNOWS went active (primary stamps
        # it at activation and broadcasts to the acting set): the
        # find_best_info tiebreaker that beats a stray higher version
        # minted on a partitioned branch (info_t.last_epoch_started)
        self.last_epoch_started = 0
        self.up: list[int] = []
        self.acting: list[int] = []
        # scheduled-scrub bookkeeping (OSD::sched_scrub, osd/OSD.cc:
        # 1054): per-PG stamps drive the interval checks; the last
        # result is kept for observability/tests
        now = osd.clock.now()
        self.last_scrub_stamp = now
        self.last_deep_scrub_stamp = now
        self.last_scrub_result: dict | None = None
        self.active = False
        # the last EC peering round found no head held by k shards
        self.peer_incomplete = False
        # (EC primary) the shard-role audit of this interval has not yet
        # seen every acting member hold every object at its role
        self.ec_audit_pending = False
        # last_backfill watermark (the reference's info_t.last_backfill,
        # a real high-water mark now, not just a flag): None = this
        # copy is complete; a string = every object NAME at or below
        # it has been restored, everything above is still in flight.
        # Peering treats a watermarked copy as incomplete regardless
        # of last_update (its log head overstates what it holds), an
        # interrupted backfill RESUMES from the persisted watermark
        # instead of re-walking the namespace, and the primary routes
        # live ops: oid <= watermark rides the normal log path, oid
        # beyond it is backfill-deferred (the scan lands it).
        self.last_backfill: str | None = None
        # primary-side view of each backfilling peer's watermark
        # (drives the op routing above); cleared on interval change
        self.peer_last_backfill: dict[int, str] = {}
        # instantiated with no persisted state this boot (vs reloaded
        # from the store): a split release may adopt the parent's
        # completeness for such a copy
        self.fresh_copy = False
        # True on a fresh split child until the local parent split has
        # moved its objects in: client I/O answers EAGAIN and peering
        # answers "unknown" meanwhile (both retry)
        self.split_pending = False
        self.lock = threading.RLock()
        self._inflight: dict[tuple, dict] = {}   # reqid -> gather state
        # EC reads of an object whose write is still gathering its
        # shards PARK here until it finishes (oid -> [(conn, msg)])
        self._reads_behind_writes: dict[str, list] = {}
        # serve-during-repair: client ops touching an object in the
        # pg's `missing` set PARK here until the recovery pull lands
        # (oid -> {"ops": [(conn, msg)], "retries": n}) — serving
        # whatever bytes the store holds for a missing object is the
        # stale-read hole the reference closes the same way
        # (ReplicatedPG wait_for_unreadable_object / wait_for_degraded)
        self._recovery_blocked: dict[str, dict] = {}
        # one front-of-queue pull promotion per blocked object
        self._promoted_pulls: set[str] = set()
        # oid -> monotonic time its recovery pull was last queued
        # (peering-round dedup; see _queue_missing_pulls)
        self._pull_queued_at: dict[str, float] = {}
        # (osd_id, oid) -> monotonic time a peer-claim heal push was
        # last queued (same dedup for the heal path)
        self._heal_pushed_at: dict[tuple, float] = {}
        # parked sub-op keys counted as recovery-blocked (backfill
        # target raced ahead of its base push; see _park_if_gap)
        self._parked_blocked: set[tuple] = set()
        self._failed_floor: tuple | None = None  # oldest failed write
        # reqid -> (result, version): the client resends on timeout;
        # a duplicate must re-reply, NEVER re-execute (the reference
        # dedups via reqid-carrying pg log entries, osd/osd_types.h)
        self._completed_reqs: dict[tuple, tuple] = {}
        # out-of-order sub-ops parked until their predecessor applies
        # (ordered apply, the reference's in-order MOSDRepOp delivery):
        # (oid, ev) -> (conn, msg, kind)
        self._parked: dict[tuple, tuple] = {}
        # watch/notify (osd/Watch.h): oid -> {(entity, cookie): addr};
        # primary-memory only — clients re-watch on reconnect
        self.watchers: dict[str, dict[tuple, tuple]] = {}
        self._notifies: dict[int, dict] = {}
        self._notify_reqs: dict[tuple, int] = {}   # reqid -> notify id
        self._notify_seq = 0
        # cache tiering (ReplicatedPG agent/promote + HitSet analogs)
        self.hit_sets: list[list] = []     # [[start_ts, set(oids)]...]
        self._promote_waiting: dict[str, list] = {}  # oid -> [(conn,msg)]
        self._flushing: set[str] = set()
        self._agent_hints: set[str] = set()  # oids likely dirty/whiteout
        self._agent_tick = 0
        self._int_tid = itertools.count(1)   # internal-op reqid tids
        self._load()

    # -- identity ----------------------------------------------------------

    @property
    def pool(self):
        return self.osd.osdmap.pools.get(self.pgid.pool)

    @property
    def is_ec(self) -> bool:
        pool = self.pool
        return bool(pool and pool.is_erasure)

    @property
    def is_cache(self) -> bool:
        pool = self.pool
        return bool(pool and pool.tier_of >= 0
                    and pool.cache_mode != "none")

    @property
    def base_pool(self):
        pool = self.pool
        if pool is None or pool.tier_of < 0:
            return None
        return self.osd.osdmap.pools.get(pool.tier_of)

    @property
    def backfill_complete(self) -> bool:
        """Complete == no backfill watermark outstanding."""
        return self.last_backfill is None

    def role_of(self, osd_id: int) -> int:
        """Index in acting set (shard id for EC), -1 if not a member."""
        try:
            return self.acting.index(osd_id)
        except ValueError:
            return -1

    @property
    def is_primary(self) -> bool:
        """First LIVE member acts as primary (up_primary semantics:
        an EC acting set can have a NONE hole at position 0)."""
        live = self.acting_live()
        return bool(live) and live[0] == self.osd.whoami

    def acting_live(self) -> list[int]:
        return [o for o in self.acting if o != ITEM_NONE]

    # -- persistence -------------------------------------------------------

    def _load(self) -> None:
        store = self.osd.store
        if not store.collection_exists(self.cid):
            t = Transaction().create_collection(self.cid)
            store.apply_transaction(t)
            self.fresh_copy = True
            if not self.osd.witnessed_pool_birth(self.pgid.pool):
                # fresh copy of a pg that predates us — a reboot that
                # lost our store (memstore), or a membership change.
                # An empty log that then applies live sub-ops would
                # advertise their head as a complete last_update and
                # WIN auth election with none of the history behind
                # it (a lying head loses acked writes); stay
                # incomplete until a backfill restores us (or, for a
                # split child, until the local parent split fills us
                # and hands us the parent's completeness).
                self.set_backfill_state(False)
            return
        try:
            blob = store.getattr(self.cid, "_pgmeta", "log")
            self.pglog = PGLog.decode(
                blob, max_entries=int(
                    self.osd.conf.osd_pg_log_max_entries))
            self.version = self.pglog.head[1]
        except StoreError:
            pass
        try:
            vals = store.omap_get_values(self.cid, "_pgmeta", ["hitsets"])
            if "hitsets" in vals:
                self.hit_sets = [[ts, set(oids)] for ts, oids
                                 in denc.loads(vals["hitsets"])]
        except StoreError:
            pass
        from .pglog import (BACKFILL_ATTR, LES_ATTR,
                            decode_backfill_attr)
        try:
            # died mid-backfill: resume from the persisted watermark
            self.last_backfill = decode_backfill_attr(
                store.getattr(self.cid, "_pgmeta", BACKFILL_ATTR))
        except StoreError:
            pass
        try:
            self.last_epoch_started = int(
                store.getattr(self.cid, "_pgmeta", LES_ATTR).decode())
        except (StoreError, ValueError):
            pass

    def set_backfill_state(self, complete: bool,
                           watermark: str = "") -> None:
        """Persist the incomplete-copy watermark so a crash
        mid-backfill resumes FROM it (not from scratch).  Caller
        holds self.lock."""
        from .pglog import BACKFILL_ATTR, encode_backfill_attr
        self.last_backfill = None if complete else watermark
        txn = Transaction()
        if complete:
            txn.touch(self.cid, "_pgmeta")
            txn.rmattr(self.cid, "_pgmeta", BACKFILL_ATTR)
        else:
            txn.setattr(self.cid, "_pgmeta", BACKFILL_ATTR,
                        encode_backfill_attr(watermark))
        try:
            self.osd.store.apply_transaction(txn)
        except StoreError:
            pass

    def advance_backfill(self, watermark: str) -> None:
        """Primary finished pushing a scan batch up to `watermark`:
        persist the high-water mark (monotonic — a reordered or
        duplicate progress marker never regresses it).  Caller holds
        self.lock."""
        if self.last_backfill is None or watermark <= self.last_backfill:
            return
        self.set_backfill_state(False, watermark)

    def set_last_epoch_started(self, epoch: int) -> None:
        """Record (and persist) that interval `epoch` went active —
        stamped by the primary at activation and broadcast to the
        acting set; the authority tiebreaker of find_best_info.
        Caller holds self.lock."""
        if epoch <= self.last_epoch_started:
            return
        from .pglog import LES_ATTR
        self.last_epoch_started = epoch
        txn = Transaction()
        txn.setattr(self.cid, "_pgmeta", LES_ATTR,
                    str(epoch).encode())
        try:
            self.osd.store.apply_transaction(txn)
        except StoreError:
            pass

    def _persist_log(self, txn: Transaction) -> None:
        txn.setattr(self.cid, "_pgmeta", "log", self.pglog.encode())

    # -- map updates -------------------------------------------------------

    def update_acting(self, up: list[int], acting: list[int]) -> None:
        with self.lock:
            changed = acting != self.acting
            self.up = up
            self.acting = acting
            if changed:
                # new interval: versions minted from here carry this
                # epoch so they order after every prior interval's
                self.interval_epoch = self.osd.osdmap.epoch
                self.version = max(self.version, self.pglog.head[1])
                self._failed_floor = None    # peering reconciles
                self._drop_parked()          # dead interval's sub-ops
                self._drop_recovery_blocked()   # clients re-send
                self._drop_reads_behind_writes()    # clients re-send
                self._pull_queued_at.clear()    # new round re-pulls
                # the dead interval's catch-up: its poll returns without
                # clearing it, and a primary no longer behind never
                # fetches again — left set, the pg never reads clean
                self._catchup_pending = {}
                self._heal_pushed_at.clear()
                self.peer_last_backfill.clear()  # peering re-learns
                self.active = False
                if self.is_primary:
                    self.osd.queue_peering(self.pgid)
                else:
                    self.active = True   # replicas serve what primary sends

    # -- client op execution (primary) ------------------------------------

    def do_op(self, conn, msg) -> None:
        # debug service-time injection (osd_debug_inject_dispatch_
        # delay_*): stretches CLIENT-op execution on the op shard so
        # tests can pin the service rate (QoS drills need a known
        # capacity to overload deterministically).  Sleeps OUTSIDE
        # pg.lock; sub-ops/replies are never delayed.
        p = float(self.osd.conf.
                  osd_debug_inject_dispatch_delay_probability)
        if p > 0:
            import random as _random
            if p >= 1.0 or _random.random() < p:
                import time as _time
                _time.sleep(float(
                    self.osd.conf.
                    osd_debug_inject_dispatch_delay_duration))
        with self.lock:
            if "@" in msg.oid or msg.oid.startswith("_"):
                # '@' marks EC rollback stashes, '_' pg metadata;
                # client names must not collide with either namespace
                self._reply(conn, msg, -22, [])   # EINVAL
                return
            if not self.is_primary:
                self._reply(conn, msg, -11, [])   # EAGAIN: wrong primary
                return
            pool = self.pool
            if pool is None:
                self._reply(conn, msg, -2, [])
                return
            live = len([o for o in self.acting if o != ITEM_NONE])
            if live < pool.min_size:
                self._reply(conn, msg, -11, [])   # degraded below min_size
                return
            if not self.active or self.split_pending:
                self._reply(conn, msg, -11, [])
                return
            if msg.oid in self.pglog.missing and \
                    self._block_on_missing(conn, msg):
                return           # parked; resumes when the pull lands
            if self.is_ec and (getattr(msg, "snapid", None) is not None
                               or getattr(msg, "snapc", None)):
                # EC pools have no clone machinery here: erroring is
                # honest; silently serving head data for a snap read
                # would be a wrong answer
                self._reply(conn, msg, -95, [])   # EOPNOTSUPP
                return
            if self.is_cache and not getattr(msg, "_cache_internal",
                                             False):
                if self._cache_intercept(conn, msg):
                    return
            if any(op[0] in ("watch", "unwatch", "notify")
                   for op in msg.ops):
                self._do_watch_ops(conn, msg)
                return
            reads, writes = self._split_ops(msg.ops)
            if writes:
                self._do_write(conn, msg)
            else:
                self._do_read(conn, msg)

    @staticmethod
    def _split_ops(ops):
        from ..cls import registry as cls_registry
        reads, writes = [], []
        for op in ops:
            if op[0] in ("read", "stat", "getxattr", "getxattrs",
                         "omap_get", "omap_get_keys", "omap_get_vals",
                         "list"):
                reads.append(op)
            elif op[0] == "call" and not cls_registry.is_write(op[1],
                                                              op[2]):
                reads.append(op)
            else:
                writes.append(op)
        return reads, writes

    # ---- serve-during-repair: ops block on recovery pulls ----------------
    #
    # A pg can be ACTIVE with a non-empty `missing` set (the log claims
    # a version whose data has not landed yet: GetLog merges, divergent
    # rewinds that could not restore bytes locally).  A client op that
    # touches such an object must NOT execute against whatever the
    # store holds — a read would serve stale bytes, a write (append,
    # partial write) would build its txn over them.  The op parks on
    # the pg, its pull is promoted to the FRONT of the recovery queue,
    # and it resumes bit-exact once the push applies (the reference
    # blocks exactly this way: ReplicatedPG::wait_for_unreadable_object
    # / wait_for_degraded_object; mClock's recovery class keeps the
    # promoted pull schedulable under load).

    def _block_on_missing(self, conn, msg) -> bool:
        """Park a client op whose object is in `missing`; True when
        parked.  Caller holds self.lock."""
        need = self.pglog.missing.get(msg.oid)
        if need is None:
            return False
        trk = getattr(msg, "_trk", None)
        if trk is not None:
            trk.mark_event("recovery_blocked")
            trk.span_begin("recovery_wait", oid=msg.oid,
                           need=list(need))
        self.osd.perf.inc("recovery_blocked_ops")
        ent = self._recovery_blocked.get(msg.oid)
        if ent is None:
            ent = self._recovery_blocked[msg.oid] = {"ops": [],
                                                     "retries": 0}
            # safety recheck: a lost push must re-promote, and an
            # unrecoverable object must hand the op back eventually.
            # The chain is keyed to THIS ent: a wake-then-reblock
            # cycle mints a fresh ent with its own chain, and the old
            # chain dies on the identity mismatch instead of double-
            # burning the new ent's retry budget.
            self.osd.clock.timer(
                float(self.osd.conf.osd_recovery_block_retry),
                lambda: self.osd.op_wq.queue(
                    self.pgid, self._blocked_recheck, msg.oid, ent))
        ent["ops"].append((conn, msg))
        self._promote_blocked_pull(msg.oid, tuple(need))
        self.log.info("op on missing %s@%s recovery-blocked "
                      "(pull promoted)", msg.oid, tuple(need))
        return True

    def _promote_blocked_pull(self, oid: str, need: tuple,
                              round_: int = 0) -> None:
        """Jump the blocked object's pull to the front of the
        recovery queue (one promotion per blocked object per round).
        Caller holds self.lock."""
        if oid in self._promoted_pulls:
            return
        self._promoted_pulls.add(oid)
        self._pull_queued_at[oid] = time.monotonic()
        self.osd.perf.inc("recovery_prio_promotions")
        my = self.osd.whoami
        if self.is_ec:
            self.osd.queue_ec_rebuild(self.pgid, oid, need,
                                      [(self.role_of(my), my)],
                                      front=True)
            return
        # rotate the holder per retry round: the pusher-side guard
        # makes a holder whose own copy is still missing answer
        # nothing, and re-picking it deterministically would burn the
        # whole retry budget against a peer that can never serve
        holders = [o for o in self.acting_live() if o != my]
        if holders:
            self.osd.pg_request_push(
                self.pgid, holders[round_ % len(holders)], oid,
                front=True)

    def _wake_recovery_blocked(self, oid: str) -> None:
        """The missing entry for `oid` was retired (push applied, or
        a delete superseded the pull): resume every parked op through
        the op queue.  A push too old to retire the claim wakes
        nothing.  Caller holds self.lock."""
        if oid in self.pglog.missing:
            return
        ent = self._recovery_blocked.pop(oid, None)
        self._promoted_pulls.discard(oid)
        if not ent:
            return
        for conn, msg in ent["ops"]:
            self.osd.perf.inc("recovery_unblocked_ops")
            self.osd.op_wq.queue(self.pgid,
                                 self._resume_recovery_blocked,
                                 conn, msg)

    def _resume_recovery_blocked(self, conn, msg) -> None:
        """Op-queue re-entry for a formerly blocked op: close the
        recovery_wait span and run the op from the top (do_op re-checks
        everything — a re-missing object re-parks, a dup write
        re-replies via the dedup table instead of re-executing)."""
        trk = getattr(msg, "_trk", None)
        if trk is not None:
            trk.span_end("recovery_wait")
            trk.mark_event("recovery_unblocked")
        self.osd._handle_op(conn, msg)

    def _blocked_recheck(self, oid: str, armed_ent: dict) -> None:
        """Clock-armed safety net for parked ops: wake if the pull
        landed without a hook firing, re-promote while it has not,
        and EAGAIN the ops back to the client once the retry budget
        is spent (the objecter's resend machinery then owns them)."""
        with self.lock:
            ent = self._recovery_blocked.get(oid)
            if ent is None or ent is not armed_ent:
                return          # a newer park owns its own chain
            if oid not in self.pglog.missing:
                self._wake_recovery_blocked(oid)
                return
            ent["retries"] += 1
            if ent["retries"] > int(
                    self.osd.conf.osd_recovery_block_max_retries):
                self._recovery_blocked.pop(oid, None)
                self._promoted_pulls.discard(oid)
                self.log.warn(
                    "recovery-blocked ops on %s gave up after %d "
                    "pull rounds; EAGAIN", oid, ent["retries"])
                for conn, msg in ent["ops"]:
                    self.osd.perf.inc("recovery_unblocked_ops")
                    trk = getattr(msg, "_trk", None)
                    if trk is not None:
                        trk.mark_event("recovery_unblocked")
                    self._reply(conn, msg, -11, [])
                return
            self._promoted_pulls.discard(oid)
            self._promote_blocked_pull(oid,
                                       tuple(self.pglog.missing[oid]),
                                       round_=ent["retries"])
            self.osd.clock.timer(
                float(self.osd.conf.osd_recovery_block_retry),
                lambda: self.osd.op_wq.queue(
                    self.pgid, self._blocked_recheck, oid, ent))

    def _drop_recovery_blocked(self) -> None:
        """New interval: the parked ops' pulls belong to a dead round —
        EAGAIN them back (clients resend against the re-peered pg).
        Caller holds self.lock."""
        if not self._recovery_blocked:
            return
        blocked = list(self._recovery_blocked.values())
        self._recovery_blocked.clear()
        self._promoted_pulls.clear()
        for ent in blocked:
            for conn, msg in ent["ops"]:
                self.osd.perf.inc("recovery_unblocked_ops")
                trk = getattr(msg, "_trk", None)
                if trk is not None:
                    trk.mark_event("recovery_unblocked")
                self._reply(conn, msg, -11, [])

    # ---- reads -----------------------------------------------------------

    def _do_read(self, conn, msg) -> None:
        if self.is_ec:
            self._ec_read(conn, msg)
            return
        out = []
        result = 0
        store = self.osd.store
        snapid = getattr(msg, "snapid", None)
        read_oid = msg.oid
        clamp = None
        if snapid is not None:
            try:
                read_oid, clamp = self._resolve_snap(msg.oid, int(snapid))
            except StoreError as e:
                self._reply(conn, msg, -e.errno, [None])
                return
        for op in msg.ops:
            try:
                if op[0] == "read":
                    data = store.read(self.cid, read_oid, op[1], op[2])
                    if clamp is not None and op[1] + len(data) > clamp:
                        data = data[: max(0, clamp - op[1])]
                    out.append(data)
                elif op[0] == "stat":
                    st = store.stat(self.cid, read_oid)
                    if clamp is not None:
                        st["size"] = min(st["size"], clamp)
                    st["version"] = self._obj_version(msg.oid)
                    out.append(st)
                elif op[0] == "getxattr":
                    out.append(store.getattr(self.cid, read_oid,
                                             "u." + op[1]))
                elif op[0] == "getxattrs":
                    out.append({k[2:]: v for k, v in
                                store.getattrs(self.cid,
                                               read_oid).items()
                                if k.startswith("u.")})
                elif op[0] == "omap_get":
                    out.append(store.omap_get(self.cid, read_oid))
                elif op[0] == "omap_get_keys":
                    out.append(store.omap_get_values(self.cid, read_oid,
                                                     op[1]))
                elif op[0] == "omap_get_vals":
                    out.append(store.omap_get_vals(
                        self.cid, read_oid, start_after=op[1],
                        prefix=op[2], max_return=op[3]))
                elif op[0] == "call":
                    out.append(self._cls_call(None, read_oid, op))
                elif op[0] == "list":
                    names = store.collection_list(self.cid)
                    out.append([n for n in names
                                if not n.startswith("_pgmeta")
                                and "@" not in n])
            except StoreError as e:
                result = -e.errno
                out.append(None)
                break
        self._reply(conn, msg, result, out)

    def _obj_version(self, oid: str) -> int:
        return self.pglog.objects.get(oid, ZERO_EV)

    # ---- writes ----------------------------------------------------------

    def _do_write(self, conn, msg) -> None:
        reqid = (msg.src, msg.tid)
        inflight = self._inflight.get(reqid)
        if inflight is not None:
            inflight["conn"] = conn       # retry: reply to latest conn
            trk = getattr(msg, "_trk", None)
            if trk is not None:           # the ORIGINAL op is tracked;
                trk.mark_event("duplicate")   # close this one out
                trk.finish()
            return
        done = self._completed_reqs.get(reqid)
        if done is not None:
            result, version, outdata = done
            self._reply(conn, msg, result, outdata, version=version)
            return
        if (self.is_cache and self.pool.cache_mode == "writeback"
                and not getattr(msg, "_cache_internal", False)
                and not any(op[0] == "setxattr_raw" for op in msg.ops)):
            # every client write in a writeback tier marks the object
            # dirty so the agent/flush knows to push it to the base
            msg.ops = list(msg.ops) + [("setxattr_raw", DIRTY_KEY, b"1")]
            self._agent_hints.add(msg.oid)
        self.version += 1
        version = (self.interval_epoch, self.version)
        if self.is_ec:
            self._ec_write(conn, msg, version, reqid)
        else:
            self._replicated_write(conn, msg, version, reqid)

    def _record_completed(self, reqid, result: int, version,
                          outdata: list | None = None) -> None:
        self._completed_reqs[reqid] = (result, version, outdata or [])
        if len(self._completed_reqs) > 1024:
            for key in list(self._completed_reqs)[:256]:
                del self._completed_reqs[key]

    def _build_txn(self, oid: str, ops, version,
                   snapc=None, internal: bool = False
                   ) -> tuple[Transaction, str, list]:
        """Translate client ops into a store Transaction (do_osd_ops).
        Returns (txn, kind, outdata) — cls WR methods produce output."""
        txn = Transaction()
        kind = "modify"
        outdata: list = []
        # "call" here is always a WR method (RD calls took the read
        # path): it mutates, so snapshots need the same COW clone
        mutates = any(op[0] in ("write", "writefull", "append",
                                "truncate", "delete", "rollback", "call",
                                "evict")
                      for op in ops)
        ss = None
        if mutates and not self.is_ec:
            ss = self._make_writeable(txn, oid, snapc)
        cache_wb = self.is_cache and self.pool.cache_mode == "writeback"
        if cache_wb and mutates and not internal:
            # a client write over a whiteout revives the object: the
            # marker must not survive the mutation (delete re-adds it)
            txn.touch(self.cid, oid)
            txn.rmattr(self.cid, oid, WHITEOUT_KEY)
        for op in ops:
            name = op[0]
            if name == "write":
                txn.write(self.cid, oid, op[1], op[2])
            elif name == "writefull":
                txn.truncate(self.cid, oid, 0)
                txn.write(self.cid, oid, 0, op[1])
            elif name == "append":
                size = 0
                try:
                    size = self.osd.store.stat(self.cid, oid)["size"]
                except StoreError:
                    pass
                txn.write(self.cid, oid, size, op[1])
            elif name == "truncate":
                txn.truncate(self.cid, oid, op[1])
            elif name == "delete":
                if cache_wb and not internal:
                    # writeback tier: deletion is a local fact until
                    # flushed — leave a dirty whiteout, the flush
                    # propagates the delete to the base pool
                    # (ReplicatedPG whiteout semantics)
                    self._snap_delete_txn(txn, oid, ss)
                    txn.remove(self.cid, oid)
                    txn.touch(self.cid, oid)
                    txn.setattr(self.cid, oid, WHITEOUT_KEY, b"1")
                    txn.setattr(self.cid, oid, DIRTY_KEY, b"1")
                    self._agent_hints.add(oid)
                else:
                    if not self.is_ec:
                        self._snap_delete_txn(txn, oid, ss)
                    txn.remove(self.cid, oid)
                    kind = "delete"
            elif name == "evict":
                # cache-internal: drop the local copy outright (no
                # whiteout — the base still holds the truth)
                txn.try_remove(self.cid, oid)
                kind = "delete"
            elif name == "setxattr_raw":
                txn.setattr(self.cid, oid, op[1], op[2])
            elif name == "rmattr_raw":
                txn.rmattr(self.cid, oid, op[1])
            elif name == "rollback":
                # restore head from the clone covering the snap
                # (ReplicatedPG rollback: clone contents onto head).
                # `ss` may hold the snapset updated by _make_writeable
                # earlier in THIS txn — reloading from the store here
                # would clobber the just-made clone entry
                src, size = self._resolve_snap(oid, int(op[1]))
                if src != oid:
                    cur_ss = ss if ss is not None \
                        else self._load_snapset(oid)
                    txn.try_remove(self.cid, oid)
                    txn.clone(self.cid, src, oid)
                    if size is not None:
                        txn.truncate(self.cid, oid, size)
                    txn.setattr(self.cid, oid, SNAPSET_KEY,
                                denc.dumps(cur_ss))
            elif name == "setxattr":
                txn.setattr(self.cid, oid, "u." + op[1], op[2])
            elif name == "omap_set":
                txn.omap_setkeys(self.cid, oid, op[1])
            elif name == "omap_rm":
                txn.omap_rmkeys(self.cid, oid, op[1])
            elif name == "touch":
                txn.touch(self.cid, oid)
            elif name == "call":
                kind_out: list = []
                outdata.append(self._cls_call(txn, oid, op, kind_out))
                if kind_out:
                    kind = "delete"
            else:
                raise StoreError(22, f"unknown write op {name}")
        if kind != "delete":
            txn.setattr(self.cid, oid, VER_KEY, repr(version).encode())
        return txn, kind, outdata

    # ---- object classes (in-OSD RPC) -------------------------------------

    def _cls_call(self, txn, oid: str, op,
                  kind_out: list | None = None) -> bytes | None:
        """Execute a class method against the object (do_osd_ops
        CEPH_OSD_OP_CALL; txn None = RD method).  A method that
        removes its object reports it via kind_out so the caller
        treats the op as a delete — otherwise the post-op version
        xattr write would resurrect the object."""
        from ..cls import ClsError, MethodContext, registry
        _name, cls, method, inp = op[0], op[1], op[2], op[3]
        ent = registry.get(cls, method)
        if ent is None:
            raise StoreError(95, f"no such method {cls}.{method}")
        fn, _flags = ent
        ctx = MethodContext(self, txn, oid, inp or b"")
        try:
            out = fn(ctx)
        except ClsError as e:
            raise StoreError(e.errno, str(e))
        if getattr(ctx, "removed", False) and kind_out is not None:
            kind_out.append("delete")
        return out

    # ---- watch / notify (osd/Watch.h) ------------------------------------

    def _do_watch_ops(self, conn, msg) -> None:
        if any(op[0] not in ("watch", "unwatch", "notify")
               for op in msg.ops) or \
                sum(1 for op in msg.ops if op[0] == "notify") > 1:
            # watch-class ops must come alone: silently dropping the
            # other ops in a mixed vector would ack unexecuted writes
            self._reply(conn, msg, -22, [])
            return
        out: list = []
        for op in msg.ops:
            if op[0] == "watch":
                self.watchers.setdefault(msg.oid, {})[
                    (msg.src, int(op[1]))] = conn.peer_addr
                out.append(None)
            elif op[0] == "unwatch":
                w = self.watchers.get(msg.oid, {})
                w.pop((msg.src, int(op[1])), None)
                if not w:
                    self.watchers.pop(msg.oid, None)
                out.append(None)
            elif op[0] == "notify":
                self._start_notify(conn, msg, op)
                return           # replied when acks gather / timeout
        self._reply(conn, msg, 0, out)

    def _start_notify(self, conn, msg, op) -> None:
        from .messages import MWatchNotify
        # notify needs the same retry dedup as writes: the objecter
        # resends on per-try timeouts/map churn, and a re-executed
        # fan-out would invoke every watcher's callback again
        reqid = (msg.src, msg.tid)
        active = self._notify_reqs.get(reqid)
        if active is not None and active in self._notifies:
            self._notifies[active]["conn"] = conn
            return
        done = self._completed_reqs.get(reqid)
        if done is not None:
            self._reply(conn, msg, done[0], done[2])
            return
        payload, timeout = op[1], float(op[2]) if len(op) > 2 else 5.0
        targets = dict(self.watchers.get(msg.oid, {}))
        self._notify_seq += 1
        nid = self._notify_seq
        if not targets:
            self._record_completed(reqid, 0, ZERO_EV, [{}])
            self._reply(conn, msg, 0, [{}])
            return
        state = {"waiting": set(targets), "replies": {}, "conn": conn,
                 "msg": msg, "reqid": reqid}
        self._notifies[nid] = state
        self._notify_reqs[reqid] = nid
        for (entity, cookie), addr in targets.items():
            self.osd.msgr.send_message(
                MWatchNotify(oid=msg.oid, pgid=str(self.pgid),
                             notify_id=nid, cookie=cookie,
                             payload=payload),
                entity, tuple(addr))
        self.osd.clock.timer(timeout,
                             lambda: self._finish_notify(nid, True))

    def handle_notify_ack(self, msg) -> None:
        with self.lock:
            state = self._notifies.get(msg.notify_id)
            if state is None:
                return
            key = (msg.src, int(msg.cookie))
            state["replies"]["/".join(map(str, key))] = msg.reply
            state["waiting"].discard(key)
            if not state["waiting"]:
                self._finish_notify(msg.notify_id, False)

    def _finish_notify(self, nid: int, timed_out: bool) -> None:
        with self.lock:
            state = self._notifies.pop(nid, None)
            if state is None:
                return
            if timed_out:
                self.log.warn("notify %d timed out waiting for %s",
                              nid, state["waiting"])
            out = [dict(state["replies"])]
            self._notify_reqs.pop(state["reqid"], None)
            self._record_completed(state["reqid"], 0, ZERO_EV, out)
            self._reply(state["conn"], state["msg"], 0, out)

    def remove_watchers_of(self, entity: str) -> None:
        """Client connection reset: its watches die (Watch::disconnect)
        and pending notify gathers stop waiting on it — no ack will
        ever come, so waiting out the full timeout helps nobody."""
        with self.lock:
            for oid in list(self.watchers):
                w = self.watchers[oid]
                for key in [k for k in w if k[0] == entity]:
                    del w[key]
                if not w:
                    del self.watchers[oid]
            for nid in list(self._notifies):
                state = self._notifies[nid]
                dead = {k for k in state["waiting"] if k[0] == entity}
                if dead:
                    state["waiting"] -= dead
                    if not state["waiting"]:
                        self._finish_notify(nid, False)

    def _reply(self, conn, msg, result: int, outdata, version: int = 0):
        if conn is None:
            # cache-internal op (promote/flush/evict): no client to
            # answer — complete the continuation instead
            cb = getattr(msg, "_internal_done", None)
            if cb is not None:
                msg._internal_done = None
                cb(result)
            return
        trk = getattr(msg, "_trk", None)
        if trk is not None:
            msg._trk = None
            perf = self.osd.perf
            reads, writes = self._split_ops(msg.ops)
            perf.inc("op_w" if writes else "op_r")
            from ..utils.bufferlist import BufferList
            from ..utils import copyaudit
            if writes:
                copyaudit.note_write()
            else:
                copyaudit.note_read()
            perf.inc("op_out_bytes", sum(
                len(d) for d in outdata
                if isinstance(d, (bytes, bytearray, memoryview,
                                  BufferList))))
            perf.tinc("op_latency", trk.age(self.osd.clock.now()))
            trk.finish()
        reply = MOSDOpReply(
            tid=msg.tid, result=result, outdata=outdata, version=version,
            epoch=self.osd.osdmap.epoch)
        rtid = getattr(msg, "rpc_tid", None)
        if rtid is not None:
            reply.rpc_tid = rtid        # OSD-internal client (promote/
        self.osd.reply_to_client(conn, reply)   # flush) matches by tid


    def scrub(self, deep: bool = False, repair: bool = False) -> dict:
        """Compare object sets (+ checksums if deep) across the acting
        set; returns {"inconsistent": [...], "checked": N}.

        repair=True additionally heals what the scan found (the
        reference's `ceph pg repair` flow: authoritative-copy
        selection + repair pushes for replicated pools,
        PGBackend.cc:501 be_select_auth_object; shard rebuild for EC,
        test/osd/osd-scrub-repair.sh:201-243 scenarios) and re-scrubs
        to report `clean_after_repair`."""
        with self.lock:
            result = (self.osd.scrub_ec_pg(self) if self.is_ec
                      else self.osd.scrub_replicated_pg(self, deep))
        now = self.osd.clock.now()
        self.last_scrub_stamp = now
        if deep or self.is_ec:
            self.last_deep_scrub_stamp = now
        self.last_scrub_result = dict(result)
        if repair and result["inconsistent"]:
            # repair runs WITHOUT pg.lock: it pulls authoritative
            # copies over RPCs whose reply handlers take the lock
            if self.is_ec:
                repaired = self.osd.repair_ec_pg(
                    self, result["inconsistent"])
            else:
                repaired = self.osd.repair_replicated_pg(
                    self, result["inconsistent"])
            with self.lock:
                after = (self.osd.scrub_ec_pg(self) if self.is_ec
                         else self.osd.scrub_replicated_pg(self, deep))
            result = dict(result)
            result["repaired"] = repaired
            result["clean_after_repair"] = not after["inconsistent"]
        return result

