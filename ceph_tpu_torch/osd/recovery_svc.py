"""OSD recovery service: pushes, backfill, PG split, EC rebuild.

Mixin half of the OSD daemon (osd/daemon.py keeps dispatch/lifecycle):
log-driven recovery pushes (osd/ReplicatedBackend.cc push/pull),
reservation-throttled backfill scans, pg_temp reconciliation and PG
split follow-through (osd/OSD.cc:7553 split_pgs), the cache tier's
internal base-pool client, and EC shard fetch/rebuild
(osd/ECBackend.cc RecoveryOp).  All methods run on worker threads or
the async-RPC callbacks — never on the messenger loop.
"""

from __future__ import annotations

import threading
from typing import Callable

from ..msg import Message
from ..store.objectstore import StoreError, Transaction
from ..utils import denc
from .messages import (MOSDECSubOpRead, MOSDECSubOpReadReply, MOSDOp,
                       MOSDOpReply, MPGInfo, MPGPush, MPGPushReply)
from .osdmap import PgId
from ..crush.map import ITEM_NONE
from .pg import (HINFO_KEY, PG, SNAPSET_KEY, VER_KEY,
                 WHITEOUT_KEY, shard_oid)


class RecoveryService:
    def _note_recovery_push(self, nbytes: int) -> None:
        """recovery_bytes accounting: every payload byte recovery
        sends a peer (push, rebuild shard, repair, tombstones are
        free).  The log-authoritative acceptance metric: proportional
        to DIVERGENCE, never to pg size."""
        self.perf.inc("recovery_pushes")
        self.perf.inc("recovery_bytes", int(nbytes))

    def pg_push_object(self, pgid: PgId, target: int, oid: str,
                       version: int, shard: int | None,
                       front: bool = False) -> None:
        """Recovery push, gated by a reservation slot: the slot frees
        when the peer acks the push (or a safety timer fires), so at
        most osd_recovery_max_active pushes are in flight.  front=True
        queues ahead of every waiting grant — a pull a client op is
        recovery-blocked on must not wait out the repair backlog."""
        def work(release: Callable) -> None:
            # run off the caller's thread: the reserver fires work
            # INLINE when a slot is free, and pg.lock may be held here
            # (peering's delta pushes) — get_pg takes pg_lock, which
            # must never nest under pg.lock
            self.op_wq.queue(pgid, self._do_push_object, pgid, target,
                             oid, version, shard, release)

        self._recovery.request(work, front=front)

    def _do_push_object(self, pgid: PgId, target: int, oid: str,
                        version: int, shard: int | None,
                        release: Callable) -> None:
        pg = self.get_pg(pgid)
        if pg is None:
            release()
            return
        with pg.lock:
            if oid in pg.pglog.missing:
                # OUR copy's data has not landed either (the log
                # merely claims the version): pushing store bytes
                # stamped with the claimed version would propagate
                # stale data and retire the target's missing claim
                # with it.  Skip — the requester's recheck (or the
                # next nudge round) retries once our own pull lands.
                self.log.info("not pushing %s to osd.%d: our own "
                              "copy is still missing", oid, target)
                release()
                return
        name = oid if shard is None else shard_oid(oid, shard)
        try:
            data = self.store.read(pg.cid, name)
            xattrs = self.store.getattrs(pg.cid, name)
            omap = self.store.omap_get(pg.cid, name)
        except StoreError:
            release()
            return
        self._note_recovery_push(len(data))
        # recovery pushes are traced like ops: the primary's push op
        # spans the RPC round trip, and the MPGPush carries the trace
        # id so the target's apply timeline correlates with it
        trace = f"push:{pgid}:{oid}:{version}"
        trk = self.op_tracker.create(
            f"push({pgid} {oid} v={version} -> osd.{target})",
            trace_id=trace, kind="recovery")
        trk.span_begin("push_rpc", target=target, bytes=len(data))

        def _pushed(_reply) -> None:
            trk.finish()
            release()

        self._call_async(target, MPGPush(
            pgid=str(pgid), oid=oid, version=version, data=data,
            xattrs=xattrs, omap=omap, shard=shard, trace=trace,
            epoch=self.osdmap.epoch),
            _pushed, timeout=10.0)
        if shard is None:
            # replicated snap history travels with the head:
            # clones referenced by the SnapSet must exist on the
            # peer or its snap reads will ENOENT after recovery
            self._push_clones(pg, target, oid, xattrs)

    def repair_push_object(self, pg: PG, target: int, oid: str,
                           version, shard: int | None) -> bool:
        """Synchronous repair push: send the authoritative copy and
        WAIT for the peer's apply ack, so the caller's verification
        re-scrub cannot race the heal.  Scrub repair runs without
        pg.lock held, so blocking here is safe (the async
        pg_push_object path defers through the reserver + op queue
        and gives no ordering guarantee against a later scan)."""
        name = oid if shard is None else shard_oid(oid, shard)
        try:
            data = self.store.read(pg.cid, name)
            xattrs = self.store.getattrs(pg.cid, name)
            omap = self.store.omap_get(pg.cid, name)
        except StoreError:
            return False
        self._note_recovery_push(len(data))
        reply = self._call(target, MPGPush(
            pgid=str(pg.pgid), oid=oid, version=version, data=data,
            xattrs=xattrs, omap=omap, shard=shard,
            epoch=self.osdmap.epoch), timeout=10.0)
        if shard is None:
            self._push_clones(pg, target, oid, xattrs)
        return reply is not None

    def _push_clones(self, pg: PG, target: int, oid: str,
                     head_xattrs: dict) -> None:
        from .pg import SNAPSET_KEY, clone_oid
        blob = head_xattrs.get(SNAPSET_KEY)
        if not blob:
            return
        try:
            ss = denc.loads(blob)
        except Exception:
            return
        for entry in ss.get("clones", []):
            cname = clone_oid(oid, entry[0])
            try:
                data = self.store.read(pg.cid, cname)
                xattrs = self.store.getattrs(pg.cid, cname)
            except StoreError:
                continue
            self.send_osd(target, MPGPush(
                pgid=str(pg.pgid), oid=oid, version=(0, 0), data=data,
                xattrs=xattrs, omap={}, shard=None, raw_name=cname,
                epoch=self.osdmap.epoch))

    def _handle_push(self, conn, msg, pg: PG) -> None:
        raw = getattr(msg, "raw_name", None)
        if raw is not None:
            # snapshot clone payload: store verbatim, no log update
            with pg.lock:
                txn = Transaction()
                txn.try_remove(pg.cid, raw)
                txn.touch(pg.cid, raw)
                txn.write(pg.cid, raw, 0, msg.data)
                for k, v in msg.xattrs.items():
                    txn.setattr(pg.cid, raw, k, v)
                try:
                    self.store.apply_transaction(txn)
                except StoreError:
                    pass
            reply = MPGPushReply(pgid=msg.pgid, oid=msg.oid,
                                 shard=msg.shard)
            reply.rpc_tid = getattr(msg, "rpc_tid", None)
            self.send_osd_reply(conn, reply)
            return
        name = msg.oid if msg.shard is None else shard_oid(msg.oid, msg.shard)
        with pg.lock:
            cur = pg.pglog.objects.get(msg.oid, (0, 0))
            version = tuple(msg.version)
            # a tombstone newer than the push must win: absence reads
            # as (0,0) in the gate below, which is correct for a
            # backfill target that never held the object but would
            # RESURRECT one deleted while the push was in flight
            dv = pg.pglog.deleted.get(msg.oid)
            if dv is not None and tuple(dv) > version:
                version = None
            if version is not None and version >= cur:
                txn = Transaction()
                txn.truncate(pg.cid, name, 0)
                txn.write(pg.cid, name, 0, msg.data)
                for k, v in msg.xattrs.items():
                    txn.setattr(pg.cid, name, k, v)
                if msg.omap:
                    txn.omap_setkeys(pg.cid, name, msg.omap)
                pg.pglog.record_recovered(version, msg.oid,
                                          shard=msg.shard)
                pg.version = max(pg.version, version[1])
                pg._persist_log(txn)
                self.store.apply_transaction(txn)
                # recovery may have filled the gap a parked sub-op is
                # waiting on — flush it now instead of letting it sit
                # out the expiry timer and issue a spurious heal
                pg._flush_parked(msg.oid)
            # the push may have retired a `missing` claim client ops
            # are recovery-blocked on: resume them (no-op otherwise)
            pg._wake_recovery_blocked(msg.oid)
        reply = MPGPushReply(pgid=msg.pgid, oid=msg.oid, shard=msg.shard)
        reply.rpc_tid = getattr(msg, "rpc_tid", None)
        self.send_osd_reply(conn, reply)

    def pg_request_push(self, pgid: PgId, holder: int, oid: str,
                        front: bool = False) -> None:
        """Pull: ask the holder to push its authoritative copy to us.
        front=True asks the holder to jump its recovery queue (a
        client op is blocked on this object)."""
        self.send_osd(holder, MPGInfo(op="pull", pgid=str(pgid), oid=oid,
                                      front=1 if front else 0,
                                      epoch=self.osdmap.epoch))

    # -- backfill (reservation-throttled ranged scans) ---------------------
    #
    # A peer whose last_update predates the primary's log tail cannot
    # be recovered from log deltas: the primary walks its own object
    # space in sorted batches, asks the peer for its version view of
    # the same range (scan_range), pushes every object the peer lacks
    # or holds stale, and instructs deletes for objects the peer has
    # that no longer exist (PG Backfilling state + BackfillInterval,
    # osd/PG.h:195; reservations osd/OSD.h:918).

    def queue_backfill(self, pgid: PgId, target: int,
                       interval_at: int,
                       resume_from: str = "") -> None:
        # dedup: repeated peering rounds within one interval (unknown-
        # peer retries, catch-up re-peers) must not spawn concurrent
        # backfill loops for the same target — each would hold a
        # recovery slot and re-push the whole object space
        key = (pgid, target)
        active = self._backfills_active
        # NOT pg_lock: peering calls this holding pg.lock, and the map
        # thread takes pg_lock -> pg.lock — taking pg_lock here closes
        # an ABBA deadlock cycle (caught by the crash-restart soak)
        with self.backfill_lock:
            if key in active:
                return
            active.add(key)

        def work(release: Callable) -> None:
            def done() -> None:
                with self.backfill_lock:
                    active.discard(key)
                release()
            state = {"pushed": 0, "failed": False, "rescans": 0,
                     "resume": resume_from}
            if resume_from:
                self.perf.inc("backfill_resumes")
                self.log.info("backfill of osd.%d resuming from "
                              "watermark %r", target, resume_from)
            self.recovery_wq.queue(pgid, self._backfill_round, pgid, target,
                             resume_from, interval_at, done, state)
        self._recovery.request(work)

    def _backfill_round(self, pgid: PgId, target: int, cursor: str,
                        interval_at: int, release: Callable,
                        state: dict) -> None:
        pg = self.get_pg(pgid)
        if pg is None or not pg.is_primary or \
                pg.interval_epoch != interval_at:
            release()
            return
        batch = max(1, int(self.conf.osd_backfill_scan_batch))
        # (mutations below the resume watermark — downtime writes and
        # deletes alike — are covered by the LOG DELTA the peering
        # round pushed before queueing this session; peering clears
        # the watermark when the peer's log is not delta-coverable)
        with pg.lock:
            mine = pg.scan_range(after=cursor, upto="", limit=batch)
            # routing frontier, updated under the SAME lock hold as
            # the scan snapshot (writes serialize on pg.lock): a live
            # write to a name at or below this batch's end is SENT to
            # the peer from now on — it raced past the snapshot and
            # the cursor will never look at that name again, so
            # deferring it would leave a claimed-but-missing hole the
            # backfill_done log adoption then papers over.  Names
            # beyond the end stay deferred: the next round's fresh
            # listing covers them.  The FINAL batch (end == "") lifts
            # the deferral entirely — nothing is "beyond" the scan.
            if mine["end"]:
                if target in pg.peer_last_backfill:
                    pg.peer_last_backfill[target] = max(
                        pg.peer_last_backfill[target], mine["end"])
            else:
                pg.peer_last_backfill.pop(target, None)
        seg = mine["objects"]
        end = mine["end"]           # "" == ran off the end of our space
        # the peer's view of the SAME range (upto-bounded, not
        # limit-bounded: deletions hiding past our batch edge would
        # otherwise be missed)
        reply = self._call(target, MPGInfo(
            op="scan_range", pgid=str(pgid), after=cursor, upto=end,
            limit=0, epoch=self.osdmap.epoch), timeout=10.0)
        if reply is None or reply.info.get("unknown"):
            # peer silent or map-lagged (pg not instantiated yet):
            # give the slot back and retry shortly — pushes to a
            # pg-less OSD would vanish
            self.log.warn("backfill of osd.%d stalled at %r; retrying",
                          target, cursor)
            release()
            self.clock.timer(
                2.0, lambda: self.queue_backfill(pgid, target,
                                                 interval_at))
            return
        theirs = {o: tuple(v) for o, v in
                  (reply.info.get("objects", {}) or {}).items()}
        shard = None
        if pg.is_ec:
            shard = pg.role_of(target)
            if shard < 0:
                # a CRUSH target being pre-seeded before a pg_temp
                # release: its shard id is its POSITION in the raw
                # CRUSH up set, not in the (temp) acting set
                up, _a = self.osdmap.pg_to_up_acting_osds(pgid)
                shard = up.index(target) if target in up else -1
            if shard < 0:
                self.log.warn("backfill of osd.%d: no shard position "
                              "in %s; abandoning", target, pgid)
                release()
                return
        for oid, ev in seg.items():
            ev = tuple(ev)
            tv = theirs.get(oid)
            if tv is not None and tv >= ev:
                continue
            state["pushed"] += 1
            # pushes go INLINE (we already hold the backfill's
            # reservation slot), so they ride the same FIFO connection
            # as the final backfill_done marker — the peer can never
            # be marked complete ahead of a still-queued push
            if pg.is_ec:
                if not self._ec_rebuild(pgid, oid, ev,
                                        [(shard, target)],
                                        retry=False):
                    # sources busy (concurrent write): the re-scan
                    # below picks this object up again
                    state["failed"] = True
            else:
                self._push_object_inline(pg, target, oid, ev)
        for oid, tv in theirs.items():
            if oid not in seg:
                # the peer holds an object we no longer have: deleted
                # while it was away — tombstone it
                with pg.lock:
                    dv = pg.pglog.deleted.get(oid, pg.pglog.head)
                self.send_osd(target, MPGInfo(
                    op="push_delete", pgid=str(pgid), oid=oid,
                    version=dv, epoch=self.osdmap.epoch))
        if end:
            # batch complete: advance the peer's PERSISTED watermark
            # (an interrupted session resumes HERE; the pushes above
            # ride the same FIFO connection, so they land first).
            # Only on a clean batch: a failed push must stay above
            # the watermark so the rescan still covers it.  (The
            # primary's live-op routing frontier advanced at scan
            # time, under the snapshot's lock hold.)
            if not state["failed"]:
                self.send_osd(target, MPGInfo(
                    op="backfill_progress", pgid=str(pgid),
                    watermark=end, epoch=self.osdmap.epoch))
            self.recovery_wq.queue(pgid, self._backfill_round, pgid, target,
                             end, interval_at, release, state)
        elif state["failed"] and state["rescans"] < 10:
            # some EC rebuilds hit busy sources: run the whole scan
            # again (version compares skip everything already landed)
            # rather than marking a peer with holes complete
            state["failed"] = False
            state["rescans"] += 1
            self.log.info("backfill of osd.%d rescanning (%d pushes "
                          "so far)", target, state["pushed"])
            self.recovery_wq.queue(pgid, self._backfill_round, pgid, target,
                             state.get("resume", ""), interval_at,
                             release, state)
        elif state["failed"]:
            # persistently undecodable sources: give up this pass and
            # let a later peering round retry from scratch
            self.log.warn("backfill of osd.%d abandoned after %d "
                          "rescans", target, state["rescans"])
            release()
        else:
            # hand the peer our log window so its advertised bounds
            # match what it now holds, and clear its incomplete flag
            with pg.lock:
                snap = list(pg.pglog.entries)
                tail = pg.pglog.tail
                pg.peer_last_backfill.pop(target, None)
            self.send_osd(target, MPGInfo(
                op="backfill_done", pgid=str(pgid), entries=snap,
                tail=tail, epoch=self.osdmap.epoch))
            self.log.info("backfill of osd.%d complete (%d pushes)",
                          target, state["pushed"])
            release()

    # -- pg_temp reconcile (split follow-through) --------------------------

    def _pg_temp_reconcile(self, pgid: PgId) -> None:
        """Converge a pg_temp-pinned pg to its CRUSH placement: the
        temp primary backfills every CRUSH target that is not already
        a member, and once all targets report complete (or are
        log-coverable) it asks the mon to drop the pin — the
        reference's primary-driven pg_temp lifecycle."""
        pg = self.get_pg(pgid)
        if pg is None or not pg.is_primary or not pg.active:
            return
        if pgid not in self.osdmap.pg_temp:
            return
        with pg.lock:
            acting = set(pg.acting_live())
            my_head = pg.pglog.head
            my_tail = pg.pglog.tail
            interval_at = pg.interval_epoch
        up, _acting = self.osdmap.pg_to_up_acting_osds(pgid)
        targets = [o for o in up
                   if o != ITEM_NONE and o not in acting
                   and o != self.whoami]
        if not targets:
            # CRUSH already agrees with the temp set (or no live
            # target): drop the pin
            self._rm_pg_temp_async(pgid)
            return
        ready = []
        for osd_id in targets:
            reply = self._call(osd_id, MPGInfo(
                op="query", pgid=str(pgid), epoch=self.osdmap.epoch),
                timeout=5.0)
            info = reply.info if reply is not None else {}
            lu = tuple(info.get("last_update", (0, 0)))
            ok = (not info.get("unknown")
                  and not info.get("backfilling")
                  and (my_head == (0, 0)     # empty pg: nothing to hold
                       or (lu > (0, 0) and lu >= my_tail)))
            ready.append(ok)
            if not ok:
                # not there yet: (re-)queue its backfill (deduped)
                self.queue_backfill(pgid, osd_id, interval_at)
        if all(ready):
            # targets hold the data (any residual delta is within the
            # log window and recovers in the post-release peering)
            self._rm_pg_temp_async(pgid)

    def _rm_pg_temp_async(self, pgid: PgId) -> None:
        """monc.command blocks; run the release off the worker."""
        key = ("rmtemp", pgid)
        active = self._rmtemp_active
        with self.backfill_lock:       # not pg_lock; see queue_backfill
            if key in active:
                return
            active.add(key)

        def run() -> None:
            try:
                self.monc.command({"prefix": "osd rm-pg-temp",
                                   "pgid": str(pgid)}, timeout=15.0)
            except Exception:
                pass
            finally:
                with self.backfill_lock:
                    active.discard(key)

        threading.Thread(target=run, daemon=True,
                         name=f"rm-pg-temp-{pgid}").start()

    # -- pg split (osd/OSD.cc:7553 split_pgs) ------------------------------

    @staticmethod
    def _split_base(name: str, is_ec: bool) -> str:
        """Base object name of a pg-collection file for split
        re-bucketing: strip clone/stash suffixes ('@...') always, the
        EC shard suffix ('.sN', N digits) only on EC pools — a
        replicated object named 'app.state' must hash under its full
        name (the scrub scanner applies the same rule)."""
        base = name.split("@", 1)[0]
        if is_ec and ".s" in base:
            stem, _, sfx = base.rpartition(".s")
            if sfx.isdigit():
                base = stem
        return base

    def _split_pg(self, pgid: PgId, old_pg_num: int) -> None:
        """Re-bucket one local parent pg's objects after pg_num grew:
        every file (head, clones, snapdir, EC shards, rollback
        stashes) whose BASE object now stable-mods to a different seed
        moves to that child's collection, and the log have-index moves
        with it.  Purely local — each acting member performs the same
        deterministic split."""
        parent = self.pgs.get(pgid)
        if parent is None:
            return
        pool = self.osdmap.pools.get(pgid.pool)
        if pool is None:
            return
        is_ec = pool.is_erasure
        # resolve every possible child pg BEFORE taking parent.lock:
        # get_pg acquires pg_lock, and taking it while holding a
        # pg.lock inverts the pg_lock -> pg.lock order the map thread
        # uses (AB-BA deadlock)
        child_pgs: dict[PgId, PG] = {}
        for seed in range(pool.pg_num):
            cpgid = PgId(pgid.pool, seed)
            if cpgid == pgid:
                continue
            child = self.get_pg(cpgid)
            if child is not None:
                child_pgs[cpgid] = child
        moved = 0
        children: dict[PgId, list[str]] = {}
        with parent.lock:
            try:
                names = self.store.collection_list(parent.cid)
            except StoreError:
                names = []
            # group every file under its base object name
            by_base: dict[str, list[str]] = {}
            for name in names:
                if name.startswith("_pgmeta"):
                    continue
                by_base.setdefault(self._split_base(name, is_ec),
                                   []).append(name)
            for base, files in by_base.items():
                new_pgid = self.osdmap.object_to_pg(pgid.pool, base)
                if new_pgid == pgid:
                    continue
                children.setdefault(new_pgid, []).extend(files)
            for child_pgid, files in sorted(children.items()):
                child = child_pgs.get(child_pgid)
                if child is None:
                    self.log.warn("split %s: child %s not ours",
                                  pgid, child_pgid)
                    continue
                with child.lock:
                    txn = Transaction()
                    skip_bases: set[str] = set()
                    for f in files:
                        base = self._split_base(f, is_ec)
                        pe = parent.pglog.objects.get(base, (0, 0))
                        ce = child.pglog.objects.get(base, (0, 0))
                        cd = child.pglog.deleted.get(base, (0, 0))
                        if max(ce, cd) >= pe and (ce or cd) != (0, 0):
                            # a residual split racing live I/O: the
                            # child already holds something NEWER —
                            # moving the stale parent copy over it
                            # would clobber an acked write.  Drop the
                            # leftover instead.
                            skip_bases.add(base)
                    for name in sorted(files):
                        base = self._split_base(name, is_ec)
                        if base in skip_bases:
                            txn.try_remove(parent.cid, name)
                        else:
                            txn.collection_move_rename(
                                parent.cid, name, child.cid, name)
                    bases = {self._split_base(f, is_ec)
                             for f in files}
                    for base in bases:
                        ev = parent.pglog.objects.pop(base, None)
                        if base in skip_bases:
                            parent.pglog.deleted.pop(base, None)
                            continue
                        if ev is not None:
                            child.pglog.record_recovered(ev, base)
                        dv = parent.pglog.deleted.pop(base, None)
                        if dv is not None and \
                                dv > child.pglog.deleted.get(base,
                                                             (0, 0)):
                            child.pglog.deleted[base] = dv
                    child.version = max(child.version,
                                        child.pglog.head[1])
                    child._persist_log(txn)
                    parent._persist_log(txn)
                    try:
                        self.store.apply_transaction(txn)
                        moved += len(files)
                    except StoreError as e:
                        self.log.warn("split %s -> %s failed: %s",
                                      pgid, child_pgid, e)
        # residual mode: release the whole pool once every local
        # re-bucket pass has completed
        pending = getattr(self, "_residual_pending", {})
        if pgid.pool in pending:
            release_all = False
            with self.pg_lock:
                pending[pgid.pool] -= 1
                if pending[pgid.pool] <= 0:
                    del pending[pgid.pool]
                    release_all = True
                kids_all = ([pg for kpgid, pg in self.pgs.items()
                             if kpgid.pool == pgid.pool and
                             getattr(pg, "split_pending", False)]
                            if release_all else [])
            for pg in kids_all:
                with pg.lock:
                    pg.split_pending = False
                    if pg.fresh_copy and not pg.backfill_complete \
                            and parent.backfill_complete:
                        # the local split just filled this fresh child
                        # from a complete parent copy: it inherits
                        # that completeness (it was only flagged
                        # incomplete because the pool predates us)
                        pg.set_backfill_state(True)
                if pg.is_primary:
                    self.queue_peering(pg.pgid)
            if moved:
                self.log.info(
                    "residual split %s: moved %d files to %d "
                    "children", pgid, moved, len(children))
            return
        # release THIS parent's children: they can serve I/O and
        # answer peering (other parents may still be mid-split)
        from .osdmap import parent_seed
        with self.pg_lock:
            kids = [pg for kpgid, pg in self.pgs.items()
                    if kpgid.pool == pgid.pool and
                    getattr(pg, "split_pending", False) and
                    parent_seed(kpgid.seed, old_pg_num) == pgid.seed]
        for pg in kids:
            with pg.lock:
                pg.split_pending = False
                if pg.fresh_copy and not pg.backfill_complete \
                        and parent.backfill_complete:
                    pg.set_backfill_state(True)
            if pg.is_primary:
                self.queue_peering(pg.pgid)
        if moved:
            self.log.info("split %s: moved %d files to %d children",
                          pgid, moved, len(children))

    def _apply_fetched(self, pg: PG, oid: str, info: dict) -> None:
        """Install a synchronously fetched object (self-backfill pull,
        mirroring the _handle_push apply path + version gate)."""
        version = tuple(info.get("version", (0, 0)))
        with pg.lock:
            if version < pg.pglog.objects.get(oid, (0, 0)):
                return
            txn = Transaction()
            txn.truncate(pg.cid, oid, 0)
            txn.write(pg.cid, oid, 0, info.get("data", b""))
            for k, v in (info.get("xattrs") or {}).items():
                txn.setattr(pg.cid, oid, k, v)
            if info.get("omap"):
                txn.omap_setkeys(pg.cid, oid, dict(info["omap"]))
            pg.pglog.record_recovered(version, oid, shard=None)
            pg.version = max(pg.version, version[1])
            pg._persist_log(txn)
            try:
                self.store.apply_transaction(txn)
            except StoreError:
                pass
            pg._flush_parked(oid)
            pg._wake_recovery_blocked(oid)

    def _push_object_inline(self, pg: PG, target: int, oid: str,
                            version) -> None:
        """Read + send one recovery push now (no reservation — the
        caller holds the backfill slot).  Fire-and-forget: ordering
        and version gates make duplicates/retries safe."""
        with pg.lock:
            if oid in pg.pglog.missing:
                # same guard as _do_push_object: never serve store
                # bytes for an object whose data has not landed here
                return
        try:
            data = self.store.read(pg.cid, oid)
            xattrs = self.store.getattrs(pg.cid, oid)
            omap = self.store.omap_get(pg.cid, oid)
        except StoreError:
            return
        self._note_recovery_push(len(data))
        self.send_osd(target, MPGPush(
            pgid=str(pg.pgid), oid=oid, version=version, data=data,
            xattrs=xattrs, omap=omap, shard=None,
            epoch=self.osdmap.epoch))
        self._push_clones(pg, target, oid, xattrs)

    def queue_self_backfill(self, pgid: PgId, holder: int,
                            interval_at: int) -> None:
        """The primary itself is too far behind to delta-recover
        (head predates the holder's log tail) or was interrupted
        mid-backfill: walk the HOLDER's object space, pull everything
        newer, drop our objects the holder no longer has, adopt the
        holder's log, then re-peer."""
        key = (pgid, "self")
        active = self._backfills_active
        with self.backfill_lock:       # not pg_lock; see queue_backfill
            if key in active:
                return
            active.add(key)
        # plain dict read, NOT get_pg: callers hold pg.lock and get_pg
        # acquires pg_lock (the inverse of the map thread's order)
        pg = self.pgs.get(pgid)
        if pg is not None:
            with pg.lock:
                if pg.backfill_complete:
                    pg.set_backfill_state(False)

        def work(release: Callable) -> None:
            def done() -> None:
                with self.backfill_lock:
                    active.discard(key)
                release()
            self.recovery_wq.queue(pgid, self._self_backfill_round, pgid,
                             holder, "", interval_at, done)
        self._recovery.request(work)

    def _self_backfill_round(self, pgid: PgId, holder: int,
                             cursor: str, interval_at: int,
                             release: Callable) -> None:
        pg = self.get_pg(pgid)
        if pg is None or not pg.is_primary or \
                pg.interval_epoch != interval_at:
            release()
            return
        batch = max(1, int(self.conf.osd_backfill_scan_batch))
        reply = self._call(holder, MPGInfo(
            op="scan_range", pgid=str(pgid), after=cursor, upto="",
            limit=batch, epoch=self.osdmap.epoch), timeout=10.0)
        if reply is None or reply.info.get("unknown"):
            release()
            self.queue_peering(pgid)   # holder gone? re-peer decides
            return
        theirs = {o: tuple(v) for o, v in
                  (reply.info.get("objects", {}) or {}).items()}
        end = reply.info.get("end", "")
        with pg.lock:
            mine = pg.scan_range(after=cursor, upto=end, limit=0)
            my_shard = pg.role_of(self.whoami)
        for oid, ev in theirs.items():
            mv = mine["objects"].get(oid)
            if mv is not None and tuple(mv) >= ev:
                continue
            # synchronous restore: the round's objects must be ON DISK
            # before the final round adopts the holder's log — an
            # async pull still in flight at adoption would leave a
            # claimed-but-missing object nothing ever retries
            if pg.is_ec:
                self._ec_rebuild(pgid, oid, ev,
                                 [(my_shard, self.whoami)])
            else:
                r = self._call(holder, MPGInfo(
                    op="fetch_obj", pgid=str(pgid), oid=oid,
                    epoch=self.osdmap.epoch), timeout=10.0)
                if r is not None and not r.info.get("missing"):
                    self._apply_fetched(pg, oid, r.info)
        for oid in mine["objects"]:
            if oid not in theirs:
                pg.handle_push_delete(oid, pg.pglog.head)
        if end:
            self.recovery_wq.queue(pgid, self._self_backfill_round, pgid,
                             holder, end, interval_at, release)
        else:
            # adopt the holder's log so our bounds reflect what we now
            # hold, clear our incomplete flag, then re-peer and
            # distribute to the rest of the acting set
            log_reply = self._call(holder, MPGInfo(
                op="get_full_log", pgid=str(pgid),
                epoch=self.osdmap.epoch), timeout=10.0)
            release()
            if log_reply is None or log_reply.info.get("unknown"):
                self.queue_peering(pgid)     # retry the whole round
                return
            pg.handle_backfill_done(
                log_reply.info.get("entries", []),
                tuple(log_reply.info.get("tail", (0, 0))))
            self.log.info("self-backfill from osd.%d complete", holder)
            self.queue_peering(pgid)

    # -- divergent-log reconciliation (rewind_divergent_log plumbing) ------
    #
    # A peer whose last_update names a branch the auth log never
    # merged (a stale replicated primary that re-served through a
    # partition; an EC shard past the decodable head) is reconciled
    # BEFORE the pg activates: fetch its log window, find the
    # divergence point (PGLog.divergence_point), send it a rewind, and
    # push exactly the divergence — the log delta since the common
    # point plus every divergent entry's target.  recovery_bytes stays
    # proportional to the divergence, never the pg size.

    def queue_divergent_reconcile(self, pgid: PgId, target: int,
                                  interval_at: int) -> None:
        key = (pgid, target, "div")
        active = self._backfills_active
        with self.backfill_lock:       # not pg_lock; see queue_backfill
            if key in active:
                return
            active.add(key)

        def work(release: Callable) -> None:
            def done() -> None:
                with self.backfill_lock:
                    active.discard(key)
                release()
            self.recovery_wq.queue(pgid, self._divergent_reconcile,
                                   pgid, target, interval_at, done)
        self._recovery.request(work)

    def _divergent_reconcile(self, pgid: PgId, target: int,
                             interval_at: int,
                             release: Callable) -> None:
        pg = self.get_pg(pgid)
        if pg is None or not pg.is_primary or \
                pg.interval_epoch != interval_at:
            release()
            return
        if not hasattr(self, "_divergent_attempts"):
            self._divergent_attempts = {}
        # prune dead intervals' keys (the counter only matters within
        # the interval that flagged the peer — stale keys are a leak)
        for k in [k for k in self._divergent_attempts
                  if k[0] == pgid and k[2] != interval_at]:
            del self._divergent_attempts[k]
        akey = (pgid, target, interval_at)
        attempts = self._divergent_attempts.get(akey, 0)
        reply = self._call(target, MPGInfo(
            op="get_full_log", pgid=str(pgid),
            epoch=self.osdmap.epoch), timeout=10.0)
        if reply is None or reply.info.get("unknown"):
            self._divergent_attempts[akey] = attempts + 1
            release()
            if attempts + 1 < 5:
                self.clock.timer(
                    1.0, lambda: self.queue_peering(pgid))
            else:
                # peer keeps not answering with a log: fall back to a
                # full backfill — wipe-and-restore is always safe
                self.log.warn("divergent osd.%d unresponsive after %d "
                              "tries: falling back to backfill",
                              target, attempts + 1)
                self._divergent_attempts.pop(akey, None)
                self.send_osd(target, MPGInfo(
                    op="backfill_start", pgid=str(pgid),
                    epoch=self.osdmap.epoch))
                self.queue_backfill(pgid, target, interval_at)
                self.queue_peering(pgid)
            return
        self._divergent_attempts.pop(akey, None)   # answered: reset
        entries = reply.info.get("entries", [])
        with pg.lock:
            if not pg.is_primary or pg.interval_epoch != interval_at:
                release()
                return
            rewind_to, div = pg.pglog.find_divergence(entries)
            # the rewind rides the same FIFO connection as the pushes
            # below: the peer always rewinds BEFORE new data lands
            self.send_osd(target, MPGInfo(
                op="rewind", pgid=str(pgid), rewind_to=rewind_to,
                epoch=self.osdmap.epoch))
            delta = pg.pglog.entries_since(rewind_to)
            if delta is None:
                # common point predates our tail: the peer cannot be
                # delta-recovered once rewound — backfill it
                self.send_osd(target, MPGInfo(
                    op="backfill_start", pgid=str(pgid),
                    epoch=self.osdmap.epoch))
                self.queue_backfill(pgid, target, interval_at)
                release()
                self.queue_peering(pgid)
                return
            # missing set from log divergence: delta targets PLUS the
            # divergent entries' objects at OUR authoritative state
            # (current version or tombstone) — a divergent-only object
            # the delta never names would otherwise stay forked
            push_list = list(delta)
            named = {e["oid"] for e in delta}
            for e in div:
                oid = e["oid"]
                if oid in named:
                    continue
                named.add(oid)
                cur = pg.pglog.objects.get(oid)
                if cur is not None:
                    push_list.append({"ev": cur, "oid": oid,
                                      "op": "modify", "prior": None,
                                      "rollback": None, "shard": None})
                else:
                    dv = pg.pglog.deleted.get(oid, pg.pglog.head)
                    push_list.append({"ev": dv, "oid": oid,
                                      "op": "delete", "prior": None,
                                      "rollback": None, "shard": None})
            pg._push_log_delta(target, push_list)
            self.log.info("reconciled divergent osd.%d: rewound to "
                          "%s, %d divergent entr%s, %d push targets",
                          target, rewind_to, len(div),
                          "y" if len(div) == 1 else "ies",
                          len({e['oid'] for e in push_list}))
        release()
        # the peer is clean now: re-run the round — this time it takes
        # the plain delta path and the pg activates
        self.queue_peering(pgid)

    def queue_primary_divergence(self, pgid: PgId, holder: int,
                                 interval_at: int) -> None:
        """The PRIMARY's own log sits on a stale branch vs the elected
        auth holder (get_log came back contains_since=False): fetch
        the full auth window off-thread, rewind our divergent suffix
        through the shared core, merge the auth claims, pull, then
        re-peer.  The pg never activates in between — the GetLog
        authority proof."""
        key = (pgid, "selfdiv")
        active = self._backfills_active
        with self.backfill_lock:       # not pg_lock; see queue_backfill
            if key in active:
                return
            active.add(key)

        def done() -> None:
            with self.backfill_lock:
                active.discard(key)

        self.recovery_wq.queue(pgid, self._primary_divergence_round,
                               pgid, holder, interval_at, done)

    def _primary_divergence_round(self, pgid: PgId, holder: int,
                                  interval_at: int,
                                  done: Callable) -> None:
        pg = self.get_pg(pgid)
        if pg is None or not pg.is_primary or \
                pg.interval_epoch != interval_at:
            done()
            return
        reply = self._call(holder, MPGInfo(
            op="get_full_log", pgid=str(pgid),
            epoch=self.osdmap.epoch), timeout=10.0)
        if reply is None or reply.info.get("unknown"):
            done()
            self.clock.timer(1.0, lambda: self.queue_peering(pgid))
            return
        auth_entries = reply.info.get("entries", [])
        auth_tail = tuple(reply.info.get("tail", (0, 0)))
        with pg.lock:
            if not pg.is_primary or pg.interval_epoch != interval_at:
                done()
                return
            from .pglog import PGLog
            rewind_to, _mydiv = PGLog.divergence_point(
                auth_entries, pg.pglog.entries, auth_tail)
        pg.rewind_divergent_log(rewind_to)
        with pg.lock:
            if not pg.is_primary or pg.interval_epoch != interval_at:
                done()
                return
            pulls = pg.pglog.merge_log(auth_entries, shard=None)
            for e in auth_entries:
                if e["op"] == "delete":
                    pg._apply_remote_delete(e["oid"], tuple(e["ev"]))
            # the rewind may have re-exposed objects at prior versions
            # whose bytes we no longer hold: pull those too
            for oid, ev in pg.pglog.missing.items():
                pulls.setdefault(oid, ev)
            txn = Transaction()
            pg._persist_log(txn)
            try:
                self.store.apply_transaction(txn)
            except StoreError:
                pass
            self.perf.inc("peering_getlog_merges")
            pg.version = max(pg.version, pg.pglog.head[1])
            my_shard = pg.role_of(self.whoami)
            for oid, ev in pulls.items():
                if pg.is_ec:
                    self.queue_ec_rebuild(pgid, oid, ev,
                                          [(my_shard, self.whoami)])
                else:
                    self.pg_request_push(pgid, holder, oid)
            pg._catchup_pending = dict(pulls)
            pg._catchup_polls = 0
        done()
        pg._poll_catchup(interval_at)

    # -- cache tiering: internal client ops to the base pool ---------------

    def base_pool_op(self, pool_id: int, oid: str, ops: list,
                     done: Callable, timeout: float = 10.0) -> None:
        """Async internal op against another pool's primary — the
        tier agent's promote reads and flush writes (the reference
        routes these through the Objecter with copy_from/flush ops;
        here the OSD speaks the same client protocol directly).
        done(reply_or_None) runs on the messenger/timer thread."""
        pgid = self.osdmap.object_to_pg(pool_id, oid)
        primary = self.osdmap.pg_primary(pgid)
        if primary is None:
            done(None)
            return
        msg = MOSDOp(tid=next(self._rpc_tid), pgid=str(pgid), oid=oid,
                     ops=ops, epoch=self.osdmap.epoch)
        msg._cache_internal = True
        self._call_async(primary, msg, done, timeout=timeout)

    # -- EC shard fetch (degraded reads / rebuild) -------------------------

    def ec_fetch_shards(self, pgid: PgId, oid: str,
                        targets: list[tuple[int, int]],
                        off: int = 0, length: int = 0,
                        timeout: float = 5.0,
                        need_ver: tuple | None = None,
                        need: int | None = None) -> dict:
        """Fetch shards from peers CONCURRENTLY (start_read_op model,
        osd/ECBackend.cc:321): one gather, one timeout window — a
        multi-shard outage costs one RPC window, not one per shard.
        off/length select a range (the partial-append tail read,
        O(chunk) not O(shard)); 0,0 fetches the whole shard.
        `need` early-completes the gather once that many shards
        answered OK — a degraded read returns as soon as k shards
        exist instead of waiting out a dead peer's full RPC window.
        Returns {shard: (data, hinfo, ver)} — ver is the shard's
        applied version when the read was version-gated, else None."""
        if not targets:
            return {}
        out: dict[int, tuple] = {}
        # keyed per (shard, holder): the degraded sweep may ask SEVERAL
        # osds for the same shard id (mid-remap it could be anywhere),
        # and one holder's failure must not end the shard's gather
        remaining = {(shard, osd_id) for shard, osd_id in targets}
        lock = threading.Lock()
        done_ev = threading.Event()

        def make_cb(shard: int, osd_id: int) -> Callable:
            def cb(reply) -> None:
                with lock:
                    if reply is not None and reply.result == 0 \
                            and shard not in out:
                        out[shard] = (reply.data, reply.hinfo,
                                      getattr(reply, "ver", None))
                    remaining.discard((shard, osd_id))
                    if not remaining or (need is not None
                                         and len(out) >= need):
                        done_ev.set()
            return cb

        for shard, osd_id in targets:
            self._call_async(osd_id, MOSDECSubOpRead(
                reqid=None, pgid=str(pgid), shard=shard, oid=oid,
                off=off, length=length, need_ver=need_ver),
                make_cb(shard, osd_id), timeout=timeout)
        # bound by REAL time too: _call_async timeouts ride the
        # cluster clock, which only advances when a test ticks it
        done_ev.wait(timeout + 1.0)
        with lock:
            return dict(out)

    def ec_get_omap(self, pgid: PgId, oid: str, acting: list[int]) -> dict:
        """The omap from shard 0's holder, or, while that holder is
        down, from the lowest live shard's: writes set it on every
        shard (the remote path of an early round silently returned
        {})."""
        pg = self.get_pg(pgid)
        live = [(s, o) for s, o in enumerate(acting) if o != ITEM_NONE]
        if not live:
            raise StoreError(5, "EC omap: no shard holder up")
        shard, holder = live[0]
        if holder == self.whoami:
            try:
                return self.store.omap_get(pg.cid,
                                           pg._ec_local_shard(oid, shard))
            except StoreError:
                return {}
        reply = self._call(holder, MPGInfo(
            op="ec_omap", pgid=str(pgid), oid=oid, shard=shard,
            epoch=self.osdmap.epoch), timeout=5.0)
        if reply is None:
            raise StoreError(110, "EC omap fetch timed out")
        if reply.info.get("unknown"):
            raise StoreError(11, "EC omap: holder has no pg yet")
        return dict(reply.info.get("omap", {}))

    # -- EC shard-role audit -----------------------------------------------
    #
    # Identical pglogs cannot reveal shard files parked under the wrong
    # ROLE: after a pg_temp release whose CRUSH acting is a permutation
    # of the pinned order, every member's log matches the primary's
    # while every member's on-disk shard id mismatches its new role —
    # peering sees nothing to recover and reads fail (served only by
    # the degraded sweep).  After each activation the primary audits
    # per-role holdings and queues single-shard rebuilds to converge;
    # the audit stays pending (pg.ec_audit_pending, repeated from the
    # heartbeat) until one round hears every member and finds nothing
    # to rebuild: a scan reply that timed out, a member still
    # backfilling or a push that did not land is looked at again.

    def queue_ec_role_audit(self, pgid: PgId, interval_at: int) -> None:
        pg = self.get_pg(pgid)
        if pg is None:
            return
        with pg.lock:
            if not pg.is_primary or pg.interval_epoch != interval_at:
                return
            acting = list(pg.acting)
            objects = {o: tuple(v) for o, v in pg.pglog.objects.items()}
            if not objects:
                pg.ec_audit_pending = False
                return
        if any(o == ITEM_NONE for o in acting):
            # degraded pg (hole in the acting set): normal recovery /
            # backfill owns its convergence — auditing now would pile
            # duplicate rebuilds onto an already-stressed pg.  The
            # post-recovery interval change re-queues the audit.
            return
        results: dict[int, dict] = {}
        local = [s for s, o in enumerate(acting) if o == self.whoami]
        remote = [(s, o) for s, o in enumerate(acting)
                  if o != ITEM_NONE and o != self.whoami]
        store = self.store
        from .pglog import _parse_ev
        for shard in local:
            held: dict[str, tuple | None] = {}
            for oid in objects:
                try:
                    held[oid] = _parse_ev(store.getattr(
                        pg.cid, shard_oid(oid, shard), VER_KEY))
                except StoreError:
                    continue
            results[shard] = held
        if not remote:
            self.op_wq.queue(pgid, self._ec_role_audit_done, pgid,
                             interval_at, objects, dict(results))
            return
        remaining = set(remote)
        lock = threading.Lock()

        def make_cb(shard: int, osd_id: int) -> Callable:
            def cb(reply) -> None:
                with lock:
                    if reply is not None and \
                            not reply.info.get("unknown") and \
                            not reply.info.get("backfilling"):
                        results[shard] = {
                            o: (tuple(v) if v is not None else None)
                            for o, v in
                            reply.info.get("objects", {}).items()}
                    remaining.discard((shard, osd_id))
                    fire = not remaining
                if fire:
                    self.op_wq.queue(pgid, self._ec_role_audit_done,
                                     pgid, interval_at, objects,
                                     dict(results))
            return cb

        for shard, osd_id in remote:
            self._call_async(osd_id, MPGInfo(
                op="shard_scan", pgid=str(pgid), shard=shard,
                epoch=self.osdmap.epoch),
                make_cb(shard, osd_id), timeout=5.0)

    def _ec_role_audit_done(self, pgid: PgId, interval_at: int,
                            objects: dict, results: dict) -> None:
        pg = self.get_pg(pgid)
        if pg is None:
            return
        with pg.lock:
            if not pg.is_primary or pg.interval_epoch != interval_at:
                return
            acting = list(pg.acting)
        queued = unheard = gaps = 0
        for shard, osd_id in enumerate(acting):
            if osd_id == ITEM_NONE:
                continue
            held = results.get(shard)
            if held is None:
                unheard += 1   # unreachable/backfilling: the next round
                continue       # looks again
            for oid, ver in objects.items():
                hv = held.get(oid)
                if hv is None or hv < ver:
                    gaps += 1
                    key = (pgid, oid, shard)
                    if key in self._audit_rebuilds:
                        continue      # queued by an earlier round
                    self._audit_rebuilds.add(key)
                    self.queue_ec_rebuild(
                        pgid, oid, ver, [(shard, osd_id)],
                        done=lambda k=key: self._audit_rebuilds.discard(k))
                    queued += 1
        if queued:
            self.log.info("ec role audit %s: %d shard rebuilds queued",
                          pgid, queued)
        if not (unheard or gaps):
            with pg.lock:
                if pg.interval_epoch == interval_at:
                    pg.ec_audit_pending = False

    def queue_ec_rebuild(self, pgid: PgId, oid: str, version: int,
                         missing: list[tuple[int, int]],
                         attempt: int = 0, front: bool = False,
                         done: Callable | None = None) -> None:
        def work(release: Callable) -> None:
            def run() -> None:
                # traced like a push: the rebuild runs under its own
                # recovery op, so the decode/encode pipeline phases it
                # pays (device compute, H2D/D2H) land as ec.* spans in
                # the op dumps — a recovery rebuild's device time is
                # attributable, not invisible background work
                from ..utils import optracker
                trk = self.op_tracker.create(
                    f"rebuild({pgid} {oid} v={version})",
                    trace_id=f"rebuild:{pgid}:{oid}", kind="recovery")
                try:
                    with optracker.op_context(trk), \
                            optracker.span("rebuild"):
                        self._ec_rebuild(pgid, oid, version, missing,
                                         attempt)
                finally:
                    trk.finish()
                    release()
                    if done is not None:
                        done()
            self.op_wq.queue(pgid, run)

        self._recovery.request(work, front=front)

    def _ec_rebuild(self, pgid: PgId, oid: str, version: int,
                    missing: list[tuple[int, int]],
                    attempt: int = 0, retry: bool = True) -> bool:
        """Reconstruct missing shards and push them to their OSDs.
        Returns True when the shards were pushed this call (the
        backfill loop uses retry=False and re-scans failures)."""
        pg = self.get_pg(pgid)
        if pg is None or not pg.is_primary:
            return False
        # rebuild at the object's CURRENT version, gating every source
        # shard on it: a peer mid-write must not contribute old-
        # generation bytes to the decode (silent corruption).  Never
        # reconstruct FROM a shard being rebuilt either — it may exist
        # with stale-but-self-consistent bytes (superseded sub-op skip)
        with pg.lock:
            cur = pg.pglog.objects.get(oid)
        if cur is None:
            return True               # deleted since; nothing to heal
        need = max(tuple(version), cur)
        # HBM-cache fast path first: with the object's encoded stripes
        # still on a chip at exactly the target version, the push
        # fetches only the missing shards' rows D2H from the cached
        # arrays (data=None — no shard gather, no decode, and the full
        # payload never crosses the boundary); False = no usable entry
        if self._ec_push_shards(pg, oid, need, missing, None):
            return True
        # the rebuild's decode lane bills the same class as its
        # re-encode: both halves of a repair sit under the repair cap
        from .daemon import RECOVERY_QOS_CLASS
        data = pg._ec_read_local(
            oid, exclude={s for s, _o in missing}, need_ver=need,
            qos=(RECOVERY_QOS_CLASS
                 if self._qos_recovery is not None else None))
        if data is None:
            # sources not all at `need` yet (write still fanning out):
            # retry with backoff rather than stranding the stale shard
            if retry and attempt < 6:
                self.clock.timer(
                    0.3 * (attempt + 1),
                    lambda: self.queue_ec_rebuild(
                        pgid, oid, need, missing, attempt + 1))
            elif retry:
                self.log.warn("cannot rebuild %s/%s: undecodable",
                              pgid, oid)
            return False
        self._ec_push_shards(pg, oid, need, missing, data)
        return True

    def _ec_push_shards(self, pg: PG, oid: str, version,
                        missing: list[tuple[int, int]],
                        data: bytes | None) -> bool:
        """Re-encode `data` and land the listed shards (local write or
        MPGPush) — shared by log-driven rebuild and scrub repair.

        When the HBM stripe cache still holds this object at exactly
        `version`, the shard payloads come straight off the chip (D2H
        of only the missing shards' rows) and the CRCs fold from the
        cached per-stripe chunk CRCs — no re-encode, no H2D.  A
        cache-trusting caller passes data=None (the payload itself
        never crosses the boundary); returns False only then, when
        the entry vanished before its rows could be fetched."""
        from ..ops import hbm_cache
        from . import ecutil
        codec = pg._ec_codec()
        sinfo = pg._ec_sinfo(codec)
        payloads: dict[int, bytes] = {}
        stripe_crcs = None
        size = 0
        ent = hbm_cache.get().lookup(pg.cid, oid,
                                     version=tuple(version))
        if ent is not None and ent.chunk_size == sinfo.chunk_size \
                and (data is None or ent.size == len(data)):
            for shard, _o in missing:
                b = ent.shard_bytes(shard)
                if b is None:
                    payloads.clear()     # chip buffer gone: re-encode
                    break
                payloads[shard] = b
            else:
                stripe_crcs = ent.crcs
                size = ent.size
        if stripe_crcs is None:
            if data is None:
                return False
            # the rebuild's re-encode is RECOVERY work: with
            # osd_qos_recovery set it rides the @recovery class on the
            # EC dispatch lanes too (bytes-weighted), so a repair storm
            # cannot monopolize the device plane any more than it can
            # the op shards
            from .daemon import RECOVERY_QOS_CLASS
            qos = (RECOVERY_QOS_CLASS if self._qos_recovery is not None
                   else None)
            shards, stripe_crcs = ecutil.encode_object_ex(codec, sinfo,
                                                          data, qos=qos)
            payloads = {shard: shards[shard] for shard, _o in missing}
            size = len(data)
        crcs = ecutil.fold_shard_crcs(stripe_crcs, sinfo.chunk_size)
        prefix_crcs = ecutil.fold_shard_crcs(
            stripe_crcs, sinfo.chunk_size,
            upto=size // sinfo.stripe_width)
        with pg.lock:
            cur = pg.pglog.objects.get(oid)
        if cur is None or cur > tuple(version):
            # deleted or superseded while we were decoding: landing
            # these shards would RESURRECT a removed object (absence
            # must not read as version (0,0) and pass the gate)
            return True
        for shard, osd_id in missing:
            hinfo = denc.dumps({
                "size": size,
                "crc": crcs[shard],
                "crc_prefix": prefix_crcs[shard],
                "shard": shard,
                "stripe_unit": sinfo.chunk_size})
            payload = payloads[shard]
            self._note_recovery_push(len(payload))
            # the healed shard must carry the version xattr too, or
            # it can never pass a later version-gated rebuild read
            ver = repr(tuple(version)).encode()
            if osd_id == self.whoami:
                txn = Transaction()
                soid = shard_oid(oid, shard)
                txn.truncate(pg.cid, soid, 0)
                txn.write(pg.cid, soid, 0, payload)
                txn.setattr(pg.cid, soid, HINFO_KEY, hinfo)
                txn.setattr(pg.cid, soid, VER_KEY, ver)
                with pg.lock:
                    cur2 = pg.pglog.objects.get(oid)
                    if cur2 is None or cur2 > tuple(version):
                        # deleted or rewritten while we were encoding:
                        # clobbering the shard would mix generations or
                        # resurrect a removed object
                        continue
                    pg.pglog.record_recovered(tuple(version), oid,
                                              shard=shard)
                    pg._persist_log(txn)
                    self.store.apply_transaction(txn)
                    # our shard landed: client ops blocked on this
                    # object's missing claim can resume
                    pg._wake_recovery_blocked(oid)
            else:
                self.send_osd(osd_id, MPGPush(
                    pgid=str(pg.pgid), oid=oid, version=version,
                    data=payload,
                    xattrs={HINFO_KEY: hinfo, VER_KEY: ver}, omap={},
                    shard=shard, epoch=self.osdmap.epoch))
        return True

