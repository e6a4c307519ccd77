"""PGBackend base: machinery shared by the replicated and EC
backends (osd/PGBackend.{h,cc} seam).

Mixed into PG (pg.py): replica-side ordered sub-op apply (parking),
duplicate/superseded detection, the log+txn atomic apply, and the
primary-side commit gather.  Backend-specific submit/handle paths live
in backend_rep.py / backend_ec.py.
"""

from __future__ import annotations

from ..crush.map import ITEM_NONE
from ..store.objectstore import StoreError, Transaction
from .pglog import ZERO_EV


class PGBackendBase:
    def _already_applied(self, ev: tuple) -> bool:
        """True if a log entry at exactly `ev` is present — the sub-op
        was applied by an earlier delivery and this one is a resend
        (the primary re-transmits on gather timeout; applying twice
        would double-append the log and re-run the txn)."""
        for e in reversed(self.pglog.entries):
            if e["ev"] == ev:
                return True
            if e["ev"] < ev:
                return False
        return False

    # ---- ordered sub-op apply (replica side) -----------------------------
    #
    # The reference delivers MOSDRepOp/MOSDECSubOpWrite in order per
    # connection; here a LOST message + resend can reorder (op N+1
    # lands before the resend of N).  Applying N+1 first leaves a
    # hole the _superseded path can only heal after the fact — so a
    # sub-op whose predecessor (entry["prior"]) has not applied here
    # yet is PARKED and replayed in ev order once the gap fills.  A
    # timer bounds the park: if the predecessor never arrives the op
    # applies out of order anyway and a heal (pull/rebuild) is queued.

    _PARK_CAP = 128

    def _park_if_gap(self, conn, msg, kind: str) -> bool:
        """Park an out-of-order sub-op; True when parked."""
        entry = msg.log
        prior = entry.get("prior")
        if prior is None:
            return False
        prior = tuple(prior)
        oid = entry["oid"]
        if self.pglog.objects.get(oid, ZERO_EV) >= prior or \
                self.pglog.deleted.get(oid, ZERO_EV) >= prior:
            return False              # predecessor applied: no gap
        ev = tuple(entry["ev"])
        key = (oid, ev)
        if key in self._parked:
            # a resend of an already-parked op: refresh the conn so
            # the eventual reply reaches the latest peer session
            self._parked[key] = (conn, msg, kind)
            return True
        if len(self._parked) >= self._PARK_CAP:
            return False              # overload: apply out of order
        self._parked[key] = (conn, msg, kind)
        self.log.info("parking out-of-order %s sub-op %s on %s "
                      "(prior %s not applied)", kind, ev, oid, prior)
        if self.last_backfill is not None:
            # we are a backfill TARGET and a live sub-op raced ahead
            # of its base object's push (the primary's routing
            # frontier advances at scan time, before the batch's
            # pushes land): same serve-during-repair discipline as a
            # primary's missing-object op — count the block and
            # promote the base pull to the front of the primary's
            # recovery queue instead of waiting out the scan (or the
            # park expiry's apply-out-of-order + heal)
            self.osd.perf.inc("recovery_blocked_ops")
            self._parked_blocked.add(key)
            trk = getattr(msg, "_trk", None)
            if trk is not None:
                trk.mark_event("recovery_blocked")
            from .messages import sender_id
            primary = sender_id(msg)
            if primary is not None and oid not in self._promoted_pulls:
                self._promoted_pulls.add(oid)
                self.osd.perf.inc("recovery_prio_promotions")
                self.osd.pg_request_push(self.pgid, primary, oid,
                                         front=True)
        timeout = 2.0 * float(self.osd.conf.osd_subop_resend_interval)
        # expiry is QUEUED to the op workqueue, never run on the clock
        # thread: _park_expire takes pg.lock, and a timer callback
        # blocking on it would stall every other timer in the wheel
        self.osd.clock.timer(
            timeout,
            lambda: self.osd.op_wq.queue(self.pgid,
                                         self._park_expire, key))
        return True

    def _flush_parked(self, oid: str) -> None:
        """Apply parked successors whose gap just filled, in ev order.
        Caller holds self.lock."""
        while True:
            ready = None
            for (poid, ev), (conn, msg, kind) in sorted(
                    self._parked.items()):
                if poid != oid:
                    continue
                prior = tuple(msg.log["prior"])
                if self.pglog.objects.get(oid, ZERO_EV) >= prior or \
                        self.pglog.deleted.get(oid, ZERO_EV) >= prior:
                    ready = (poid, ev)
                    break
            if ready is None:
                return
            conn, msg, kind = self._parked.pop(ready)
            self._note_park_released(ready, msg)
            if kind == "ec":
                self.handle_ec_sub_write(conn, msg, _parked=True)
            else:
                self.handle_rep_op(conn, msg, _parked=True)

    def _drop_parked(self, newer_than: tuple | None = None) -> None:
        """Discard parked sub-ops WITHOUT applying them — on interval
        change or divergent rewind the cluster just agreed to forget
        that history, and a later park-expiry must not resurrect an
        aborted, never-acked write (it would then win the next
        peering round's newest-version-wins reconciliation).
        `newer_than` limits the drop to evs above it (rewind);
        None drops everything (new interval).  Caller holds lock."""
        for key in list(self._parked):
            if newer_than is None or key[1] > newer_than:
                self.log.info("dropping parked sub-op %s on %s",
                              key[1], key[0])
                _conn, pmsg, _kind = self._parked.pop(key)
                self._note_park_released(key, pmsg)

    def _note_park_released(self, key: tuple, msg=None) -> None:
        """A parked sub-op counted as recovery-blocked (backfill
        target) left the park (applied, expired or dropped): balance
        the blocked/unblocked counters (and the op's trace events).
        Caller holds self.lock."""
        if key in self._parked_blocked:
            self._parked_blocked.discard(key)
            # other sub-ops for the same oid may still be parked on
            # the same base pull — the promotion marker (and its
            # one-promotion-per-oid invariant) lives until the LAST
            # of them leaves the park
            if not any(k[0] == key[0] for k in self._parked_blocked):
                self._promoted_pulls.discard(key[0])
            self.osd.perf.inc("recovery_unblocked_ops")
            trk = getattr(msg, "_trk", None)
            if trk is not None:
                trk.mark_event("recovery_unblocked")

    def _park_expire(self, key: tuple) -> None:
        """Park timed out: the predecessor never arrived — apply out
        of order (old behavior) and let the superseded/heal path
        reconcile."""
        with self.lock:
            item = self._parked.pop(key, None)
            if item is None:
                return
            conn, msg, kind = item
            self._note_park_released(key, msg)
            self.log.warn("parked sub-op %s on %s expired; applying "
                          "out of order", key[1], key[0])
            if kind == "ec":
                self.handle_ec_sub_write(conn, msg, _parked=True)
                # we knowingly skipped the predecessor: heal our shard
                self._request_ec_heal(key[0], msg.shard, msg)
            else:
                self.handle_rep_op(conn, msg, _parked=True)
                self._request_rep_heal(key[0], msg)

    def _superseded(self, entry: dict) -> bool:
        """True if a NEWER op on the same object already applied here:
        a resend that lost the race must not run its store txn (a
        stale writefull would clobber the newer content).  Acked as
        success, but the SKIPPED op's effects may be missing locally
        (e.g. missed writefull N, applied setxattr N+1), so the
        superseded handlers also queue a heal — a pull of the
        primary's full copy (replicated) or a shard rebuild (EC) —
        instead of trusting a manual scrub to find the hole."""
        ev = tuple(entry["ev"])
        oid = entry["oid"]
        return (self.pglog.objects.get(oid, ZERO_EV) > ev
                or self.pglog.deleted.get(oid, ZERO_EV) > ev)

    def _maybe_commit(self, reqid) -> None:
        state = self._inflight.get(reqid)
        if state is None or state["waiting"]:
            return
        del self._inflight[reqid]
        if state.get("kind") == "ec":
            self._wake_reads_behind_writes(state["msg"].oid)
        failed = state.get("failed")
        if failed:
            self._record_completed(reqid, failed, state["version"])
            # a live shard failed to persist: the "acked writes exist
            # on all live shards" invariant would break, so the client
            # gets the error and last_complete may NEVER advance past
            # this version (its rollback stash must survive for
            # peering to repair the inconsistency) — the floor clears
            # when a new interval re-peers
            self.log.warn("write %s failed on a shard: %d",
                          state["version"], failed)
            v = tuple(state["version"])
            if self._failed_floor is None or v < self._failed_floor:
                self._failed_floor = v
            self._reply(state["conn"], state["msg"], failed, [])
            return
        # advance last_complete: every write at or below it is fully
        # acked by all live shards, so rollback state that old is dead
        # weight (the reference's roll_forward_to, ECBackend ECSubWrite)
        if not self._inflight:
            cap = self.pglog.head
            if self._failed_floor is not None:
                prior = max((e["ev"] for e in self.pglog.entries
                             if e["ev"] < self._failed_floor),
                            default=ZERO_EV)
                cap = min(cap, prior)
            if cap > self.last_complete:
                self.last_complete = cap
                if self.is_ec:
                    self._trim_rollback(self.last_complete)
        self._record_completed(reqid, 0, state["version"],
                               state.get("outdata"))
        self._reply(state["conn"], state["msg"], 0,
                    state.get("outdata", []), version=state["version"])

    def _log_and_apply(self, txn: Transaction, entry: dict) -> None:
        """Record the log entry and apply the txn as one unit: the
        serialized log rides inside the txn, and a store failure
        un-records the in-memory entry — otherwise the log would claim
        a version whose data (and rollback stash) never persisted,
        and a later rewind would 'restore' from a stash that does not
        exist, destroying the still-valid prior object."""
        oid = entry["oid"]
        # crash site: the op reached the pg but neither the log entry
        # nor the txn hit the store — after restart the object must
        # be bit-exact at its prior version (nothing was acked)
        self.osd.store._maybe_crash("pglog.append")
        prev_obj = self.pglog.objects.get(oid)
        prev_del = self.pglog.deleted.get(oid)
        self.pglog.add(entry)
        self._persist_log(txn)
        try:
            self.osd.store.apply_transaction(txn)
        except StoreError:
            if self.pglog.entries and \
                    self.pglog.entries[-1]["ev"] == tuple(entry["ev"]):
                self.pglog.entries.pop()
            if prev_obj is None:
                self.pglog.objects.pop(oid, None)
            else:
                self.pglog.objects[oid] = prev_obj
            if prev_del is None:
                self.pglog.deleted.pop(oid, None)
            else:
                self.pglog.deleted[oid] = prev_del
            raise
        self.version = max(self.version, tuple(entry["ev"])[1])

    def check_inflight(self) -> None:
        """Re-arm stalled write gathers (ECBackend::check_op +
        on_change requeue semantics, osd/ECBackend.cc:1765): a lost
        MOSDRepOp/MOSDECSubOpWrite or its reply must not strand the
        gather until the client's timeout.  Sub-ops are resent to
        shards still waiting (replicas dedup by log ev); shards whose
        OSD left the acting set or went down are dropped from the
        gather — the new interval's peering/recovery owns them."""
        with self.lock:
            if not self._inflight or not self.is_primary:
                return
            now = self.osd.clock.now()
            interval = float(self.osd.conf.osd_subop_resend_interval)
            for reqid, state in list(self._inflight.items()):
                if not state["waiting"]:
                    continue
                if now - state.get("born", now) < interval:
                    continue
                state["born"] = now
                if state.get("kind") == "ec":
                    for shard in sorted(state["waiting"]):
                        holder = self.acting[shard] \
                            if shard < len(self.acting) else ITEM_NONE
                        orig = state["peers"].get(shard)
                        if orig is None or holder == ITEM_NONE or \
                                holder != orig[0] or \
                                not self.osd.osdmap.is_up(holder):
                            self.log.warn(
                                "dropping shard %d from gather %s "
                                "(holder gone)", shard, reqid)
                            state["waiting"].discard(shard)
                        else:
                            self.osd.send_osd(holder, orig[1])
                    if not state["waiting"] and "failed" not in state:
                        # never ack a write fewer than k shards hold —
                        # it would be unreconstructable if the applied
                        # minority then dies; EAGAIN makes the client
                        # retry against the re-peered interval
                        k = self._ec_codec().get_data_chunk_count()
                        if len(state.get("applied", ())) < k:
                            state["failed"] = -11
                elif state.get("kind") == "rep":
                    live = set(self.acting_live())
                    for osd_id in sorted(state["waiting"]):
                        if osd_id not in live or \
                                not self.osd.osdmap.is_up(osd_id):
                            self.log.warn(
                                "dropping osd.%d from gather %s "
                                "(peer gone)", osd_id, reqid)
                            state["waiting"].discard(osd_id)
                        else:
                            self.osd.send_osd(
                                osd_id, state["peers"][osd_id])
                if not state["waiting"]:
                    self._maybe_commit(reqid)

