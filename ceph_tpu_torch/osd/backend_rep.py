"""ReplicatedBackend: primary-copy replication
(osd/ReplicatedBackend.cc reduced — submit fan-out, replica apply,
reply gather; heal request for superseded skips).

Mixed into PG (pg.py).
"""

from __future__ import annotations

from ..store.objectstore import StoreError, Transaction
from .messages import MOSDRepOp, MOSDRepOpReply, sender_id


class ReplicatedBackend:
    def _replicated_write(self, conn, msg, version: tuple, reqid) -> None:
        try:
            txn, kind, outdata = self._build_txn(
                msg.oid, msg.ops, version,
                snapc=getattr(msg, "snapc", None),
                internal=getattr(msg, "_cache_internal", False))
        except StoreError as e:
            self._reply(conn, msg, -e.errno, [])
            return
        prior = self.pglog.objects.get(msg.oid)
        # the entry carries the client reqid (the reference's
        # reqid-carrying pg log entries): a NEW primary that merges
        # this log can re-reply to a client retry instead of
        # re-executing it — dedup survives primary changes.  Ops with
        # OUTPUT (cls WR calls) don't carry it: the log cannot replay
        # their outdata, and a seeded empty reply would hand the
        # retrying client a wrong payload — those re-execute instead
        # (the pre-subsystem semantics).
        entry = {"ev": version, "oid": msg.oid, "op": kind,
                 "prior": prior, "rollback": None, "shard": None,
                 "reqid": None if outdata else reqid}
        try:
            self._log_and_apply(txn, entry)
        except StoreError as e:
            self._reply(conn, msg, -e.errno, [])
            return
        # last_backfill routing: a backfill peer only receives ops for
        # objects at or below its watermark — anything beyond is
        # backfill-deferred (the resumed scan pushes the current
        # version when the walk reaches that name), so live writes
        # never convoy behind a peer that cannot hold them yet
        peers = [o for o in self.acting_live()
                 if o != self.osd.whoami
                 and self.should_send_op(o, msg.oid)]
        # sub-ops carry the client op's trace id (a plain CTM2 frame
        # field): the replica's own sub_op timeline correlates with
        # the primary's under one id in merged trace dumps
        trk = getattr(msg, "_trk", None)
        trace = getattr(trk, "trace_id", "") if trk is not None else ""
        sub_msgs = {peer: MOSDRepOp(
            reqid=reqid, pgid=str(self.pgid), ops=txn.ops,
            log=entry, trace=trace,
            epoch=self.osd.osdmap.epoch) for peer in peers}
        state = {"waiting": set(peers), "conn": conn, "msg": msg,
                 "version": version, "outdata": outdata,
                 "kind": "rep", "peers": sub_msgs,
                 "born": self.osd.clock.now()}
        self._inflight[reqid] = state
        for peer, sub in sub_msgs.items():
            self.osd.send_osd(peer, sub)
        if trk is not None and state["waiting"]:
            # open until the gather completes — trk.finish() at reply
            # time closes it, so the span IS the replica round trip
            trk.span_begin("replica_wait", peers=len(peers))
        self._maybe_commit(reqid)

    def _request_rep_heal(self, oid: str, msg) -> None:
        """Pull the primary's current full copy of `oid` — ours
        skipped an op and may hold a hole.  No-op when the object is
        deleted here (nothing to pull)."""
        if oid not in self.pglog.objects:
            return
        sender = sender_id(msg)
        if sender is None:
            live = self.acting_live()
            sender = live[0] if live else None
        if sender is not None and sender != self.osd.whoami:
            self.osd.pg_request_push(self.pgid, sender, oid)

    def handle_rep_op(self, conn, msg, _parked: bool = False) -> None:
        """Replica applies the primary's transaction (in ev order:
        out-of-order arrivals park until their predecessor lands)."""
        with self.lock:
            if self._already_applied(tuple(msg.log["ev"])):
                self.osd.send_osd_reply(conn, MOSDRepOpReply(
                    reqid=msg.reqid, pgid=str(self.pgid), result=0))
                return
            if self._superseded(msg.log):
                # our copy skipped this op (park expired or cap hit):
                # ack — the primary's gather must complete — but heal
                self._request_rep_heal(msg.log["oid"], msg)
                self.osd.send_osd_reply(conn, MOSDRepOpReply(
                    reqid=msg.reqid, pgid=str(self.pgid), result=0))
                return
            if not _parked and self._park_if_gap(conn, msg, "rep"):
                return            # replied when the gap fills/expires
            txn = Transaction()
            txn.ops = list(msg.ops)
            try:
                self._log_and_apply(txn, dict(msg.log))
                result = 0
            except StoreError as e:
                result = -e.errno
            self.osd.send_osd_reply(conn, MOSDRepOpReply(
                reqid=msg.reqid, pgid=str(self.pgid), result=result))
            if result == 0:
                self._flush_parked(msg.log["oid"])

    def handle_rep_reply(self, msg) -> None:
        with self.lock:
            state = self._inflight.get(msg.reqid)
            if state is None:
                return
            if msg.result != 0:
                state["failed"] = msg.result
            state["waiting"].discard(msg.src and int(msg.src.split(".")[1]))
            self._maybe_commit(msg.reqid)

