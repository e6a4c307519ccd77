"""Paxos: the single replicated transaction log (mon/Paxos.{h,cc} analog).

One value sequence shared by all services.  Protocol phases exactly as
the reference:

  * recovery (leader only, after every election): OP_COLLECT with a
    fresh proposal number -> peons promise (if pn beats accepted_pn)
    and reply OP_LAST carrying last_committed plus any uncommitted
    (version, pn, value); the leader re-proposes the highest-pn
    uncommitted value at last_committed+1 and catches lagging peons up
    by shipping committed values inside OP_COLLECT/OP_LAST (share).
  * steady state: OP_BEGIN(version, value) -> peons journal the pending
    value, OP_ACCEPT -> when the WHOLE quorum accepted (Paxos.cc
    requires all quorum members, not a bare majority), the leader
    commits locally and broadcasts OP_COMMIT.
  * leases: after commit the leader issues OP_LEASE(last_committed,
    expiry) so peons may serve reads (Paxos.cc:623).

Values are MonitorDBStore transaction blobs; committing = applying the
blob to the store + bumping last_committed, all in one KV transaction.
"""

from __future__ import annotations

from ..utils import denc
from typing import Callable

from ..utils.dout import DoutLogger
from .messages import MMonPaxos
from .store import MonitorDBStore

COLLECT = "collect"
LAST = "last"
BEGIN = "begin"
ACCEPT = "accept"
COMMIT = "commit"
LEASE = "lease"
LEASE_ACK = "lease_ack"
SYNC = "sync"

SVC = "paxos"


class Paxos:
    def __init__(self, name: str, store: MonitorDBStore,
                 send: Callable[[str, MMonPaxos], None],
                 on_commit: Callable[[int], None],
                 lease_duration: float = 5.0, clock=None,
                 schedule: Callable | None = None,
                 on_stall: Callable | None = None,
                 phase_timeout: float = 10.0,
                 trim_max: int = 500, trim_keep: int = 250):
        from ..utils.clock import SystemClock
        self.clock = clock or SystemClock()
        # collect/accept phase watchdog: a lost LAST/ACCEPT (e.g. a
        # peon that died or demoted mid-round) must not wedge the
        # leader forever (Paxos::collect_timeout/accept_timeout ->
        # bootstrap in the reference)
        self.schedule = schedule
        self.on_stall = on_stall
        self.phase_timeout = phase_timeout
        self._phase_timer = None
        self.perf = None                 # optional PerfCounters
        # optional op-trace hook: tracer(event, version) fires at
        # "begin" (value enters the accept round) and "commit" (value
        # applied + visible) — the monitor turns these into
        # paxos.propose / paxos.commit spans on tracked command ops
        self.tracer: Callable | None = None
        self.name = name
        self.store = store
        self.send = send
        self.on_commit = on_commit       # on_commit(version) -> refresh
        # fired when the leader becomes writeable: the monitor drains
        # service proposals queued while we were recovering.  Without
        # this, a proposal queued mid-recovery waits for the NEXT
        # commit to flush it — and if no commit ever follows, it is
        # stranded forever (the mon-add-acked-but-never-committed
        # membership race)
        self.on_active: Callable | None = None
        self.lease_duration = lease_duration
        # trim: keep the committed window bounded (Paxos.cc trim);
        # peers behind the trim point rejoin via full store sync
        self.trim_max = trim_max
        self.trim_keep = trim_keep
        self.log = DoutLogger("paxos", name)

        self.leader: str | None = None
        self.quorum: list[str] = []
        self.rank = 0

        self.last_committed = store.get_int(SVC, "last_committed")
        self.first_committed = store.get_int(SVC, "first_committed")
        self.accepted_pn = store.get_int(SVC, "accepted_pn")

        # uncommitted (journaled but not committed) value
        self.uncommitted_v: int | None = None
        self.uncommitted_pn = 0
        self.uncommitted_value: bytes | None = None
        self._load_uncommitted()

        # leader collect state
        self.collecting = False
        self.collect_acks: set[str] = set()
        self.collect_max_last = 0
        self.best_uncommitted: tuple[int, int, bytes] | None = None
        self._peer_last: dict[str, int] = {}   # peer -> last_committed

        # leader begin state
        self.pending_value: bytes | None = None
        self.pending_v = 0
        self.accept_acks: set[str] = set()
        self.proposals: list[tuple[bytes, Callable | None]] = []
        self._pending_done: Callable | None = None

        # lease
        self.lease_expire = 0.0
        self.active = False              # writeable (leader, recovered)

    # -- persistence helpers ----------------------------------------------

    def _load_uncommitted(self) -> None:
        blob = self.store.get(SVC, "uncommitted")
        if blob:
            v, pn, value = denc.loads(blob)
            if v > self.last_committed:
                self.uncommitted_v, self.uncommitted_pn = v, pn
                self.uncommitted_value = value

    def _save_uncommitted(self, txn, v: int | None, pn: int = 0,
                          value: bytes | None = None) -> None:
        if v is None:
            txn.rmkey(SVC, "uncommitted")
        else:
            txn.set(SVC, "uncommitted", denc.dumps((v, pn, value)))

    def new_pn(self) -> int:
        """Fresh proposal number: counter*100 + rank (Paxos get_new_pn)."""
        cur = max(self.accepted_pn, self.store.get_int(SVC, "max_pn"))
        pn = (cur // 100 + 1) * 100 + self.rank
        txn = self.store.transaction()
        self.store.put_int(txn, SVC, "max_pn", pn)
        self.store.apply_transaction(txn)
        return pn

    # -- role changes ------------------------------------------------------

    def leader_init(self, quorum: list[str], rank: int) -> None:
        self.leader = self.name
        self.quorum = quorum
        self.rank = rank
        self.active = False
        self.pending_value = None
        if len(quorum) == 1:
            # singleton: no peons to collect from
            self.accepted_pn = self.new_pn()
            self._commit_uncommitted_if_any()
            self._activate()
            return
        self.collecting = True
        self.collect_acks = {self.name}
        self.collect_max_last = self.last_committed
        self._peer_last = {}
        self.best_uncommitted = (
            (self.uncommitted_v, self.uncommitted_pn, self.uncommitted_value)
            if self.uncommitted_v else None)
        pn = self.new_pn()
        self.accepted_pn = pn
        txn = self.store.transaction()
        self.store.put_int(txn, SVC, "accepted_pn", pn)
        self.store.apply_transaction(txn)
        if self.perf:
            self.perf.inc("collect")
        for peer in quorum:
            if peer != self.name:
                self.send(peer, MMonPaxos(
                    op=COLLECT, pn=pn, last_committed=self.last_committed,
                    first_committed=self.first_committed))
        self._arm_phase_timer(lambda: self.collecting, "collect")

    def peon_init(self, leader: str, quorum: list[str], rank: int) -> None:
        self.leader = leader
        self.quorum = quorum
        self.rank = rank
        self.active = False
        self.collecting = False
        self.pending_value = None
        # grace for the new leader's first LEASE: the monitor's
        # lease-timeout watchdog must not re-trip on the PREVIOUS
        # leader's stale expiry the instant we lose an election
        self.lease_expire = self.clock.now() + self.lease_duration
        self._cancel_phase_timer()

    # -- phase watchdog -----------------------------------------------------

    def _arm_phase_timer(self, still_stuck: Callable[[], bool],
                         phase: str) -> None:
        self._cancel_phase_timer()
        if self.schedule is None or self.on_stall is None:
            return

        def check():
            self._phase_timer = None
            if self.is_leader() and still_stuck():
                self.log.warn("%s phase stalled for %.0fs, bootstrapping",
                              phase, self.phase_timeout)
                self.on_stall()

        self._phase_timer = self.schedule(self.phase_timeout, check)

    def _cancel_phase_timer(self) -> None:
        if self._phase_timer is not None:
            try:
                self._phase_timer.cancel()
            except Exception:
                pass
            self._phase_timer = None

    # -- recovery phase ----------------------------------------------------

    def handle(self, msg: MMonPaxos) -> None:
        op = msg.op
        if op == COLLECT:
            self._handle_collect(msg)
        elif op == LAST:
            self._handle_last(msg)
        elif op == BEGIN:
            self._handle_begin(msg)
        elif op == ACCEPT:
            self._handle_accept(msg)
        elif op == COMMIT:
            self._handle_commit(msg)
        elif op == LEASE:
            self._handle_lease(msg)
        elif op == LEASE_ACK:
            pass
        elif op == SYNC:
            self._handle_sync(msg)

    def _committed_range(self, first: int, last: int) -> dict[int, bytes]:
        out = {}
        for v in range(first, last + 1):
            blob = self.store.get_version(SVC, v)
            if blob is not None:
                out[v] = blob
        return out

    def _handle_collect(self, msg: MMonPaxos) -> None:
        if msg.pn < self.accepted_pn:
            return   # promised a higher pn already; ignore (leader times out)
        self.accepted_pn = msg.pn
        txn = self.store.transaction()
        self.store.put_int(txn, SVC, "accepted_pn", msg.pn)
        self.store.apply_transaction(txn)
        # share commits the leader is missing; a leader behind OUR
        # trim point cannot replay version-by-version — ship the whole
        # store instead (Monitor sync_start semantics)
        commits = {}
        sync = None
        if msg.last_committed < self.last_committed:
            if msg.last_committed + 1 < self.first_committed:
                self.log.info("leader %s at v%d behind our trim point "
                              "v%d: full sync", msg.src,
                              msg.last_committed, self.first_committed)
                sync = self.store.dump_all()
            else:
                commits = self._committed_range(msg.last_committed + 1,
                                                self.last_committed)
        reply = MMonPaxos(op=LAST, pn=msg.pn,
                          last_committed=self.last_committed,
                          first_committed=self.first_committed,
                          commits=commits, sync=sync,
                          uncommitted=(self.uncommitted_v,
                                       self.uncommitted_pn,
                                       self.uncommitted_value)
                          if self.uncommitted_v else None)
        self.send(msg.src, reply)

    def _handle_last(self, msg: MMonPaxos) -> None:
        if not self.collecting or msg.pn != self.accepted_pn:
            return
        sync = getattr(msg, "sync", None)
        if sync:
            # we (the new leader) are behind the quorum's trim point:
            # adopt the peon's whole store, keep our proposal number
            self._absorb_sync(sync)
            txn = self.store.transaction()
            self.store.put_int(txn, SVC, "accepted_pn", self.accepted_pn)
            self.store.apply_transaction(txn)
        # absorb shared commits
        for v, blob in sorted(getattr(msg, "commits", {}).items()):
            if v == self.last_committed + 1:
                self._apply_commit(v, blob)
        self._peer_last[msg.src] = msg.last_committed
        if msg.last_committed > self.collect_max_last:
            self.collect_max_last = msg.last_committed
        unc = getattr(msg, "uncommitted", None)
        if unc and unc[0] is not None:
            if (self.best_uncommitted is None
                    or unc[1] > self.best_uncommitted[1]):
                self.best_uncommitted = tuple(unc)
        self.collect_acks.add(msg.src)
        if self.collect_acks >= set(self.quorum):
            self.collecting = False
            self._cancel_phase_timer()
            self._post_collect()

    def _post_collect(self) -> None:
        # catch up lagging peons by sharing commits in BEGIN-free path:
        # peons learn via commit messages; one behind the trim point
        # gets the whole store instead (its missing versions are gone)
        for peer in self.quorum:
            if peer == self.name:
                continue
            plast = self._peer_last.get(peer, 0)
            if plast + 1 < self.first_committed:
                self.log.info("peon %s at v%d behind trim point v%d: "
                              "full sync", peer, plast,
                              self.first_committed)
                self.send(peer, MMonPaxos(
                    op=SYNC, sync=self.store.dump_all(),
                    last_committed=self.last_committed,
                    first_committed=self.first_committed))
                continue
            self.send(peer, MMonPaxos(
                op=COMMIT, last_committed=self.last_committed,
                commits=self._committed_range(
                    max(self.first_committed, plast + 1),
                    self.last_committed)))
        if (self.best_uncommitted
                and self.best_uncommitted[0] == self.last_committed + 1):
            v, pn, value = self.best_uncommitted
            self.log.info("re-proposing uncommitted v%d", v)
            self.best_uncommitted = None
            self._begin(value, None)
            return
        self.best_uncommitted = None
        self._commit_uncommitted_if_any()
        self._activate()

    def _commit_uncommitted_if_any(self) -> None:
        if (self.uncommitted_v
                and self.uncommitted_v == self.last_committed + 1
                and len(self.quorum) == 1):
            # singleton recovery: our own journaled value wins
            self._apply_commit(self.uncommitted_v, self.uncommitted_value)
        self.uncommitted_v = None
        self.uncommitted_value = None

    def _activate(self) -> None:
        self.active = True
        self._extend_lease()
        self.log.info("active as leader at v%d", self.last_committed)
        if self.on_active is not None:
            try:
                self.on_active()
            except Exception:
                self.log.error("on_active callback failed")
        self._propose_queued()

    # -- steady state ------------------------------------------------------

    def propose(self, value: bytes, done: Callable | None = None) -> None:
        """Queue a txn blob for commit (leader only)."""
        assert self.is_leader()
        self.proposals.append((value, done))
        self._propose_queued()

    def is_leader(self) -> bool:
        return self.leader == self.name

    def is_writeable(self) -> bool:
        return self.is_leader() and self.active

    def is_readable(self) -> bool:
        if self.is_leader():
            return self.active
        return self.clock.now() < self.lease_expire

    def _propose_queued(self) -> None:
        if (not self.active or self.pending_value is not None
                or not self.proposals):
            return
        value, done = self.proposals.pop(0)
        self._pending_done = done
        self._begin(value, done)

    def _begin(self, value: bytes, done: Callable | None) -> None:
        if self.perf:
            self.perf.inc("begin")
        if self.tracer:
            try:
                self.tracer("begin", self.last_committed + 1)
            except Exception:
                pass             # tracing must never wedge consensus
        self.pending_v = self.last_committed + 1
        self.pending_value = value
        self._pending_done = done
        self.accept_acks = {self.name}
        # journal our own uncommitted value
        txn = self.store.transaction()
        self._save_uncommitted(txn, self.pending_v, self.accepted_pn, value)
        self.store.apply_transaction(txn)
        self.uncommitted_v = self.pending_v
        self.uncommitted_pn = self.accepted_pn
        self.uncommitted_value = value
        if len(self.quorum) == 1:
            self._commit_pending()
            return
        for peer in self.quorum:
            if peer != self.name:
                self.send(peer, MMonPaxos(
                    op=BEGIN, pn=self.accepted_pn, version=self.pending_v,
                    value=value, last_committed=self.last_committed))
        self._arm_phase_timer(
            lambda: self.pending_value is not None, "accept")

    def _handle_begin(self, msg: MMonPaxos) -> None:
        if msg.pn < self.accepted_pn:
            return
        self.accepted_pn = msg.pn
        txn = self.store.transaction()
        self.store.put_int(txn, SVC, "accepted_pn", msg.pn)
        self._save_uncommitted(txn, msg.version, msg.pn, msg.value)
        self.store.apply_transaction(txn)
        self.uncommitted_v = msg.version
        self.uncommitted_pn = msg.pn
        self.uncommitted_value = msg.value
        # crash site: the value is journaled (accepted) but the ACCEPT
        # never leaves — the PAR invariant requires a remount to still
        # OFFER this value during the next leader's collect phase
        self.store.maybe_crash("paxos.post_accept_pre_ack")
        self.send(msg.src, MMonPaxos(op=ACCEPT, pn=msg.pn,
                                     version=msg.version))

    def _handle_accept(self, msg: MMonPaxos) -> None:
        if (self.pending_value is None or msg.pn != self.accepted_pn
                or msg.version != self.pending_v):
            return
        self.accept_acks.add(msg.src)
        if self.accept_acks >= set(self.quorum):
            self._commit_pending()

    def _commit_pending(self) -> None:
        v, value = self.pending_v, self.pending_value
        done = self._pending_done
        self.pending_value = None
        self._pending_done = None
        self._cancel_phase_timer()
        # trace BEFORE applying: _apply_commit runs the monitor's
        # on_commit refresh (which drains client acks), and the
        # paxos.commit span must already be open to cover it
        if self.tracer:
            try:
                self.tracer("commit", v)
            except Exception:
                pass
        self._apply_commit(v, value)
        for peer in self.quorum:
            if peer != self.name:
                self.send(peer, MMonPaxos(
                    op=COMMIT, last_committed=self.last_committed,
                    commits={v: value}))
        self._extend_lease()
        if done:
            try:
                done()
            except Exception:
                self.log.error("proposal completion callback failed")
        if not self.active and self.is_leader():
            # the value just committed was the recovery round's
            # re-proposed uncommitted value (_post_collect returned
            # before activating): the round is now complete
            self._activate()
        else:
            self._propose_queued()

    def _apply_commit(self, v: int, value: bytes) -> None:
        """Apply the txn blob + bump last_committed atomically."""
        assert v == self.last_committed + 1, (v, self.last_committed)
        # crash site: nothing of the commit reached disk yet — the
        # journaled uncommitted value must survive the remount
        self.store.maybe_crash("paxos.pre_commit")
        txn = self.store.transaction()
        for op in denc.loads(value):
            txn.ops.append(op)
        self.store.put_version(txn, SVC, v, value)
        self.store.put_int(txn, SVC, "last_committed", v)
        if self.first_committed == 0:
            self.first_committed = 1
            self.store.put_int(txn, SVC, "first_committed", 1)
        # the seal vouches for the whole commit; it precedes the
        # uncommitted-record removal so ANY prefix tear keeps the
        # accepted value on disk (a mon never forgets what it
        # accepted — the PAR invariant)
        self.store.seal_commit(txn, v, value)
        self._save_uncommitted(txn, None)
        # crash site: the commit transaction tears — a seeded prefix
        # (or reordered subset) of its ops land; check_integrity
        # detects the damage at remount and the quorum repairs it
        self.store.apply_transaction(txn, torn_site="paxos.mid_commit")
        self.last_committed = v
        # a trim blob moves first_committed inside the applied txn
        self.first_committed = max(
            self.first_committed,
            self.store.get_int(SVC, "first_committed"))
        self.uncommitted_v = None
        self.uncommitted_value = None
        if self.perf:
            self.perf.inc("commit")
        self.on_commit(v)

    def _handle_commit(self, msg: MMonPaxos) -> None:
        for v, blob in sorted(getattr(msg, "commits", {}).items()):
            if v == self.last_committed + 1:
                self._apply_commit(v, blob)
        # peon lease is implied refreshed by commit traffic
        self.lease_expire = self.clock.now() + self.lease_duration

    # -- trim + full store sync --------------------------------------------

    def _absorb_sync(self, entries: list) -> None:
        self.store.restore_all(entries)
        txn = self.store.transaction()
        txn.rmkey(SVC, "uncommitted")     # the donor's, not ours
        self.store.apply_transaction(txn)
        self.last_committed = self.store.get_int(SVC, "last_committed")
        self.first_committed = self.store.get_int(SVC, "first_committed")
        self.uncommitted_v = None
        self.uncommitted_value = None
        self.log.info("store sync absorbed: now at v%d (first v%d)",
                      self.last_committed, self.first_committed)
        self.on_commit(self.last_committed)

    def _handle_sync(self, msg: MMonPaxos) -> None:
        """Peon: the quorum trimmed past our last_committed — replace
        our store wholesale and resume from the leader's head."""
        self._absorb_sync(msg.sync)
        self.lease_expire = self.clock.now() + self.lease_duration

    def maybe_trim(self) -> None:
        """Leader: propose erasing committed versions older than the
        keep window (Paxos::trim) — the erase rides the log itself, so
        every quorum member trims identically."""
        if not self.is_writeable():
            return
        if self.last_committed - self.first_committed < self.trim_max:
            return
        target = self.last_committed - self.trim_keep
        if target <= self.first_committed:
            return
        self.log.info("trimming paxos v%d..v%d", self.first_committed,
                      target)
        txn = self.store.transaction()
        self.store.erase_version_range(txn, SVC, self.first_committed,
                                       target)
        self.store.put_int(txn, SVC, "first_committed", target)
        self.propose(denc.dumps(txn.ops))

    # -- leases ------------------------------------------------------------

    def _extend_lease(self) -> None:
        if self.perf:
            self.perf.inc("lease")
        self.lease_expire = self.clock.now() + self.lease_duration
        for peer in self.quorum:
            if peer != self.name:
                self.send(peer, MMonPaxos(
                    op=LEASE, last_committed=self.last_committed,
                    lease_expire=self.lease_expire))

    def _handle_lease(self, msg: MMonPaxos) -> None:
        self.lease_expire = self.clock.now() + self.lease_duration
        self.active = True
        self.send(msg.src, MMonPaxos(op=LEASE_ACK))

    def tick(self) -> None:
        """Leader: renew leases periodically."""
        if self.is_leader() and self.active:
            self._extend_lease()
