"""Leader election (mon/Elector.h:34 analog).

Lowest-rank live monitor wins.  A candidate proposes itself with a
fresh epoch; peers ack anyone with a lower rank than any candidate they
have acked this epoch (deferring), or counter-propose if they outrank
the candidate.  Majority of acks -> victory broadcast with the quorum.
Epochs are bumped on every election so stale messages are discarded.
"""

from __future__ import annotations

from typing import Callable

from ..utils.dout import DoutLogger
from .messages import MMonElection
from .monmap import MonMap

PROPOSE = "propose"
ACK = "ack"
VICTORY = "victory"


class Elector:
    def __init__(self, name: str, monmap: MonMap,
                 send: Callable[[str, MMonElection], None],
                 on_win: Callable[[int, list[str]], None],
                 on_lose: Callable[[int, str, list[str]], None],
                 schedule: Callable[[float, Callable], object] | None = None,
                 cancel: Callable[[object], None] | None = None,
                 timeout: float = 1.0):
        import threading

        def _sched(delay, fn):
            t = threading.Timer(delay, fn)
            t.daemon = True
            t.start()
            return t

        self.name = name
        self.monmap = monmap
        self.send = send                  # send(peer_name, msg)
        self.on_win = on_win              # on_win(epoch, quorum)
        self.on_lose = on_lose            # on_lose(epoch, leader, quorum)
        self.schedule = schedule or _sched
        self.cancel = cancel or (lambda t: t.cancel())
        self.timeout = timeout
        self.log = DoutLogger("elector", name)
        self.epoch = 1
        self.electing = False
        self.acked: str | None = None     # whom we acked this epoch
        self.acks: set[str] = set()
        self.leader: str | None = None
        self.quorum: list[str] = []
        self._victory_timer = None
        self._restart_timer = None
        # a mon removed from the map steps out: its name has no rank
        # in the new roster, so any election activity would throw
        self.disabled = False

    @property
    def rank(self) -> int:
        return self.monmap.rank_of(self.name)

    def start(self) -> None:
        """Begin (or restart) an election round."""
        if self.disabled:
            return
        self._cancel_victory()
        self.epoch += 1
        self.electing = True
        self.acked = self.name
        self.acks = {self.name}
        self.leader = None
        self.log.debug("start election epoch %d", self.epoch)
        for peer in self.monmap.ranks():
            if peer != self.name:
                self.send(peer, MMonElection(op=PROPOSE, epoch=self.epoch,
                                             rank=self.rank, quorum=[]))
        self._arm_restart()
        self._check_victory()

    def _arm_restart(self) -> None:
        """Liveness: an election that neither wins nor loses within the
        full timeout restarts with a fresh epoch (the reference's
        expire_election) — e.g. our propose raced a round that excluded
        us, so peers drop our now-stale epoch on the floor."""
        self._cancel_restart()
        epoch_at = self.epoch
        self._restart_timer = self.schedule(
            self.timeout * 5, lambda: self._restart_timeout(epoch_at))

    def _restart_timeout(self, epoch: int) -> None:
        self._restart_timer = None
        if self.electing and epoch == self.epoch:
            self.log.debug("election epoch %d expired, restarting", epoch)
            self.start()

    def stop(self) -> None:
        """Step out permanently (removed from the roster): cancel any
        armed victory/restart timers — a mid-candidacy removed mon
        must not fire _declare_victory from a stale timer — and go
        inert."""
        self.disabled = True
        self.electing = False
        self._cancel_victory()
        self._cancel_restart()
        self.leader = None
        self.quorum = []

    def _cancel_restart(self) -> None:
        if self._restart_timer is not None:
            try:
                self.cancel(self._restart_timer)
            except Exception:
                pass
            self._restart_timer = None

    def handle(self, msg: MMonElection) -> None:
        if self.disabled:
            return                        # removed from the roster
        if msg.epoch < self.epoch and msg.op != VICTORY:
            return                        # stale round
        if msg.op == PROPOSE:
            self._handle_propose(msg)
        elif msg.op == ACK:
            self._handle_ack(msg)
        elif msg.op == VICTORY:
            self._handle_victory(msg)

    def _handle_propose(self, msg: MMonElection) -> None:
        peer = msg.src
        peer_rank = msg.rank
        if msg.epoch > self.epoch:
            self.epoch = msg.epoch
            self.electing = True
            self.acked = None
            self.acks = set()
            self._cancel_victory()
            self._arm_restart()
        if peer_rank < self.rank:
            # candidate outranks us: defer unless we already acked better
            if (self.acked is None
                    or self.monmap.rank_of(self.acked) > peer_rank):
                self.acked = peer
                self._cancel_victory()     # our candidacy is over
                self.send(peer, MMonElection(op=ACK, epoch=self.epoch,
                                             rank=self.rank, quorum=[]))
        else:
            # we outrank the candidate: push our own candidacy
            if self.acked != self.name:
                self.epoch += 1
                self.electing = True
                self.acked = self.name
                self.acks = {self.name}
                self._arm_restart()
                for p in self.monmap.ranks():
                    if p != self.name:
                        self.send(p, MMonElection(
                            op=PROPOSE, epoch=self.epoch, rank=self.rank,
                            quorum=[]))

    def _handle_ack(self, msg: MMonElection) -> None:
        if not self.electing or self.acked != self.name:
            return
        if msg.epoch != self.epoch:
            return
        self.acks.add(msg.src)
        self._check_victory()

    def _cancel_victory(self) -> None:
        if self._victory_timer is not None:
            try:
                self.cancel(self._victory_timer)
            except Exception:
                pass
            self._victory_timer = None

    def _check_victory(self) -> None:
        """Declare immediately with ALL acks; with a bare majority wait
        out the election timeout so a better-ranked candidate's propose
        can still preempt us (the reference's expire_election model)."""
        if self.acked != self.name or not self.electing:
            return
        if len(self.acks) >= self.monmap.size:
            self._declare_victory()
        elif (len(self.acks) >= self.monmap.quorum_needed()
                and self._victory_timer is None):
            epoch_at_schedule = self.epoch
            self._victory_timer = self.schedule(
                self.timeout,
                lambda: self._victory_timeout(epoch_at_schedule))

    def _victory_timeout(self, epoch: int) -> None:
        self._victory_timer = None
        if (self.electing and self.acked == self.name
                and epoch == self.epoch
                and len(self.acks) >= self.monmap.quorum_needed()):
            self._declare_victory()

    def _declare_victory(self) -> None:
        self._cancel_victory()
        self._cancel_restart()
        quorum = sorted(self.acks, key=self.monmap.rank_of)
        self.epoch += 1
        self.electing = False
        self.leader = self.name
        self.quorum = quorum
        self.log.info("won election epoch %d quorum %s",
                      self.epoch, quorum)
        for peer in quorum:
            if peer != self.name:
                self.send(peer, MMonElection(
                    op=VICTORY, epoch=self.epoch, rank=self.rank,
                    quorum=quorum))
        self.on_win(self.epoch, quorum)

    def _handle_victory(self, msg: MMonElection) -> None:
        if msg.epoch < self.epoch:
            return
        self._cancel_victory()
        self._cancel_restart()
        self.epoch = msg.epoch
        self.electing = False
        self.leader = msg.src
        self.quorum = list(msg.quorum)
        self.log.info("lost election to %s epoch %d", msg.src, self.epoch)
        self.on_lose(self.epoch, msg.src, self.quorum)
