"""MonClient: a daemon/client session to the monitor quorum.

The mon/MonClient.cc analog: pick a mon, subscribe to maps, relay
commands (blocking with timeout + failover to another mon), surface
OSDMap updates to the owner via a callback.
"""

from __future__ import annotations

import itertools
from ..utils import denc
import threading
from typing import Callable

from ..msg import Dispatcher, Message, Messenger
from ..osd.osdmap import OSDMap, OSDMapIncremental
from ..utils.dout import DoutLogger
from .messages import (MMonCommand, MMonCommandAck, MMonMap, MMonSubscribe,
                       MOSDBoot, MOSDFailure, MOSDMapMsg, MPGTemp)
from .monmap import MonMap


class MonClient(Dispatcher):
    def __init__(self, msgr: Messenger, monmap: MonMap):
        self.msgr = msgr
        self.monmap = monmap
        self.log = DoutLogger("monc", msgr.name)
        self.osdmap = OSDMap()
        self.on_osdmap: Callable[[OSDMap], None] | None = None
        # pool ids whose CREATION we observed arrive as an incremental
        # chained onto a map we already held — for these, and only
        # these, an empty pg copy is known to be the complete initial
        # state rather than a reboot-emptied husk of older data
        self.pool_births_witnessed: set[int] = set()
        self._tid = itertools.count(1)
        self._acks: dict[int, tuple] = {}
        self._ack_cv = threading.Condition()
        self._cur_mon: str | None = None
        # standing subscriptions, renewed periodically: the mon drops a
        # session's subs when its (lossy) push link to us resets, and a
        # stranded push is never resent — without renewal one dropped
        # frame freezes our map forever (MonClient::tick sub renewal,
        # mon/MonClient.cc: _renew_subs on sub interval)
        self._sub_what: dict[str, int] = {}
        self._sub_stop = threading.Event()
        self._sub_lock = threading.Lock()
        self._sub_thread: threading.Thread | None = None
        self._sub_timer = None
        msgr.add_dispatcher_head(self)

    # -- session -----------------------------------------------------------

    def _target(self) -> tuple[str, tuple]:
        if self._cur_mon not in self.monmap.mons:
            self._cur_mon = None          # roster changed under us
        name = self._cur_mon or self.monmap.ranks()[0]
        self._cur_mon = name
        return f"mon.{name}", self.monmap.addr_of(name)

    def _hunt(self) -> None:
        """Fail over to the next mon."""
        ranks = self.monmap.ranks()
        if self._cur_mon is None or self._cur_mon not in ranks:
            self._cur_mon = ranks[0]
        else:
            i = (ranks.index(self._cur_mon) + 1) % len(ranks)
            self._cur_mon = ranks[i]

    def subscribe(self, what: dict) -> None:
        self._sub_what.update(what)
        entity, addr = self._target()
        self.msgr.send_message(MMonSubscribe(what=what), entity, addr)
        with self._sub_lock:
            if self._sub_thread is not None or self._sub_timer is not None:
                return
            # periodic renewal rides the messenger's own loop (both
            # stacks expose call_later) — a session costs no renewal
            # thread; the thread remains only for bare test doubles
            if hasattr(self.msgr, "call_later"):
                self._sub_timer = self.msgr.call_later(
                    self._renew_interval(), self._renew_tick)
            else:
                self._sub_thread = threading.Thread(
                    target=self._renew_loop, daemon=True,
                    name=f"monc-renew-{self.msgr.name}")
                self._sub_thread.start()

    def sub_want_osdmap(self, start: int = 0) -> None:
        self.subscribe({"osdmap": start})

    def renew_subs(self) -> None:
        """Re-assert standing subscriptions from our CURRENT epochs.

        Idempotent at the mon: a start past its latest epoch sends
        nothing back (both osdmap and monmap subs are epoch-gated).
        Heals both a mon-side session drop (lossy push-link reset pops
        mon.subs) and a stranded push (the mon optimistically advanced
        our want past maps we never saw)."""
        what = {}
        if "osdmap" in self._sub_what:
            what["osdmap"] = self.osdmap.epoch + 1
        if "monmap" in self._sub_what:
            what["monmap"] = self.monmap.epoch + 1
        if not what:
            return
        try:
            entity, addr = self._target()
            self.msgr.send_message(MMonSubscribe(what=what), entity,
                                   addr)
        except RuntimeError:
            pass          # messenger shut down

    def _hunt_if_dead(self) -> None:
        """The session to the current mon rides a LOSSLESS link: a
        dead mon never produces a reset event, it just reconnect-loops
        forever with our sends stranded in its queue.  If the link has
        no live socket across TWO consecutive renew ticks (one tick
        could be an ordinary reconnect/handshake window), fail over
        (MonClient::tick hunting)."""
        if self.monmap.size < 2 or self._cur_mon is None:
            return
        conn = self.msgr.conns.get(f"mon.{self._cur_mon}")
        if conn is None or conn._writer is not None:
            self._dead_ticks = 0
            return
        self._dead_ticks = getattr(self, "_dead_ticks", 0) + 1
        if self._dead_ticks < 2:
            return
        self._dead_ticks = 0
        old = self._cur_mon
        self._hunt()
        if self._cur_mon != old:
            self.log.info("mon.%s unresponsive: hunting to mon.%s",
                          old, self._cur_mon)

    def _renew_interval(self) -> float:
        return float(getattr(self.msgr.conf,
                             "mon_sub_renew_interval", 2.0) or 2.0)

    def _renew_tick(self) -> None:
        """One renewal pass, on the messenger loop (non-blocking:
        sends are queued, never awaited)."""
        if self._sub_stop.is_set():
            return
        try:
            self._hunt_if_dead()
            self.renew_subs()
        finally:
            if not self._sub_stop.is_set():
                try:
                    self._sub_timer = self.msgr.call_later(
                        self._renew_interval(), self._renew_tick)
                except RuntimeError:
                    pass          # messenger shut down under us

    def _renew_loop(self) -> None:
        interval = self._renew_interval()
        while not self._sub_stop.wait(interval):
            self._hunt_if_dead()
            self.renew_subs()

    def shutdown(self) -> None:
        self._sub_stop.set()
        if self._sub_timer is not None:
            self._sub_timer.cancel()
            self._sub_timer = None
        self._auth_stop = True

    # -- commands ----------------------------------------------------------

    def command(self, cmd: dict, timeout: float = 30.0) -> tuple[int, str, bytes]:
        """Send an admin command; failover between mons until acked."""
        tid = next(self._tid)
        deadline = threading.TIMEOUT_MAX if timeout is None else timeout
        attempts = max(3, self.monmap.size + 1)
        per_try = max(2.0, deadline / attempts)
        for _ in range(attempts):
            entity, addr = self._target()
            self.msgr.send_message(MMonCommand(tid=tid, cmd=cmd),
                                   entity, addr)
            with self._ack_cv:
                ok = self._ack_cv.wait_for(lambda: tid in self._acks,
                                           per_try)
                if ok:
                    return self._acks.pop(tid)
            self._hunt()
        return -110, "command timed out", b""

    # -- cephx service tickets + rotating keys -----------------------------
    #
    # CephxProtocol's TGS flow, client side: fetch service tickets
    # over the (statically-authenticated, frame-signed) mon channel
    # and renew them at ~ttl/3; a service daemon additionally fetches
    # its own class's ROTATING secrets on the same cadence so its
    # messenger can redeem clients' tickets.  Both run on one
    # background thread — the messenger's connect coroutine only ever
    # reads the CACHE (a blocking fetch inside the event loop would
    # deadlock against the mon session riding the same messenger).

    def enable_service_auth(self, msgrs: list, own_service: str | None,
                            ticket_services: list[str],
                            clock=None) -> None:
        from ..utils import denc as _denc
        import base64
        self._tickets: dict[str, dict] = getattr(self, "_tickets", {})
        for m in msgrs:
            m.ticket_provider = self._tickets.get
            if clock is not None:
                m.ticket_clock = clock.now

        def refresh_once() -> float:
            ttl = None
            for svc in ticket_services:
                rv, _out, data = self.command(
                    {"prefix": "auth get-ticket", "service": svc},
                    timeout=10.0)
                if rv == 0 and data:
                    t = _denc.loads(data)
                    self._tickets[svc] = t
                    ttl = float(self.msgr.conf.auth_service_ticket_ttl)
            if own_service:
                rv, _out, data = self.command(
                    {"prefix": "auth get-rotating",
                     "service": own_service}, timeout=10.0)
                if rv == 0 and data:
                    rot = _denc.loads(data)
                    keys = {int(r["id"]): base64.b64decode(r["secret"])
                            for r in rot}
                    for m in msgrs:
                        m.rotating_keys = keys
            return ttl or float(self.msgr.conf.auth_service_ticket_ttl)

        def loop() -> None:
            import time as _time
            while not getattr(self, "_auth_stop", False):
                try:
                    ttl = refresh_once()
                except Exception:
                    ttl = 5.0
                # REAL-time cadence: ticket expiry stamps ride the
                # cluster clock, but renewal just needs to happen
                # often enough; ttl/3 in real seconds over-renews
                # under a ManualClock, never under-renews
                _time.sleep(max(0.5, ttl / 3.0))

        t = threading.Thread(target=loop, daemon=True,
                             name=f"cephx-renew-{self.msgr.name}")
        self._auth_thread = t
        t.start()

    # -- osd daemon helpers ------------------------------------------------

    def send(self, msg) -> None:
        """Send an arbitrary message to the current mon."""
        entity, addr = self._target()
        self.msgr.send_message(msg, entity, addr)

    def send_boot(self, osd_id: int, addr, hb_addr=None) -> None:
        entity, maddr = self._target()
        self.msgr.send_message(
            MOSDBoot(osd_id=osd_id, addr=tuple(addr),
                     heartbeat_addr=tuple(hb_addr) if hb_addr else None),
            entity, maddr)

    def report_failure(self, target_osd: int, failed_for: float) -> None:
        entity, addr = self._target()
        self.msgr.send_message(
            MOSDFailure(target_osd=target_osd, failed_for=failed_for),
            entity, addr)

    def cluster_log(self, level: str, text: str) -> None:
        """Send one cluster-log entry (LogClient -> LogMonitor)."""
        from .messages import MLogMsg
        entity, addr = self._target()
        self.msgr.send_message(
            MLogMsg(entries=[{"level": level, "text": text}]),
            entity, addr)

    def send_pg_stats(self, osd_id: int, stats: dict,
                      epoch: int, flags: dict | None = None) -> None:
        """Primary-pg stats for the mon's PGMap/health aggregation;
        `flags` carries per-daemon health markers (e.g. a device-
        degraded EC codec) the mon folds into its health report."""
        from .messages import MPGStats
        entity, addr = self._target()
        self.msgr.send_message(
            MPGStats(osd_id=osd_id, stats=stats, epoch=epoch,
                     flags=flags),
            entity, addr)

    def send_pg_temp(self, osd_id: int, pg_temp: dict) -> None:
        entity, addr = self._target()
        self.msgr.send_message(MPGTemp(osd_id=osd_id, pg_temp=pg_temp),
                               entity, addr)

    # -- dispatch ----------------------------------------------------------

    def ms_dispatch(self, conn, msg: Message) -> bool:
        if isinstance(msg, MMonCommandAck):
            with self._ack_cv:
                self._acks[msg.tid] = (msg.retval, msg.out, msg.data)
                self._ack_cv.notify_all()
            return True
        if isinstance(msg, MOSDMapMsg):
            self._handle_osdmap(msg)
            return True
        if isinstance(msg, MMonMap):
            self.monmap = MonMap.decode(msg.monmap)
            if self._cur_mon is not None and \
                    self._cur_mon not in self.monmap.mons:
                # our session mon was removed from the map: fail over
                # before the next _target()/_hunt() would KeyError
                self._cur_mon = self.monmap.ranks()[0] \
                    if self.monmap.mons else None
            return True
        return False

    def _handle_osdmap(self, msg: MOSDMapMsg) -> None:
        before = self.osdmap.epoch
        if msg.full is not None:
            full = OSDMap.decode(msg.full)
            if full.epoch >= self.osdmap.epoch:
                # pools first learned from a FULL map are of unknown
                # age (boot catch-up, gap refetch): we did NOT watch
                # them come to life — a consumer instantiating their
                # pgs fresh must assume data may already exist
                # elsewhere (see pool_birth_witnessed)
                self.pool_births_witnessed.difference_update(
                    set(full.pools) - set(self.osdmap.pools))
                self.osdmap = full
        for blob in msg.incrementals:
            inc = denc.loads(blob)
            if not isinstance(inc, OSDMapIncremental):
                raise denc.DencError("not an OSDMapIncremental")
            if inc.epoch == self.osdmap.epoch + 1:
                if before > 0:
                    # born in front of us: an empty pg of this pool IS
                    # the complete initial copy.  `before` guards the
                    # bootstrap replay — a want-from-epoch-1 request
                    # answers with the WHOLE incremental history
                    # chained from zero, and replaying an old pool's
                    # creation is not witnessing it
                    self.pool_births_witnessed.update(inc.new_pools)
                for pid in inc.removed_pools:
                    self.pool_births_witnessed.discard(pid)
                self.osdmap.apply_incremental(inc)
        if msg.epoch > self.osdmap.epoch:
            # gap: a previous push was lost (lossy mon link) and these
            # incrementals don't chain onto our map — re-request the
            # missing range instead of silently freezing (the reference
            # OSDMap subscribe-from-epoch catch-up)
            self.sub_want_osdmap(self.osdmap.epoch + 1)
        if self.on_osdmap and self.osdmap.epoch != before:
            try:
                self.on_osdmap(self.osdmap)
            except Exception:
                self.log.error("osdmap callback failed")

    def ms_handle_reset(self, conn) -> None:
        self._hunt()
