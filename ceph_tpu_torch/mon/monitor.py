"""The monitor daemon (mon/Monitor.cc analog).

Owns the messenger, elector, paxos and services under one big lock
(the reference's Monitor::lock model).  Handles:
  * elections + paxos traffic between quorum peers;
  * client/daemon sessions: subscriptions (osdmap pushed on commit),
    admin commands (forwarded to the leader, answered after commit);
  * OSD lifecycle: boot, failure reports, pg_temp, down->out ticks.
"""

from __future__ import annotations

from ..utils import denc
import threading
import uuid
from typing import Callable

from ..msg import Dispatcher, Message, Policy, create_messenger
from ..utils.clock import SystemClock
from ..utils.config import Config
from ..utils.dout import DoutLogger
from .elector import Elector
from .messages import (MLogMsg, MMDSBeacon, MMgrBeacon, MMonCommand,
                       MMonCommandAck, MMonElection, MMonMap, MMonPaxos,
                       MMonSubscribe, MOSDBoot, MOSDFailure, MOSDMapMsg,
                       MPGStats, MPGTemp)
from .monmap import MonMap
from .paxos import Paxos
from .services import MonmapMonitor, OSDMonitor, PaxosService
from .store import MonitorDBStore


class Monitor(Dispatcher):
    def __init__(self, name: str, monmap: MonMap, conf: Config | None = None,
                 store_path: str = "", clock=None,
                 store: MonitorDBStore | None = None):
        self.name = name                       # short name, e.g. "a"
        self.entity = f"mon.{name}"
        # private copy: membership changes arrive through paxos
        # (adopt_monmap), never by another daemon mutating a shared map
        self.monmap = monmap.copy()
        self.conf = conf or Config()
        self.clock = clock or SystemClock()
        self.log = DoutLogger("mon", self.entity)
        self.lock = threading.RLock()

        # `store` lets a crash-restart cycle remount the SAME store a
        # killed mon left behind (vstart restart_mon)
        self.store = store if store is not None else \
            MonitorDBStore(store_path)
        self.store.open()
        self.store.owner = self.entity
        self.store.crash_callback = self._on_store_crash
        # torn-commit detection BEFORE paxos/services read the store:
        # a half-applied commit transaction must never be adopted —
        # the claim rolls back to the sealed floor and the quorum
        # re-shares the lost tail (Protocol-Aware Recovery)
        self.store.check_integrity()

        self.msgr = create_messenger(self.entity, conf=self.conf)
        self.msgr.bind(monmap.addr_of(name))
        self.msgr.set_policy("mon", Policy.lossless_peer())
        self.msgr.set_policy("osd", Policy.stateless_server())
        self.msgr.set_policy("client", Policy.stateless_server())
        self.msgr.add_dispatcher_tail(self)

        def _sched(delay, fn):
            def locked_fn():
                if self._stopped:
                    return    # timers may outlive the messenger
                with self.lock:
                    fn()
            return self.clock.timer(delay, locked_fn)

        self.elector = Elector(self.entity_name, self._mon_monmap(),
                               self._send_mon, self._won, self._lost,
                               schedule=_sched,
                               timeout=float(self.conf.mon_election_timeout)
                               / 5.0)
        self.paxos = Paxos(self.entity, self.store, self._send_mon,
                           self._on_commit,
                           lease_duration=float(self.conf.mon_lease),
                           clock=self.clock, schedule=_sched,
                           on_stall=self.elector.start,
                           phase_timeout=float(
                               self.conf.mon_lease_ack_timeout),
                           trim_max=int(self.conf.paxos_max_versions),
                           trim_keep=int(self.conf.paxos_trim_keep))
        self.paxos.on_active = self._on_paxos_active
        # sessions first: MonmapMonitor's constructor may adopt a
        # persisted monmap, which re-publishes to subscribers (and may
        # discover we were removed while down)
        self.subs: dict[str, dict] = {}
        self._pending_acks: list[tuple] = []
        self._proposing: list[PaxosService] = []
        self._removed = False

        self.services: dict[str, PaxosService] = {}
        self.osdmon = OSDMonitor(self)
        self.monmon = MonmapMonitor(self)
        from .auth_log import AuthMonitor, LogMonitor
        self.authmon = AuthMonitor(self)
        self.logmon = LogMonitor(self)
        self.services["osdmap"] = self.osdmon
        self.services["monmap"] = self.monmon
        self.services["authm"] = self.authmon
        self.services["logm"] = self.logmon

        self._tick_timer = None
        self._stopped = False
        self._boot_time = self.clock.now()
        self._ticks = 0

        # observability
        from ..utils.admin_socket import AdminSocket
        from ..utils.perf_counters import (PerfCountersBuilder,
                                           PerfCountersCollection)
        self.perf_collection = PerfCountersCollection()
        self.perf = (PerfCountersBuilder("mon")
                     .add_u64_counter("elections_won")
                     .add_u64_counter("elections_lost")
                     .add_u64_counter("commands")
                     .create_perf_counters())
        self.paxos.perf = (PerfCountersBuilder("paxos")
                           .add_u64_counter("collect")
                           .add_u64_counter("begin")
                           .add_u64_counter("commit")
                           .add_u64_counter("lease")
                           .create_perf_counters())
        self.perf_collection.add(self.perf)
        self.perf_collection.add(self.paxos.perf)
        self.perf_collection.add(self.msgr.perf)
        # op tracing: leader-handled commands become tracked ops whose
        # paxos.propose / paxos.commit spans (fed by self.paxos.tracer)
        # expose where a write spent its consensus time — same dump
        # surface as the OSD plane, so tools/trace_dump.py merges mon
        # consensus lanes into the one Chrome trace
        from ..utils.optracker import OpTracker
        self.op_tracker = OpTracker(
            self.clock,
            complaint_age=float(self.conf.osd_op_complaint_time),
            logger=self.log, daemon=self.entity)
        self._cmd_ops: list = []       # [trk, phase] holders in flight
        self.paxos.tracer = self._paxos_trace
        sock_dir = str(self.conf.admin_socket_dir)
        self.asok = AdminSocket(
            self.entity,
            path=f"{sock_dir}/{self.entity}.asok" if sock_dir else "")
        self.asok.register("perf dump", lambda c: self._perf_dump())
        self.asok.register("dump_ops_in_flight",
                           lambda c: self.op_tracker.dump_ops_in_flight())
        self.asok.register("dump_historic_ops",
                           lambda c: self.op_tracker.dump_historic_ops())
        self.asok.register(
            "dump_historic_slow_ops",
            lambda c: self.op_tracker.dump_historic_slow_ops())
        self.asok.register("config show", lambda c: self.conf.dump())
        self.asok.register("quorum_status", lambda c: {
            "leader": self.elector.leader,
            "quorum": list(self.elector.quorum),
            "election_epoch": self.elector.epoch})
        self.asok.register("status", lambda c: self._cmd_status()[1])
        # fault-injection surface (FaultSet install/clear/dump)
        from ..utils import faults
        faults.get().register_asok(self.asok)
        # flight recorder: mons contribute identity + quorum + crash
        # state + their tracked command ops (with paxos spans) to
        # every incident capture
        from ..utils import optracker
        optracker.recorder().register(self.entity, self._flight_dump)
        frd = str(getattr(self.conf, "flight_recorder_dir", "") or "")
        if frd:
            optracker.recorder().arm(
                frd, int(self.conf.flight_recorder_max))

    MON_CRASH_SITES = ["paxos.pre_commit", "paxos.mid_commit",
                       "paxos.post_accept_pre_ack"]

    def _flight_dump(self) -> dict:
        """Flight-recorder contribution: identity/quorum + crash
        state, plus the tracked command ops whose paxos.propose /
        paxos.commit spans date a consensus wedge."""
        d = self._perf_dump()
        return {"daemon": d["daemon"], "crash": d["crash"],
                "ops_in_flight": self.op_tracker.dump_ops_in_flight(),
                "historic_ops": self.op_tracker.dump_historic_ops()}

    def _perf_dump(self) -> dict:
        from ..utils import faults
        out = self.perf_collection.dump()
        # daemon info block (every reference daemon answers `status`
        # with identity/uptime facts; OSDs report the same schema)
        out["daemon"] = {
            "entity": self.entity,
            "role": "mon",
            "uptime": round(self.clock.now() - self._boot_time, 3),
            "ticks": self._ticks,
            "store_backend": type(self.store).__name__,
            "conf_epoch": self.conf.generation,
            "osdmap_epoch": self.osdmon.osdmap.epoch,
            "quorum": list(self.elector.quorum),
        }
        out["crash"] = {
            "crashed": int(bool(self.store.frozen)),
            "site": self.store.crash_site,
            "crash_rules": sum(1 for r in faults.get().rules()
                               if r.kind == "crash"),
            "sites": list(self.MON_CRASH_SITES),
            "paxos_torn_commit_repairs":
                self.store.counters["paxos_torn_commit_repairs"],
            "fsync_reorder_windows":
                self.store.counters["fsync_reorder_windows"],
        }
        return out

    # entity helpers -------------------------------------------------------

    @property
    def entity_name(self) -> str:
        return self.entity

    def _mon_monmap(self) -> MonMap:
        """MonMap keyed by entity names for the elector."""
        mm = MonMap(epoch=self.monmap.epoch, fsid=self.monmap.fsid)
        for n in self.monmap.ranks():
            mm.add(f"mon.{n}", self.monmap.addr_of(n))
        return mm

    def adopt_monmap(self, mm) -> None:
        """A newer monmap committed (MonmapMonitor): swap it in,
        rebuild the elector's roster, re-publish to subscribers, and —
        when the ROSTER actually changed — call a fresh election
        (Monitor::bootstrap on monmap change): a sitting leader must
        not keep committing under the old, smaller quorum rule, and a
        removed member must drop out.  Growing 1->2 therefore stalls
        the quorum until the new mon boots, exactly like the
        reference."""
        from .messages import MMonMap
        old_roster = set(self.monmap.ranks())
        self.monmap = mm
        self.elector.monmap = self._mon_monmap()
        self.log.info("adopted monmap e%d: %s", mm.epoch,
                      ",".join(mm.ranks()))
        for entity, sess in list(self.subs.items()):
            if "monmap" in sess["what"]:
                try:
                    self.msgr.send_message(MMonMap(monmap=mm.encode()),
                                           entity, sess["addr"])
                except Exception:
                    pass
        if self.name not in mm.mons:
            # we were removed: step down and stop participating — a
            # deposed leader must not keep acking commands while the
            # survivors elect a replacement (two-leader window), and
            # the elector cannot run with a roster that lacks us
            self.log.info("removed from monmap e%d: stepping down",
                          mm.epoch)
            self._removed = True
            self.elector.stop()       # cancels armed victory/restart
                                      # timers too — a mid-candidacy
                                      # removed mon must not win
            self.paxos.active = False
            return
        if set(mm.ranks()) != old_roster and self.msgr._loop is not None:
            # roster changed: force re-election (Monitor::bootstrap).
            # Skip during construction (messenger not started yet) —
            # Monitor.start() begins the election anyway.
            self.elector.start()

    def _send_mon(self, peer_entity: str, msg: Message) -> None:
        short = peer_entity.split(".", 1)[1]
        self.msgr.send_message(msg, peer_entity, self.monmap.addr_of(short))

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self.msgr.start()
        self.asok.start()
        with self.lock:
            self.elector.start()
        self._schedule_tick()

    def shutdown(self) -> None:
        self._stopped = True
        from ..utils import optracker
        optracker.recorder().unregister(self.entity)
        if self._tick_timer:
            self._tick_timer.cancel()
        self.asok.shutdown()
        self.msgr.shutdown()
        self.store.close()

    def abort(self) -> None:
        """kill -9 analog: freeze the store FIRST (no in-flight paxos
        txn lands another op, no clean teardown write happens), then
        tear the threads down — the store comes back exactly as the
        crash left it."""
        self.store.freeze()
        self.shutdown()

    def _on_store_crash(self, site: str) -> None:
        """A FaultSet crash rule fired inside our store (which is
        already frozen): simulated power loss.  Abort from a separate
        thread — the crashing paxos path is deep inside dispatch
        holding the monitor lock and must simply unwind via
        CrashPoint, never ack, never run the teardown itself."""
        if self._stopped:
            return
        self.log.warn("CRASH POINT %s fired: simulated power loss, "
                      "aborting", site)
        threading.Thread(target=self.abort, daemon=True,
                         name=f"{self.entity}-crash").start()

    def _schedule_tick(self) -> None:
        if self._stopped:
            return
        self._tick_timer = self.clock.timer(
            float(self.conf.mon_tick_interval), self._tick)

    def _tick(self) -> None:
        self._ticks += 1
        with self.lock:
            self.paxos.tick()
            if self.is_leader():
                self.osdmon.tick()
                self.paxos.maybe_trim()
            else:
                self._check_lease_timeout()
        self._schedule_tick()

    def _check_lease_timeout(self) -> None:
        """Peon leader-death detection (Paxos::lease_timeout ->
        bootstrap in the reference): a live leader renews leases every
        tick, so a lease a full mon_lease past its expiry means the
        leader is gone — call an election instead of sitting wedged
        forever forwarding commands to a dead address.  Without this,
        an abruptly killed leader (restart_mon, a paxos crash point)
        stalls the quorum until an operator intervenes."""
        p = self.paxos
        if (p.is_leader() or self.elector.electing or self._removed
                or self.monmap.size < 2):
            return
        if self.elector.leader is None or p.lease_expire <= 0:
            return
        overdue = self.clock.now() - p.lease_expire
        if overdue > float(self.conf.mon_lease):
            self.log.warn("leader %s lease expired %.1fs ago: "
                          "calling election", self.elector.leader,
                          overdue)
            p.lease_expire = 0.0     # one election per expiry window
            self.elector.start()

    # -- election ----------------------------------------------------------

    def is_leader(self) -> bool:
        return self.paxos.is_leader() and self.paxos.active

    def _won(self, epoch: int, quorum: list[str]) -> None:
        self.perf.inc("elections_won")
        rank = self.elector.rank
        self.paxos.leader_init(quorum, rank)

    def _lost(self, epoch: int, leader: str, quorum: list[str]) -> None:
        self.perf.inc("elections_lost")
        self.paxos.peon_init(leader, quorum, self.elector.rank)

    # -- paxos glue --------------------------------------------------------

    def propose_service(self, svc: PaxosService) -> None:
        """Collect the service's pending into a paxos value and propose."""
        if not self.paxos.is_writeable():
            # queue: re-proposed on activation; simplest correct behavior
            if svc not in self._proposing:
                self._proposing.append(svc)
            return
        ops: list = []
        svc.encode_pending(ops)
        svc.have_pending = False
        svc.pending = None
        self.paxos.propose(denc.dumps(ops))

    def _paxos_trace(self, event: str, version: int) -> None:
        """Paxos phase hook -> spans on tracked command ops.  Runs
        under self.lock (every paxos entry point holds it — a round
        begun during _execute_command fires this synchronously).
        paxos.propose covers the accept round (begin -> quorum
        accepted+applied); paxos.commit covers commit-visible ->
        client ack.  Commands batched into one proposal share the
        interval."""
        if event == "begin":
            for holder in self._cmd_ops:
                if holder[1] == "pending":
                    holder[0].span_begin("paxos.propose",
                                         version=version)
                    holder[1] = "propose"
        elif event == "commit":
            for holder in self._cmd_ops:
                if holder[1] == "propose":
                    holder[0].span_end("paxos.propose")
                    holder[0].span_begin("paxos.commit",
                                         version=version)
                    holder[1] = "commit"

    def _on_commit(self, version: int) -> None:
        for svc in self.services.values():
            svc.update_from_paxos()
        self._drain_proposing()
        if self.paxos.pending_value is None and \
                not self.paxos.proposals and not self._proposing:
            acks, self._pending_acks = self._pending_acks, []
            for origin, addr, tid, retval, out, data, holder in acks:
                if holder is not None:
                    trk, phase = holder
                    if phase == "commit":
                        trk.span_end("paxos.commit")
                    trk.mark_event("acked")
                    trk.finish()
                    if holder in self._cmd_ops:
                        self._cmd_ops.remove(holder)
                self._ack_to(origin, addr, tid, retval, out, data)

    def _drain_proposing(self) -> None:
        while self._proposing and self.paxos.is_writeable():
            svc = self._proposing.pop(0)
            if svc.have_pending:
                self.propose_service(svc)

    def _on_paxos_active(self) -> None:
        """The leader just became writeable: propose everything queued
        while it was recovering.  A service proposal accepted during
        the recovery window would otherwise sit in _proposing until
        the NEXT commit — and with no commit ever coming, an acked
        `mon add` could strand uncommitted forever (the
        grow-one-to-three membership race)."""
        self._drain_proposing()

    # -- publication -------------------------------------------------------

    def publish_osdmap(self) -> None:
        for entity, sess in list(self.subs.items()):
            want = sess["what"].get("osdmap")
            if want is None:
                continue
            self._send_osdmap_to(entity, sess["addr"], want)
            sess["what"]["osdmap"] = self.osdmon.osdmap.epoch + 1

    def _send_osdmap_to(self, entity: str, addr, since_epoch: int) -> None:
        cur = self.osdmon.osdmap
        if since_epoch > cur.epoch:
            return          # subscriber is current: renewal sends nothing
        if since_epoch <= 0:
            incs: list[bytes] = []
        else:
            incs = self.osdmon.get_incrementals(since_epoch - 1)
        if since_epoch <= 0 or (incs and len(incs) !=
                                cur.epoch - since_epoch + 1):
            msg = MOSDMapMsg(full=cur.encode(), incrementals=[],
                             epoch=cur.epoch)
        else:
            msg = MOSDMapMsg(full=None if incs else cur.encode(),
                             incrementals=incs, epoch=cur.epoch)
        self.msgr.send_message(msg, entity, addr)

    # -- dispatch ----------------------------------------------------------

    def ms_dispatch(self, conn, msg: Message) -> bool:
        with self.lock:
            return self._dispatch_locked(conn, msg)

    def _dispatch_locked(self, conn, msg: Message) -> bool:
        if self._removed:
            return True          # deposed: drop everything
        if isinstance(msg, MMonElection):
            self.elector.handle(msg)
            return True
        if isinstance(msg, MMonPaxos):
            self.paxos.handle(msg)
            return True
        if isinstance(msg, MMonSubscribe):
            self._handle_subscribe(conn, msg)
            return True
        if isinstance(msg, MMonCommand):
            self.perf.inc("commands")
            self._handle_command(conn, msg)
            return True
        if isinstance(msg, (MOSDBoot, MOSDFailure, MPGTemp, MMgrBeacon,
                            MMDSBeacon, MPGStats, MLogMsg)):
            # OSDMap mutations only mean anything on the leader; a peon
            # relays them (Monitor::forward_request_leader model).  The
            # session note stays local: the booting OSD subscribed to
            # *this* mon, and peons publish maps on commit too.
            if isinstance(msg, MOSDBoot) and \
                    not conn.peer_name.startswith("mon."):
                self._note_session(conn, {"osdmap": 0})
            if not self.is_leader():
                leader = self.elector.leader
                if leader is not None and leader != self.entity:
                    if isinstance(msg, MOSDFailure):
                        # src is re-stamped in transit; keep the reporter
                        msg.reporter = getattr(msg, "reporter", msg.src)
                    self._send_mon(leader, msg)
                return True
            if isinstance(msg, MOSDBoot):
                self.osdmon.handle_boot(msg.osd_id, msg.addr,
                                        getattr(msg, "heartbeat_addr", None))
            elif isinstance(msg, MOSDFailure):
                self.osdmon.handle_failure(
                    msg.target_osd, getattr(msg, "reporter", msg.src))
            elif isinstance(msg, MMgrBeacon):
                self.osdmon.handle_mgr_beacon(msg.name, msg.addr)
            elif isinstance(msg, MMDSBeacon):
                self.osdmon.handle_mds_beacon(
                    msg.name, msg.addr, getattr(msg, "rank", 0))
            elif isinstance(msg, MPGStats):
                self.osdmon.handle_pg_stats(msg.osd_id, msg.stats,
                                            getattr(msg, "epoch", 0),
                                            getattr(msg, "flags", None))
            elif isinstance(msg, MLogMsg):
                self.logmon.handle_log(msg)
            else:
                self.osdmon.handle_pg_temp(msg.osd_id, msg.pg_temp)
            return True
        return False

    def _note_session(self, conn, what: dict) -> None:
        sess = self.subs.setdefault(
            conn.peer_name, {"addr": conn.peer_addr, "what": {}})
        sess["addr"] = conn.peer_addr
        for k, v in what.items():
            sess["what"].setdefault(k, v)

    def _handle_subscribe(self, conn, msg: MMonSubscribe) -> None:
        sess = self.subs.setdefault(
            conn.peer_name, {"addr": conn.peer_addr, "what": {}})
        sess["addr"] = conn.peer_addr
        for name, start in msg.what.items():
            sess["what"][name] = start
            if name == "osdmap":
                self._send_osdmap_to(conn.peer_name, conn.peer_addr, start)
                sess["what"]["osdmap"] = self.osdmon.osdmap.epoch + 1
            elif name == "monmap":
                # epoch-gated like osdmap: a renewal claiming the
                # current epoch+1 costs nothing; a change pushes
                if self.monmap.epoch >= (start or 0):
                    self.msgr.send_message(
                        MMonMap(monmap=self.monmap.encode()),
                        conn.peer_name, conn.peer_addr)

    # -- commands ----------------------------------------------------------

    def _handle_command(self, conn, msg: MMonCommand) -> None:
        if not self.paxos.is_leader():
            leader = self.elector.leader
            if leader is None:
                self._ack(conn, msg.tid, -11, "no quorum", b"")
                return
            # forward to leader, remember where to send the reply.
            # fwd_origin is REAL wire data (the leader routes its ack
            # by it) — underscore-prefixed fields never leave the
            # process (Message.encode_iov skips them: they hold live
            # local objects like TrackedOp handles)
            fwd = MMonCommand(tid=msg.tid, cmd=msg.cmd,
                              fwd_origin=conn.peer_name,
                              fwd_origin_addr=conn.peer_addr)
            self._send_mon(leader, fwd)
            return
        origin = getattr(msg, "fwd_origin", None) or conn.peer_name
        origin_addr = getattr(msg, "fwd_origin_addr", None) \
            or conn.peer_addr
        in_flight_before = (self.paxos.pending_value is not None
                            or bool(self.paxos.proposals)
                            or bool(self._proposing))
        cmd = dict(msg.cmd)
        # the AUTHENTICATED peer identity, for commands that gate on
        # who is asking (rotating-key fetches); never client-supplied
        cmd["_requester"] = origin
        trk = self.op_tracker.create(
            f"mon_command {cmd.get('prefix', '?')} from {origin}",
            kind="command")
        # register BEFORE executing: a write command's paxos round can
        # begin synchronously inside _execute_command, and the tracer
        # hook must find this op to open its paxos.propose span
        holder = [trk, "pending"]
        self._cmd_ops.append(holder)
        trk.span_begin("execute")
        result = self._execute_command(cmd)
        trk.span_end("execute")
        if result is None:
            self._cmd_ops.remove(holder)
            trk.finish()
            self._ack_to(origin, origin_addr, msg.tid, -22,
                         f"unknown command {msg.cmd.get('prefix')!r}", b"")
            return
        retval, out, data = result
        # a proposal QUEUED for a recovering leader (self._proposing)
        # is a write too: acking it before the eventual commit would
        # let the client observe an ack whose effect can still vanish
        wrote = (self.paxos.pending_value is not None
                 or bool(self.paxos.proposals)
                 or bool(self._proposing) or in_flight_before)
        if wrote and retval == 0:
            # ack only after the commit lands so a follow-up read
            # observes the new state (wait_for_commit semantics); the
            # tracked op rides along, the paxos tracer hook stamping
            # its paxos.propose / paxos.commit spans as rounds pass
            self._pending_acks.append(
                (origin, origin_addr, msg.tid, retval, out, data,
                 holder))
        else:
            self._cmd_ops.remove(holder)
            trk.finish()
            self._ack_to(origin, origin_addr, msg.tid, retval, out, data)

    def _execute_command(self, cmd: dict):
        if cmd.get("prefix") == "status":
            return self._cmd_status()
        for svc in self.services.values():
            result = svc.dispatch_command(cmd)
            if result is not None:
                return result
        return None

    def _cmd_status(self):
        """`ceph -s` analog: health + mon/osd/pg summaries."""
        m = self.osdmon.osdmap
        up = sum(1 for o in m.osds.values() if o.up)
        inn = sum(1 for o in m.osds.values() if o.in_cluster)
        status, warns = self.osdmon.health()
        lines = [f"health: {status}"]
        lines += [f"  {w}" for w in warns]
        lines += [
            f"mon: {self.monmap.size} mons, quorum "
            f"{self.elector.quorum}",
            f"osd: {len(m.osds)} osds: {up} up, {inn} in; epoch "
            f"{m.epoch}",
            f"pools: {len(m.pools)}",
        ]
        summary = self.osdmon.pg_summary()
        if summary:
            pgs = ", ".join(f"{n} {state}" for state, n
                            in sorted(summary.items()))
            lines.append(f"pgs: {sum(summary.values())} total: {pgs}")
        return 0, "\n".join(lines), b""

    def _ack(self, conn, tid, retval, out, data) -> None:
        self._ack_to(conn.peer_name, conn.peer_addr, tid, retval, out, data)

    def _ack_to(self, entity, addr, tid, retval, out, data=b"") -> None:
        self.msgr.send_message(
            MMonCommandAck(tid=tid, retval=retval, out=out, data=data),
            entity, addr)

    def ms_handle_reset(self, conn) -> None:
        self.subs.pop(conn.peer_name, None)


def make_fsid() -> str:
    return str(uuid.uuid4())
