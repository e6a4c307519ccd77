"""MiniCluster: the vstart.sh / ceph-helpers.sh analog.

Launches a real cluster (N monitors + M OSDs, real messengers on
localhost ports) inside one process — the reference's tier-3 test
pattern (qa/workunits/ceph-helpers.sh run_mon/run_osd) — and hands back
connected Rados clients.  On demand it also starts mgrs (``start_mgr``),
CephFS metadata servers (``start_mds``) and S3/Swift gateways
(``start_rgw``).

The OSDs' EC work runs on the package device: ``cuda`` (the CUDA
kernels, one pipeline lane per card) unless the caller asked for the
CPU with ``ceph_tpu_torch.set_device("cpu")`` first.  With the default
device and no card, the first OSD's start raises.  An MDS or a gateway
does no device work of its own: the EC work its clients cause runs on
the OSDs.
"""

from __future__ import annotations

import socket
import time

from .client import Rados
from .mon import MonMap, Monitor
from .mon.monitor import make_fsid
from .osd.daemon import OSDDaemon
from .utils.clock import ManualClock
from .utils.config import Config


def free_addrs(n: int) -> list[tuple]:
    socks, addrs = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        addrs.append(("127.0.0.1", s.getsockname()[1]))
    for s in socks:
        s.close()
    return addrs


class MiniCluster:
    def __init__(self, num_mons: int = 3, num_osds: int = 3,
                 conf: Config | None = None, store_kind: str = "memstore",
                 store_dir: str = "", clock=None):
        # All daemons share one ManualClock: heartbeat grace, lease
        # expiry and down->out aging advance via the slow background
        # autotick plus explicit tick()/wait_for_* calls — a GIL stall
        # (e.g. a first-use kernel build) pauses the ticker with
        # everyone else, so it cannot read as "peer dead past grace".
        self.clock = clock or ManualClock()
        # grace is virtual seconds; _wait advances ~0.25 virtual per
        # ~0.02s real, so 8.0 virtual tolerates ~0.6s of real-world
        # messenger-thread stall before a ping reply counts as silence
        self.conf = conf or Config({
            "mon_tick_interval": 0.5,
            "osd_heartbeat_interval": 0.5,
            "osd_heartbeat_grace": 8.0,
            "mon_osd_min_down_reporters": 2,
            "mon_osd_down_out_interval": 5.0,
        })
        self.monmap = MonMap(fsid=make_fsid())
        for i, addr in enumerate(free_addrs(num_mons)):
            self.monmap.add(chr(ord("a") + i), addr)
        self.mons: list[Monitor] = []
        self._dead_mon_stores: dict[str, object] = {}
        self.osds: dict[int, OSDDaemon] = {}
        self.mgrs: list = []
        self.mdss: list = []
        self.rgws: list = []
        self.num_osds = num_osds
        self.store_kind = store_kind
        self.store_dir = store_dir
        self._clients: list[Rados] = []
        self._stopping = False
        self._ticker = None

    # -- lifecycle ---------------------------------------------------------

    def _mon_store_path(self, name: str) -> str:
        if not self.store_dir:
            return ""
        import os
        os.makedirs(self.store_dir, exist_ok=True)
        return f"{self.store_dir}/mon-{name}.db"

    def start(self, timeout: float = 30.0) -> "MiniCluster":
        for name in self.monmap.ranks():
            mon = Monitor(name, self.monmap, conf=self.conf,
                          store_path=self._mon_store_path(name),
                          clock=self.clock)
            self.mons.append(mon)
            mon.start()
        self.wait_for_leader(timeout)
        for i in range(self.num_osds):
            self.start_osd(i)
        self.wait_for_osds(self.num_osds, timeout)
        self._start_autotick()
        return self

    def _start_autotick(self) -> None:
        """Advance virtual time ~1:1 with real time in the background.

        Without this, a test blocked in a real-time client op cannot
        tick, so any recovery that needs a virtual-time timeout
        (peering RPC, paxos watchdog, heartbeat) freezes with it.
        Because the ticker is itself a Python thread, a GIL stall (the
        original flake source) pauses virtual time together with the
        daemons — a stall still cannot read as a dead peer.  Virtual
        time runs HALF speed (0.25 virtual per 0.5s real) so grace
        windows span twice their nominal seconds of GIL-releasing
        stall (sqlite fsync, an nvcc build) before tripping.
        """
        if not isinstance(self.clock, ManualClock):
            return
        import threading

        def ticker():
            while not self._stopping:
                time.sleep(0.5)
                if not self._stopping:
                    self.clock.advance(0.25)

        self._stopping = False
        t = threading.Thread(target=ticker, daemon=True,
                             name="minicluster-autotick")
        self._ticker = t
        t.start()

    def start_mgr(self, name: str = "x"):
        from .mgr import MgrDaemon
        mgr = MgrDaemon(name, self.monmap, conf=self.conf,
                        clock=self.clock)
        self.mgrs.append(mgr)
        mgr.start()
        return mgr

    def start_mds(self, name: str = "a", metadata_pool: str =
                  "cephfs_metadata", data_pool: str = "cephfs_data",
                  rank: int = 0):
        from .fs.mds import MDSDaemon
        mds = MDSDaemon(name, self.monmap, conf=self.conf,
                        metadata_pool=metadata_pool,
                        data_pool=data_pool, clock=self.clock,
                        rank=rank)
        self.mdss.append(mds)
        mds.start()
        return mds

    def start_rgw(self, port: int = 0, access_key: str = "",
                  secret_key: str = "", data_pool: str | None = None):
        from .rgw import DATA_POOL, RGWDaemon
        # the gateway's objecter must never ABANDON an in-flight op: a
        # rados op that hits objecter_op_timeout client-side can still
        # sit queued at an OSD behind peering and apply later — after
        # the gateway has 5xx'd and the front-door client has retried
        # with a NEWER mutation, the zombie resurrects the old state
        # (observed as a stale read / tombstone resurrection under the
        # storm drills).  Real radosgw runs with no objecter op
        # timeout and surfaces stalls as slow requests; mirror that
        # with a per-gateway conf overlay so test-tightened cluster
        # timeouts (MDS starvation workarounds) don't leak in
        gconf = Config(dict(self.conf._values))
        gconf.set_val("objecter_op_timeout", 86400.0)
        gconf.apply_changes()
        cli = Rados(self.monmap, f"client.rgw{len(self.rgws)}",
                    conf=gconf)
        cli.connect()
        self._clients.append(cli)
        # a distinct data_pool per gateway makes each one a ZONE:
        # disjoint object namespaces on one cluster, replicated only
        # by the multisite sync agent (rgw/sync.py)
        rgw = RGWDaemon(cli, port=port, access_key=access_key,
                        secret_key=secret_key,
                        data_pool=data_pool or DATA_POOL)
        self.rgws.append(rgw)
        rgw.start()
        return rgw

    def start_osd(self, osd_id: int) -> OSDDaemon:
        path = (f"{self.store_dir}/osd{osd_id}" if self.store_dir else "")
        osd = OSDDaemon(osd_id, self.monmap, conf=self.conf,
                        store_kind=self.store_kind, store_path=path,
                        clock=self.clock)
        self.osds[osd_id] = osd
        osd.start()
        return osd

    def kill_osd(self, osd_id: int) -> None:
        """kill_daemon analog: abrupt stop, no goodbye, no final
        checkpoint — the store comes back exactly as the crash left
        it (osd.abort freezes it before teardown)."""
        osd = self.osds.pop(osd_id, None)
        if osd:
            osd.abort()

    def restart_osd(self, osd_id: int, timeout: float = 60.0,
                    wait_clean: bool = True) -> OSDDaemon:
        """Crash-restart cycle: abrupt kill (or pick up a daemon that
        already crashed itself on a FaultSet crash rule), remount the
        SAME store path — journal replay, snapshot fallback, pg log
        reload all run here — then wait for the mon map to show the
        reborn daemon (new address) and, by default, for every pg to
        re-peer back to active+clean.  Shared by tests and chaos
        scenarios."""
        self.kill_osd(osd_id)
        osd = self.start_osd(osd_id)

        def rejoined() -> bool:
            mon = self._leader_or_none()
            if mon is None:
                return False
            m = mon.osdmon.osdmap
            addr = m.get_addr(osd_id)
            return m.is_up(osd_id) and addr is not None and \
                tuple(addr) == tuple(osd.msgr.addr)

        self._wait(rejoined, timeout, f"osd.{osd_id} did not rejoin")
        if wait_clean:
            self.wait_for_clean(timeout)
        return osd

    def mon(self, name: str) -> Monitor:
        return next(m for m in self.mons if m.name == name)

    def kill_mon(self, name: str) -> Monitor:
        """kill -9 a monitor: abrupt abort, no goodbye — the mon store
        stays exactly as the crash left it.  Also picks up a mon that
        already crashed itself on a FaultSet paxos crash rule."""
        mon = self.mon(name)
        self.mons.remove(mon)
        self._dead_mon_stores[name] = mon.store
        mon.abort()
        return mon

    def restart_mon(self, name: str, timeout: float = 60.0) -> Monitor:
        """Mon crash-restart cycle: abrupt kill, remount the SAME
        store (torn-commit detection + quorum repair run at mount),
        rejoin the quorum.  The reborn mon keeps its monmap address."""
        from .mon.store import MonitorDBStore
        if any(m.name == name for m in self.mons):
            self.kill_mon(name)
        old_store = self._dead_mon_stores.pop(name, None)
        path = self._mon_store_path(name)
        store = MonitorDBStore(path)
        if not path and old_store is not None:
            # in-memory store: the reborn mon remounts the killed
            # mon's surviving KV "disk" through a fresh (unfrozen)
            # MonitorDBStore wrapper
            store.db = old_store.db
        seed = self._leader_or_none()
        monmap = seed.monmap.copy() if seed is not None else self.monmap
        mon = Monitor(name, monmap, conf=self.conf, clock=self.clock,
                      store=store)
        self.mons.append(mon)
        mon.start()

        def rejoined() -> bool:
            leader = self._leader_or_none()
            return leader is not None and \
                mon.entity in leader.elector.quorum

        self._wait(rejoined, timeout,
                   f"mon.{name} did not rejoin the quorum")
        return mon

    def mark_osd_down(self, osd_id: int) -> None:
        client = self.client()
        client.mon_command({"prefix": "osd down", "id": osd_id})

    def mark_osd_out(self, osd_id: int) -> None:
        client = self.client()
        client.mon_command({"prefix": "osd out", "id": osd_id})

    def stop(self) -> None:
        self._stopping = True
        # gateways first: they serve HTTP through these rados clients
        for rgw in self.rgws:
            rgw.shutdown()
        for c in self._clients:
            c.shutdown()
        for mds in self.mdss:
            mds.shutdown()
        for mgr in self.mgrs:
            mgr.shutdown()
        for osd in self.osds.values():
            osd.shutdown()
        for mon in self.mons:
            mon.shutdown()

    # -- waiting helpers (ceph-helpers.sh wait_for_*) ----------------------

    def tick(self, dt: float = 0.5) -> None:
        """Advance cluster (virtual) time; real time for a SystemClock."""
        if isinstance(self.clock, ManualClock):
            self.clock.advance(dt)
            time.sleep(0.02)      # let messenger threads deliver
        else:
            time.sleep(dt)

    def _wait(self, pred, timeout: float, what: str) -> None:
        """Poll pred while advancing cluster time (real-time bounded)."""
        end = time.time() + timeout
        while time.time() < end:
            if pred():
                return
            self.tick(0.25)
        raise TimeoutError(what)

    def wait_for_leader(self, timeout: float = 30.0) -> None:
        self._wait(lambda: any(m.is_leader() for m in self.mons),
                   timeout, "no mon leader")

    def leader(self) -> Monitor:
        return next(m for m in self.mons if m.is_leader())

    def _leader_or_none(self) -> Monitor | None:
        """Elections restart when a round goes stale; a brief no-leader
        window is normal, so polling predicates must tolerate it."""
        return next((m for m in self.mons if m.is_leader()), None)

    def wait_for_osds(self, n: int, timeout: float = 30.0) -> None:
        def up() -> bool:
            mon = self._leader_or_none()
            if mon is None:
                return False
            osdmap = mon.osdmon.osdmap
            return sum(1 for o in osdmap.osds.values() if o.up) >= n
        self._wait(up, timeout, f"fewer than {n} osds up")

    def wait_for_osd_down(self, osd_id: int, timeout: float = 30.0) -> None:
        def down() -> bool:
            mon = self._leader_or_none()
            return mon is not None and not mon.osdmon.osdmap.is_up(osd_id)
        self._wait(down, timeout, f"osd.{osd_id} still up")

    def wait_for_clean(self, timeout: float = 30.0) -> None:
        """All PGs of all pools active+clean: full acting sets in the
        map AND — for daemons this cluster holds in-process — every
        copy recovered.  The mapping alone is NOT clean: right after a
        crash-restart the map looks whole while the reborn daemon is
        still catching up / being backfilled, and a verify racing that
        window reads from an incomplete primary."""
        def clean() -> bool:
            mon = self._leader_or_none()
            if mon is None:
                return False
            osdmap = mon.osdmon.osdmap
            for pgid in osdmap.all_pgs():
                pool = osdmap.pools[pgid.pool]
                up, acting = osdmap.pg_to_up_acting_osds(pgid)
                live = [o for o in acting if o >= 0]
                if len(live) < pool.size:
                    return False
                primary = live[0]
                for osd_id in live:
                    osd = self.osds.get(osd_id)
                    if osd is None:
                        return False
                    pg = osd.pgs.get(pgid)
                    if pg is None or not pg.backfill_complete:
                        return False
                    if pg.pglog.missing:
                        # the log CLAIMS versions whose data has not
                        # landed (catch-up/rewind pulls in flight): a
                        # "clean" report here let a verify read race
                        # the pull — the exact transient behind the
                        # historical "deg: ACKED write lost" flake
                        # (reads now also block on the pull; this
                        # keeps the clean predicate honest too)
                        return False
                    # (an EC primary's role audit pending: some member
                    # may still lack an object's shard at its role)
                    if osd_id == primary and (
                            not pg.active or pg.ec_audit_pending or
                            getattr(pg, "_catchup_pending", None)):
                        return False
            # no recovery machinery still in flight anywhere
            for osd in self.osds.values():
                if getattr(osd, "_backfills_active", None):
                    return False
            return True
        self._wait(clean, timeout, "cluster not clean")

    # -- clients -----------------------------------------------------------

    def client(self, name: str | None = None) -> Rados:
        if name is None and self._clients:
            return self._clients[0]
        r = Rados(self.monmap,
                  name or f"client.c{len(self._clients)}", conf=self.conf)
        r.connect()
        self._clients.append(r)
        return r
