"""PaxosService framework + OSDMonitor (mon/PaxosService.h, OSDMonitor.cc).

Each service keeps versioned state in the shared MonitorDBStore under
its own prefix and folds its pending changes into the single Paxos
value when the monitor proposes.  OSDMonitor manages the OSDMap:
boot/failure/out transitions, pool + EC-profile commands (validated by
instantiating the erasure plugin, OSDMonitor.cc:6291 semantics), map
publication to subscribers.
"""

from __future__ import annotations

from ..utils import denc
from typing import TYPE_CHECKING

from ..erasure.interface import ErasureCodeError
from ..erasure.registry import registry as ec_registry
from ..osd.osdmap import (ERASURE, REPLICATED, OSDMap, OSDMapIncremental,
                          PgId, Pool)
from ..utils.dout import DoutLogger

if TYPE_CHECKING:
    from .monitor import Monitor


class PaxosService:
    name = "base"

    def __init__(self, mon: "Monitor"):
        self.mon = mon
        self.log = DoutLogger(self.name, mon.name)
        self.have_pending = False

    @property
    def version(self) -> int:
        return self.mon.store.get_int(self.name, "last_committed")

    def update_from_paxos(self) -> None:
        """Replay any committed versions we have not absorbed yet."""
        raise NotImplementedError

    def create_pending(self) -> None:
        raise NotImplementedError

    def encode_pending(self, txn_ops: list) -> None:
        """Append ('set', prefix, key, blob) KV ops for the pending state."""
        raise NotImplementedError

    def propose_pending(self) -> None:
        self.mon.propose_service(self)

    def dispatch_command(self, cmd: dict) -> tuple[int, str, bytes] | None:
        """(retval, out_text, out_data) or None if not ours / deferred."""
        return None


class OSDMonitor(PaxosService):
    name = "osdmap"

    def __init__(self, mon: "Monitor"):
        super().__init__(mon)
        self.osdmap = OSDMap()
        self.pending: OSDMapIncremental | None = None
        self._last_proposed_epoch = 0
        # failure_reports[target] = {reporter: first_report_time}
        self.failure_reports: dict[int, dict[str, float]] = {}
        self.down_at: dict[int, float] = {}
        # PGMap-lite (mon/PGMonitor.cc): pgid -> latest primary-
        # reported stat dict; leader-local, repopulated within one
        # osd stats interval after an election
        self.pg_stats: dict[str, dict] = {}
        # per-osd health flags riding the stats reports (e.g. a
        # device-degraded EC codec); leader-local like pg_stats
        self.osd_health_flags: dict[int, dict] = {}
        # rank -> last MDS beacon time; ranks silent past
        # mds_beacon_grace are dropped from the map so clients stop
        # routing to dead addresses (FSMap failed-rank analog)
        self.mds_last_beacon: dict[int, float] = {}
        self._replay()

    # -- state machinery ---------------------------------------------------

    def _replay(self) -> None:
        v = self.version
        while self.osdmap.epoch < v:
            blob = self.mon.store.get_version(self.name, self.osdmap.epoch + 1)
            if blob is None:
                break
            self.osdmap.apply_incremental(denc.loads(blob))

    def update_from_paxos(self) -> None:
        before = self.osdmap.epoch
        self._replay()
        if self.osdmap.epoch != before:
            self.have_pending = False
            self.pending = None
            self.mon.publish_osdmap()

    def create_pending(self) -> None:
        # a prior pending inc may still be in flight through paxos;
        # epochs must stay strictly increasing across proposals
        epoch = max(self.osdmap.epoch, self._last_proposed_epoch) + 1
        self.pending = OSDMapIncremental(epoch=epoch)
        self.have_pending = True

    def _pending(self) -> OSDMapIncremental:
        if not self.have_pending or self.pending is None:
            self.create_pending()
        return self.pending

    def encode_pending(self, txn_ops: list) -> None:
        inc = self.pending
        blob = denc.dumps(inc)
        vkey = f"{inc.epoch:020d}"
        txn_ops.append(("set", self.name, vkey, blob))
        txn_ops.append(("set", self.name, "last_committed",
                        str(inc.epoch).encode()))
        self._last_proposed_epoch = inc.epoch

    def get_incrementals(self, since: int) -> list[bytes]:
        out = []
        for v in range(since + 1, self.osdmap.epoch + 1):
            blob = self.mon.store.get_version(self.name, v)
            if blob is not None:
                out.append(blob)
        return out

    # -- osd lifecycle -----------------------------------------------------

    def handle_boot(self, osd_id: int, addr, hb_addr=None) -> None:
        if self.osdmap.is_up(osd_id) and \
                self.osdmap.get_addr(osd_id) == tuple(addr):
            return
        inc = self._pending()
        inc.new_up[osd_id] = tuple(addr)
        self.failure_reports.pop(osd_id, None)
        self.down_at.pop(osd_id, None)
        self.log.info("osd.%d booting at %s", osd_id, addr)
        self._cluster_log("INF", f"osd.{osd_id} boot")
        self.propose_pending()

    def _cluster_log(self, level: str, text: str) -> None:
        logmon = getattr(self.mon, "logmon", None)
        if logmon is not None:
            logmon.log_entry("mon", level, text)

    def handle_failure(self, target: int, reporter: str) -> None:
        if not self.osdmap.is_up(target):
            return
        reports = self.failure_reports.setdefault(target, {})
        reports[reporter] = self.mon.clock.now()
        need = int(self.mon.conf.mon_osd_min_down_reporters)
        if len(reports) >= need:
            inc = self._pending()
            if target not in inc.new_down:
                inc.new_down.append(target)
                self.down_at[target] = self.mon.clock.now()
                self.log.info("marking osd.%d down (%d reporters)",
                              target, len(reports))
                self._cluster_log(
                    "WRN", f"osd.{target} marked down "
                           f"({len(reports)} reporters)")
                self.failure_reports.pop(target, None)
                self.propose_pending()

    def handle_mgr_beacon(self, name: str, addr) -> None:
        """Active-mgr registration (MgrMonitor folded into the osdmap:
        the beacon publishes where daemons should send MMgrReport)."""
        if self.osdmap.mgr_name == name and \
                self.osdmap.mgr_addr == tuple(addr):
            return
        inc = self._pending()
        inc.new_mgr = (name, tuple(addr))
        self.log.info("mgr %s active at %s", name, addr)
        self.propose_pending()

    def handle_mds_beacon(self, name: str, addr, rank: int = 0) -> None:
        """Active-mds registration (FSMap folded into the osdmap);
        each rank registers independently (multi-rank FSMap)."""
        # record liveness even when the map already has this rank —
        # the early return below must not starve the beacon clock
        self.mds_last_beacon[rank] = self.mon.clock.now()
        if self.osdmap.mds_ranks.get(rank) == (name, tuple(addr)):
            return
        inc = self._pending()
        inc.new_mds_ranks = dict(inc.new_mds_ranks)
        inc.new_mds_ranks[rank] = (name, tuple(addr))
        if rank == 0:
            inc.new_mds = (name, tuple(addr))
        self.log.info("mds %s rank %d active at %s", name, rank, addr)
        self.propose_pending()

    def handle_pg_temp(self, osd_id: int, pg_temp: dict) -> None:
        inc = self._pending()
        changed = False
        for pgid_str, osds in pg_temp.items():
            pgid = PgId.parse(pgid_str)
            cur = self.osdmap.pg_temp.get(pgid, [])
            if list(osds) != cur:
                inc.new_pg_temp[pgid] = list(osds)
                changed = True
        if changed:
            self.propose_pending()

    def _prune_stale_mds_ranks(self, now: float) -> None:
        """Drop mds_ranks entries whose daemon stopped beaconing: a
        dead rank left in the map keeps routing that subtree's client
        ops to a dead address until an operator intervenes (the
        reference FSMap marks such ranks failed)."""
        grace = float(self.mon.conf.mds_beacon_grace)
        if grace <= 0:
            return
        changed = False
        for rank in list(self.osdmap.mds_ranks):
            # seed on first sight so a fresh leader (empty beacon
            # clock) never insta-prunes a live rank
            last = self.mds_last_beacon.setdefault(rank, now)
            if now - last <= grace:
                continue
            inc = self._pending()
            if rank in inc.new_mds_ranks and \
                    inc.new_mds_ranks[rank] is None:
                continue            # prune already pending
            inc.new_mds_ranks = dict(inc.new_mds_ranks)
            inc.new_mds_ranks[rank] = None
            self.mds_last_beacon.pop(rank, None)
            changed = True
            self.log.warn("mds rank %d silent for %.0fs, removing "
                          "from map", rank, now - last)
            self._cluster_log(
                "WRN", f"mds rank {rank} silent past beacon grace; "
                       f"removed from map")
        if changed:
            self.propose_pending()

    def tick(self) -> None:
        """Auto-out for long-down OSDs + stale-MDS pruning."""
        self._prune_stale_mds_ranks(self.mon.clock.now())
        interval = float(self.mon.conf.mon_osd_down_out_interval)
        if interval <= 0:
            return
        now = self.mon.clock.now()
        changed = False
        for osd, t in list(self.down_at.items()):
            if (now - t > interval and self.osdmap.is_in(osd)
                    and not self.osdmap.is_up(osd)):
                inc = self._pending()
                if osd not in inc.new_out:
                    inc.new_out.append(osd)
                    changed = True
                    self.down_at.pop(osd)
                    self.log.info("marking osd.%d out after %ds down",
                                  osd, int(now - t))
                    self._cluster_log(
                        "WRN", f"osd.{osd} marked out after "
                               f"{int(now - t)}s down")
        if changed:
            self.propose_pending()

    # -- commands ----------------------------------------------------------

    def dispatch_command(self, cmd: dict):
        prefix = cmd.get("prefix", "")
        if prefix == "osd pool create":
            return self._cmd_pool_create(cmd)
        if prefix == "osd pool rm":
            return self._cmd_pool_rm(cmd)
        if prefix == "osd pool ls":
            names = [p.name for p in self.osdmap.pools.values()]
            return 0, "\n".join(names), b""
        if prefix == "osd erasure-code-profile set":
            return self._cmd_ec_profile_set(cmd)
        if prefix == "osd erasure-code-profile get":
            name = cmd.get("name", "")
            prof = self.osdmap.ec_profiles.get(name)
            if prof is None:
                return -2, f"no such profile {name}", b""
            text = "\n".join(f"{k}={v}" for k, v in sorted(prof.items()))
            return 0, text, b""
        if prefix == "osd erasure-code-profile ls":
            return 0, "\n".join(sorted(self.osdmap.ec_profiles)), b""
        if prefix == "osd erasure-code-profile rm":
            return self._cmd_ec_profile_rm(cmd)
        if prefix == "osd dump":
            return 0, self._dump_text(), self.osdmap.encode()
        if prefix == "osd getmap":
            return 0, "", self.osdmap.encode()
        if prefix == "osd tree":
            return 0, self._tree_text(), b""
        if prefix == "osd pool selfmanaged-snap create":
            return self._cmd_snap_create(cmd)
        if prefix == "osd pool selfmanaged-snap rm":
            return self._cmd_snap_rm(cmd)
        if prefix in ("osd down", "osd out", "osd in"):
            return self._cmd_osd_state(prefix, cmd)
        if prefix.startswith("osd tier "):
            return self._cmd_tier(prefix, cmd)
        if prefix == "osd pool set":
            return self._cmd_pool_set(cmd)
        if prefix == "osd rm-pg-temp":
            # a primary finished backfilling the CRUSH targets of a
            # temp-pinned pg: release the pin (empty list = removal)
            from ..osd.osdmap import PgId
            try:
                pgid = PgId.parse(cmd.get("pgid", ""))
            except Exception:
                return -22, f"bad pgid {cmd.get('pgid')!r}", b""
            if pgid not in self.osdmap.pg_temp:
                return 0, f"no pg_temp for {pgid}", b""
            self._pending().new_pg_temp[pgid] = []
            self.propose_pending()
            return 0, f"removed pg_temp for {pgid}", b""
        if prefix == "osd reweight":
            inc = self._pending()
            inc.new_weights[int(cmd["id"])] = float(cmd["weight"])
            self.propose_pending()
            return 0, f"reweighted osd.{cmd['id']}", b""
        if prefix in ("pg scrub", "pg deep-scrub", "pg repair"):
            return self._cmd_pg_scrub(prefix, cmd)
        if prefix == "health":
            status, warns = self.health()
            return 0, "\n".join([status] + [f"  {w}" for w in warns]), b""
        if prefix == "pg dump":
            import json
            lines = [f"{pgid} {st.get('state', '?')} "
                     f"objects={st.get('objects', 0)} "
                     f"osd.{st.get('reported_by')}"
                     for pgid, st in sorted(self.pg_stats.items())]
            return 0, "\n".join(lines), json.dumps(
                self.pg_stats, default=str).encode()
        return None

    def _cmd_pg_scrub(self, prefix: str, cmd: dict):
        """Instruct a pg's primary to scrub/repair (the reference's
        `ceph pg repair` -> OSDMonitor -> MOSDScrub to the primary;
        execution is asynchronous on the OSD)."""
        from ..osd.messages import MOSDScrub
        from ..osd.osdmap import PgId
        pgid_s = cmd.get("pgid", "")
        try:
            pgid = PgId.parse(pgid_s)
        except Exception:
            return -22, f"bad pgid {pgid_s!r}", b""
        if pgid.pool not in self.osdmap.pools:
            return -2, f"no pool for pg {pgid_s}", b""
        primary = self.osdmap.pg_primary(pgid)
        if primary is None:
            return -11, f"pg {pgid_s} has no primary", b""
        addr = self.osdmap.get_addr(primary)
        if addr is None:
            return -11, f"osd.{primary} has no address", b""
        self.mon.msgr.send_message(
            MOSDScrub(pgid=pgid_s, deep=prefix != "pg scrub",
                      repair=prefix == "pg repair"),
            f"osd.{primary}", tuple(addr))
        verb = prefix.split(" ", 1)[1].replace("-", " ")
        return 0, f"instructing pg {pgid_s} on osd.{primary} to {verb}", b""

    def _cmd_pool_create(self, cmd: dict):
        name = cmd.get("pool", "")
        if not name:
            return -22, "pool name required", b""
        if self.osdmap.pool_by_name(name):
            return 0, f"pool '{name}' already exists", b""
        pg_num = int(cmd.get("pg_num",
                             self.mon.conf.osd_pool_default_pg_num))
        pool_type = cmd.get("pool_type", "replicated")
        pid = self.osdmap.pool_max + 1
        pending_pools = self._pending().new_pools
        while pid in pending_pools or pid in self.osdmap.pools:
            pid += 1
        pool = Pool(id=pid, name=name, pg_num=pg_num)
        if pool_type == "erasure":
            profile_name = cmd.get("erasure_code_profile", "default")
            profile = dict(self.osdmap.ec_profiles.get(profile_name, {}))
            for k, v in self._pending().new_ec_profiles.get(
                    profile_name, {}).items():
                profile[k] = v
            if not profile and profile_name == "default":
                profile = {"plugin": "tpu", "technique": "reed_sol_van",
                           "k": "2", "m": "1"}
                self._pending().new_ec_profiles["default"] = profile
            if not profile:
                return -2, f"no erasure profile {profile_name}", b""
            try:
                codec = ec_registry.factory(
                    profile.get("plugin", "tpu"), profile)
            except ErasureCodeError as e:
                return -22, f"bad profile: {e}", b""
            k = codec.get_data_chunk_count()
            km = codec.get_chunk_count()
            pool.type = ERASURE
            pool.size = km
            pool.min_size = k + 1 if km > k + 1 else k
            pool.erasure_code_profile = profile_name
            # each EC pool gets an indep crush rule; mutate a COPY so
            # the committed map only changes when the inc commits
            import copy
            crush = copy.deepcopy(self.osdmap.crush)
            rid = crush.make_erasure_rule(f"ec-{name}", k, km - k)
            pool.crush_ruleset = rid
            self._pending().new_crush = denc.dumps(crush)
        else:
            pool.type = REPLICATED
            pool.size = int(cmd.get("size",
                                    self.mon.conf.osd_pool_default_size))
            pool.min_size = max(1, pool.size - pool.size // 2)
        self._pending().new_pools[pid] = pool
        self.propose_pending()
        return 0, f"pool '{name}' created", b""

    def _cmd_pool_rm(self, cmd: dict):
        name = cmd.get("pool", "")
        pool = self.osdmap.pool_by_name(name)
        if pool is None:
            return -2, f"no such pool {name}", b""
        self._pending().removed_pools.append(pool.id)
        self.propose_pending()
        return 0, f"pool '{name}' removed", b""

    def _cmd_ec_profile_set(self, cmd: dict):
        name = cmd.get("name", "")
        profile = {}
        for tok in cmd.get("profile", []):
            if "=" not in tok:
                return -22, f"bad profile entry {tok!r}", b""
            k, v = tok.split("=", 1)
            profile[k] = v
        profile.setdefault("plugin", "tpu")
        # validate by instantiating (OSDMonitor.cc:6291 behavior)
        try:
            ec_registry.factory(profile["plugin"], profile)
        except ErasureCodeError as e:
            return -22, f"invalid profile: {e}", b""
        if (name in self.osdmap.ec_profiles
                and self.osdmap.ec_profiles[name] != profile
                and not cmd.get("force")):
            return -1, f"profile {name} exists; use force to override", b""
        self._pending().new_ec_profiles[name] = profile
        self.propose_pending()
        return 0, "", b""

    def _cmd_ec_profile_rm(self, cmd: dict):
        name = cmd.get("name", "")
        for pool in self.osdmap.pools.values():
            if pool.erasure_code_profile == name:
                return -16, f"profile {name} in use by pool {pool.name}", b""
        inc = self._pending()
        inc.new_ec_profiles[name] = None   # tombstone
        self.propose_pending()
        return 0, "", b""

    def _cmd_snap_create(self, cmd: dict):
        """Allocate a self-managed snap id (pool snap_seq bump; the
        librados selfmanaged_snap_create / OSDMonitor pool snap path)."""
        pool = self.osdmap.pool_by_name(cmd.get("pool", ""))
        if pool is None:
            return -2, f"no such pool {cmd.get('pool')!r}", b""
        inc = self._pending()
        cur = inc.new_pool_snap_seq.get(pool.id, pool.snap_seq)
        snapid = cur + 1
        inc.new_pool_snap_seq[pool.id] = snapid
        self.propose_pending()
        return 0, str(snapid), denc.dumps(snapid)

    def _cmd_snap_rm(self, cmd: dict):
        pool = self.osdmap.pool_by_name(cmd.get("pool", ""))
        if pool is None:
            return -2, f"no such pool {cmd.get('pool')!r}", b""
        snapid = int(cmd.get("snapid", 0))
        if snapid <= 0 or snapid > pool.snap_seq:
            return -22, f"invalid snapid {snapid}", b""
        inc = self._pending()
        inc.new_removed_snaps.setdefault(pool.id, [])
        if snapid not in inc.new_removed_snaps[pool.id]:
            inc.new_removed_snaps[pool.id].append(snapid)
        self.propose_pending()
        return 0, f"removed snap {snapid}", b""

    def _cmd_osd_state(self, prefix: str, cmd: dict):
        osd = int(cmd["id"])
        inc = self._pending()
        if prefix == "osd down":
            inc.new_down.append(osd)
            self.down_at[osd] = self.mon.clock.now()
        elif prefix == "osd out":
            inc.new_out.append(osd)
        else:
            inc.new_in.append(osd)
        self.propose_pending()
        return 0, f"{prefix} osd.{osd}", b""

    # -- PGMap / health (PGMonitor + HealthMonitor reduced) ----------------

    def handle_pg_stats(self, osd_id: int, stats: dict,
                        epoch: int = 0,
                        flags: dict | None = None) -> None:
        now = self.mon.clock.now()
        if flags:
            # leased, not latched: a degraded daemon re-sends its
            # flags every stats report, so a daemon that dies or
            # restarts clean (and may then hold no primary pgs to
            # report about) ages out instead of warning forever
            self.osd_health_flags[osd_id] = {"flags": dict(flags),
                                             "at": now}
        else:
            self.osd_health_flags.pop(osd_id, None)
        for pgid, st in stats.items():
            cur = self.pg_stats.get(pgid)
            if cur is not None and cur.get("epoch", 0) > epoch:
                continue   # a stale ex-primary must not overwrite the
                           # current primary's report (PGMonitor gates
                           # on the reported epoch the same way)
            st = dict(st)
            st["reported_by"] = osd_id
            st["reported_at"] = now
            st["epoch"] = epoch
            self.pg_stats[pgid] = st
        # drop ghosts of deleted pools — they would pad the pg counts
        # and suppress the "not yet reported" warning forever
        pools = set(self.osdmap.pools)
        for pgid in list(self.pg_stats):
            try:
                pool_id = int(pgid.split(".", 1)[0])
            except ValueError:
                pool_id = -1
            if pool_id not in pools:
                del self.pg_stats[pgid]

    def pg_summary(self) -> dict[str, int]:
        """{state_string: count} over the latest reports."""
        out: dict[str, int] = {}
        for st in self.pg_stats.values():
            out[st.get("state", "unknown")] = \
                out.get(st.get("state", "unknown"), 0) + 1
        return out

    def health(self) -> tuple[str, list[str]]:
        """(HEALTH_OK|HEALTH_WARN, detail lines) — the `ceph -s`
        health block (mon/HealthMonitor.cc + PGMap::get_health)."""
        warns: list[str] = []
        m = self.osdmap
        down = [o for o, info in m.osds.items()
                if info.in_cluster and not info.up]
        if down:
            warns.append(f"{len(down)} osds down")
        total_pgs = sum(p.pg_num for p in m.pools.values())
        degraded = {s: n for s, n in self.pg_summary().items()
                    if "degraded" in s or "undersized" in s
                    or "peering" in s or "incomplete" in s}
        for state, n in sorted(degraded.items()):
            warns.append(f"{n} pgs {state}")
        if total_pgs and len(self.pg_stats) < total_pgs:
            warns.append(
                f"{total_pgs - len(self.pg_stats)} pgs not yet "
                f"reported")
        quorum = self.mon.elector.quorum
        if quorum and len(quorum) < self.mon.monmap.size:
            warns.append(f"{self.mon.monmap.size - len(quorum)}/"
                         f"{self.mon.monmap.size} mons out of quorum")
        now = self.mon.clock.now()
        for osd_id, ent in sorted(self.osd_health_flags.items()):
            if not m.is_up(osd_id) or now - ent.get("at", 0) > 60.0:
                continue   # dead/stale reporter: lease expired
            profiles = ent["flags"].get("ec_device_degraded")
            if profiles:
                warns.append(
                    f"osd.{osd_id} EC device degraded "
                    f"(matrix-codec fallback: "
                    f"{', '.join(profiles)})")
            quarantined = ent["flags"].get("ec_device_quarantined")
            if quarantined:
                warns.append(
                    f"osd.{osd_id} EC pipeline {quarantined} devices "
                    f"quarantined (redraining to surviving chips)")
            store_health = ent["flags"].get("store_health")
            if store_health:
                warns.append(f"osd.{osd_id} object store: "
                             f"{store_health}")
            slow = ent["flags"].get("slow_ops")
            if slow:
                # the reference's exact health line (OSDMap/PGMap slow
                # request warnings): level-triggered — the daemon
                # drops the flag once the ops complete, so the warn
                # clears with the next lease/report cycle
                warns.append(
                    f"{slow['count']} slow ops, oldest blocked for "
                    f"{slow['oldest']:.0f}s (osd.{osd_id})")
        return ("HEALTH_WARN" if warns else "HEALTH_OK"), warns

    # -- cache tiering commands (OSDMonitor "osd tier *" handlers) ---------

    def _pool_for_update(self, name: str):
        """Staged-or-committed pool by name, deep-copied for mutation;
        the copy goes into the pending incremental's new_pools."""
        import copy
        for p in self._pending().new_pools.values():
            if p.name == name:
                return p                   # already staged: mutate it
        pool = self.osdmap.pool_by_name(name)
        if pool is None:
            return None
        staged = copy.deepcopy(pool)
        self._pending().new_pools[pool.id] = staged
        return staged

    def _cmd_tier(self, prefix: str, cmd: dict):
        base = self._pool_for_update(cmd.get("pool", ""))
        if base is None:
            return -2, f"no such pool {cmd.get('pool')!r}", b""
        if prefix == "osd tier add":
            tier = self._pool_for_update(cmd.get("tierpool", ""))
            if tier is None:
                return -2, f"no such pool {cmd.get('tierpool')!r}", b""
            if tier is base:
                return -22, "a pool cannot tier itself", b""
            if tier.tier_of >= 0 or tier.tiers:
                return -22, f"{tier.name} is already involved in tiering", b""
            if base.tier_of >= 0:
                # no tier chains: the single-level objecter overlay
                # redirect and PG promote/flush logic cannot follow
                # a->b->c (OSDMonitor _check_become_tier forbids this)
                return -22, f"{base.name} is itself a cache tier", b""
            if tier.is_erasure:
                return -22, "cache pool must be replicated", b""
            tier.tier_of = base.id
            base.tiers = sorted(set(base.tiers) | {tier.id})
            self.propose_pending()
            return 0, f"pool {tier.name} is now a tier of {base.name}", b""
        if prefix == "osd tier cache-mode":
            mode = cmd.get("mode", "")
            if mode not in ("none", "writeback", "readonly"):
                return -22, f"bad cache-mode {mode!r}", b""
            if base.tier_of < 0:
                return -22, f"{base.name} is not a cache tier", b""
            base.cache_mode = mode
            self.propose_pending()
            return 0, f"cache-mode of {base.name} is now {mode}", b""
        if prefix == "osd tier set-overlay":
            tier = self._pool_for_update(cmd.get("overlaypool", ""))
            if tier is None or tier.tier_of != base.id:
                return -22, "overlay pool must be a tier of the base", b""
            base.read_tier = tier.id
            base.write_tier = tier.id
            self.propose_pending()
            return 0, f"overlay for {base.name} is now {tier.name}", b""
        if prefix == "osd tier remove-overlay":
            base.read_tier = -1
            base.write_tier = -1
            self.propose_pending()
            return 0, f"removed overlay for {base.name}", b""
        if prefix == "osd tier remove":
            tier = self._pool_for_update(cmd.get("tierpool", ""))
            if tier is None or tier.tier_of != base.id:
                return -22, "not a tier of that pool", b""
            if base.read_tier == tier.id or base.write_tier == tier.id:
                return -16, "remove the overlay first", b""   # EBUSY
            tier.tier_of = -1
            tier.cache_mode = "none"
            base.tiers = [t for t in base.tiers if t != tier.id]
            self.propose_pending()
            return 0, f"pool {tier.name} is no longer a tier", b""
        return -22, f"unknown tier command {prefix!r}", b""

    _POOL_SET_VARS = {
        "size": int, "min_size": int, "hit_set_count": int,
        "hit_set_period": float, "target_max_objects": int,
        "pg_num": int,
    }

    def _cmd_pool_set(self, cmd: dict):
        pool = self._pool_for_update(cmd.get("pool", ""))
        if pool is None:
            return -2, f"no such pool {cmd.get('pool')!r}", b""
        var = cmd.get("var", "")
        caster = self._POOL_SET_VARS.get(var)
        if caster is None:
            return -22, f"unknown pool variable {var!r}", b""
        try:
            val = caster(cmd.get("val", ""))
        except (TypeError, ValueError) as e:
            return -22, f"bad value for {var}: {e}", b""
        # range/consistency guards (OSDMonitor prepare_command_pool_set):
        # a committed min_size > size would EAGAIN every PG forever
        if var == "size" and not 1 <= val <= 10:
            return -22, f"size {val} out of range", b""
        if var == "size" and pool.min_size > val:
            return -22, f"size {val} < min_size {pool.min_size}", b""
        if var == "min_size" and not 1 <= val <= pool.size:
            return -22, (f"min_size {val} out of range "
                         f"[1, size={pool.size}]"), b""
        if var == "hit_set_period" and val <= 0:
            return -22, "hit_set_period must be > 0", b""
        if var == "hit_set_count" and val < 1:
            return -22, "hit_set_count must be >= 1", b""
        if var == "target_max_objects" and val < 0:
            return -22, "target_max_objects must be >= 0", b""
        if var == "pg_num":
            return self._cmd_pool_set_pg_num(pool, val)
        setattr(pool, var, val)
        self.propose_pending()
        return 0, f"set pool {pool.name} {var}", b""

    def _cmd_pool_set_pg_num(self, pool, val: int):
        """PG split: pg_num may only GROW (mon/OSDMonitor.cc:3649 —
        'specified pg_num must be > current'; merge does not exist in
        the reference either).  Each new child pg starts pinned via
        pg_temp to its PARENT's current acting set: the parent's OSDs
        split their local collections in place, so the children are
        immediately served from where the data already is; the
        primaries then backfill the CRUSH-computed targets and release
        the pg_temp pin (the reference's split + pg_temp/backfill
        flow, osd/OSD.cc:7553 split_pgs)."""
        # validate against the PENDING value: a second command in the
        # same uncommitted round must not slip a shrink past the guard
        old_num = pool.pg_num
        if val <= old_num:
            return -22, (f"specified pg_num {val} <= current "
                         f"{old_num}"), b""
        from ..osd.osdmap import PgId, parent_seed
        inc = self._pending()
        for child in range(old_num, val):
            parent = PgId(pool.id, parent_seed(child, old_num))
            _up, acting = self.osdmap.pg_to_up_acting_osds(parent)
            if acting:
                inc.new_pg_temp[PgId(pool.id, child)] = list(acting)
        pool.pg_num = val
        self.propose_pending()
        return 0, (f"set pool {pool.name} pg_num to {val} "
                   f"({val - old_num} pgs splitting)"), b""

    def _dump_text(self) -> str:
        m = self.osdmap
        lines = [f"epoch {m.epoch}", f"max_osd {m.max_osd}"]
        for pid, pool in sorted(m.pools.items()):
            kind = "erasure" if pool.is_erasure else "replicated"
            tier = ""
            if pool.tier_of >= 0:
                tier = f" tier_of {pool.tier_of} cache_mode {pool.cache_mode}"
            if pool.read_tier >= 0 or pool.write_tier >= 0:
                tier += (f" read_tier {pool.read_tier}"
                         f" write_tier {pool.write_tier}")
            lines.append(
                f"pool {pid} '{pool.name}' {kind} size {pool.size} "
                f"min_size {pool.min_size} pg_num {pool.pg_num}{tier}")
        for osd in sorted(m.osds):
            info = m.osds[osd]
            state = ("up" if info.up else "down") + \
                (" in" if info.in_cluster else " out")
            lines.append(f"osd.{osd} {state} weight {info.weight} "
                         f"addr {info.addr}")
        return "\n".join(lines)

    def _tree_text(self) -> str:
        lines = []
        for b in sorted(self.osdmap.crush.buckets.values(),
                        key=lambda b: -b.id):
            lines.append(f"{b.id}\t{b.name or '(bucket)'}")
            for item, w in zip(b.items, b.weights):
                lines.append(f"\t{item}\t{w / 0x10000:.3f}")
        return "\n".join(lines)


class MonmapMonitor(PaxosService):
    """Monitor-roster membership through paxos (mon/MonmapMonitor.cc:
    320 prepare_command `mon add`/`mon remove`): each committed version
    stores the FULL monmap at its new epoch; every mon adopts it on
    commit (Monitor.adopt_monmap rebuilds the elector roster and
    re-publishes to monmap subscribers), and a freshly-seeded mon that
    joins with an empty store pulls history via the paxos full-sync
    path and replays the latest monmap from it."""
    name = "monmap"

    def __init__(self, mon: "Monitor"):
        super().__init__(mon)
        self.pending = None
        self._last_proposed_epoch = 0
        self.update_from_paxos()

    def update_from_paxos(self) -> None:
        from .monmap import MonMap
        v = self.version
        if v <= self.mon.monmap.epoch:
            return
        blob = self.mon.store.get_version(self.name, v)
        if blob is None:
            return
        mm = MonMap.decode(blob)
        if mm.epoch > self.mon.monmap.epoch:
            self.mon.adopt_monmap(mm)

    def create_pending(self) -> None:
        # pending is a list of OPERATIONS, rebased onto the CURRENT
        # monmap at encode time: a queued proposal built while an
        # earlier one was still in flight must neither reuse its epoch
        # nor resurrect its pre-commit roster (the OSDMonitor
        # incremental + _last_proposed_epoch pattern)
        self.pending_ops: list[tuple] = []
        self.have_pending = True

    def encode_pending(self, txn_ops: list) -> None:
        mm = self.mon.monmap.copy()
        for op in self.pending_ops:
            if op[0] == "add":
                mm.add(op[1], op[2])
            else:
                mm.remove(op[1])
        mm.epoch = max(self.mon.monmap.epoch,
                       self._last_proposed_epoch) + 1
        self.pending_ops = []
        txn_ops.append(("set", self.name, f"{mm.epoch:020d}",
                        mm.encode()))
        txn_ops.append(("set", self.name, "last_committed",
                        str(mm.epoch).encode()))
        self._last_proposed_epoch = mm.epoch

    def _effective_roster(self) -> dict:
        mm = self.mon.monmap.copy()
        for op in getattr(self, "pending_ops", []):
            if op[0] == "add":
                mm.add(op[1], op[2])
            else:
                mm.remove(op[1])
        return mm.mons

    def _pending(self) -> list:
        if not self.have_pending or not hasattr(self, "pending_ops"):
            self.create_pending()
        return self.pending_ops

    def dispatch_command(self, cmd: dict):
        prefix = cmd.get("prefix")
        if prefix == "mon add":
            name = str(cmd.get("name", ""))
            addr = cmd.get("addr")
            if not name or not addr or len(tuple(addr)) != 2:
                return -22, "usage: mon add <name> <host:port>", b""
            ops = self._pending()
            roster = self._effective_roster()
            if name in roster:
                # idempotent for retries: a client whose first attempt
                # is still waiting out the commit may resend; the same
                # name at the same address is success, not EEXIST
                if tuple(roster[name]) == (str(addr[0]), int(addr[1])):
                    return 0, f"mon.{name} already exists", b""
                return -17, f"mon.{name} already exists", b""
            ops.append(("add", name, (str(addr[0]), int(addr[1]))))
            self.propose_pending()
            return 0, f"adding mon.{name} at {tuple(addr)}", b""
        if prefix == "mon remove":
            name = str(cmd.get("name", ""))
            ops = self._pending()
            roster = self._effective_roster()
            if name not in roster:
                return -2, f"mon.{name} does not exist", b""
            if len(roster) == 1:
                return -22, "cannot remove the last monitor", b""
            ops.append(("remove", name))
            self.propose_pending()
            return 0, f"removed mon.{name}", b""
        if prefix == "mon dump":
            mm = self.mon.monmap
            lines = [f"epoch {mm.epoch}"]
            for name in mm.ranks():
                lines.append(f"mon.{name} {mm.addr_of(name)}")
            return 0, "\n".join(lines), mm.encode()
        if prefix == "quorum_status":
            import json
            return 0, json.dumps({
                "quorum": self.mon.elector.quorum,
                "leader": self.mon.elector.leader,
                "epoch": self.mon.elector.epoch,
            }), b""
        return None
