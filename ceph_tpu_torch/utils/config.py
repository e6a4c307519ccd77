"""Typed config with live mutation + observer pattern.

The md_config_t analog (src/common/config.h:168-212:
set_val + apply_changes calling handle_conf_change on registered
md_config_obs_t observers; options declared with typed defaults like
common/config_opts.h).  Fault-injection knobs live here from day one,
matching the reference's config-driven injection style (SURVEY.md §5.3).
"""

from __future__ import annotations

import configparser
import threading
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Mapping


@dataclass(frozen=True)
class Option:
    name: str
    type: type          # int, float, bool, str
    default: Any
    desc: str = ""

    def parse(self, value):
        if self.type is bool:
            if isinstance(value, bool):
                return value
            return str(value).lower() in ("1", "true", "yes", "on")
        return self.type(value)


# The subset of the reference's 1159 options this framework uses so far;
# grows as components land.  Names keep the reference's spelling where
# the meaning is identical so operators can carry intuition over.
OPTIONS: dict[str, Option] = {}


def _opt(name: str, type_: type, default, desc: str = "") -> None:
    OPTIONS[name] = Option(name, type_, default, desc)


# -- global ----------------------------------------------------------------
_opt("name", str, "client.admin", "entity name")
_opt("fsid", str, "", "cluster id")
_opt("mon_host", str, "", "comma-separated mon addresses")
_opt("log_level", int, 1, "default per-subsystem log level")
_opt("log_ring_size", int, 10000, "recent log entries kept for crash dump")

# -- auth --------------------------------------------------------------------
_opt("auth_cluster_required", str, "none",
     "cephx | none: session auth + per-message signing on the messenger")
_opt("keyring", str, "", "path to the keyring file")
_opt("key", str, "", "base64 secret (overrides keyring lookup)")

# -- messenger -------------------------------------------------------------
_opt("ms_type", str, "blocking",
     "messenger stack: blocking (one loop thread per messenger) | "
     "async (shared epoll event-loop worker pool)")
_opt("ms_async_op_threads", int, 3,
     "event-loop workers in the shared async-messenger pool")
_opt("ms_tcp_nodelay", bool, True, "")
_opt("ms_initial_backoff", float, 0.2, "reconnect backoff start")
_opt("ms_max_backoff", float, 15.0, "reconnect backoff cap")
_opt("ms_connect_timeout", float, 10.0, "handshake reply timeout")
_opt("ms_inject_socket_failures", int, 0,
     "1-in-N chance to drop a connection (fault injection)")
_opt("ms_inject_delay_probability", float, 0.0, "")
_opt("ms_inject_delay_max", float, 1.0, "seconds")
_opt("ms_dispatch_throttle_bytes", int, 100 << 20, "")

# -- mon -------------------------------------------------------------------
_opt("mon_lease", float, 5.0, "paxos peon lease seconds")
_opt("mon_lease_renew_interval", float, 3.0, "")
_opt("mon_lease_ack_timeout", float, 10.0, "")
_opt("mon_election_timeout", float, 5.0, "")
_opt("mon_tick_interval", float, 5.0, "")
_opt("osd_scrub_min_interval", float, 86400.0,
     "seconds between automatic shallow scrubs per PG")
_opt("osd_deep_scrub_interval", float, 604800.0,
     "seconds between automatic deep scrubs per PG")
_opt("osd_max_scrubs", int, 1,
     "max scheduled scrubs kicked per heartbeat tick")
_opt("osd_scrub_load_threshold", int, 8,
     "skip scheduled scrubs while this many ops are in flight")
_opt("osd_scrub_auto_repair", bool, False,
     "scheduled scrubs repair what they find inconsistent")
_opt("mds_bal_auto", bool, False,
     "auto-export hot subtrees to cooler ranks on beacon ticks")
_opt("mds_bal_min", int, 20,
     "minimum per-tick load before the balancer considers moving")
_opt("mon_osd_down_out_interval", float, 600.0,
     "seconds before a down OSD is marked out")
_opt("mon_osd_min_down_reporters", int, 1, "")
_opt("mon_osd_report_timeout", float, 900.0, "")
_opt("paxos_propose_interval", float, 1.0, "")

# -- osd -------------------------------------------------------------------
_opt("osd_pool_default_size", int, 3, "replicas")
_opt("osd_pool_default_min_size", int, 0, "0 -> size - size/2")
_opt("osd_pool_default_pg_num", int, 8, "")
_opt("osd_pool_default_erasure_code_profile", str,
     "plugin=tpu technique=reed_sol_van k=2 m=1", "")
_opt("osd_heartbeat_interval", float, 6.0, "")
_opt("osd_heartbeat_grace", float, 20.0, "")
_opt("osd_max_write_size", int, 90 << 20, "")
_opt("osd_client_message_size_cap", int, 500 << 20, "")
_opt("osd_op_num_shards", int, 5, "sharded op queue shards")
_opt("osd_op_num_threads_per_shard", int, 2, "")
_opt("osd_recovery_max_active", int, 3, "")
_opt("osd_recovery_block_retry", float, 1.0,
     "re-promotion cadence for client ops parked on a missing "
     "object's recovery pull (the op blocks instead of serving stale "
     "store bytes; each retry re-promotes the pull to the front of "
     "the recovery queue)")
_opt("osd_recovery_block_max_retries", int, 30,
     "recovery-blocked ops are EAGAINed back to the client after "
     "this many re-promotion rounds (the objecter resend/timeout "
     "machinery then owns the op) so a pull that can never complete "
     "cannot wedge a client op forever")
_opt("osd_scrub_sleep", float, 0.0, "")
_opt("osd_deep_scrub_stripe_batch", int, 64,
     "stripes per device dispatch during deep scrub")
_opt("osd_ec_pipeline_depth", int, 2,
     "overlapped EC device dispatches kept in flight")
_opt("osd_ec_pipeline_coalesce_ms", float, 2.0,
     "wait granularity while coalescing EC stripe work behind a "
     "busy device")
_opt("osd_ec_pipeline_max_batch", int, 256,
     "max stripes fused into one EC pipeline dispatch")
_opt("osd_ec_device_shards", str, "all",
     "devices the EC pipeline spreads mega-batches over: 'all' (every "
     "visible chip) or a count capping the dispatch lanes")
_opt("osd_ec_pipeline_scrub_weight", float, 0.25,
     "scrub CRC channels' share of contended EC pipeline dispatch "
     "slots (client-write encodes take the rest); >= 1 disables the "
     "yield (strict cross-channel FIFO)")
_opt("osd_ec_hbm_cache_bytes", int, 64 << 20,
     "HBM budget for the device-resident EC stripe cache (encoded "
     "stripes stay on-chip so deep scrub / recovery of a cached "
     "object pay zero re-upload); 0 disables the cache")
_opt("osd_ec_mesh_min_bytes", int, 256 << 20,
     "a single dispatch lane's staging budget: a coalesced EC batch "
     "larger than this shard_maps its chunk-length axis across the "
     "device mesh (one pod-scale dispatch, donated staging arena) "
     "instead of riding one chip's HBM; 0 disables mesh dispatch")
_opt("osd_ec_device_mesh", str, "auto",
     "axis layout for EC mesh dispatch: 'auto' spans every active "
     "lane on the chunk-length axis, an integer caps the member "
     "count, 'AxB' lays out dp x ls (stripes x chunk-length) "
     "explicitly")
# -- per-pool QoS (dmClock-style service classes) ---------------------------
# Options named `osd_pool_qos_<pool>` are DYNAMIC (auto-registered on
# first set): the value is a `res:weight:lim` triple (utils/dmclock.
# parse_spec) giving pool <pool> a reserved IOPS floor, a proportional
# weight for the surplus, and an IOPS ceiling (0 = none/unlimited,
# e.g. "100:2:0").  They shape BOTH the OSD's sharded op queue and the
# EC pipeline's dispatch-lane picks.  `osd_pool_qos_default` applies
# to every pool without its own entry ('' = unconstrained FIFO).
QOS_OPT_PREFIX = "osd_pool_qos_"
_opt("osd_qos_recovery", str, "",
     "dmClock service class for recovery/backfill pushes "
     "('res:weight:lim'; '' = unconstrained).  With a class set, "
     "MPGPush payloads are tagged into it with bytes-weighted cost, "
     "so a backfill storm is throttleable instead of riding the "
     "unconstrained control plane")
_opt("osd_qos_cost_bytes_unit", int, 4096,
     "dmClock cost normalization: an op costs "
     "1 + payload_bytes/this (a 4 MiB write is not the same grant as "
     "a 4 KiB stat); 0 reverts to cost=1 per op")
_opt("osd_pool_qos_default", str, "",
     "res:weight:lim service class for pools without their own "
     "osd_pool_qos_<pool> entry ('' = unconstrained FIFO)")
_opt("osd_ec_cost_aware_placement", bool, True,
     "EC pipeline lane placement uses per-(shape, chip) measured "
     "service-time EMAs to override the least-loaded pick when a "
     "chip is measured faster (cost_diverged counts overrides); "
     "false restores pure least-loaded/round-robin")
_opt("osd_inject_failure_on_pg_removal", bool, False, "")
_opt("osd_debug_inject_dispatch_delay_probability", float, 0.0, "")
_opt("osd_debug_inject_dispatch_delay_duration", float, 0.1, "")
_opt("osd_op_complaint_time", float, 30.0,
     "ops in flight longer than this are reported as slow (one-shot "
     "log complaint + the level-triggered 'N slow ops' HEALTH_WARN "
     "flag on pg-stats reports)")
_opt("osd_op_history_size", int, 20, "historic ops kept for dump")
_opt("osd_op_history_duration", float, 600.0,
     "historic ops older than this are pruned from the ring even "
     "below the size bound (osd_op_history_duration analog)")
_opt("osd_enable_op_tracker", bool, True,
     "per-op tracing (TrackedOp spans + historic rings); off keeps "
     "only the latency counters — the bench tracer-overhead gate "
     "compares both modes")
_opt("flight_recorder_dir", str, "",
     "arm the op-tracing flight recorder: a fired CrashPoint or a "
     "DurabilityLedger verify failure snapshots every registered "
     "daemon's in-flight/historic ops + pg log summaries into this "
     "directory ('' = disarmed)")
_opt("flight_recorder_max", int, 16,
     "incident directories the flight recorder writes before going "
     "quiet (bounds a crash soak's disk use)")
_opt("paxos_max_versions", int, 500,
     "committed paxos versions kept before the leader proposes a trim")
_opt("paxos_trim_keep", int, 250,
     "versions retained by a trim; peers behind the trim point "
     "rejoin via full store sync")
_opt("auth_service_ticket_ttl", float, 60.0,
     "cephx service-ticket lifetime; clients renew at ~1/3 of it and "
     "services refresh rotating secrets on the same cadence")
_opt("osd_pg_log_max_entries", int, 2000,
     "bounded PG log length (osd_max_pg_log_entries analog): peering "
     "exchanges log deltas within this window; a peer whose "
     "last_update predates the trimmed tail must backfill")
_opt("osd_backfill_scan_batch", int, 64,
     "objects compared per backfill scan round (BackfillInterval "
     "window analog)")
_opt("osd_subop_resend_interval", float, 2.0,
     "write gathers older than this resend sub-ops to unacked shards "
     "(replicas dedup by log ev) and drop shards whose holder left "
     "the acting set — ECBackend check_op/on_change requeue analog")
_opt("admin_socket_dir", str, "",
     "directory for per-daemon admin sockets ('' disables the socket; "
     "the in-process hook registry always works)")

# -- objectstore -----------------------------------------------------------
_opt("objectstore", str, "memstore", "memstore | filestore")
_opt("objectstore_inject_eio_probability", float, 0.0,
     "1-in-N read EIO fault injection")
_opt("filestore_commit_interval", float, 0.2,
     "seconds between journal commits")

# -- erasure ---------------------------------------------------------------
_opt("erasure_code_plugins_preload", str, "tpu jerasure", "")

# -- client ----------------------------------------------------------------
_opt("client_mount_timeout", float, 300.0, "")
_opt("objecter_inflight_ops", int, 1024, "op budget")
_opt("objecter_inflight_op_bytes", int, 100 << 20, "")
_opt("objecter_timeout", float, 10.0, "resend/ping interval")
_opt("objecter_op_timeout", float, 30.0,
     "per-op deadline: an op not acked within this window fails with "
     "ETIMEDOUT (110) instead of hanging on a dead primary")
_opt("objecter_backoff_base", float, 0.5,
     "first resend interval for a silent op; doubles per silent try")
_opt("objecter_backoff_max", float, 5.0,
     "resend interval cap for the exponential backoff")
_opt("objecter_silent_kick", float, 6.0,
     "seconds of continuous silence on one primary's link before the "
     "connection is marked down and redialed; must exceed a slow-but-"
     "alive op's service time or the kick drops its in-flight reply")

# -- rgw -------------------------------------------------------------------
_opt("rgw_sync_retries", int, 3,
     "in-round retries per bucket before the sync agent quarantines "
     "it (the bucket sits out under exponential backoff instead of "
     "failing the whole round)")
_opt("rgw_sync_backoff_base", float, 0.5,
     "first backoff interval for a quarantined bucket (and for the "
     "round-level peer probe after a failed discovery); doubles per "
     "consecutive failure")
_opt("rgw_sync_backoff_max", float, 10.0,
     "backoff interval cap for the sync agent's exponential backoff "
     "(bounds time-to-recover after a long partition heals)")

# -- mds -------------------------------------------------------------------
_opt("mds_beacon_grace", float, 15.0,
     "mds ranks silent past this are dropped from the map so clients "
     "stop routing to dead addresses (0 disables pruning)")

# -- fault injection (FaultSet, ceph_tpu_torch/utils/faults.py) -------------------
_opt("faultset_seed", int, 0,
     "seed for the FaultSet decision streams; same seed + same "
     "per-entity call order reproduces the fault schedule")
_opt("faultset_rules", str, "",
     "';'-separated FaultSet rules installed via injectargs, e.g. "
     "'partition osd.1 osd.2; eio osd.0 obj* 0.5; tpu_error 1.0' "
     "(replaces prior conf-sourced rules; '' clears them)")


class Config:
    """A live option map with observers (thread-safe)."""

    def __init__(self, overrides: Mapping[str, Any] | None = None):
        self._lock = threading.RLock()
        self._values: dict[str, Any] = {
            name: opt.default for name, opt in OPTIONS.items()}
        self._observers: list[tuple[Callable, tuple[str, ...]]] = []
        self._pending: set[str] = set()
        # bumped per apply_changes batch that changed anything: the
        # `perf dump` daemon block reports it as the conf epoch
        self.generation = 0
        if overrides:
            for key, val in overrides.items():
                self.set_val(key, val)
            self.apply_changes()

    def __getattr__(self, name: str):
        # config.osd_pool_default_size style access
        try:
            with self._lock:
                return self._values[name]
        except KeyError:
            raise AttributeError(name) from None

    def get_val(self, name: str):
        with self._lock:
            if name not in self._values:
                raise KeyError(f"unknown option {name!r}")
            return self._values[name]

    def set_val(self, name: str, value) -> None:
        opt = OPTIONS.get(name)
        if opt is None and name.startswith(QOS_OPT_PREFIX):
            # per-pool QoS entries are dynamic by nature (pools are
            # created at runtime): auto-register as a string option so
            # injectargs/conf files/observers all work unchanged
            opt = Option(name, str, "", "dynamic per-pool qos spec")
            OPTIONS[name] = opt
            with self._lock:
                self._values.setdefault(name, opt.default)
        if opt is None:
            raise KeyError(f"unknown option {name!r}")
        parsed = opt.parse(value)
        with self._lock:
            # .get: a dynamic option may have been registered by a
            # DIFFERENT Config instance after this one was built
            if self._values.get(name, opt.default) != parsed or \
                    name not in self._values:
                self._values[name] = parsed
                self._pending.add(name)

    def add_observer(self, handler: Callable[[Config, set[str]], None],
                     keys: Iterable[str]) -> None:
        """handler(conf, changed_keys) fires on apply_changes."""
        self._observers.append((handler, tuple(keys)))

    def remove_observer(self, handler) -> None:
        self._observers = [(h, k) for h, k in self._observers
                           if h is not handler]

    def apply_changes(self) -> set[str]:
        with self._lock:
            changed = set(self._pending)
            self._pending.clear()
            if changed:
                self.generation += 1
        if changed:
            for handler, keys in list(self._observers):
                # a trailing '*' in an observer key is a prefix match
                # (dynamic options like osd_pool_qos_<pool>)
                hit = {c for c in changed
                       if any(c == k or (k.endswith("*")
                                         and c.startswith(k[:-1]))
                              for k in keys)}
                if hit:
                    handler(self, hit)
        return changed

    def injectargs(self, args: str) -> None:
        """'--osd-heartbeat-grace 30 --mon-lease 7' style live
        injection.  Values are shell-quoted, so multi-word values work:
        --faultset-rules 'partition osd.1 osd.2'."""
        import shlex
        toks = shlex.split(args)
        i = 0
        while i < len(toks):
            tok = toks[i]
            if not tok.startswith("--"):
                raise ValueError(f"expected --option, got {tok!r}")
            name = tok[2:]
            if "=" in name:
                name, val = name.split("=", 1)
                name = name.replace("-", "_")
            else:
                name = name.replace("-", "_")
                i += 1
                if i >= len(toks):
                    raise ValueError(f"missing value for {tok}")
                val = toks[i]
            self.set_val(name, val)
            i += 1
        self.apply_changes()

    def parse_file(self, path: str, section: str | None = None) -> None:
        """ini config file; [global] plus optional entity section."""
        parser = configparser.ConfigParser()
        parser.read(path)
        for sec in ("global", section):
            if sec and parser.has_section(sec):
                for key, val in parser.items(sec):
                    name = key.replace(" ", "_").replace("-", "_")
                    # dynamic options (osd_pool_qos_<pool>) register
                    # themselves inside set_val — a conf file must be
                    # able to carry them just like injectargs
                    if name in OPTIONS or \
                            name.startswith(QOS_OPT_PREFIX):
                        self.set_val(name, val)
        self.apply_changes()

    def dump(self) -> dict[str, Any]:
        with self._lock:
            return dict(self._values)
