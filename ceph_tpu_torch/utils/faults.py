"""FaultSet: central, seed-deterministic fault-injection registry.

Every layer that used to hand-roll its own injection (the messenger's
``ms_inject_socket_failures`` 1-in-N roll, MemStore's
``inject_eio_probability``) now asks ONE process-wide registry instead.
That buys three properties the scattered hooks never had:

  * **targetable** — rules are scoped by entity glob ("osd.3",
    "osd.*", "client.*") and, for stores, by object-name glob, so a
    test can partition exactly two daemons or EIO exactly one shard
    instead of spraying randomness everywhere;
  * **deterministic** — all randomness flows through named streams
    derived from one seed (per-entity streams, so one daemon's
    decision sequence does not depend on another thread's
    interleaving); the same seed and the same per-entity call order
    reproduce the same fault schedule;
  * **runtime-operable** — rules install/clear through the daemons'
    admin sockets ("faults install/clear/dump") and through
    ``injectargs --faultset-rules ...`` (config observer), the same
    surface the reference exposes for its ms_inject_* knobs.

Rule types (the teuthology thrasher vocabulary, reduced):

  partition(a, b, symmetric=True)   no traffic a->b (and b->a)
  drop(dst, prob, src="*")          message loss on the send path
  delay(dst, secs, prob, src="*")   extra latency on the send path
  socket_kill(dst, one_in, src="*") kill 1-in-N sends' connections
  store_eio(osd, oid_glob, prob)    targeted EIO on store reads
  tpu_device_error(prob, device)    EC device dispatch fails; device
                                    "*" degrades the plugin to the
                                    host matrix-codec path + health
                                    WARN, a device-index glob
                                    quarantines just that chip's
                                    pipeline lane (redrain to the
                                    surviving chips).  This injected
                                    rule is the only device error
                                    that degrades a codec: a real
                                    CUDA error raises
  crash(site_glob, prob, owner)     simulated power loss at a named
                                    crash point threaded through the
                                    write path (journal.pre_fsync,
                                    journal.post_fsync,
                                    journal.mid_apply,
                                    snapshot.mid_write,
                                    snapshot.pre_rename, pglog.append,
                                    store.pre_apply, store.post_apply,
                                    the BlockStore deferred-write WAL
                                    sites wal.pre_kv_commit,
                                    wal.post_kv_commit, wal.mid_apply,
                                    wal.pre_trim, alloc.mid_cow, and
                                    the mon-store paxos sites
                                    paxos.pre_commit, paxos.mid_commit,
                                    paxos.post_accept_pre_ack): the
                                    store freezes (no further
                                    mutation reaches disk) and the
                                    owning daemon aborts without
                                    acking.  ONE-SHOT: the rule
                                    removes itself after firing, so a
                                    restart of the crashed daemon does
                                    not immediately re-crash.
  fsync_reorder(prob, owner)        arms the ALICE reordering model
                                    for crashes on matching owners:
                                    writes buffered BETWEEN fsync
                                    barriers may survive out of order
                                    (durable B, lost earlier A) — the
                                    crashing store keeps a seeded
                                    SUBSET of its un-fsync'd writes
                                    instead of a prefix.  Consumed
                                    together with the crash rule that
                                    fires (one-shot).

The module-level singleton (``faults.get()``) is what the wired layers
consult; tests that want isolation can swap it with ``set_global()``
or simply ``get().reset()`` between cases.
"""

from __future__ import annotations

import threading
import zlib
from fnmatch import fnmatchcase
from random import Random
from typing import Callable


def _match(pattern: str, entity: str) -> bool:
    return pattern == "*" or fnmatchcase(entity, pattern)


class CrashPoint(Exception):
    """Simulated power loss: a crash rule fired at a named crash site.

    Deliberately NOT a StoreError — the write paths' StoreError
    handlers reply to the client, and a crash must never ack or nack:
    the op simply dies with the daemon, exactly like a kill -9 between
    the disk write and the reply.  Propagates to the op worker, which
    drops it quietly (the daemon is already aborting)."""


class FaultRule:
    __slots__ = ("id", "kind", "params", "source", "hits")

    def __init__(self, rid: int, kind: str, params: dict,
                 source: str = "api"):
        self.id = rid
        self.kind = kind
        self.params = params
        self.source = source
        self.hits = 0

    def dump(self) -> dict:
        return {"id": self.id, "kind": self.kind, "source": self.source,
                "hits": self.hits, **self.params}

    def __repr__(self):
        return f"FaultRule({self.id}, {self.kind}, {self.params})"


class FaultSet:
    def __init__(self, seed: int = 0):
        self._lock = threading.RLock()
        self._seed = int(seed)
        self._rules: dict[int, FaultRule] = {}
        self._next_id = 1
        self._streams: dict[str, Random] = {}
        # per-kind fast-path flags: the messenger consults this on
        # EVERY frame, so "no rules installed" must cost one attribute
        # read, not a lock + scan
        self._have_net = False
        self._have_store = False
        self._have_tpu = False
        self._have_crash = False
        self._have_reorder = False
        # bounded trace of fired faults, for post-mortem + repro checks
        self._trace: list[tuple] = []
        self._trace_cap = 10000

    # -- seeding -----------------------------------------------------------

    @property
    def seed(self) -> int:
        return self._seed

    def reseed(self, seed: int) -> None:
        """Reset all decision streams to a fresh seed (rules stay)."""
        with self._lock:
            self._seed = int(seed)
            self._streams.clear()
            self._trace.clear()

    def reset(self, seed: int | None = None) -> None:
        """Clear every rule and decision stream (test isolation)."""
        with self._lock:
            self._rules.clear()
            self._streams.clear()
            self._trace.clear()
            if seed is not None:
                self._seed = int(seed)
            self._refresh_flags()

    def _stream(self, name: str) -> Random:
        rng = self._streams.get(name)
        if rng is None:
            rng = self._streams[name] = Random(
                (self._seed << 32) ^ zlib.crc32(name.encode()))
        return rng

    def _note(self, *event) -> None:
        if len(self._trace) < self._trace_cap:
            self._trace.append(event)

    def trace(self) -> list[tuple]:
        with self._lock:
            return list(self._trace)

    # -- rule installation -------------------------------------------------

    def _add(self, kind: str, params: dict, source: str = "api") -> int:
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            self._rules[rid] = FaultRule(rid, kind, params, source)
            self._refresh_flags()
            return rid

    def _refresh_flags(self) -> None:
        kinds = {r.kind for r in self._rules.values()}
        self._have_net = bool(kinds & {"partition", "drop", "delay",
                                       "socket_kill"})
        self._have_store = "store_eio" in kinds
        self._have_tpu = "tpu_device_error" in kinds
        self._have_crash = "crash" in kinds
        self._have_reorder = "fsync_reorder" in kinds

    def partition(self, a: str, b: str, symmetric: bool = True,
                  source: str = "api") -> int:
        """Block all traffic a->b (and b->a when symmetric)."""
        return self._add("partition", {"a": a, "b": b,
                                       "symmetric": bool(symmetric)},
                         source)

    def drop(self, dst: str, prob: float, src: str = "*",
             source: str = "api") -> int:
        """Silently lose sent messages src->dst with probability."""
        return self._add("drop", {"src": src, "dst": dst,
                                  "prob": float(prob)}, source)

    def delay(self, dst: str, secs: float, prob: float = 1.0,
              src: str = "*", source: str = "api") -> int:
        """Add latency to sends src->dst."""
        return self._add("delay", {"src": src, "dst": dst,
                                   "secs": float(secs),
                                   "prob": float(prob)}, source)

    def socket_kill(self, dst: str, one_in: int, src: str = "*",
                    source: str = "api") -> int:
        """Kill 1-in-N sends' connections (the ms_inject_socket_failures
        semantics, but targetable)."""
        return self._add("socket_kill", {"src": src, "dst": dst,
                                         "one_in": int(one_in)}, source)

    def store_eio(self, osd: str, oid_glob: str = "*",
                  prob: float = 1.0, source: str = "api") -> int:
        """EIO on store reads of matching objects on matching daemons."""
        return self._add("store_eio", {"osd": osd, "oid": oid_glob,
                                       "prob": float(prob)}, source)

    def tpu_device_error(self, prob: float = 1.0, device: str = "*",
                         source: str = "api") -> int:
        """Fail EC device dispatch; untargeted (device="*") the tpu
        plugin must degrade to the host matrix-codec path, not error
        the op.  `device` may glob a device INDEX (e.g. "3"): the EC
        pipeline then quarantines only that chip's dispatch lane and
        redrains its work onto the surviving chips."""
        return self._add("tpu_device_error",
                         {"prob": float(prob), "device": str(device)},
                         source)

    def crash(self, site: str = "*", prob: float = 1.0,
              owner: str = "osd.*", source: str = "api") -> int:
        """Simulated power loss at crash points matching `site` on
        daemons matching `owner`.  The firing store freezes (nothing
        after the site's disk state reaches disk) and the daemon
        aborts without acking.  One-shot: the rule removes itself
        after firing."""
        return self._add("crash", {"site": str(site),
                                   "prob": float(prob),
                                   "owner": str(owner)}, source)

    def fsync_reorder(self, prob: float = 1.0, owner: str = "*",
                      source: str = "api") -> int:
        """Arm the fsync-reordering model for crashes on `owner`: the
        next crash keeps a seeded SUBSET of the writes buffered since
        the last fsync barrier instead of a contiguous prefix (ALICE's
        reordering vulnerability window: durable B, lost earlier A).
        One-shot: consumed together with the crash that uses it."""
        return self._add("fsync_reorder", {"prob": float(prob),
                                           "owner": str(owner)}, source)

    def clear(self, rule_id: int | None = None,
              source: str | None = None) -> int:
        """Remove one rule by id, all rules from a source, or all."""
        with self._lock:
            if rule_id is not None:
                removed = 1 if self._rules.pop(int(rule_id), None) else 0
            elif source is not None:
                victims = [r for r, rule in self._rules.items()
                           if rule.source == source]
                for r in victims:
                    del self._rules[r]
                removed = len(victims)
            else:
                removed = len(self._rules)
                self._rules.clear()
            self._refresh_flags()
            return removed

    def rules(self) -> list[FaultRule]:
        with self._lock:
            return list(self._rules.values())

    def dump(self) -> dict:
        with self._lock:
            return {"seed": self._seed,
                    "rules": [r.dump() for r in self._rules.values()],
                    "fired": len(self._trace)}

    # -- spec parsing (injectargs / admin-socket surface) ------------------
    #
    # A spec is ';'-separated rules:
    #   partition osd.1 osd.2 [oneway]
    #   drop <dst-glob> <prob> [src-glob]
    #   delay <dst-glob> <secs> [prob] [src-glob]
    #   kill <dst-glob> <one_in> [src-glob]
    #   eio <osd-glob> <oid-glob> [prob]
    #   tpu_error <prob> [device-index-glob]
    #   crash <prob> <site-glob> [owner-glob]
    # install_from_spec REPLACES all rules previously installed from the
    # same source, so re-applying a config value is idempotent.

    def install_from_spec(self, spec: str, source: str = "conf"
                          ) -> list[int]:
        rules: list[tuple] = []
        for part in (spec or "").split(";"):
            toks = part.split()
            if not toks:
                continue
            kind, args = toks[0], toks[1:]
            if kind == "partition" and len(args) >= 2:
                rules.append(("partition",
                              dict(a=args[0], b=args[1],
                                   symmetric="oneway" not in args[2:])))
            elif kind == "drop" and len(args) >= 2:
                rules.append(("drop", dict(
                    dst=args[0], prob=float(args[1]),
                    src=args[2] if len(args) > 2 else "*")))
            elif kind == "delay" and len(args) >= 2:
                rules.append(("delay", dict(
                    dst=args[0], secs=float(args[1]),
                    prob=float(args[2]) if len(args) > 2 else 1.0,
                    src=args[3] if len(args) > 3 else "*")))
            elif kind == "kill" and len(args) >= 2:
                rules.append(("socket_kill", dict(
                    dst=args[0], one_in=int(args[1]),
                    src=args[2] if len(args) > 2 else "*")))
            elif kind == "eio" and len(args) >= 2:
                rules.append(("store_eio", dict(
                    osd=args[0], oid_glob=args[1],
                    prob=float(args[2]) if len(args) > 2 else 1.0)))
            elif kind == "tpu_error" and len(args) >= 1:
                rules.append(("tpu_device_error", dict(
                    prob=float(args[0]),
                    device=args[1] if len(args) > 1 else "*")))
            elif kind == "crash" and len(args) >= 2:
                rules.append(("crash", dict(
                    prob=float(args[0]), site=args[1],
                    owner=args[2] if len(args) > 2 else "osd.*")))
            elif kind == "reorder" and len(args) >= 1:
                rules.append(("fsync_reorder", dict(
                    prob=float(args[0]),
                    owner=args[1] if len(args) > 1 else "*")))
            else:
                raise ValueError(f"bad fault rule {part.strip()!r}")
        with self._lock:
            self.clear(source=source)
            return [getattr(self, kind)(source=source, **kw)
                    for kind, kw in rules]

    # -- decision hooks (the wired layers call these) ----------------------

    def partitioned(self, src: str, dst: str) -> bool:
        if not self._have_net:
            return False
        with self._lock:
            for rule in self._rules.values():
                if rule.kind != "partition":
                    continue
                p = rule.params
                if (_match(p["a"], src) and _match(p["b"], dst)) or (
                        p["symmetric"] and _match(p["a"], dst)
                        and _match(p["b"], src)):
                    rule.hits += 1
                    return True
        return False

    def should_drop(self, src: str, dst: str) -> bool:
        if not self._have_net:
            return False
        with self._lock:
            for rule in self._rules.values():
                if rule.kind != "drop":
                    continue
                p = rule.params
                if _match(p["src"], src) and _match(p["dst"], dst) and \
                        self._stream(f"net:{src}").random() < p["prob"]:
                    rule.hits += 1
                    self._note("drop", src, dst)
                    return True
        return False

    def send_delay(self, src: str, dst: str) -> float:
        if not self._have_net:
            return 0.0
        total = 0.0
        with self._lock:
            for rule in self._rules.values():
                if rule.kind != "delay":
                    continue
                p = rule.params
                if _match(p["src"], src) and _match(p["dst"], dst) and \
                        self._stream(f"net:{src}").random() < p["prob"]:
                    rule.hits += 1
                    total += p["secs"]
            if total:
                self._note("delay", src, dst, total)
        return total

    def should_kill_socket(self, src: str, dst: str,
                           conf_one_in: int = 0) -> bool:
        """Combines the legacy ms_inject_socket_failures config knob
        (the caller passes its value) with targeted socket_kill rules;
        all randomness comes from this registry's seeded streams."""
        if not self._have_net and not conf_one_in:
            return False
        with self._lock:
            rng = self._stream(f"net:{src}")
            if conf_one_in and rng.randrange(int(conf_one_in)) == 0:
                self._note("socket_kill", src, dst, "conf")
                return True
            for rule in self._rules.values():
                if rule.kind != "socket_kill":
                    continue
                p = rule.params
                if _match(p["src"], src) and _match(p["dst"], dst) and \
                        p["one_in"] > 0 and \
                        rng.randrange(p["one_in"]) == 0:
                    rule.hits += 1
                    self._note("socket_kill", src, dst, rule.id)
                    return True
        return False

    def recv_delay(self, src: str, dst: str, conf_prob: float,
                   conf_max: float) -> float:
        """Legacy ms_inject_delay_* knobs, seeded centrally."""
        if not conf_prob:
            return 0.0
        with self._lock:
            rng = self._stream(f"net:{dst}")
            if rng.random() < conf_prob:
                return rng.random() * conf_max
        return 0.0

    def should_store_eio(self, owner: str, oid: str,
                         conf_prob: float = 0.0) -> bool:
        if not self._have_store and not conf_prob:
            return False
        with self._lock:
            rng = self._stream(f"store:{owner or '?'}")
            if conf_prob and rng.random() < conf_prob:
                self._note("store_eio", owner, oid, "conf")
                return True
            for rule in self._rules.values():
                if rule.kind != "store_eio":
                    continue
                p = rule.params
                if _match(p["osd"], owner) and _match(p["oid"], oid) \
                        and rng.random() < p["prob"]:
                    rule.hits += 1
                    self._note("store_eio", owner, oid, rule.id)
                    return True
        return False

    def tpu_error(self, device=None) -> bool:
        """Roll the device-error rules.

        device=None is the untargeted query (plugin route guard, the
        whole-device degrade): only device="*" rules match it.  A
        device INDEX (the pipeline asks per dispatch lane) matches
        both "*" rules and rules targeting that index — a targeted
        rule never fires outside its chip, so one bad chip of eight
        quarantines one lane instead of degrading the codec."""
        if not self._have_tpu:
            return False
        with self._lock:
            for rule in self._rules.values():
                if rule.kind != "tpu_device_error":
                    continue
                pat = rule.params.get("device", "*")
                if device is None:
                    if pat != "*":
                        continue
                elif not _match(pat, str(device)):
                    continue
                if self._stream("tpu").random() < rule.params["prob"]:
                    rule.hits += 1
                    self._note("tpu_device_error", rule.id, device)
                    return True
        return False

    def should_crash(self, owner: str, site: str) -> bool:
        """Roll the crash rules for a named crash point on `owner`.

        A firing rule is ONE-SHOT — it removes itself — so the crashed
        daemon can be restarted against the same FaultSet without
        instantly crashing again (the Jepsen kill-restart cycle needs
        exactly one kill per installed rule)."""
        if not self._have_crash:
            return False
        with self._lock:
            fired = None
            for rule in self._rules.values():
                if rule.kind != "crash":
                    continue
                p = rule.params
                if _match(p["site"], site) and \
                        _match(p["owner"], owner or "?") and \
                        self._stream(f"crash:{owner or '?'}").random() \
                        < p["prob"]:
                    rule.hits += 1
                    self._note("crash", owner, site, rule.id)
                    fired = rule.id
                    break
            if fired is not None:
                del self._rules[fired]
                self._refresh_flags()
                return True
        return False

    def torn_keep_fraction(self, owner: str) -> float:
        """Seeded fraction of an un-fsynced write that survives a
        crash (the ALICE torn-write model): the store truncates the
        tail to this fraction before freezing, so the same seed
        reproduces the same torn record byte-for-byte."""
        with self._lock:
            return self._stream(f"crash:{owner or '?'}").random()

    def crash_tracking_armed(self, owner: str) -> bool:
        """Should `owner`'s store pay for crash bookkeeping (pre-image
        capture for the reordering model)?  True only when a crash or
        fsync_reorder rule could actually fire on this owner — a
        mon-only rule must not tax every OSD store's write path."""
        if not self._have_crash and not self._have_reorder:
            return False
        with self._lock:
            for rule in self._rules.values():
                if rule.kind == "crash" and \
                        _match(rule.params["owner"], owner or "?"):
                    return True
                if rule.kind == "fsync_reorder" and \
                        _match(rule.params["owner"], owner or "?"):
                    return True
        return False

    def torn_ops(self, owner: str, ops: list) -> tuple[list, bool]:
        """The ALICE torn-write model applied to a transaction's op
        list: returns (surviving ops, reorder_used).  With an
        fsync_reorder rule armed (consumed here, one-shot) a seeded
        SUBSET survives — out-of-order durability; otherwise a seeded
        prefix.  Shared by every store that tears KV commits."""
        if self.reorder_armed(owner):
            mask = self.torn_survivors(owner, len(ops))
            return [op for op, keep in zip(ops, mask) if keep], True
        keep = int(self.torn_keep_fraction(owner) * len(ops))
        return list(ops[:keep]), False

    def reorder_armed(self, owner: str) -> bool:
        """Consume an fsync_reorder rule for `owner`, if one matches:
        the crash firing right now should keep a seeded SUBSET of the
        un-fsync'd writes (out-of-order survival) instead of a prefix.
        One-shot, like the crash rule it rides with."""
        with self._lock:
            fired = None
            for rule in self._rules.values():
                if rule.kind != "fsync_reorder":
                    continue
                p = rule.params
                if _match(p["owner"], owner or "?") and \
                        self._stream(f"crash:{owner or '?'}").random() \
                        < p["prob"]:
                    rule.hits += 1
                    self._note("fsync_reorder", owner, rule.id)
                    fired = rule.id
                    break
            if fired is not None:
                del self._rules[fired]
                self._refresh_flags()
                return True
        return False

    def torn_survivors(self, owner: str, n: int) -> list[bool]:
        """Seeded per-write survival mask for the reordering model: of
        `n` writes buffered since the last fsync barrier, which landed
        on disk before power was lost.  Independent coin flips, so
        "durable B, lost earlier A" windows occur; deterministic per
        seed + owner call order."""
        with self._lock:
            rng = self._stream(f"crash:{owner or '?'}")
            return [rng.random() < 0.5 for _ in range(n)]

    # -- admin-socket glue -------------------------------------------------

    def register_asok(self, asok) -> None:
        """Hook the faults surface onto a daemon's AdminSocket."""
        asok.register("faults dump", lambda c: self.dump())
        asok.register(
            "faults install",
            lambda c: {"installed": self.install_from_spec(
                c.get("rules", ""), source=c.get("source", "asok"))})
        asok.register(
            "faults clear",
            lambda c: {"removed": self.clear(
                rule_id=c.get("id"), source=c.get("source"))})
        asok.register(
            "faults reseed",
            lambda c: (self.reseed(int(c.get("seed", 0))),
                       {"seed": self.seed})[1])


_global = FaultSet()


def get() -> FaultSet:
    return _global


def set_global(fs: FaultSet) -> FaultSet:
    global _global
    prev, _global = _global, fs
    return prev


def conf_observer() -> Callable:
    """A Config observer applying faultset_seed/faultset_rules; daemons
    register it so `injectargs --faultset-rules '...'` takes effect."""
    def handler(conf, changed: set[str]) -> None:
        if "faultset_seed" in changed:
            get().reseed(int(conf.faultset_seed))
        if "faultset_rules" in changed:
            get().install_from_spec(str(conf.faultset_rules),
                                    source="conf")
    return handler
