"""Open-loop multi-tenant load harness (the "millions of users" probe).

bench.py's closed-loop rows measure how fast ONE submitter can push
the pipeline; a serving system is judged by what happens when load
ARRIVES ON ITS OWN CLOCK.  This generator is:

  * **open-loop** — every op has a scheduled arrival time drawn from a
    Poisson process at the tenant's configured rate; arrivals never
    wait for completions, so a slow cluster grows queue depth (and the
    latency distribution shows it) instead of silently throttling the
    offered load.  Latency is measured from the SCHEDULED arrival, not
    the submit instant — the standard guard against coordinated
    omission.
  * **seeded** — the full schedule (arrival times, op kinds, object
    choices, payload content) is a pure function of the seed, so a
    perf regression reproduces under the same op stream and two runs
    are diffable row by row.
  * **multi-tenant** — each :class:`TenantSpec` is one pool/client
    pair with its own op mix, Zipf(s) object popularity (a hot head
    and a long tail, like real object traffic), payload size and
    arrival rate; tenants run on their OWN worker pools and client
    sessions, so client-side queuing can never fake server-side
    isolation (the QoS drills depend on that).

Reported per pool: p50/p99/p999/mean latency (ms), goodput (GB/s of
successful payload bytes), op/error/timeout counts, and a queue-depth
timeline (scheduled-minus-completed, sampled on a fixed cadence).

With ``phase_sources`` (the cluster's OSD op trackers, or callables
returning ``dump_historic_ops`` documents) the report also breaks the
measured latency down BY PHASE from the op tracing plane's spans:
queue wait (dmClock stalls included) vs device (EC pipeline phases)
vs journal/WAL vs replica-wait — so a p99 regression names the layer
that moved, not just the number.

Typical use (bench.py --load, tests/test_loadgen.py):

    spec = TenantSpec("gold", rate=50, duration=5.0, obj_count=64)
    gen = LoadGen([spec], seed=7)
    report = gen.run({"gold": ioctx})
    report["pools"]["gold"]["p99_ms"]
"""

from __future__ import annotations

import bisect
import math
import random
import threading
import time
from dataclasses import dataclass, field

# op kinds a schedule can carry; read_frac splits read vs write,
# append_frac carves appends out of the write share and delete_frac
# carves deletes out of its top end
OP_READ = "read"
OP_WRITE = "write_full"
OP_APPEND = "append"
OP_DELETE = "delete"


@dataclass(frozen=True)
class TenantSpec:
    """One tenant: a pool/door plus its traffic shape.

    ``pool`` is the key into the ``ioctxs`` map run() drives — for a
    front-door tenant it names the DOOR, not a rados pool (the value
    is any IoCtx-duck: a raw rados IoCtx, an
    :class:`~ceph_tpu_torch.client.RGWDoor` / ``SwiftDoor`` / ``CephFSDoor``,
    or this module's :class:`RBDImageDoor`).  ``door`` labels the
    tenant for per-door reporting ("rados", "s3", "swift", "cephfs",
    "rbd", ...).  A door without a native ``append`` serves appends as
    seeded full writes; one without ``remove_object`` serves deletes
    the same way — the SCHEDULE stays a pure function of the seed
    either way."""
    pool: str
    rate: float = 50.0          # mean op arrivals per second
    duration: float = 5.0       # seconds of offered load
    obj_count: int = 64         # object-name space ("obj00042")
    zipf_s: float = 1.1         # popularity skew (0 = uniform)
    read_frac: float = 0.5      # fraction of ops that are reads
    append_frac: float = 0.0    # fraction of WRITES that are appends
    delete_frac: float = 0.0    # fraction of WRITES that are deletes
    payload: int = 16384        # bytes per write
    append_bytes: int = 2048    # bytes per append
    max_workers: int = 32       # tenant-local submission concurrency
    door: str = "rados"         # report label for per-door breakdowns
    retry_window: float = 0.0   # seconds an op retries ETIMEDOUT (110)
    # before counting as an error — front doors speak HTTP, where a
    # degraded-window 5xx maps to ETIMEDOUT and the DOOR, not an
    # objecter, owns the resend.  Latency stays measured from the
    # SCHEDULED arrival (retries included: no coordinated omission).
    # (per-op deadlines belong to the client stack — conf
    # objecter_op_timeout; ops failing with errno 110 count as
    # timeouts in the report)


@dataclass
class _Op:
    t: float                    # scheduled arrival (relative seconds)
    pool: str
    kind: str
    oid: str
    body_seed: int


@dataclass
class _Rec:
    __slots__ = ("pool", "kind", "lat", "nbytes", "ok", "timeout",
                 "t", "stale")
    pool: str
    kind: str
    lat: float
    nbytes: int
    ok: bool
    timeout: bool
    t: float                # scheduled arrival (windowed reports)
    stale: bool             # verify mode: read served provably old/
                            # unknown bytes (see _Verifier)


def _zipf_cdf(n: int, s: float) -> list[float]:
    if s <= 0:
        return [(i + 1) / n for i in range(n)]
    weights = [1.0 / (i + 1) ** s for i in range(n)]
    total = sum(weights)
    acc, out = 0.0, []
    for w in weights:
        acc += w / total
        out.append(acc)
    out[-1] = 1.0
    return out


class _Verifier:
    """Stale-read oracle for verify-mode runs (the storm drill's
    zero-stale-bytes gate).

    Every write_full payload starts with its 8-byte body_seed, so the
    first 8 bytes of any read identify WHICH write's state the read
    observed (appends extend a base write without changing its
    header).  Per (pool, oid) the verifier records each write's
    [submit, ack] interval; a read that began at ``rs`` and observed
    write ``w`` is STALE when some other write ``w'`` was fully acked
    before the read began AND ``w`` was fully acked before ``w'`` was
    even submitted — i.e. the read returned state that had been
    strictly superseded before it started (the standard interval
    check; concurrent or in-flight writes are never false positives).
    A header matching no recorded write at all (torn/foreign bytes)
    is always stale.

    DELETES are ops in the same interval algebra: an absent read
    (door-native ENOENT) observes the state of some recorded delete,
    judged by the identical superseding rule — absence with no
    recorded delete at all is always stale (the object was warmed
    into existence), and absence after a delete that was strictly
    superseded by a fully-acked write is a stale tombstone."""

    # delete ops keyed apart from write seeds (which are ints)
    _DEL = "del"

    def __init__(self):
        self._lock = threading.Lock()
        # (pool, oid) -> {op_key: [submit_t, ack_t_or_None]} where
        # op_key is a write's int seed or (_DEL, n) for a delete
        self._writes: dict[tuple, dict] = {}

    def note_warm(self, pool: str, oid: str, seed: int) -> None:
        with self._lock:
            self._writes.setdefault((pool, oid), {})[seed] = [-1.0, 0.0]

    def note_submit(self, pool: str, oid: str, seed: int,
                    now: float) -> None:
        with self._lock:
            self._writes.setdefault((pool, oid), {})[seed] = [now, None]

    def note_ack(self, pool: str, oid: str, seed: int,
                 now: float) -> None:
        with self._lock:
            ent = self._writes.get((pool, oid), {}).get(seed)
            if ent is not None:
                ent[1] = now

    def note_delete_submit(self, pool: str, oid: str, n: int,
                           now: float) -> None:
        self.note_submit(pool, oid, (self._DEL, n), now)

    def note_delete_ack(self, pool: str, oid: str, n: int,
                        now: float) -> None:
        self.note_ack(pool, oid, (self._DEL, n), now)

    def _superseded(self, writes: dict, mine: list,
                    read_submit: float) -> bool:
        if mine[1] is None:
            return False                  # still in flight: current
        for other in writes.values():
            sub, ack = other
            if ack is None or other is mine:
                continue
            if ack < read_submit and mine[1] < sub:
                return True               # strictly superseded first
        return False

    def judge_read(self, pool: str, oid: str, data: bytes,
                   read_submit: float) -> bool:
        """True when the read observed stale (superseded or unknown)
        bytes."""
        if len(data) < 8:
            return True
        seed = int.from_bytes(data[:8], "little")
        with self._lock:
            writes = dict(self._writes.get((pool, oid), {}))
        mine = writes.get(seed)
        if mine is None:
            return True                   # bytes of no recorded write
        return self._superseded(writes, mine, read_submit)

    def judge_absent(self, pool: str, oid: str,
                     read_submit: float) -> bool:
        """True when an ENOENT read is a STALE observation: no delete
        was ever recorded for the object, or every recorded delete
        was strictly superseded by a fully-acked write before the
        read began."""
        with self._lock:
            writes = dict(self._writes.get((pool, oid), {}))
        deletes = [v for k, v in writes.items()
                   if isinstance(k, tuple) and k[0] == self._DEL]
        if not deletes:
            return True                   # absence of no recorded op
        return all(self._superseded(writes, d, read_submit)
                   for d in deletes)


def _payload_bytes(seed: int, size: int) -> bytes:
    """Deterministic, distinct-per-seed payload, cheap to build: an
    8-byte counter header over a repeating seed-derived block (content
    verification only needs per-version distinctness, not entropy)."""
    if size <= 0:
        return b""
    block = seed.to_bytes(8, "little", signed=False) * 512
    reps = -(-size // len(block))
    return (block * reps)[:size]


class LoadGen:
    """Seeded open-loop generator over a set of tenants."""

    def __init__(self, tenants: list[TenantSpec], seed: int = 0,
                 sample_every: float = 0.1):
        self.tenants = list(tenants)
        self.seed = int(seed)
        self.sample_every = float(sample_every)
        self.schedule = self._build_schedule()
        # set when run()'s timed window opens (after warm-up): storm
        # drills synchronize their kill schedule to THIS instant
        self.started = threading.Event()
        self.last_records: list[_Rec] = []

    # -- planning (pure function of the seed) ------------------------------

    def _build_schedule(self) -> list[_Op]:
        ops: list[_Op] = []
        for ti, spec in enumerate(self.tenants):
            rng = random.Random((self.seed << 16) ^ (ti * 0x9E3779B9))
            cdf = _zipf_cdf(spec.obj_count, spec.zipf_s)
            t = 0.0
            i = 0
            while True:
                # Poisson arrivals: exponential inter-arrival gaps
                t += rng.expovariate(spec.rate) if spec.rate > 0 \
                    else spec.duration + 1
                if t >= spec.duration:
                    break
                u = rng.random()
                oid = f"obj{bisect.bisect_left(cdf, rng.random()):05d}"
                if u < spec.read_frac:
                    kind = OP_READ
                else:
                    # ONE draw splits the write share three ways
                    # (append low end, delete top end) so tenants
                    # with delete_frac=0 keep byte-identical
                    # schedules from older seeds
                    w = rng.random()
                    if w < spec.append_frac:
                        kind = OP_APPEND
                    elif w >= 1.0 - spec.delete_frac:
                        kind = OP_DELETE
                    else:
                        kind = OP_WRITE
                ops.append(_Op(t, spec.pool, kind, oid,
                               body_seed=(self.seed << 20)
                               ^ (ti << 16) ^ i))
                i += 1
        ops.sort(key=lambda op: op.t)
        return ops

    def offered(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for op in self.schedule:
            out[op.pool] = out.get(op.pool, 0) + 1
        return out

    # -- execution ---------------------------------------------------------

    # span name -> canonical phase bucket for the report breakdown
    PHASE_BUCKETS = {
        "queue": "queue",
        "ec.coalesce": "device", "ec.stage_h2d": "device",
        "ec.device_compute": "device", "ec.d2h": "device",
        "ec.host_encode": "device",
        "journal": "journal", "wal": "journal",
        "store_apply": "journal",
        "replica_wait": "replica",
        # serve-during-repair: time an op sat parked on a missing
        # object's recovery pull (the blocked-op span)
        "recovery_wait": "recovery",
        "execute": "execute",
    }

    def run(self, ioctxs: dict[str, object],
            warm: bool = True, phase_sources: list | None = None,
            verify: bool = False) -> dict:
        """Drive the schedule against `ioctxs` ({pool: IoCtx-like}).

        `warm` pre-creates every object a READ can hit (a read against
        a never-written object would measure ENOENT, not service) —
        one seeded write per object, outside the timed window.

        `phase_sources` — OpTracker-like objects (anything with
        ``dump_historic_ops``) or callables returning such a dump —
        adds the per-phase latency breakdown to the report, computed
        over the client ops the daemons traced DURING this run.

        `verify` arms the stale-read oracle (:class:`_Verifier`):
        every read's content is judged against the write intervals the
        run itself recorded, and the report carries per-pool
        ``stale_reads`` — the storm drill's zero-stale-bytes gate.

        Returns the report dict (see :meth:`_report`).  The raw
        records survive as ``self.last_records`` (scheduled-arrival-
        stamped) so :meth:`window_report` can slice percentiles for a
        sub-window, e.g. DURING a recovery storm."""
        from concurrent.futures import ThreadPoolExecutor
        specs = {s.pool: s for s in self.tenants}
        verifier = _Verifier() if verify else None
        if warm:
            for spec in self.tenants:
                io = ioctxs[spec.pool]
                for i in range(spec.obj_count):
                    io.write_full(
                        f"obj{i:05d}",
                        _payload_bytes(i ^ 0x5EED, spec.payload))
                    if verifier is not None:
                        verifier.note_warm(spec.pool, f"obj{i:05d}",
                                           i ^ 0x5EED)
        pools = {}
        for spec in self.tenants:
            pools[spec.pool] = {
                "exec": ThreadPoolExecutor(
                    max_workers=spec.max_workers,
                    thread_name_prefix=f"load-{spec.pool}"),
                "scheduled": 0, "done": 0}
        records: list[_Rec] = []
        rec_lock = threading.Lock()
        depth_samples: dict[str, list] = {s.pool: []
                                          for s in self.tenants}
        stop = threading.Event()
        t0 = time.monotonic()
        self.started.set()

        def sampler():
            while not stop.is_set():
                now = time.monotonic() - t0
                for pool, st in pools.items():
                    depth_samples[pool].append(
                        (round(now, 3),
                         st["scheduled"] - st["done"]))
                stop.wait(self.sample_every)

        def execute(op: _Op, spec: TenantSpec):
            io = ioctxs[op.pool]
            kind = op.kind
            # door fallbacks keep one seeded schedule universal: a
            # door without .append serves appends as seeded full
            # writes, one without .remove_object serves deletes the
            # same way (the schedule itself never changes).  Tenants
            # mixing deletes also serve appends as full writes: an
            # append RECREATING a just-deleted object would put bytes
            # at the header position the oracle never recorded
            if kind == OP_APPEND and (spec.delete_frac > 0
                                      or not hasattr(io, "append")):
                kind = OP_WRITE
            if kind == OP_DELETE and not hasattr(io, "remove_object"):
                kind = OP_WRITE
            deadline = time.monotonic() + max(0.0, spec.retry_window)
            while True:
                ok, timeout, nbytes, stale = True, False, 0, False
                submit = time.monotonic() - t0
                try:
                    if kind == OP_READ:
                        try:
                            data = io.read(op.oid)
                        except Exception as e:
                            if (getattr(e, "errno", None) == 2
                                    and spec.delete_frac > 0):
                                # door-native absence on a pool that
                                # schedules deletes: judged by the
                                # delete intervals, never an error
                                if verifier is not None:
                                    stale = verifier.judge_absent(
                                        op.pool, op.oid, submit)
                            else:
                                raise
                        else:
                            nbytes = len(data)
                            if verifier is not None:
                                stale = verifier.judge_read(
                                    op.pool, op.oid, bytes(data[:8]),
                                    submit)
                    elif kind == OP_APPEND:
                        body = _payload_bytes(op.body_seed,
                                              spec.append_bytes)
                        io.append(op.oid, body)
                        nbytes = len(body)
                    elif kind == OP_DELETE:
                        if verifier is not None:
                            verifier.note_delete_submit(
                                op.pool, op.oid, op.body_seed, submit)
                        try:
                            io.remove_object(op.oid)
                        except Exception as e:
                            # already gone counts as applied
                            if getattr(e, "errno", None) != 2:
                                raise
                        if verifier is not None:
                            verifier.note_delete_ack(
                                op.pool, op.oid, op.body_seed,
                                time.monotonic() - t0)
                    else:
                        body = _payload_bytes(op.body_seed,
                                              spec.payload)
                        if verifier is not None:
                            verifier.note_submit(op.pool, op.oid,
                                                 op.body_seed, submit)
                        io.write_full(op.oid, body)
                        nbytes = len(body)
                        if verifier is not None:
                            verifier.note_ack(op.pool, op.oid,
                                              op.body_seed,
                                              time.monotonic() - t0)
                except Exception as e:
                    ok = False
                    timeout = getattr(e, "errno", None) == 110
                    # HTTP doors surface a degraded-window 5xx as
                    # errno 110 with no objecter resend behind them —
                    # the tenant's retry_window owns the resend here.
                    # Verifier stamps are per-attempt; latency still
                    # runs from the SCHEDULED arrival, so retries
                    # show up in the tail, not as omitted samples.
                    if timeout and time.monotonic() < deadline:
                        time.sleep(0.05)
                        continue
                break
            # open-loop latency: from the SCHEDULED arrival — client-
            # side queuing (all workers busy) counts, as it must
            lat = (time.monotonic() - t0) - op.t
            with rec_lock:
                records.append(_Rec(op.pool, kind, lat, nbytes,
                                    ok, timeout, op.t, stale))
                # under rec_lock: a bare += from max_workers threads
                # loses increments and inflates the depth timeline
                pools[op.pool]["done"] += 1

        smp = threading.Thread(target=sampler, daemon=True,
                               name="loadgen-sampler")
        smp.start()
        try:
            for op in self.schedule:
                delay = op.t - (time.monotonic() - t0)
                if delay > 0:
                    time.sleep(delay)
                st = pools[op.pool]
                st["scheduled"] += 1
                st["exec"].submit(execute, op, specs[op.pool])
            for pool, st in pools.items():
                st["exec"].shutdown(wait=True)
        finally:
            stop.set()
            smp.join(timeout=2)
        wall = time.monotonic() - t0
        self.last_records = list(records)
        report = self._report(records, depth_samples, wall)
        if phase_sources:
            report["phases"] = self._phase_breakdown(
                phase_sources, since=t0)
        return report

    def window_report(self, t0: float, t1: float) -> dict:
        """Per-pool latency/ops/stale slice over records whose
        SCHEDULED arrival fell in [t0, t1) seconds of the last run —
        how the cluster served clients DURING a storm, not averaged
        across calm bookends."""
        out: dict[str, dict] = {}
        by_pool: dict[str, list[_Rec]] = {}
        for r in getattr(self, "last_records", []):
            if t0 <= r.t < t1:
                by_pool.setdefault(r.pool, []).append(r)
        for pool, recs in sorted(by_pool.items()):
            lats = sorted(r.lat for r in recs if r.ok)
            out[pool] = {
                "ops": len(recs),
                "errors": sum(1 for r in recs if not r.ok),
                "stale_reads": sum(1 for r in recs if r.stale),
                "p50_ms": round(self._pct(lats, 0.50) * 1e3, 2),
                "p99_ms": round(self._pct(lats, 0.99) * 1e3, 2),
                "p999_ms": round(self._pct(lats, 0.999) * 1e3, 2),
                "mean_ms": round(sum(lats) / len(lats) * 1e3, 2)
                if lats else 0.0,
            }
        return out

    # -- per-phase breakdown (op tracing plane) ----------------------------

    @classmethod
    def _phase_breakdown(cls, sources: list, since: float = 0.0) -> dict:
        """Aggregate span durations from the daemons' historic op
        dumps into the canonical phase buckets (queue / device /
        journal / replica / execute / other), over client ops traced
        since `since` (monotonic).  Per bucket: op count, mean and
        p50/p99 of the per-op TOTAL time spent in that phase."""
        per_op: dict[str, dict[str, float]] = {}
        for src in sources:
            fn = getattr(src, "dump_historic_ops", None)
            doc = fn() if fn is not None else src()
            for op in doc.get("ops", []):
                if op.get("kind", "client") != "client":
                    continue
                if float(op.get("mstart", 0.0)) < since:
                    continue
                key = (f"{op.get('daemon', '')}/"
                       f"{op.get('trace_id') or id(op)}")
                tot = per_op.setdefault(key, {})
                for sp in op.get("spans", []):
                    bucket = cls.PHASE_BUCKETS.get(
                        sp.get("name", ""), "other")
                    dur = max(0.0, float(sp.get("t1", 0.0))
                              - float(sp.get("t0", 0.0)))
                    tot[bucket] = tot.get(bucket, 0.0) + dur
        buckets: dict[str, list[float]] = {}
        for tot in per_op.values():
            for bucket, dur in tot.items():
                buckets.setdefault(bucket, []).append(dur)
        out = {}
        for bucket, durs in sorted(buckets.items()):
            durs.sort()
            out[bucket] = {
                "ops": len(durs),
                "mean_ms": round(sum(durs) / len(durs) * 1e3, 3),
                "p50_ms": round(cls._pct(durs, 0.50) * 1e3, 3),
                "p99_ms": round(cls._pct(durs, 0.99) * 1e3, 3),
            }
        return out

    # -- reporting ---------------------------------------------------------

    @staticmethod
    def _pct(sorted_lats: list[float], q: float) -> float:
        if not sorted_lats:
            return 0.0
        idx = min(len(sorted_lats) - 1,
                  max(0, math.ceil(q * len(sorted_lats)) - 1))
        return sorted_lats[idx]

    def _report(self, records: list[_Rec],
                depth_samples: dict[str, list],
                wall: float) -> dict:
        doors = {s.pool: s.door for s in self.tenants}
        by_pool: dict[str, list[_Rec]] = {}
        for r in records:
            by_pool.setdefault(r.pool, []).append(r)
        pools = {}
        all_lats: list[float] = []
        total_bytes = 0
        for pool, recs in sorted(by_pool.items()):
            lats = sorted(r.lat for r in recs if r.ok)
            all_lats.extend(lats)
            good = sum(r.nbytes for r in recs if r.ok)
            total_bytes += good
            depths = [d for _t, d in depth_samples.get(pool, [])]
            pools[pool] = {
                "door": doors.get(pool, "rados"),
                "ops": len(recs),
                "errors": sum(1 for r in recs if not r.ok),
                "stale_reads": sum(1 for r in recs if r.stale),
                "timeouts": sum(1 for r in recs if r.timeout),
                "reads": sum(1 for r in recs if r.kind == OP_READ),
                "writes": sum(1 for r in recs
                              if r.kind != OP_READ),
                "deletes": sum(1 for r in recs
                               if r.kind == OP_DELETE),
                "p50_ms": round(self._pct(lats, 0.50) * 1e3, 2),
                "p99_ms": round(self._pct(lats, 0.99) * 1e3, 2),
                "p999_ms": round(self._pct(lats, 0.999) * 1e3, 2),
                "mean_ms": round(
                    sum(lats) / len(lats) * 1e3, 2) if lats else 0.0,
                "goodput_gbs": round(good / wall / 1e9, 5),
                "queue_depth_max": max(depths, default=0),
                "queue_depth_mean": round(
                    sum(depths) / len(depths), 1) if depths else 0.0,
            }
        # per-DOOR rollup: tenants sharing a door label (e.g. two S3
        # buckets) merge here, so mixed-door runs report one latency
        # profile per front door regardless of tenant layout
        by_door: dict[str, list[_Rec]] = {}
        for r in records:
            by_door.setdefault(doors.get(r.pool, "rados"),
                               []).append(r)
        door_out = {}
        for door, recs in sorted(by_door.items()):
            lats = sorted(r.lat for r in recs if r.ok)
            good = sum(r.nbytes for r in recs if r.ok)
            door_out[door] = {
                "ops": len(recs),
                "errors": sum(1 for r in recs if not r.ok),
                "stale_reads": sum(1 for r in recs if r.stale),
                "p50_ms": round(self._pct(lats, 0.50) * 1e3, 2),
                "p99_ms": round(self._pct(lats, 0.99) * 1e3, 2),
                "p999_ms": round(self._pct(lats, 0.999) * 1e3, 2),
                "goodput_gbs": round(good / wall / 1e9, 5),
            }
        all_lats.sort()
        return {
            "seed": self.seed,
            "wall_s": round(wall, 3),
            "offered": self.offered(),
            "completed": len(records),
            "p50_ms": round(self._pct(all_lats, 0.50) * 1e3, 2),
            "p99_ms": round(self._pct(all_lats, 0.99) * 1e3, 2),
            "p999_ms": round(self._pct(all_lats, 0.999) * 1e3, 2),
            "goodput_gbs": round(total_bytes / wall / 1e9, 5),
            "pools": pools,
            "doors": door_out,
            "queue_depth": {p: s[-50:] for p, s in
                            depth_samples.items()},
        }


# ---------------------------------------------------------------------------
# Recovery-storm drill: LoadGen x FaultSet-style OSD kill under load
# ---------------------------------------------------------------------------


def run_recovery_storm(cluster, ioctxs: dict, tenants: list[TenantSpec],
                       seed: int = 0, victim: int | None = None,
                       kill_at: float = 1.0, revive_after: float = 1.5,
                       ledger_oids: int = 2,
                       clean_timeout: float = 180.0) -> dict:
    """The serve-during-repair SLO probe: kill an OSD under steady
    multi-tenant open-loop load, revive it, and measure what clients
    experienced WHILE the cluster repaired itself.

    Composition of this module's :class:`LoadGen` (verify mode: every
    read judged by the stale-read oracle) with the cluster kill plane
    (``MiniCluster.kill_osd`` — abrupt, store frozen as-is; the reborn
    daemon rewinds/backfills under the ``@recovery`` dmClock class
    when ``osd_qos_recovery`` is configured).  A small
    :class:`~ceph_tpu_torch.client.DurabilityLedger` stream rides along on
    the first pool (disjoint ``ldg-*`` oids) so acked-write
    durability is oracle-verified through the same storm.

    Reports, per pool: the full-run latency profile, the profile of
    the STORM WINDOW only (kill -> cluster clean), error/stale
    counts; plus recovery wall time (rebirth -> active+clean),
    summed recovery-blocked/unblocked/promotion counters and the
    ``@recovery`` class's grants/stalls across the live daemons, and
    the ledger verdict.  Seeded: the offered schedule and the kill
    instant are pure functions of the arguments."""
    import threading as _threading

    from ..client import DurabilityLedger

    if victim is None:
        victim = sorted(cluster.osds)[-1]
    first_pool = tenants[0].pool
    ledger = DurabilityLedger()
    retry = lambda: cluster.tick(0.3)            # noqa: E731
    for i in range(ledger_oids):
        ledger.write(ioctxs[first_pool], f"ldg-{i}",
                     f"pre-storm-{i}-".encode() * 40,
                     retry_window=60, on_retry=retry)

    gen = LoadGen(tenants, seed=seed)
    result: dict = {}
    err: list = []

    def _load():
        try:
            result["report"] = gen.run(ioctxs, verify=True)
        except Exception as e:                   # pragma: no cover
            err.append(e)

    loader = _threading.Thread(target=_load, daemon=True,
                               name="storm-load")
    # accelerated virtual time while the storm runs: down detection /
    # auto-out ride the heartbeat grace on the cluster's ManualClock,
    # and the drill must not serialize real minutes waiting for it
    tick_stop = _threading.Event()

    def _ticker():
        while not tick_stop.is_set():
            cluster.tick(0.25)
            tick_stop.wait(0.05)

    ticker = _threading.Thread(target=_ticker, daemon=True,
                               name="storm-ticker")
    loader.start()
    if not gen.started.wait(60.0):
        # warm-up never completed (slow host, or gen.run died before
        # opening the measurement window): killing the OSD now would
        # land the storm on warm writes and desynchronize every
        # window-relative number — surface the real problem instead
        tick_stop.set()
        loader.join(timeout=10)
        if err:
            raise err[0]
        raise RuntimeError("recovery storm: load warm-up did not "
                           "complete within 60s")
    t0 = time.monotonic()
    ticker.start()
    try:
        time.sleep(max(0.0, kill_at))
        kill_rel = time.monotonic() - t0
        cluster.kill_osd(victim)
        cluster.wait_for_osd_down(victim, timeout=60)
        # an acked mutation DURING the degraded window joins the
        # ledger stream — the "deg: ACKED write lost" class must not
        # survive the reborn peer's claim adoption
        ledger.write(ioctxs[first_pool], "ldg-deg",
                     b"degraded-storm-write" * 30,
                     retry_window=90, on_retry=retry)
        time.sleep(max(0.0, revive_after))
        rebirth = time.monotonic()
        cluster.start_osd(victim)
        loader.join(timeout=sum(t.duration for t in tenants) + 120)
        cluster.wait_for_clean(clean_timeout)
        clean = time.monotonic()
    finally:
        tick_stop.set()
        ticker.join(timeout=2)
        loader.join(timeout=10)
    if err:
        raise err[0]
    storm_end_rel = clean - t0
    report = result["report"]

    # counters across the CURRENT daemons (the killed daemon's counts
    # died with it — blocked ops it held were client-resent): after
    # recovery quiesces, every surviving block must have resumed
    blocked = unblocked = promotions = 0
    rec_grants = rec_stalls = 0
    for osd in cluster.osds.values():
        dump = osd._perf_dump()
        blocked += dump["osd"]["recovery_blocked_ops"]
        unblocked += dump["osd"]["recovery_unblocked_ops"]
        promotions += dump["osd"]["recovery_prio_promotions"]
        rec = dump["qos"]["recovery"]
        rec_grants += rec["res_grants"] + rec["prop_grants"]
        rec_stalls += rec["throttle_stalls"]

    ledger_ok = True
    ledger_detail = ""
    try:
        ledger.verify(ioctxs[first_pool], retry_window=90,
                      on_retry=retry)
    except AssertionError as e:
        ledger_ok = False
        ledger_detail = str(e)

    pools = report["pools"]
    return {
        "seed": seed,
        "victim": victim,
        "kill_at_s": round(kill_rel, 3),
        "recovery_wall_s": round(clean - rebirth, 3),
        "storm_window_s": round(storm_end_rel - kill_rel, 3),
        "report": report,
        "storm": gen.window_report(kill_rel, storm_end_rel),
        "errors": sum(p["errors"] for p in pools.values()),
        "stale_reads": sum(p["stale_reads"] for p in pools.values()),
        "recovery_blocked_ops": blocked,
        "recovery_unblocked_ops": unblocked,
        "recovery_prio_promotions": promotions,
        "recovery_qos_grants": rec_grants,
        "recovery_qos_throttle_stalls": rec_stalls,
        "ledger_ok": ledger_ok,
        "ledger_detail": ledger_detail,
    }


# ---------------------------------------------------------------------------
# RBD front door: the block path as an IoCtx-duck
# ---------------------------------------------------------------------------


class RBDImageDoor:
    """IoCtx-duck over ONE open striped RBD :class:`~ceph_tpu_torch.rbd.Image`.

    Maps the generator's object-name space onto disjoint fixed-size
    SLOTS of the image's logical address space (``obj00042`` -> offset
    ``42 * slot_bytes``), so a block tenant rides the same seeded
    schedule as the object doors while its bytes take the librbd
    striping path (object-set fan-out, snap context, optional cache).
    Written lengths are tracked per slot so reads return exactly the
    bytes written — an RBD read of a never-written slot is all zeros,
    which is ENOENT in object-door terms.  No native ``append`` or
    ``remove_object``: the generator's fallbacks serve both as seeded
    full writes.  Size the image for ``obj_count * slot_bytes``."""

    def __init__(self, image, slot_bytes: int = 1 << 20):
        self.image = image
        self.slot_bytes = int(slot_bytes)
        self._lock = threading.Lock()
        self._lengths: dict[str, int] = {}

    def _off(self, oid: str) -> int:
        digits = "".join(ch for ch in oid if ch.isdigit())
        return int(digits or "0") * self.slot_bytes

    def write_full(self, oid: str, data: bytes) -> None:
        if len(data) > self.slot_bytes:
            raise ValueError(
                f"payload {len(data)} overflows slot_bytes "
                f"{self.slot_bytes}")
        self.image.write(self._off(oid), bytes(data))
        with self._lock:
            self._lengths[oid] = len(data)

    def read(self, oid: str) -> bytes:
        with self._lock:
            n = self._lengths.get(oid)
        if n is None:
            raise OSError(2, f"slot never written: {oid}")
        return self.image.read(self._off(oid), n)


# ---------------------------------------------------------------------------
# Front-door storm: mixed doors x zone partition x gateway crash x OSD kill
# ---------------------------------------------------------------------------


def run_frontdoor_storm(cluster, ioctxs: dict,
                        tenants: list[TenantSpec], zones: dict,
                        seed: int = 0, victim: int | None = None,
                        partition_at: float = 0.5,
                        osd_kill_at: float = 0.75,
                        gw_kill_at: float = 1.5,
                        revive_after: float = 1.5,
                        ledger_oids: int = 2,
                        clean_timeout: float = 180.0,
                        convergence_window: float = 120.0) -> dict:
    """Every front door under fire: drive one seeded mixed-door
    schedule (rados + S3/Swift + CephFS + RBD against ONE cluster)
    while a seeded fault script partitions the two RGW zones, kills
    the secondary-zone gateway mid-sync, and kills+rebirths an OSD —
    then prove the system degraded instead of lying.

    ``zones`` wires the multisite plane in::

        {"primary":   primary-zone RGWDaemon   (client-facing),
         "secondary": secondary-zone RGWDaemon (replica),
         "agent":     RGWSyncAgent pulling primary -> secondary,
         "respawn":   callable() -> (gw, agent) rebuilding the
                      secondary gateway ON ITS OLD PORT plus a fresh
                      STARTED agent (resumes from the durable
                      cursors at SYNC_STATE_OID)}

    Oracles stacked on the load: the per-read stale oracle
    (:class:`_Verifier`), and a :class:`~ceph_tpu_torch.client.TwoZoneLedger`
    over both zone gateways — every acked S3 object must eventually
    read bit-exact at the replica after heal, and an object DELETED at
    the primary while the zones were partitioned must never resurrect
    at either zone.  The faults land in order: partition the zone
    link, kill the OSD (degrading every door at once), delete+write
    through the primary while split, crash the secondary gateway,
    revive the OSD; after the load drains the partition heals, the
    gateway respawns, and the drill blocks on cluster clean + zone
    convergence.  Sync counters from BOTH agent incarnations are
    merged into the verdict so a test can assert backoff-not-wedge."""
    import threading as _threading

    from ..client import RGWDoor, TwoZoneLedger

    if victim is None:
        victim = sorted(cluster.osds)[-1]
    gw_a, gw_b = zones["primary"], zones["secondary"]
    agent = zones["agent"]
    retry = lambda: cluster.tick(0.3)            # noqa: E731

    zledger = TwoZoneLedger(
        RGWDoor(f"http://127.0.0.1:{gw_a.port}", bucket="zledger"),
        RGWDoor(f"http://127.0.0.1:{gw_b.port}", bucket="zledger"))
    for i in range(ledger_oids):
        zledger.write_primary(f"ldg-{i}",
                              f"pre-storm-{i}-".encode() * 40,
                              retry_window=60, on_retry=retry)
    # the object the storm will DELETE while the zones are split: it
    # must exist at BOTH zones first, else "never resurrected" is
    # vacuous (the replica would simply never have seen it)
    zledger.write_primary("zdel", b"doomed-object-" * 40,
                          retry_window=60, on_retry=retry)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        try:
            if zledger.replica.read("zdel"):
                break
        except Exception:
            pass
        cluster.tick(0.3)
        time.sleep(0.05)
    else:
        raise RuntimeError("frontdoor storm: 'zdel' never synced to "
                           "the replica zone pre-storm")

    gen = LoadGen(tenants, seed=seed)
    result: dict = {}
    err: list = []

    def _load():
        try:
            result["report"] = gen.run(ioctxs, verify=True)
        except Exception as e:                   # pragma: no cover
            err.append(e)

    loader = _threading.Thread(target=_load, daemon=True,
                               name="frontdoor-load")
    tick_stop = _threading.Event()

    def _ticker():
        while not tick_stop.is_set():
            cluster.tick(0.25)
            tick_stop.wait(0.05)

    ticker = _threading.Thread(target=_ticker, daemon=True,
                               name="frontdoor-ticker")
    loader.start()
    if not gen.started.wait(60.0):
        tick_stop.set()
        loader.join(timeout=10)
        if err:
            raise err[0]
        raise RuntimeError("frontdoor storm: load warm-up did not "
                           "complete within 60s")
    t0 = time.monotonic()
    ticker.start()
    from ..utils import faults as _faults
    fid = None
    old_agent_perf: dict = {}
    try:
        def _until(rel):
            time.sleep(max(0.0, rel - (time.monotonic() - t0)))

        _until(partition_at)
        fid = _faults.get().partition(agent.entity, agent.peer_entity)
        part_rel = time.monotonic() - t0
        _until(osd_kill_at)
        cluster.kill_osd(victim)
        cluster.wait_for_osd_down(victim, timeout=60)
        # mutations through the PRIMARY door while the zones are
        # split AND the cluster is degraded: the delete must
        # tombstone (not resurrect) at both zones after heal, and
        # the write must land bit-exact at the replica
        zledger.delete_primary("zdel", retry_window=90,
                               on_retry=retry)
        zledger.write_primary("ldg-deg", b"degraded-split-write" * 30,
                              retry_window=90, on_retry=retry)
        _until(gw_kill_at)
        # crash the secondary gateway + its agent mid-backoff: the
        # respawned pair must RESUME from the durable cursors, not
        # restart full sync from scratch or wedge.  "Mid-backoff"
        # needs the agent to have OBSERVED the severed link first —
        # a sync round already in flight when the partition landed
        # can run long under storm load, so gate on the first
        # recorded BACKOFF (bounded) instead of the wall clock.  An
        # error alone is not enough: a partition landing mid-round
        # increments sync_errors on each bucket retry before any
        # backoff exists, and killing the agent there is not
        # "mid-backoff" — backoff is recorded at round failure or
        # bucket quarantine, within one bounded round either way
        obs_deadline = time.monotonic() + 30.0
        while (agent.perf.dump().get("sync_backoff_secs", 0) <= 0
               and time.monotonic() < obs_deadline):
            time.sleep(0.05)
        old_agent_perf = agent.perf.dump()
        agent.shutdown()
        gw_b.shutdown()
        _until(gw_kill_at + revive_after)
        rebirth = time.monotonic()
        cluster.start_osd(victim)
        loader.join(timeout=sum(t.duration for t in tenants) + 120)
        # heal: link first, then the gateway, then block on repair
        _faults.get().clear(fid)
        fid = None
        gw_b, agent = zones["respawn"]()
        zones["secondary"], zones["agent"] = gw_b, agent
        cluster.wait_for_clean(clean_timeout)
        clean = time.monotonic()
    finally:
        if fid is not None:
            _faults.get().clear(fid)
        tick_stop.set()
        ticker.join(timeout=2)
        loader.join(timeout=10)
    if err:
        raise err[0]
    storm_end_rel = clean - t0
    report = result["report"]

    zone_ok, zone_detail, zone_stats = True, "", {}
    try:
        zone_stats = zledger.verify_zones(
            retry_window=90, convergence_window=convergence_window,
            on_retry=retry)
    except AssertionError as e:
        zone_ok = False
        zone_detail = str(e)

    # both incarnations of the sync agent count: the storm's verdict
    # is "backed off and resumed", never "wedged" or "tight-looped"
    sync = dict(old_agent_perf)
    for k, v in agent.perf.dump().items():
        sync[k] = sync.get(k, 0) + v

    pools = report["pools"]
    return {
        "seed": seed,
        "victim": victim,
        "partition_at_s": round(part_rel, 3),
        "recovery_wall_s": round(clean - rebirth, 3),
        "storm_window_s": round(storm_end_rel - part_rel, 3),
        "report": report,
        "doors": report["doors"],
        "storm": gen.window_report(part_rel, storm_end_rel),
        "errors": sum(p["errors"] for p in pools.values()),
        "stale_reads": sum(p["stale_reads"] for p in pools.values()),
        "sync": sync,
        "zone_ledger_ok": zone_ok,
        "zone_ledger_detail": zone_detail,
        "zone_ledger": zone_stats,
    }


# -- connection-scale storm (the thousands-of-sessions axis) --------------

def _proc_fd_count() -> int:
    import os
    return len(os.listdir("/proc/self/fd"))


def run_conn_storm(cluster, sessions: int, ops_per_session: int = 2,
                   churn_frac: float = 0.25, payload: int = 4096,
                   seed: int = 0, driver_threads: int = 32,
                   pool: str = "connstorm",
                   quiesce_timeout: float = 30.0) -> dict:
    """The connection-COUNT axis the op-rate harness above cannot see:
    open ``sessions`` full client stacks (messenger + monc + objecter
    each) against one cluster, hold them ALL open for a high-fan-in op
    round, then close everything and measure what the process keeps.

    What this exposes is the serving plane's per-session cost model:
    on the blocking stack every session pins a messenger thread, so
    ``peak_threads`` grows linearly with ``sessions``; on the async
    stack all sessions multiplex onto the fixed
    ``ms_async_op_threads`` worker pool and the peak is bounded by
    the DRIVER pool below, independent of ``sessions``.  The quiesce
    numbers are the churn-hygiene gate: after every session closes,
    threads and FDs must return to the pre-storm baseline — a leaked
    acceptor FD or an unjoined per-connection thread shows up here
    as residue, not as an eventual EMFILE in production.

    Seeded: churn picks and payload bytes are pure functions of
    ``seed``.  Sessions are opened/driven through a bounded pool of
    ``driver_threads`` workers so the measured concurrency is session
    count, not client-thread count.  A ``churn_frac`` slice of the
    sessions additionally open->op->close->reopen before settling,
    exercising the accept/teardown path under the storm itself.
    """
    from concurrent.futures import ThreadPoolExecutor

    from ..client.rados import Rados

    rng = random.Random(seed)
    churny = [rng.random() < churn_frac for _ in range(sessions)]
    bodies = [bytes([rng.randrange(256)]) * payload
              for _ in range(min(sessions, 64))]

    admin = Rados(cluster.monmap, "client.connadmin",
                  conf=cluster.conf)
    admin.connect()
    try:
        try:
            admin.create_pool(pool, pg_num=8)
        except Exception:
            pass                       # already there: reuse it
        aio = admin.open_ioctx(pool)
        end = time.time() + 60
        while True:
            try:
                aio.write_full("settle", b"s")
                break
            except Exception:
                if time.time() > end:
                    raise
                time.sleep(0.3)
        stats = admin.msgr.event_stats()

        # baseline AFTER the admin session + pool exist: the admin
        # stays open through the storm, so growth below is storm-owned
        base_threads = threading.active_count()
        base_fds = _proc_fd_count()

        lock = threading.Lock()
        lats: list[float] = []
        errors = [0]
        completed = [0]
        clients: list = [None] * sessions

        def _record(t0: float) -> None:
            dt = time.perf_counter() - t0
            with lock:
                lats.append(dt)
                completed[0] += 1

        def _one_op(cl, i: int, tag: str) -> None:
            io = cl.open_ioctx(pool)
            body = bodies[i % len(bodies)]
            t0 = time.perf_counter()
            try:
                io.write_full(f"cs-{i}-{tag}", body)
                got = io.read(f"cs-{i}-{tag}")
                assert got == body
                _record(t0)
            except Exception:
                with lock:
                    errors[0] += 1

        def _open(i: int) -> None:
            try:
                cl = Rados(cluster.monmap, f"client.conn{i}",
                           conf=cluster.conf)
                cl.connect()
                if churny[i]:          # churn: close + reopen first
                    _one_op(cl, i, "churn")
                    cl.shutdown()
                    # a fresh incarnation is a fresh entity: reusing
                    # the old name would replay (name, tid) reqids the
                    # OSD dup-filter already answered, swallowing the
                    # new incarnation's writes as duplicates
                    cl = Rados(cluster.monmap, f"client.conn{i}r",
                               conf=cluster.conf)
                    cl.connect()
                clients[i] = cl
            except Exception:
                with lock:
                    errors[0] += 1

        with ThreadPoolExecutor(driver_threads,
                                thread_name_prefix="conn-drv") as ex:
            list(ex.map(_open, range(sessions)))
            # every session is open RIGHT NOW: the fan-in peak
            peak_threads = threading.active_count()
            peak_fds = _proc_fd_count()
            hot_before = completed[0]
            t_hot0 = time.perf_counter()
            for r in range(ops_per_session):
                list(ex.map(
                    lambda i, _r=r: (clients[i] is not None
                                     and _one_op(clients[i], i,
                                                 f"hot{_r}")),
                    range(sessions)))
            hot_wall = max(time.perf_counter() - t_hot0, 1e-9)
            hot_done = completed[0] - hot_before
            list(ex.map(
                lambda i: clients[i] is not None
                and clients[i].shutdown(), range(sessions)))

        # quiesce: threads/FDs must decay back to the baseline (the
        # driver pool itself just exited above)
        end = time.time() + quiesce_timeout
        while time.time() < end:
            if threading.active_count() <= base_threads and \
                    _proc_fd_count() <= base_fds:
                break
            time.sleep(0.1)
        quiesce_threads = threading.active_count()
        quiesce_fds = _proc_fd_count()
    finally:
        admin.shutdown()

    lats.sort()
    return {
        "seed": seed,
        "ms_type": stats["type"],
        "event_workers": stats["workers"],
        "sessions": sessions,
        "churned": sum(churny),
        "completed": completed[0],
        "expected": sessions * ops_per_session + sum(churny),
        "errors": errors[0],
        "p50_ms": round(LoadGen._pct(lats, 0.50) * 1e3, 3),
        "p99_ms": round(LoadGen._pct(lats, 0.99) * 1e3, 3),
        "goodput_mbs": round(hot_done * payload * 2
                             / hot_wall / 1e6, 3),
        "base_threads": base_threads,
        "peak_threads": peak_threads,
        "quiesce_threads": quiesce_threads,
        "base_fds": base_fds,
        "peak_fds": peak_fds,
        "quiesce_fds": quiesce_fds,
    }
