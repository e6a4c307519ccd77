"""Op tracing plane: TrackedOp spans, in-flight/historic dumps,
slow-op accounting, and the crash-scoped flight recorder.

The TrackedOp/OpTracker analog (common/TrackedOp.{h,cc},
osd/OpRequest.cc) grown from an event timeline into a span tracer:

  * every client op carries a **trace id** (``"<client>:<tid>"``) and a
    list of named **spans** — [t0, t1) intervals on the process-wide
    monotonic clock — stamped by every layer the op crosses: messenger
    receive -> op-shard queue wait (dmClock stalls included, tagged
    with the pool service class), execution, EC pipeline phases
    (coalesce wait, H2D staging, device compute, D2H fetch — or the
    host drain), journal/WAL append+fsync, and the replica sub-op
    round trip.  Sub-ops and recovery pushes carry the SAME trace id
    over the wire (a plain CTM2 frame field), so per-daemon dumps
    correlate into one cross-daemon timeline
    (tools/trace_dump.py -> chrome://tracing / Perfetto).
  * two clocks on purpose: ``start``/``age`` ride the daemon's
    injectable Clock (slow-op complaint math stays deterministic under
    the test ManualClock), while span endpoints ride
    ``time.monotonic()`` (real latency attribution; one process-wide
    timebase means per-daemon dumps merge without offset fixups).
  * each tracker keeps a bounded in-flight table, a historic ring
    (``osd_op_history_size`` / ``osd_op_history_duration``) and a
    separate slow-op ring (ops that crossed ``osd_op_complaint_time``),
    behind ``dump_ops_in_flight`` / ``dump_historic_ops`` /
    ``dump_historic_slow_ops``.
  * deep layers attach spans WITHOUT parameter threading: the op shard
    publishes its op via :func:`set_current`, and e.g. the filestore
    journal calls ``with optracker.span("journal"): ...`` — the op
    stamp is skipped when no op is current (internal work, untracked
    paths).
  * every :func:`span` is also counted where no op is current: its
    seconds go to a process-wide total for its name (Ceph's time-avg
    avgcount/sum, :func:`span_totals`) and to the calling thread's
    *work* or *wait* seconds (:data:`WAIT_SPANS` names the waits) when
    the thread bound a :class:`ThreadTotals` (the EC pipeline's
    threads do).  While a torch profiler records, the span is also a
    range on its thread (a CPU op, not a user annotation), on the
    device trace's clock; :data:`WORK_SPANS` names the EC path's work
    spans for a trace reader.  An EC pipeline item's phases run from a
    stamp on one thread to a stamp on another: :func:`phase_spans`
    turns the stamps into the spans that tile the item's life.

The **flight recorder** turns "rerun and hope" into a captured
timeline: daemons register dump callables; when armed (conf
``flight_recorder_dir``) a fired CrashPoint or a DurabilityLedger
verify failure snapshots EVERY registered daemon's in-flight +
historic ops (plus its pg log summaries) into a per-incident
directory, ready for ``tools/trace_dump.py``.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from contextlib import contextmanager

import torch
from torch.autograd import profiler as _torch_profiler

# ---------------------------------------------------------------------------
# thread-local current op: how deep layers (stores, ecutil) attach
# spans to whatever op their thread is executing
# ---------------------------------------------------------------------------

_tls = threading.local()


def set_current(op: "TrackedOp | None") -> None:
    _tls.op = op


def current() -> "TrackedOp | None":
    return getattr(_tls, "op", None)


@contextmanager
def op_context(op: "TrackedOp | None"):
    """Publish `op` as the thread's current op for the block (nested
    publishes restore the outer op on exit)."""
    prev = current()
    set_current(op)
    try:
        yield op
    finally:
        set_current(prev)


# The EC path's spans, by what the thread does in them.  A wait span is
# a thread blocked on another thread or on the card; every other span
# is work.  The op thread's spans are opened in osd/ecutil.py,
# erasure/plugin_tpu.py and ops/hbm_cache.py, the pipeline threads' in
# ops/pipeline.py.
WAIT_SPANS = frozenset({
    "ec.result_wait",      # op thread: in the pipeline future's result()
    "ec.window_full",      # dispatcher: every lane's window full
    "ec.pin_wait",         # stager: a pinned buffer's last upload
    "ec.event_wait",       # collector: the dispatch's compute event
})
WORK_SPANS = (
    "ec.arena", "ec.stage_copy", "ec.shard_layout", "ec.cache_commit",
    "ec.pick", "ec.stage_h2d", "ec.launch", "ec.d2h", "ec.cache_stage",
    "ec.resolve", "ec.host_encode",
)

_totals_lock = threading.Lock()
_span_totals: dict[str, list] = {}     # name -> [avgcount, sum]
# (name, seconds) of closed spans not yet in _span_totals: a close
# appends here without a lock (a deque's append is atomic), so no span
# waits on a lock another thread holds across a switch of the
# interpreter lock; the totals fold in batches
_closed: deque = deque()
FOLD_AT = 4096


def _fold() -> None:
    with _totals_lock:
        while _closed:
            name, d = _closed.popleft()
            tot = _span_totals.get(name)
            if tot is None:
                _span_totals[name] = [1, d]
            else:
                tot[0] += 1
                tot[1] += d


class ThreadTotals:
    """One thread's seconds in work spans and in wait spans (each
    second counted once: a span nested in another is taken out of the
    outer one's), and its CPU seconds as of its last :meth:`sample`.
    Only the thread that bound it writes it."""

    __slots__ = ("work_s", "wait_s", "cpu_s", "_cpu0", "_inner")

    def __init__(self):
        self.work_s = 0.0
        self.wait_s = 0.0
        self.cpu_s = 0.0
        self._cpu0 = 0.0
        self._inner: list = []   # open spans' nested seconds, innermost last

    def sample(self) -> None:
        """Read the calling (bound) thread's CPU clock."""
        self.cpu_s = self._cpu0 + time.thread_time()

    @classmethod
    def sum(cls, counters) -> "ThreadTotals":
        """One counter holding the seconds of `counters`."""
        out = cls()
        for c in counters:
            out.work_s += c.work_s
            out.wait_s += c.wait_s
            out.cpu_s += c.cpu_s
        return out

    def dump(self) -> dict:
        return {"work_s": self.work_s, "wait_s": self.wait_s,
                "cpu_s": self.cpu_s}


def bind_thread_totals(totals: ThreadTotals) -> None:
    """Count the calling thread's spans into `totals` (a counter of its
    own) from now on."""
    totals._cpu0 = totals.cpu_s - time.thread_time()
    _tls.totals = totals


def span_totals() -> dict:
    """{name: {"avgcount", "sum"}} of every span closed in the process."""
    _fold()
    with _totals_lock:
        return {name: {"avgcount": n, "sum": s}
                for name, (n, s) in _span_totals.items()}


class span:
    """``with span(name, **args):`` — a span of the calling thread
    around the block: stamped onto the thread's current op (if any),
    counted in the process-wide total for `name` and in the thread's
    work or wait seconds (if it bound a ThreadTotals), and a profiler
    range while a torch profiler records.  After the block, `t0` and
    `t1` hold its monotonic bounds."""

    __slots__ = ("name", "args", "t0", "t1", "_op", "_rf", "_tt")

    def __init__(self, name: str, **args):
        self.name = name
        self.args = args
        self.t0 = self.t1 = None

    def __enter__(self) -> "span":
        op = self._op = getattr(_tls, "op", None)
        if op is not None:
            op.span_begin(self.name, **self.args)
        self._rf = None
        if _torch_profiler._is_profiler_enabled:
            # a plain CPU op range: a record_function user annotation
            # would be mirrored onto the device timeline as well, over
            # the kernels and copies launched inside it
            self._rf = torch._C._profiler._RecordFunctionFast(self.name)
            self._rf.__enter__()
        tt = self._tt = getattr(_tls, "totals", None)
        if tt is not None:
            tt._inner.append(0.0)
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.monotonic()
        d = self.t1 - self.t0
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        if self._op is not None:
            self._op.span_end(self.name)
        _closed.append((self.name, d))
        if len(_closed) > FOLD_AT:
            _fold()
        tt = self._tt
        if tt is not None:
            inner = tt._inner
            own = d - inner.pop()
            if inner:
                inner[-1] += d
            if self.name in WAIT_SPANS:
                tt.wait_s += own
            else:
                tt.work_s += own
        return False


def add_span(name: str, t0: float, t1: float, **args) -> None:
    """Attach an externally measured [t0, t1) monotonic interval to
    the current op (pipeline phases measured on other threads)."""
    op = current()
    if op is not None:
        op.add_span(name, t0, t1, **args)


def phase_spans(ph: dict) -> list:
    """[(name, t0, t1)] of one EC pipeline item's phase stamps (the
    ``trace_phases`` dict the pipeline attaches to its futures).  On a
    lane they tile the item's life from its submit to the return of
    the op thread's ``result()``: coalesce wait (submit -> picked), the
    wait in the lane's staging queue (picked -> stage0; ``queued`` marks
    an item that entered one), pinned staging and upload issue, device
    compute (issue -> collect0: the launch, the wait in the lane's
    in-flight window and the stream's work), the D2H fetch, and the
    tail (done -> returned: cache staging, resolve, the op thread's
    wake-up and its shard layout).  A host-served item has the host
    drain in place of the device phases, its tail from host1."""
    out = []

    def add(name, a, b):
        t0, t1 = ph.get(a), ph.get(b)
        if t0 is not None and t1 is not None and t1 > t0:
            out.append((name, t0, t1))

    add("ec.coalesce", "submit", "picked")
    if "queued" in ph:
        add("ec.lane_queue", "picked", "stage0")
    add("ec.stage_h2d", "stage0", "stage1")
    add("ec.device_compute", "issue", "collect0")
    add("ec.d2h", "collect0", "done")
    add("ec.host_encode", "host0", "host1")
    add("ec.tail", "host1" if "host1" in ph else "done", "returned")
    return out


def note_pipeline_phases(ph: dict | None) -> None:
    """Stamp one EC pipeline submission's phases (:func:`phase_spans`)
    as spans on the current op, plus a degrade marker when the batch
    was requeued off a quarantined/failed lane."""
    op = current()
    if op is None or not ph:
        return
    for name, t0, t1 in phase_spans(ph):
        op.add_span(name, t0, t1)
    if ph.get("requeues"):
        op.mark_event(f"ec_degraded_requeues:{ph['requeues']}")


# ---------------------------------------------------------------------------
# TrackedOp
# ---------------------------------------------------------------------------


class TrackedOp:
    __slots__ = ("desc", "trace_id", "kind", "start", "mstart", "mend",
                 "events", "spans", "_open", "_tracker", "_id", "_done",
                 "_slock")

    def __init__(self, tracker: "OpTracker", desc: str, now: float,
                 trace_id: str = "", kind: str = "client"):
        self._tracker = tracker
        # span/event state is touched from more than one thread (the
        # op shard's execute spans vs a timer/messenger continuation
        # finishing the op, e.g. a notify timeout) — serialize it
        self._slock = threading.Lock()
        self.desc = desc
        self.trace_id = trace_id
        self.kind = kind
        self.start = now                 # tracker clock (age math)
        self.mstart = time.monotonic()   # span timebase
        self.mend: float | None = None
        self._id = 0
        self._done = False
        self.events: list[tuple[float, float, str]] = [
            (now, self.mstart, "initiated")]
        # closed spans: [name, t0, t1, args-or-None] (monotonic)
        self.spans: list[list] = []
        self._open: list[list] = []      # LIFO of open [name, t0, args]

    # -- events ------------------------------------------------------------

    def mark_event(self, event: str) -> None:
        stamp = (self._tracker.clock.now(), time.monotonic(), event)
        with self._slock:
            if self._done:
                return
            self.events.append(stamp)

    # -- spans -------------------------------------------------------------

    def span_begin(self, name: str, _t0: float | None = None,
                   **args) -> None:
        """Open a span; `_t0` backdates its start (the queue span is
        anchored to the op's initiation instant so span coverage has
        no pre-queue bookkeeping hole on sub-millisecond ops)."""
        with self._slock:
            if self._done:
                return
            self._open.append([name, time.monotonic() if _t0 is None
                               else _t0, args or None])

    def span_end(self, name: str | None = None) -> float | None:
        """Close the most recent open span (matching `name` when
        given); a no-op when nothing matches — layers may race the
        op's finish and must never raise.  Returns the close stamp so
        an adjacent span can begin at exactly the same instant."""
        with self._slock:
            if not self._open:
                return None
            idx = len(self._open) - 1
            if name is not None:
                while idx >= 0 and self._open[idx][0] != name:
                    idx -= 1
                if idx < 0:
                    return None
            nm, t0, args = self._open.pop(idx)
            t1 = time.monotonic()
            self.spans.append([nm, t0, t1, args])
            return t1

    def add_span(self, name: str, t0: float, t1: float, **args) -> None:
        with self._slock:
            if self._done:
                return
            self.spans.append([name, float(t0), float(t1),
                               args or None])

    # -- lifecycle ---------------------------------------------------------

    def finish(self) -> None:
        now_m = time.monotonic()
        now_c = self._tracker.clock.now()
        with self._slock:
            if self._done:
                return
            while self._open:                # auto-close (replica_wait
                nm, t0, args = self._open.pop()   # ends at reply)
                self.spans.append([nm, t0, now_m, args])
            self.mend = now_m
            self.events.append((now_c, now_m, "done"))
            self._done = True
        self._tracker._finish(self)

    def age(self, now: float) -> float:
        return now - self.start

    @property
    def duration(self) -> float:
        """Monotonic wall time (so far, for in-flight ops)."""
        return (self.mend if self.mend is not None
                else time.monotonic()) - self.mstart

    def dump(self) -> dict:
        with self._slock:
            events = list(self.events)
            spans = list(self.spans)
        return {"description": self.desc,
                "trace_id": self.trace_id,
                "kind": self.kind,
                "daemon": self._tracker.daemon,
                "initiated_at": self.start,
                "age": self._tracker.clock.now() - self.start,
                "mstart": self.mstart,
                "duration": round(self.duration, 6),
                "events": [{"time": t, "mtime": mt, "event": e}
                           for t, mt, e in events],
                "spans": [{"name": nm, "t0": t0, "t1": t1,
                           **({"args": args} if args else {})}
                          for nm, t0, t1, args in spans]}


class _NullOp:
    """Tracker-disabled stand-in: carries just enough (start/age) for
    the op_latency counter; every tracing call is a no-op."""

    __slots__ = ("start", "trace_id")

    def __init__(self, now: float, trace_id: str = ""):
        self.start = now
        self.trace_id = trace_id

    def age(self, now: float) -> float:
        return now - self.start

    def mark_event(self, event: str) -> None:
        pass

    def span_begin(self, name: str, _t0: float | None = None,
                   **args) -> None:
        pass

    def span_end(self, name: str | None = None) -> float | None:
        return None

    def add_span(self, name: str, t0: float, t1: float, **args) -> None:
        pass

    def finish(self) -> None:
        pass


# ---------------------------------------------------------------------------
# OpTracker
# ---------------------------------------------------------------------------


class OpTracker:
    """Per-daemon op registry (OpTracker + OpHistory): a bounded
    in-flight table, the historic ring (size- AND age-bounded), the
    slow-op ring, and the slow-op complaint/summary machinery."""

    def __init__(self, clock, history_size: int = 20,
                 complaint_age: float = 30.0, logger=None,
                 history_duration: float = 600.0, enabled: bool = True,
                 daemon: str = ""):
        self.clock = clock
        self.complaint_age = complaint_age
        self.history_size = history_size
        self.history_duration = history_duration
        self.enabled = enabled
        self.daemon = daemon
        self.log = logger
        self._lock = threading.Lock()
        self._inflight: dict[int, TrackedOp] = {}
        self._seq = 0
        # (finished_mono, dump) rings: age pruning needs the stamp
        self._history: deque[tuple[float, dict]] = deque(
            maxlen=max(1, history_size))
        self._slow_history: deque[tuple[float, dict]] = deque(
            maxlen=max(1, history_size))
        self._complained: set[int] = set()

    def create(self, desc: str, trace_id: str = "",
               kind: str = "client"):
        if not self.enabled:
            return _NullOp(self.clock.now(), trace_id)
        op = TrackedOp(self, desc, self.clock.now(), trace_id=trace_id,
                       kind=kind)
        with self._lock:
            self._seq += 1
            op._id = self._seq
            self._inflight[op._id] = op
        return op

    def _finish(self, op: TrackedOp) -> None:
        doc = op.dump()
        now_m = time.monotonic()
        with self._lock:
            was_slow = op._id in self._complained
            self._inflight.pop(op._id, None)
            self._complained.discard(op._id)
            self._history.append((now_m, doc))
            if was_slow or doc["age"] > self.complaint_age:
                self._slow_history.append((now_m, doc))

    def _pruned_locked(self, ring: deque) -> list[dict]:
        """Ring contents minus entries older than the history
        duration (osd_op_history_duration), pruned in place."""
        floor = time.monotonic() - self.history_duration
        while ring and ring[0][0] < floor:
            ring.popleft()
        return [doc for _t, doc in ring]

    # -- slow ops ----------------------------------------------------------

    def check_slow_ops(self) -> list[dict]:
        """Ops newly past the complaint age (called from the daemon
        tick); each op is complained about once."""
        now = self.clock.now()
        slow = []
        with self._lock:
            for op_id, op in self._inflight.items():
                if op.age(now) > self.complaint_age \
                        and op_id not in self._complained:
                    self._complained.add(op_id)
                    slow.append(op.dump())
        if slow and self.log is not None:
            for s in slow:
                self.log.warn("slow op (%.0fs): %s",
                              s["age"], s["description"])
        return slow

    def slow_ops_summary(self) -> tuple[int, float]:
        """(count, oldest_age) over CURRENTLY in-flight ops older than
        the complaint threshold — the level-triggered feed behind the
        'N slow ops, oldest blocked for Xs' health flag (clears by
        itself once the ops complete)."""
        now = self.clock.now()
        count, oldest = 0, 0.0
        with self._lock:
            for op in self._inflight.values():
                age = op.age(now)
                if age > self.complaint_age:
                    count += 1
                    oldest = max(oldest, age)
        return count, oldest

    # -- dumps -------------------------------------------------------------

    def num_inflight(self) -> int:
        """O(1) in-flight count (perf dump runs every heartbeat; it
        must not serialize every op's spans just to count them)."""
        with self._lock:
            return len(self._inflight)

    def dump_ops_in_flight(self) -> dict:
        with self._lock:
            ops = [op.dump() for op in self._inflight.values()]
        return {"num_ops": len(ops), "ops": ops}

    def dump_historic_ops(self) -> dict:
        with self._lock:
            ops = self._pruned_locked(self._history)
        return {"num_ops": len(ops), "size": self.history_size,
                "duration": self.history_duration, "ops": ops}

    def dump_historic_slow_ops(self) -> dict:
        with self._lock:
            ops = self._pruned_locked(self._slow_history)
        return {"num_ops": len(ops),
                "complaint_time": self.complaint_age, "ops": ops}


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Process-wide incident snapshotter.  Daemons register a dump
    callable; :meth:`record` (fired by a CrashPoint or a ledger verify
    failure) writes every registered daemon's document — in-flight +
    historic + slow ops, pg log summaries — as JSON files under a
    fresh ``<dir>/<seq>_<reason>/`` directory.  Disarmed (the default)
    it costs one flag check; the record count is bounded so a crash
    soak cannot fill the disk."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sources: dict[str, object] = {}     # name -> callable
        self.dir = ""
        self.max_records = 16
        self._seq = 0
        self.records: list[str] = []              # written incident dirs

    # -- registration ------------------------------------------------------

    def register(self, name: str, dump_fn) -> None:
        with self._lock:
            self._sources[name] = dump_fn

    def unregister(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    # -- arming ------------------------------------------------------------

    def arm(self, directory: str, max_records: int = 16) -> None:
        with self._lock:
            d = str(directory or "")
            if d != self.dir:
                # a fresh DIRECTORY is a fresh incident budget (an
                # exhausted soak must not leave the next arming
                # unable to record) — but a re-arm of the SAME dir
                # (every restarted daemon arms from conf) keeps the
                # sequence, so incident 001 is never overwritten
                self._seq = 0
            self.dir = d
            self.max_records = max(1, int(max_records))

    def disarm(self) -> None:
        with self._lock:
            self.dir = ""

    @property
    def armed(self) -> bool:
        return bool(self.dir)

    # -- recording ---------------------------------------------------------

    def record(self, reason: str, extra: dict | None = None) -> str | None:
        """Snapshot every registered source.  Returns the incident
        directory, or None when disarmed / over the record cap.  Never
        raises: the recorder runs inside crash/verify paths whose own
        error must stay the headline."""
        with self._lock:
            if not self.dir or self._seq >= self.max_records:
                return None
            self._seq += 1
            seq = self._seq
            sources = dict(self._sources)
            base = self.dir
        slug = re.sub(r"[^A-Za-z0-9_.-]+", "_", reason)[:80] or "incident"
        path = os.path.join(base, f"{seq:03d}_{slug}")
        try:
            os.makedirs(path, exist_ok=True)
            manifest = {"reason": reason, "recorded_at": time.time(),
                        "monotonic": time.monotonic(),
                        "daemons": sorted(sources)}
            for name, fn in sorted(sources.items()):
                try:
                    doc = fn()
                except Exception as e:   # a wedged daemon still dumps
                    doc = {"error": f"{type(e).__name__}: {e}"}
                with open(os.path.join(path, f"{name}.json"), "w",
                          encoding="utf-8") as f:
                    json.dump(doc, f, indent=1, default=str)
            if extra:
                with open(os.path.join(path, "extra.json"), "w",
                          encoding="utf-8") as f:
                    json.dump(extra, f, indent=1, default=str)
            with open(os.path.join(path, "manifest.json"), "w",
                      encoding="utf-8") as f:
                json.dump(manifest, f, indent=1)
        except OSError:
            return None
        with self._lock:
            self.records.append(path)
        return path


_recorder = FlightRecorder()


def recorder() -> FlightRecorder:
    return _recorder


def flight_record(reason: str, extra: dict | None = None) -> str | None:
    """Convenience trigger: snapshot now if the recorder is armed."""
    return _recorder.record(reason, extra)
