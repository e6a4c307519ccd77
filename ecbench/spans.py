"""A cell run that also reads the port's spans and thread counters.

    python3 -m ecbench.spans --workload <name> --seed <n> --seconds <s> --trace 1

`run.py` takes six of the pipeline's counters into the window's delta
and labels the trace's idle gaps by the entry's own marks around its
calls into the port.  The port also keeps, in `pipeline.stats()`, each
span's total by name (`span_s`), each item's phase seconds by channel
kind (`phase_s`) and each pipeline thread's work, wait and CPU seconds
(`threads`), and while a profiler records, its work spans are ranges on
the threads that ran them.  This run is the cell's own run with three
additions:

  counters()   the window's delta also holds `spans`, `phases` and
               `threads`, flattened to `<name>/<field>` keys;
  summarize()  each idle gap is labelled by the port's work range that
               overlaps it most, on any thread, then by the entry's
               marks, then `host (no mark)`; `idle_unattributed_s` is
               the gaps' time in which no work range was open;
  metrics      the readers of `SPAN_METRICS` are reported beside the
               cell's own, and `ecbench spans` on standard error gives
               the window's mean op time beside the sum of the four
               `op_*_ms` and each pipeline thread's seconds.

Everything the cell's own run computes is computed as there.  A port
without these counters gives empty groups, and the readers nothing.
"""

from __future__ import annotations

import contextlib
import json
import sys

from . import run, tracing
from .manifest import Cell

SPAN_METRICS = (("op_stage_ms", "ms"), ("op_queue_ms", "ms"),
                ("op_dispatch_ms", "ms"), ("op_tail_ms", "ms"),
                ("pipeline_thread_busy_share", "%"),
                ("idle_unattributed_share", "%"))
OP_PARTS = ("op_stage_ms", "op_queue_ms", "op_dispatch_ms", "op_tail_ms")


def _flat(tree: dict, out: dict, prefix: str = "") -> dict:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, out, f"{prefix}{k}/")
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[prefix + k] = v
    return out


def counters(ctx, _base=run.counters) -> dict:
    out = _base(ctx)
    st = ctx.pipeline.stats()
    for group, key in (("spans", "span_s"), ("phases", "phase_s"),
                       ("threads", "threads")):
        out[group] = _flat(st.get(key) or {}, {})
    return out


def work_span_names() -> tuple:
    from ceph_tpu_torch.utils import optracker
    return tuple(getattr(optracker, "WORK_SPANS", ()))


def summarize(events, marks, window_s, _base=tracing.summarize,
              work=None) -> dict:
    """`tracing.summarize`'s summary, its idle gaps labelled first by
    the port's work ranges; the entry's labels stay as `mark_gaps`."""
    import torch
    events = list(events)
    out = _base(events, marks, window_s)
    work = set(work_span_names() if work is None else work)
    cuda = torch.autograd.DeviceType.CUDA
    dev, ranges = [], {}
    for e in events:
        t0, t1 = e.time_range.start, e.time_range.end
        if t1 <= t0:
            continue
        if e.device_type == cuda:
            dev.append((t0, t1))
        elif e.name in work or e.name in marks:
            ranges.setdefault(e.name, []).append((t0, t1))
    merged = {n: tracing.union(sp) for n, sp in ranges.items()}
    starts = {n: [s[0] for s in sp] for n, sp in merged.items()}
    any_work = tracing.union([s for n, sp in ranges.items() if n in work
                              for s in sp])
    any_starts = [s[0] for s in any_work]
    busy = tracing.union(dev)
    gaps: dict = {}
    gap_s = unattributed = 0.0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        label = tracing.UNLABELLED
        for names in (work, marks):
            best = 0.0
            for n in names:
                if n in merged:
                    got = tracing._overlap(merged[n], starts[n], a, b)
                    if got > best:
                        label, best = n, got
            if best > 0:
                break
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
        gap_s += (b - a) / 1e6
        unattributed += (b - a - tracing._overlap(any_work, any_starts,
                                                  a, b)) / 1e6
    out["mark_gaps"] = out["idle_gaps"]
    out["idle_gaps"] = gaps
    out["idle_gap_s"] = gap_s
    out["idle_unattributed_s"] = unattributed
    return out


def diag(rec: dict, values: dict) -> dict:
    """The window's mean op time beside the four op_*_ms, and each
    pipeline thread's work, wait and CPU share of the window."""
    lat = rec["latencies_s"]
    threads: dict = {}
    for key, v in rec["delta"].get("threads", {}).items():
        name, field = key.rsplit("/", 1)
        threads.setdefault(name, {})[field] = round(
            100.0 * v / rec["window_s"], 2)
    parts = [values.get(n) for n in OP_PARTS]
    return {"op_mean_ms": 1e3 * sum(lat) / len(lat) if lat else None,
            "op_parts_sum_ms": sum(parts) if None not in parts else None,
            "thread_share_pct": threads,
            "busiest_thread": max(threads, default=None,
                                  key=lambda t: threads[t].get("work_s", 0))}


@contextlib.contextmanager
def reading_spans(seen: dict):
    """run.py, tracing.py and the manifest's metric list as this run
    extends them, for the duration of the block; `seen` gets the
    record and the extra metrics' values."""
    saved = run.counters, tracing.summarize, Cell.metrics, Cell.reader
    base_metrics, base_reader = Cell.metrics, Cell.reader

    def metrics(self, trace):
        got = base_metrics(self, trace)
        if trace and self.cell["traffic"] == "write":
            got = got + [{"name": f"{n}.write", "unit": u}
                         for n, u in SPAN_METRICS]
        return got

    def reader(self, name):
        fn = base_reader(self, name)

        def read(rec):
            seen["rec"] = rec
            value = fn(rec)
            seen.setdefault("values", {})[name.split(".")[0]] = value
            return value
        return read

    run.counters, tracing.summarize = counters, summarize
    Cell.metrics, Cell.reader = metrics, reader
    try:
        yield
    finally:
        run.counters, tracing.summarize, Cell.metrics, Cell.reader = saved


def main(argv=None) -> int:
    seen: dict = {}
    with reading_spans(seen):
        rc = run.main(argv)
    if "rec" in seen:
        print(f"ecbench spans: {json.dumps(diag(seen['rec'], seen['values']))}",
              file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
