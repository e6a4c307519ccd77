"""One run of one cell: set up, warm, measure, check, print one line.

    python3 -m ecbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the payload pool from the seed on the card, builds the
codec from the configuration's profile through the port's plugin
registry, configures the dispatch pipeline as the OSD configures it from
its conf, and warms every padded batch shape the cell's traffic can
reach.  The op threads then run closed loops (each sends its next op
when the last returns, as an OSD's op threads do): a settling stretch
that counts as set-up, then the window of `--seconds`.  With `--trace 1`
a stretch in the middle of the window runs under torch.profiler.

Once the window has closed, a sample of the ops it completed, drawn from
the seed, is held against the NumPy reference (`ecbench/reference`),
and every number compared is printed beside its limit.  The last line
of standard output is the result.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import ctypes.util
import faulthandler
import gc
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

from . import tracing
from .manifest import Cell

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "ceph_tpu")
SETTLE_S = 1.5           # untimed traffic between warm-up and the window
TRACE_S = 4.0            # profiled stretch, at the end of the window
STALL_S = 3.0            # no op completed this long: dump the stacks
JOIN_S = 60.0            # an op still running this long past the close is late
WARM_TIMEOUT_S = 300.0
POOL_CALL_BYTES = 256 << 20   # payload bytes made per generator call
# The OSD process's allocator keeps what it frees for reuse, as Ceph's
# OSDs run under tcmalloc: glibc's defaults would map and unmap every
# 32 MiB payload copy and shard layout afresh, page faults each time,
# and would hand freed heap back to the system (mallopt(3) parameters
# of glibc's malloc.h).
MALLOPT = ((-4, 0),             # M_MMAP_MAX: no chunk mapped on its own
           (-1, (1 << 31) - 1),  # M_TRIM_THRESHOLD: keep freed heap
           (-2, 256 << 20))     # M_TOP_PAD: grow the heap 256 MiB at once
PIPE_KEYS = ("dispatches", "dev_dispatches", "host_dispatches", "stripes",
             "bytes_h2d", "bytes_d2h")


def _boot_clock() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def _process_start() -> float:
    """This process's start on the boot clock (from /proc/self/stat)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def keep_freed_memory() -> None:
    libc = ctypes.CDLL(ctypes.util.find_library("c"))
    for param, value in MALLOPT:
        if libc.mallopt(param, value) != 1:
            raise OSError(f"mallopt({param}, {value}) refused")


def host_sample() -> tuple:
    """(this process's CPU seconds, its minor page faults, the machine's
    steal ticks): what the host did to the process in a second."""
    t = os.times()
    with open("/proc/self/stat") as f:
        minflt = int(f.read().rsplit(")", 1)[1].split()[7])
    with open("/proc/stat") as f:
        steal = int(f.readline().split()[8])
    return t.user + t.system, minflt, steal


class Ctx:
    """The port's modules and the cell's set-up, handed to the entries."""


def port_modules(ctx) -> None:
    import ceph_tpu_torch
    from ceph_tpu_torch.erasure.registry import registry
    from ceph_tpu_torch.ops import hbm_cache
    from ceph_tpu_torch.ops import pipeline
    from ceph_tpu_torch.osd import ecutil
    from ceph_tpu_torch.utils import copyaudit
    ctx.port, ctx.registry, ctx.hbm_cache = ceph_tpu_torch, registry, hbm_cache
    ctx.pipeline, ctx.ecutil, ctx.copyaudit = pipeline, ecutil, copyaudit


def make_pool(n: int, nbytes: int, seed: int, device) -> np.ndarray:
    """`n` distinct objects of `nbytes` from the seed, made on the device
    in a few large calls and copied to host memory, where an OSD holds
    client payloads."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    pool = np.empty((n, nbytes), dtype=np.uint8)
    per = max(1, POOL_CALL_BYTES // nbytes)
    for a in range(0, n, per):
        b = min(n, a + per)
        t = torch.randint(0, 256, (b - a, nbytes), dtype=torch.uint8,
                          device=device, generator=gen)
        torch.from_numpy(pool[a:b]).copy_(t)
    return pool


def configure_pipeline(ctx, osd: dict, chips: int) -> None:
    ctx.pipeline.configure(
        depth=int(osd["osd_ec_pipeline_depth"]),
        coalesce_wait=float(osd["osd_ec_pipeline_coalesce_ms"]) / 1000.0,
        max_batch=int(osd["osd_ec_pipeline_max_batch"]),
        device_shards=chips,
        scrub_weight=float(osd["osd_ec_pipeline_scrub_weight"]),
        cost_aware=bool(osd["osd_ec_cost_aware_placement"]),
        hbm_cache_bytes=int(osd["osd_ec_hbm_cache_bytes"]),
        mesh_min_bytes=int(osd["osd_ec_mesh_min_bytes"]),
        qos_cost_unit=int(osd["osd_qos_cost_bytes_unit"]))
    ctx.max_batch = int(osd["osd_ec_pipeline_max_batch"])


def warm(ctx, shapes: list, device) -> None:
    """Wait until every (kind, matrix, padded shape) is warm on the
    lane's device: a cold shape is served on the host while it warms."""
    be = ctx.codec.backend
    for kind, mat, shape in shapes:
        if kind == "fused":
            def get():
                return be.fused_fn_if_ready(mat, shape, device)
        else:
            def get():
                return be.device_fn_if_ready(kind, mat, (), shape, device)
        t0 = time.monotonic()
        while get() is None:
            if time.monotonic() - t0 > WARM_TIMEOUT_S:
                raise TimeoutError(f"{kind} at {shape} not warm after "
                                   f"{WARM_TIMEOUT_S:.0f}s")
            time.sleep(0.01)


def counters(ctx) -> dict:
    st = ctx.pipeline.stats()
    snap = ctx.copyaudit.snapshot()
    return {"pipe": {k: st[k] for k in PIPE_KEYS},
            "copies": {s: v["bytes"] for s, v in snap["sites"].items()}}


def delta(a: dict, b: dict) -> dict:
    return {g: {k: b[g].get(k, 0) - a[g].get(k, 0) for k in b[g]}
            for g in b}


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def all_threads():
    """Profiler config that records every thread's ops, not only the
    thread that starts the profiler (the op threads and the pipeline's
    stager and collector threads are all started before it)."""
    from torch._C._profiler import _ExperimentalConfig
    return _ExperimentalConfig(profile_all_threads=True)


def drive(ctx, entry, seconds: float, trace: bool, sample_n: int) -> dict:
    """The op threads' closed loops: SETTLE_S of settling, then the
    window.  An op counts in the window when it completes inside it.
    With `trace`, the window's last TRACE_S run under the profiler, and
    the host-side numbers (rates, latencies, counters, GC) are taken
    over the window before it, which the profiler does not slow."""
    lock = threading.Lock()
    rng = np.random.default_rng([ctx.seed, 3])
    nxt = [0]
    done: list = []
    errors: list = []
    kept: list = []
    seen = [0]
    completed = [0]
    span = min(TRACE_S, seconds / 2) if trace else 0.0
    t_open = time.perf_counter() + SETTLE_S
    t_host = t_open + seconds - span
    # the close moves out if the profiler is slow to start: the traced
    # stretch is `span` long from the moment it records
    t_close = [t_open + seconds]
    marks = entry.marks

    def worker():
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            t0 = time.perf_counter()
            if t0 >= t_close[0]:
                return
            try:
                nbytes, out = entry.op(i)
            except Exception as e:      # counted as failed, run goes on
                with lock:
                    errors.append(f"op {i}: {type(e).__name__}: {e}")
                continue
            t1 = time.perf_counter()
            completed[0] += 1
            if not t_open <= t1 <= t_close[0]:
                continue
            with lock:
                if t1 <= t_host:
                    done.append((t0, t1, nbytes))
                # reservoir sample of the window's ops, from the seed
                seen[0] += 1
                if len(kept) < sample_n:
                    kept.append(out)
                else:
                    j = int(rng.integers(seen[0]))
                    if j < sample_n:
                        kept[j] = out

    gc_s = [0.0, 0.0, 0.0]
    gc_t = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_t[0] = time.perf_counter()
        elif t_open <= gc_t[0] <= t_host:
            gc_s[info["generation"]] += time.perf_counter() - gc_t[0]

    gc.callbacks.append(on_gc)
    workers = [threading.Thread(target=worker, name=f"ecbench-op-{w}",
                                daemon=True) for w in range(ctx.threads)]
    for t in workers:
        t.start()
    _sleep_until(t_open)
    boot_open = _boot_clock()
    c_open = counters(ctx)
    # once a second until the host-side numbers close: what the host
    # did to the process, and the threads' stacks if no op completes
    host_each_s, last = [], host_sample()
    seen_n, seen_t, dumps = completed[0], time.perf_counter(), 0
    t_next = t_open + 1.0
    while t_next <= t_host:
        _sleep_until(t_next)
        now = host_sample()
        host_each_s.append([round(now[0] - last[0], 3), now[1] - last[1],
                            now[2] - last[2]])
        last, t_next = now, t_next + 1.0
        if completed[0] != seen_n:
            seen_n, seen_t = completed[0], time.perf_counter()
        elif time.perf_counter() - seen_t > STALL_S and dumps < 2:
            dumps += 1
            print(f"ecbench stall: no op completed for {STALL_S:.0f} s; "
                  "the threads' stacks:", file=sys.stderr, flush=True)
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
            seen_t = time.perf_counter()
    _sleep_until(t_host)
    c_host = counters(ctx)
    summary = None
    if trace:
        import torch
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA], acc_events=True,
            experimental_config=all_threads())
        # the first profiler of a process takes seconds to start CUPTI;
        # the op threads run on meanwhile, and the stretch starts after
        t_close[0] = float("inf")
        prof.start()
        c_t0 = counters(ctx)
        tt0 = time.perf_counter()
        t_close[0] = tt0 + span
        _sleep_until(t_close[0])
        c_t1 = counters(ctx)
        prof_s = time.perf_counter() - tt0
        prof.stop()
    end = time.monotonic() + JOIN_S
    for t in workers:
        t.join(max(0.0, end - time.monotonic()))
    late = sum(t.is_alive() for t in workers)
    gc.callbacks.remove(on_gc)
    if trace:
        summary = tracing.summarize(prof.events(), marks, prof_s)
        summary["delta"] = delta(c_t0, c_t1)
    return {"boot_open": boot_open, "done": done, "errors": errors,
            "kept": kept, "late": late, "delta": delta(c_open, c_host),
            "trace": summary, "gc_s": gc_s, "t_open": t_open,
            "host_each_s": host_each_s,
            "host_s": t_host - t_open}


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, card: bool = True, control: bool = False,
             boot_start: float | None = None) -> dict:
    """Run one cell; returns the result (and its checks, last).  With
    `card` False the port runs on the CPU (the CPU tests); `control`
    puts the reference with a broken guarantee in the program's place."""
    import torch
    cell = Cell(root, workload)
    cfg = cell.cfg
    ctx = Ctx()
    ctx.cfg, ctx.seed = cfg, int(seed)
    ctx.threads = int(cfg["op_threads"])
    ctx.mark = torch.profiler.record_function if trace \
        else contextlib.nullcontext
    port_modules(ctx)
    device = torch.device("cuda", 0) if card else torch.device("cpu")
    ctx.port.set_device(device)
    if card:
        from ceph_tpu_torch.ops import cuda_ec
        cuda_ec.build()
    configure_pipeline(ctx, cfg["osd"], cell.chips)
    profile = {k: str(v) for k, v in cfg["profile"].items()
               if k != "plugin"}
    ctx.codec = ctx.registry.factory(cfg["profile"]["plugin"], profile)
    ctx.pool = make_pool(int(cfg["objects"]), int(cfg["object_bytes"]),
                         ctx.seed, device)
    entry = cell.entry()(ctx, cell.mix)
    pipe = ctx.pipeline.get()
    pipe.start_lanes()
    lane = pipe.lane_devices()[0]
    warm(ctx, entry.warm_shapes(), lane)
    entry.prepare()
    entry.control = control
    if card:    # the peak of what the window holds, not of set-up
        torch.cuda.synchronize(0)
        torch.cuda.reset_peak_memory_stats(0)
    sample_n = int(cfg["check_ops"])
    got = drive(ctx, entry, seconds, trace, sample_n)
    boot_start = _process_start() if boot_start is None else boot_start
    setup_s = got["boot_open"] - boot_start
    dev = {"platform": "gpu" if card else "cpu",
           "kind": torch.cuda.get_device_name(0) if card else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))
           if card else 0}
    if card:
        dev["power_limit"] = power_limit()
    pipe.release_lanes()
    lat = sorted(t1 - t0 for t0, t1, _ in got["done"])
    rec = {"entry": entry.kind, "k": entry.k, "m": entry.m, "L": entry.L,
           "lost": entry.lost_n,
           "setup_s": setup_s, "window_s": got["host_s"],
           "ops": len(got["done"]),
           "bytes": sum(n for _, _, n in got["done"]),
           "latencies_s": lat, "delta": got["delta"], "trace": got["trace"]}
    metrics = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {"checked_ops": {"value": len(got["kept"]), "min": sample_n},
              "failed_ops": {"value": len(got["errors"]), "max": 0},
              "late_ops": {"value": got["late"], "max": 0}}
    for name, value in entry.check(got["kept"]).items():
        checks[name] = {"value": value, "max": 0}
    correct = all(c["value"] >= c["min"] if "min" in c
                  else c["value"] <= c["max"] for c in checks.values())
    out = {"correct": correct,
           "attempted": len(got["done"]) + len(got["errors"]),
           "failed": len(got["errors"]), "metrics": metrics, "device": dev}
    if trace and got["trace"] is not None:
        tr = got["trace"]
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tracing.top(tr["device_ops"]),
                            "idle_gaps": tracing.top(tr["idle_gaps"])}
    per_s = np.zeros(max(1, int(np.ceil(got["host_s"]))))
    for _, t1, n in got["done"]:
        per_s[min(len(per_s) - 1, int(t1 - got["t_open"]))] += n
    out["diag"] = {"gbs_each_s": [round(x / 1e9, 3) for x in per_s],
                   "gc_s": [round(x, 4) for x in got["gc_s"]],
                   "cpu_s_minflt_steal_each_s": got["host_each_s"],
                   "p50_ms": 1e3 * lat[len(lat) // 2] if lat else None}
    out["checks"] = checks
    out["errors"] = got["errors"][:5]
    return out


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def report(out: dict) -> None:
    """Checks as the last lines of standard error, the result as the
    last line of standard output."""
    errors = out.pop("errors", [])
    checks = out.pop("checks")
    print(f"ecbench diag: {json.dumps(out.pop('diag', {}))}",
          file=sys.stderr)
    for e in errors:
        print(f"ecbench: {e}", file=sys.stderr)
    for name, c in checks.items():
        limit = f">= {c['min']}" if "min" in c else f"<= {c['max']}"
        print(f"ecbench check {name}: {c['value']} (limit {limit})",
              file=sys.stderr)
    sys.stderr.flush()
    out["checks"] = checks
    print(json.dumps(out), flush=True)


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m ecbench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, control: bool = False) -> int:
    args = parse(argv)
    keep_freed_memory()
    import torch
    if not torch.cuda.is_available():
        print("ecbench: no CUDA device; a run measures the card only",
              file=sys.stderr)
        return 2
    chips = Cell(ROOT, args.workload).chips
    if torch.cuda.device_count() < chips:
        print(f"ecbench: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    out = run_cell(ROOT, args.workload, args.seed, args.seconds,
                   bool(args.trace), control=control)
    bad = forbidden_modules()
    if bad:
        print(f"ecbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    report(out)
    return 0
