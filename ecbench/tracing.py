"""Reading a torch.profiler trace of a stretch of the window.

`union` is chip_smoke's `device_busy_share` arithmetic, copied: the
union of the card's kernel and memcpy intervals.  The gaps between
those intervals are labelled by what the host was doing meanwhile: the
benchmark's own `record_function` marks around its calls into the port.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

UNLABELLED = "host (no mark)"


def union(spans: list) -> list:
    """Merged [t0, t1) intervals of `spans`, sorted."""
    out: list = []
    for t0, t1 in sorted(spans):
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1][1] = t1
        else:
            out.append([t0, t1])
    return out


def _overlap(merged: list, starts: list, g0: float, g1: float) -> float:
    i = max(0, bisect.bisect_right(starts, g0) - 1)
    got = 0.0
    while i < len(merged) and merged[i][0] < g1:
        got += max(0.0, min(g1, merged[i][1]) - max(g0, merged[i][0]))
        i += 1
    return got


def summarize(events, marks, window_s: float) -> dict:
    """From the profiler's FunctionEvents (times in microseconds):
    device busy seconds, device time per operation name, and the idle
    gaps' seconds by the mark that overlapped them most."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, by_name, host = [], defaultdict(float), defaultdict(list)
    for e in events:
        t0, t1 = e.time_range.start, e.time_range.end
        if t1 <= t0:
            continue
        if e.device_type == cuda:
            dev.append((t0, t1))
            by_name[e.name] += (t1 - t0) / 1e6
        elif e.name in marks:
            host[e.name].append((t0, t1))
    busy = union(dev)
    merged = {name: union(sp) for name, sp in host.items()}
    starts = {name: [s[0] for s in sp] for name, sp in merged.items()}
    gaps = defaultdict(float)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        label, best = UNLABELLED, 0.0
        for name, sp in merged.items():
            got = _overlap(sp, starts[name], a, b)
            if got > best:
                label, best = name, got
        gaps[label] += (b - a) / 1e6
    return {
        "window_s": window_s,
        "busy_s": sum(t1 - t0 for t0, t1 in busy) / 1e6,
        "device_ops": dict(by_name),
        "idle_gaps": dict(gaps),
    }


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
