"""Typed perf counters (common/perf_counters.h analog).

PerfCountersBuilder declares u64 / time / long-run-average / histogram
counters for a subsystem; PerfCountersCollection aggregates every
component's counters for `perf dump` (admin socket / mgr export).
"""

from __future__ import annotations

import threading
from typing import Any

U64 = "u64"
TIME = "time"
LONGRUNAVG = "longrunavg"
HISTOGRAM = "histogram"

_HIST_BUCKETS = [0.0001, 0.001, 0.01, 0.1, 1.0, 10.0, float("inf")]


class PerfCounters:
    def __init__(self, name: str, schema: dict[str, str]):
        self.name = name
        self._schema = schema
        self._lock = threading.Lock()
        self._vals: dict[str, Any] = {}
        for key, typ in schema.items():
            if typ in (U64, TIME):
                self._vals[key] = 0
            elif typ == LONGRUNAVG:
                self._vals[key] = [0, 0.0]          # count, sum
            elif typ == HISTOGRAM:
                self._vals[key] = [0] * len(_HIST_BUCKETS)

    def inc(self, key: str, amount: int = 1) -> None:
        with self._lock:
            self._vals[key] += amount

    def dec(self, key: str, amount: int = 1) -> None:
        with self._lock:
            self._vals[key] -= amount

    def set(self, key: str, value) -> None:
        with self._lock:
            self._vals[key] = value

    def tinc(self, key: str, seconds: float) -> None:
        """Record a duration: LONGRUNAVG accumulates, HISTOGRAM buckets."""
        with self._lock:
            slot = self._vals[key]
            if self._schema[key] == LONGRUNAVG:
                slot[0] += 1
                slot[1] += seconds
            elif self._schema[key] == HISTOGRAM:
                for i, edge in enumerate(_HIST_BUCKETS):
                    if seconds <= edge:
                        slot[i] += 1
                        break
            else:
                self._vals[key] += seconds

    def value(self, key: str):
        with self._lock:
            v = self._vals[key]
            return list(v) if isinstance(v, list) else v

    def avg(self, key: str) -> float:
        with self._lock:
            count, total = self._vals[key]
            return total / count if count else 0.0

    def dump(self) -> dict[str, Any]:
        with self._lock:
            out = {}
            for key, typ in self._schema.items():
                v = self._vals[key]
                if typ == LONGRUNAVG:
                    out[key] = {"avgcount": v[0], "sum": v[1]}
                elif typ == HISTOGRAM:
                    out[key] = {"buckets": list(v),
                                "edges": list(_HIST_BUCKETS)}
                else:
                    out[key] = v
            return out


class PerfCountersBuilder:
    def __init__(self, name: str):
        self.name = name
        self._schema: dict[str, str] = {}

    def add_u64_counter(self, key: str, desc: str = ""):
        self._schema[key] = U64
        return self

    add_u64 = add_u64_counter

    def add_time(self, key: str, desc: str = ""):
        self._schema[key] = TIME
        return self

    def add_time_avg(self, key: str, desc: str = ""):
        self._schema[key] = LONGRUNAVG
        return self

    def add_histogram(self, key: str, desc: str = ""):
        self._schema[key] = HISTOGRAM
        return self

    def create_perf_counters(self) -> PerfCounters:
        return PerfCounters(self.name, dict(self._schema))


class PerfCountersCollection:
    def __init__(self):
        self._lock = threading.Lock()
        self._loggers: dict[str, PerfCounters] = {}

    def add(self, counters: PerfCounters) -> None:
        with self._lock:
            self._loggers[counters.name] = counters

    def remove(self, name: str) -> None:
        with self._lock:
            self._loggers.pop(name, None)

    def dump(self) -> dict[str, dict]:
        with self._lock:
            loggers = list(self._loggers.values())
        return {c.name: c.dump() for c in loggers}
