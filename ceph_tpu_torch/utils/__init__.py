"""Common runtime: config, logging, counters, queues, throttles, fault
injection, the op tracer (optracker), the dmClock tag picker, the copy
audit and buffer lists.

The analog of the reference's common/ tier (SURVEY.md §2.1 "common
runtime"): everything else in the framework types against these.
"""

from .config import Config, Option, OPTIONS
from .dout import DoutLogger, set_log_level
from .perf_counters import PerfCounters, PerfCountersBuilder, PerfCountersCollection
from .throttle import Throttle

__all__ = [
    "Config", "Option", "OPTIONS",
    "DoutLogger", "set_log_level",
    "PerfCounters", "PerfCountersBuilder", "PerfCountersCollection",
    "Throttle",
]
