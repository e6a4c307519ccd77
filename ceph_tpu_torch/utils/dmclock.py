"""dmClock-style QoS tag math: reservation / weight / limit per client.

The reference OSD keeps a noisy client from starving others with a
weighted op queue (osd/ mClockScheduler, after the dmClock paper:
Gulati et al., OSDI '10).  Each client class carries three knobs:

  * ``res``    — reserved service rate (grants/sec) it must receive
                 even under full contention (0 = no reservation);
  * ``weight`` — its share of the service left over after every
                 reservation is met (proportional phase);
  * ``lim``    — a hard ceiling on its service rate (0 = unlimited):
                 a limited client is NOT served above ``lim`` even
                 when the system is otherwise idle.

This module is the shared tag tracker both QoS surfaces use: the
OSD's sharded op queue (utils/workqueue.py ``ShardedThreadPool``) and
the EC pipeline's dispatch-lane picker (ops/pipeline.py).  Tags are
kept PER CLIENT, not per request (start-time fair queuing form): a
grant advances the client's reservation/proportional/limit tags by
``cost/rate``, and eligibility is tag <= now.  Sharing one
``DmClockState`` across all op shards makes the configured rates
cluster-honest no matter how a pool's pgs hash across shards.

Selection rule per service opportunity (``pick``):

  1. **reservation phase** — among clients whose reservation tag is
     due (r_tag <= now), serve the earliest tag.  Unconstrained
     clients (no spec: internal work, pools without QoS conf) are
     always reservation-eligible at their oldest queued arrival time,
     so plain FIFO behavior is preserved exactly when nothing is
     configured, and system work can never be starved by tenant QoS.
  2. **proportional phase** — otherwise, among clients under their
     limit (l_tag <= now), serve the smallest proportional tag
     (weighted fair sharing).
  3. **throttled** — every queued client is over its limit: serve
     nothing; the caller sleeps until ``next_wake`` (counted as a
     throttle stall).

Counters per client: ``res_grants`` / ``prop_grants`` (which phase
served it), ``deadline_misses`` (a reservation grant delivered more
than two periods late — the reservation was not actually honored at
that moment), plus global ``throttle_stalls``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

_INF = float("inf")


@dataclass(frozen=True)
class QosSpec:
    """One client class's reservation / weight / limit."""
    res: float = 0.0      # reserved grants/sec (0 = none)
    weight: float = 1.0   # proportional share (relative)
    lim: float = 0.0      # grant/sec ceiling (0 = unlimited)

    def __post_init__(self):
        if self.res < 0 or self.lim < 0 or self.weight <= 0:
            raise ValueError(f"invalid qos spec {self}")
        if self.lim and self.res > self.lim:
            raise ValueError(
                f"qos spec reservation {self.res} exceeds limit "
                f"{self.lim}")


def parse_spec(text: str) -> QosSpec:
    """``res:weight:lim`` (the conf grammar, e.g. ``100:2:500``).

    Missing trailing fields default (``"100"`` = res 100, weight 1,
    unlimited; ``"0:3"`` = pure weight 3)."""
    parts = [p.strip() for p in str(text).split(":")]
    if not 1 <= len(parts) <= 3:
        raise ValueError(f"qos spec {text!r}: want res[:weight[:lim]]")
    try:
        res = float(parts[0] or 0)
        weight = float(parts[1]) if len(parts) > 1 and parts[1] else 1.0
        lim = float(parts[2]) if len(parts) > 2 and parts[2] else 0.0
    except ValueError:
        raise ValueError(f"qos spec {text!r}: non-numeric field")
    return QosSpec(res=res, weight=weight, lim=lim)


class _Client:
    __slots__ = ("name", "spec", "r_tag", "p_tag", "l_tag",
                 "res_grants", "prop_grants", "deadline_misses",
                 "throttle_stalls")

    def __init__(self, name: str, spec: QosSpec | None):
        self.name = name
        self.spec = spec            # None = unconstrained (FIFO class)
        self.r_tag = 0.0
        self.p_tag = 0.0
        self.l_tag = 0.0
        self.res_grants = 0
        self.prop_grants = 0
        self.deadline_misses = 0
        # service opportunities this client sat out limit-throttled
        # while NOTHING else was servable (per-class attribution of
        # the global throttle_stalls — "how often did @recovery's lim
        # actually hold work back?")
        self.throttle_stalls = 0


# grant phases (returned by pick for accounting/tests)
RES = "res"
PROP = "prop"


class DmClockState:
    """Shared per-client tag state.  Thread-safe; one instance may
    back many queues (every op shard of a daemon, or the pipeline's
    channel picker) so the configured rates hold globally."""

    def __init__(self, clock=None):
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._clients: dict[str, _Client] = {}
        self.throttle_stalls = 0

    # -- configuration -----------------------------------------------------

    def set_spec(self, name: str, spec: QosSpec | None) -> None:
        with self._lock:
            c = self._clients.get(name)
            if c is None:
                self._clients[name] = _Client(name, spec)
            else:
                c.spec = spec

    def configure(self, specs: dict[str, QosSpec]) -> None:
        """Replace the spec set: named clients get their spec, every
        other known client drops back to unconstrained."""
        with self._lock:
            for name, c in self._clients.items():
                c.spec = specs.get(name)
            for name, spec in specs.items():
                if name not in self._clients:
                    self._clients[name] = _Client(name, spec)

    def spec_of(self, name: str) -> QosSpec | None:
        with self._lock:
            c = self._clients.get(name)
            return c.spec if c else None

    def has_specs(self) -> bool:
        with self._lock:
            return any(c.spec is not None
                       for c in self._clients.values())

    # -- the scheduling decision -------------------------------------------

    def pick(self, candidates: dict[str, float],
             now: float | None = None,
             cost: float = 1.0,
             costs: dict[str, float] | None = None
             ) -> tuple[str | None, str | None, float]:
        """One service opportunity over ``candidates``
        ({client_name: oldest queued arrival time}).

        Returns ``(client, phase, next_wake)``: the client to serve
        and which phase granted it, or ``(None, None, wake_time)``
        when every candidate is limit-throttled (the caller should
        sleep until ``wake_time`` or new work arrives — and count a
        throttle stall via :meth:`note_stall`).

        The grant ADVANCES the winner's tags by its cost/rate, so the
        caller must dequeue what it asked about.  ``costs`` carries a
        PER-CANDIDATE head cost (bytes-weighted scheduling: a 4 MiB
        write advances its client's tags ~1000x further than a 4 KiB
        stat, so configured rates meter BYTES, not op counts);
        ``cost`` is the scalar fallback for callers whose work is
        uniform.
        """
        if now is None:
            now = self._clock()
        if costs is None:
            costs = {}
        with self._lock:
            best_res = None        # (tag, name)
            best_prop = None       # (p_tag, arrival, name)
            next_wake = now + 0.1
            limited: list[str] = []
            for name, arrival in candidates.items():
                c = self._clients.get(name)
                if c is None:
                    c = self._clients[name] = _Client(name, None)
                spec = c.spec
                if spec is None:
                    # unconstrained: reservation-eligible at arrival
                    # order — FIFO among themselves and against
                    # reserved clients' due tags
                    if best_res is None or arrival < best_res[0]:
                        best_res = (arrival, name)
                    continue
                # an idle client's stale tags fast-forward to now
                # (no banked credit, no banked debt: dmClock's
                # max(now, tag) arrival rule)
                if spec.res > 0:
                    r_tag = max(c.r_tag, arrival)
                    if r_tag <= now and (best_res is None
                                         or r_tag < best_res[0]):
                        best_res = (r_tag, name)
                    elif r_tag > now:
                        next_wake = min(next_wake, r_tag)
                if spec.lim > 0 and max(c.l_tag, arrival) > now:
                    next_wake = min(next_wake,
                                    max(c.l_tag, arrival))
                    limited.append(name)
                    continue       # over limit: not prop-eligible
                p_tag = max(c.p_tag, arrival)
                key = (p_tag, arrival)
                if best_prop is None or key < best_prop[:2]:
                    best_prop = (p_tag, arrival, name)
            if best_res is not None:
                name = best_res[1]
                c = self._clients[name]
                wcost = float(costs.get(name, cost))
                if c.spec is not None and c.spec.res > 0:
                    due = max(c.r_tag, candidates[name])
                    if now - due > 2.0 * wcost / c.spec.res:
                        c.deadline_misses += 1
                    c.r_tag = max(due, now - wcost / c.spec.res) \
                        + wcost / c.spec.res
                    self._advance_aux(c, now, wcost)
                c.res_grants += 1
                return name, RES, next_wake
            if best_prop is not None:
                name = best_prop[2]
                c = self._clients[name]
                wcost = float(costs.get(name, cost))
                if c.spec is not None:
                    c.p_tag = max(c.p_tag, candidates[name], now) \
                        + wcost / c.spec.weight
                    self._advance_lim(c, now, wcost)
                c.prop_grants += 1
                return name, PROP, next_wake
            # nothing servable: every queued client is over its limit —
            # attribute the stall to each held-back class so perf dump
            # can say WHOSE lim is doing the throttling
            for name in limited:
                self._clients[name].throttle_stalls += 1
            return None, None, next_wake

    def _advance_aux(self, c: _Client, now: float, cost: float) -> None:
        """A reservation grant still consumes proportional share and
        counts toward the limit (dmClock serves each request once)."""
        c.p_tag = max(c.p_tag, now) + cost / c.spec.weight
        self._advance_lim(c, now, cost)

    @staticmethod
    def _advance_lim(c: _Client, now: float, cost: float) -> None:
        if c.spec.lim > 0:
            c.l_tag = max(c.l_tag, now) + cost / c.spec.lim

    def note_stall(self) -> None:
        with self._lock:
            self.throttle_stalls += 1

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """The perf-dump ``qos`` block: per-client grants + misses."""
        with self._lock:
            clients = {}
            for name, c in self._clients.items():
                if c.spec is None and not c.res_grants \
                        and not c.prop_grants:
                    continue
                ent = {"res_grants": c.res_grants,
                       "prop_grants": c.prop_grants,
                       "deadline_misses": c.deadline_misses,
                       "throttle_stalls": c.throttle_stalls}
                if c.spec is not None:
                    ent["spec"] = (f"{c.spec.res:g}:{c.spec.weight:g}"
                                   f":{c.spec.lim:g}")
                clients[name] = ent
            return {"enabled": any(c.spec is not None
                                   for c in self._clients.values()),
                    "throttle_stalls": self.throttle_stalls,
                    "clients": clients}
