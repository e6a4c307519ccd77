"""Monitor tier: Paxos-replicated cluster state (mon/ analog).

A small odd quorum of monitors agrees (single Paxos value sequence, mon/
Paxos.cc protocol) on every piece of cluster state: the monmap, the
OSDMap + EC profiles, auth, health.  Daemons and clients keep a
MonClient session for maps, subscriptions and admin commands.
"""

from .monmap import MonMap
from .monitor import Monitor
from .client import MonClient

__all__ = ["MonMap", "Monitor", "MonClient"]
