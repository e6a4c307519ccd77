"""Mgr: the metrics/management plane (mgr/Mgr.cc, DaemonServer.cc).

The active mgr beacons to the monitors (its address rides the osdmap,
the MgrMap folded in); every daemon then pushes MMgrReport perf dumps
to it (mgr/MgrClient.cc model — here the OSD heartbeat tick doubles as
the report timer).  The mgr aggregates the latest report per daemon
and serves them through its admin socket plus python module hooks —
the reference's embedded-module system reduced to callables over the
daemon-state snapshot.
"""

from __future__ import annotations

import threading
from typing import Callable

from ..mon.client import MonClient
from ..mon.messages import MMgrBeacon, MMgrReport
from ..mon.monmap import MonMap
from ..msg import Dispatcher, Policy, create_messenger
from ..utils.admin_socket import AdminSocket
from ..utils.clock import SystemClock
from ..utils.config import Config
from ..utils.dout import DoutLogger


class MgrDaemon(Dispatcher):
    def __init__(self, name: str, monmap: MonMap,
                 conf: Config | None = None, clock=None):
        self.name = name
        self.entity = f"mgr.{name}"
        self.conf = conf or Config()
        self.clock = clock or SystemClock()
        self.log = DoutLogger("mgr", self.entity)

        self.msgr = create_messenger(self.entity, conf=self.conf)
        self.msgr.bind(("127.0.0.1", 0))
        self.msgr.set_policy("mon", Policy.lossless_peer())
        self.msgr.set_policy("osd", Policy.stateless_server())
        self.msgr.add_dispatcher_tail(self)
        self.monc = MonClient(self.msgr, monmap)

        self._lock = threading.Lock()
        # entity -> {"counters": perf dump, "stamp": clock time}
        self.daemon_state: dict[str, dict] = {}
        self.modules: dict[str, Callable[[dict], object]] = {}
        self._beacon_timer = None
        self._stopped = False

        sock_dir = str(self.conf.admin_socket_dir)
        self.asok = AdminSocket(
            self.entity,
            path=f"{sock_dir}/{self.entity}.asok" if sock_dir else "")
        self.asok.register("dump", lambda c: self.dump())
        self.asok.register("status", lambda c: {
            "entity": self.entity,
            "daemons": sorted(self.daemon_state)})
        self.asok.register(
            "module", lambda c: self.run_module(c.get("name", "")))

        # built-in module: cluster-wide op/byte totals (the `status`
        # dashboards' data source)
        self.register_module("io_totals", _io_totals)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self.msgr.start()
        self.asok.start()
        self.monc.subscribe({"monmap": 0})   # membership changes
        self._beacon()

    def shutdown(self) -> None:
        self._stopped = True
        self.monc.shutdown()
        if self._beacon_timer:
            self._beacon_timer.cancel()
        self.asok.shutdown()
        self.msgr.shutdown()

    def _beacon(self) -> None:
        if self._stopped:
            return
        self.monc.send(MMgrBeacon(name=self.name, addr=self.msgr.addr))
        self._beacon_timer = self.clock.timer(
            float(self.conf.mon_tick_interval) * 2, self._beacon)

    # -- reports -----------------------------------------------------------

    def ms_dispatch(self, conn, msg) -> bool:
        if isinstance(msg, MMgrReport):
            with self._lock:
                self.daemon_state[msg.entity] = {
                    "counters": msg.counters,
                    "epoch": msg.epoch,
                    "stamp": self.clock.now(),
                }
            return True
        return False

    def dump(self) -> dict:
        with self._lock:
            return {e: dict(s) for e, s in self.daemon_state.items()}

    # -- modules (MgrPyModule reduced to callables) ------------------------

    def register_module(self, name: str,
                        fn: Callable[[dict], object]) -> None:
        self.modules[name] = fn

    def run_module(self, name: str):
        fn = self.modules.get(name)
        if fn is None:
            return {"error": f"no module {name!r}; "
                             f"have {sorted(self.modules)}"}
        return fn(self.dump())


def _io_totals(state: dict) -> dict:
    """Sum the osd op counters across reporters."""
    totals = {"op": 0, "op_w": 0, "op_r": 0, "op_in_bytes": 0,
              "op_out_bytes": 0}
    for entity, st in state.items():
        osd = st.get("counters", {}).get("osd", {})
        for key in totals:
            totals[key] += int(osd.get(key, 0))
    totals["reporters"] = len(state)
    return totals
