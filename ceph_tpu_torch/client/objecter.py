"""Objecter: client op targeting + resend state machine.

The osdc/Objecter.{h,cc} analog: each op computes its target pg/primary
from the current OSDMap client-side (CRUSH — no lookup service), sends
MOSDOp, and resends on map change or EAGAIN from a stale/degraded
primary (op_submit/_calc_target/_send_op semantics, Objecter.cc:2289,
2661, 3078).  Ops carry a budget throttle like the reference's.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any

from ..mon.client import MonClient
from ..msg import Dispatcher, Message, Messenger
from ..osd.messages import MOSDOp, MOSDOpReply
from ..osd.osdmap import OSDMap
from ..utils.bufferlist import BufferList, wrap_payload
from ..utils.dout import DoutLogger
from ..utils.throttle import Throttle

# the defined errno an op fails with when its deadline exhausts
# (ETIMEDOUT — the rados_osd_op_timeout contract)
ETIMEDOUT = 110


class ObjecterError(Exception):
    def __init__(self, errno_: int, msg: str = ""):
        super().__init__(msg or f"errno {errno_}")
        self.errno = errno_


class _Op:
    __slots__ = ("tid", "pool", "oid", "ops", "event", "reply", "attempts",
                 "pgid", "snapc", "snapid")

    def __init__(self, tid, pool, oid, ops, pgid=None, snapc=None,
                 snapid=None):
        self.tid = tid
        self.pool = pool
        self.oid = oid
        self.ops = ops
        self.pgid = pgid            # explicit target (pg listing ops)
        self.snapc = snapc          # (seq, [snaps]) write snap context
        self.snapid = snapid        # read-at-snap
        self.event = threading.Event()
        self.reply = None
        self.attempts = 0


class Objecter(Dispatcher):
    def __init__(self, msgr: Messenger, monc: MonClient):
        self.msgr = msgr
        self.monc = monc
        self.conf = msgr.conf
        self.log = DoutLogger("objecter", msgr.name)
        self._tid = itertools.count(1)
        self._ops: dict[int, _Op] = {}
        self._lock = threading.Lock()
        self.throttle = Throttle("objecter-ops", 1024)
        self.on_map_hooks: list = []     # linger-ish: rewatch etc.
        msgr.add_dispatcher_head(self)
        monc.on_osdmap = self._on_map

    @property
    def osdmap(self) -> OSDMap:
        return self.monc.osdmap

    # -- submission --------------------------------------------------------

    def op_submit(self, pool_id: int, oid: str, ops: list,
                  timeout: float | None = None, pgid=None, snapc=None,
                  snapid=None) -> Message:
        """Submit and wait, bounded by a per-op deadline.

        The op resends for as long as it lives (Objecter::_op_submit +
        _maybe_request_map, osdc/Objecter.cc:2289, 2661) on an
        EXPONENTIAL backoff (objecter_backoff_base doubling to
        objecter_backoff_max): every silent try re-requests newer maps,
        and after objecter_silent_kick seconds of CONTINUOUS silence on
        the same primary's link the connection is marked down so the
        resend dials a fresh socket — an opaque wedge in a long-lived
        session must cost one reconnect, not the whole op.  The kick is
        time-based, not try-based: with fast early retries a try-count
        would kill a merely-slow link in ~1.5s and drop its in-flight
        reply, turning one slow op into a resend convoy.  On deadline
        exhaustion the op fails with the DEFINED errno ETIMEDOUT
        (110); an op whose OSD dies mid-flight can never hang forever,
        even if no new osdmap arrives."""
        import time
        if timeout is None:
            timeout = float(self.conf.objecter_op_timeout)
        self.throttle.get(1, timeout=timeout)
        try:
            # zero-copy payload contract: ops may carry bytes,
            # memoryview or BufferList payloads that ride untouched to
            # the messenger's gather write.  An op outlives this call's
            # frame (map-change resends re-encode it), so mutable
            # bytearrays are snapshotted HERE — the single defense
            # point for every client surface.
            ops = [tuple(wrap_payload(f) if isinstance(
                f, (bytes, bytearray, memoryview, BufferList)) else f
                for f in op) for op in ops]
            op = _Op(next(self._tid), pool_id, oid, ops, pgid,
                     snapc=snapc, snapid=snapid)
            with self._lock:
                self._ops[op.tid] = op
            deadline = time.monotonic() + timeout
            base = max(0.05, float(self.conf.objecter_backoff_base))
            bmax = max(base, float(self.conf.objecter_backoff_max))
            kick_after = max(2 * base,
                             float(self.conf.objecter_silent_kick))
            backoff = base
            silent_for = 0.0
            last_primary = None
            while True:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    break
                primary = self._send(op)
                sent = primary is not None
                if primary != last_primary:
                    # retargeted (map change): the silence clock and
                    # the backoff curve belong to the OLD link — a
                    # fresh primary gets its full fast tries before
                    # its conn is suspected
                    silent_for = 0.0
                    backoff = base
                    last_primary = primary
                if not sent:
                    # no primary yet (pool absent / not enough osds):
                    # ask for newer maps and wait for one to arrive
                    self.monc.sub_want_osdmap(self.osdmap.epoch + 1)
                waited = min(backoff, remain)
                if op.event.wait(waited):
                    reply = op.reply
                    if reply.result == -11:     # EAGAIN: resend later
                        op.event.clear()
                        op.reply = None
                        silent_for = 0.0
                        backoff = base
                        time.sleep(0.2)
                        self.monc.sub_want_osdmap(self.osdmap.epoch + 1)
                        continue
                    with self._lock:
                        self._ops.pop(op.tid, None)
                    return reply
                op.event.clear()
                backoff = min(backoff * 2, bmax)
                if sent:
                    silent_for += waited
                    self.monc.sub_want_osdmap(self.osdmap.epoch + 1)
                    if silent_for >= kick_after:
                        # nothing heard on this link for the whole
                        # kick window: assume the session is wedged
                        # and force a reconnect (PG-side reqid dedup
                        # makes the re-execution safe)
                        silent_for = 0.0
                        self._kick_target(primary, op.tid)
            with self._lock:
                self._ops.pop(op.tid, None)
            raise ObjecterError(
                ETIMEDOUT,
                f"op on {oid} timed out after {timeout:.1f}s "
                f"({op.attempts} attempts)")
        finally:
            self.throttle.put(1)

    def _kick_target(self, primary: int, tid: int) -> None:
        """Mark down the connection to the op's silent primary."""
        conn = self.msgr.conns.get(f"osd.{primary}")
        if conn is not None:
            self.log.warn("op %d silent to osd.%d: marking conn down",
                          tid, primary)
            conn.mark_down()

    @staticmethod
    def _is_write(ops: list) -> bool:
        from ..cls import registry as cls_registry
        for op in ops:
            if op[0] in ("read", "stat", "getxattr", "getxattrs",
                         "omap_get", "list"):
                continue
            if op[0] == "call" and not cls_registry.is_write(op[1], op[2]):
                continue
            return True
        return False

    def _target_pool(self, op: _Op) -> int:
        """Cache-tier overlay redirect (Objecter::_calc_target
        consulting pg_pool_t read_tier/write_tier, Objecter.cc:2661):
        ops aimed at a base pool with an overlay go to the tier pool;
        in readonly mode only reads are diverted."""
        pool = self.osdmap.pools.get(op.pool)
        if pool is None or (pool.read_tier < 0 and pool.write_tier < 0):
            return op.pool
        if self._is_write(op.ops):
            tier = self.osdmap.pools.get(pool.write_tier)
            if tier is not None and tier.cache_mode == "writeback":
                return tier.id
            return op.pool
        tier = self.osdmap.pools.get(pool.read_tier)
        if tier is not None and tier.cache_mode in ("writeback",
                                                    "readonly"):
            return tier.id
        return op.pool

    def _send(self, op: _Op) -> int | None:
        """Send to the current target; return the primary osd id, or
        None when the op cannot be targeted yet (pool absent, no
        primary, no address)."""
        m = self.osdmap
        if op.pool not in m.pools:
            return None
        pgid = op.pgid if op.pgid is not None else \
            m.object_to_pg(self._target_pool(op), op.oid)
        primary = m.pg_primary(pgid)
        if primary is None:
            return None
        addr = m.get_addr(primary)
        if addr is None:
            return None
        op.attempts += 1
        self.msgr.send_message(
            MOSDOp(tid=op.tid, pgid=str(pgid), oid=op.oid, ops=op.ops,
                   epoch=m.epoch, snapc=op.snapc, snapid=op.snapid),
            f"osd.{primary}", tuple(addr))
        return primary

    # -- map change: resend everything pending (resend_mon_ops model) ------

    def _on_map(self, osdmap: OSDMap) -> None:
        with self._lock:
            pending = [op for op in self._ops.values() if op.reply is None]
        for op in pending:
            self._send(op)
        for hook in list(self.on_map_hooks):
            try:
                hook(osdmap)
            except Exception:
                self.log.error("on-map hook failed")

    # -- dispatch ----------------------------------------------------------

    def ms_dispatch(self, conn, msg: Message) -> bool:
        if isinstance(msg, MOSDOpReply):
            with self._lock:
                op = self._ops.get(msg.tid)
            if op is not None:
                op.reply = msg
                op.event.set()
            return True
        return False

    def ms_handle_reset(self, conn) -> None:
        # resend pending ops addressed to the dead peer on next map
        pass
