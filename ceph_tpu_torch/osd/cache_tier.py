"""Cache tiering, tier-PG side (ReplicatedPG cache machinery:
maybe_handle_cache / promote_object / agent_work / hit_set_persist
reduced — see the section comment below).

Mixed into PG (pg.py).
"""

from __future__ import annotations

from ..store.objectstore import ENOENT, StoreError, Transaction
from ..utils import denc
from .messages import MOSDOp
from .pglog import DIRTY_KEY, WHITEOUT_KEY


class CacheTier:
    # ---- cache tiering (tier-pg side) ------------------------------------
    #
    # The ReplicatedPG cache machinery reduced to its semantics
    # (osd/ReplicatedPG.cc: maybe_handle_cache ~:1986, promote_object,
    # agent_work :12031, agent_maybe_flush :12250, agent_maybe_evict
    # :12313, hit_set_persist :11789):
    #   * reads that miss the tier PROMOTE the object from the base
    #     pool (async; the client op parks until the copy lands);
    #   * writes land in the tier marked DIRTY (whole-object writes
    #     skip the promote — they define the object entirely);
    #   * deletes leave a dirty WHITEOUT, flushed as a base delete;
    #   * the agent (heartbeat-driven) flushes dirty objects to the
    #     base pool, propagates whiteouts, and evicts clean objects
    #     past target_max_objects, preferring cold ones (hit_sets).

    def _cache_intercept(self, conn, msg) -> bool:
        """Returns True when the op was fully handled (or parked for a
        promote) here; False lets do_op execute it on the tier pg.

        msg._promoted marks a post-promote re-dispatch: it suppresses
        only the promote decision — whiteout/existence semantics still
        apply (a read parked behind a parked delete must see the
        whiteout the delete just created, not the marker object)."""
        promoted = getattr(msg, "_promoted", False)
        pool = self.pool
        store = self.osd.store
        oid = msg.oid
        if not promoted:
            self._hit_set_record(oid)
        reads, writes = self._split_ops(msg.ops)
        exists = store.exists(self.cid, oid)
        whiteout = False
        if exists:
            try:
                store.getattr(self.cid, oid, WHITEOUT_KEY)
                whiteout = True
            except StoreError:
                pass
        if pool.cache_mode == "readonly":
            if writes:
                # readonly tiers serve reads only; the objecter sends
                # writes to the base pool — one reaching us is an
                # addressing error, not redirectable state
                self._reply(conn, msg, -22, [])
                return True
            if whiteout:
                # a leftover writeback-era whiteout is NOT an object
                self._reply(conn, msg, -ENOENT, [])
                return True
            if exists or promoted:
                return False
            waiting = self._promote_waiting.get(oid)
            if waiting is not None:
                waiting.append((conn, msg))
                return True
            self._promote(conn, msg)
            return True
        # writeback
        if whiteout:
            if writes:
                return False      # revive semantics in _build_txn
            self._reply(conn, msg, -ENOENT, [])
            return True
        if exists or promoted:
            return False
        # miss: a whole-object write needs no base copy
        if writes and any(op[0] == "writefull" for op in msg.ops):
            return False
        waiting = self._promote_waiting.get(oid)
        if waiting is not None:
            waiting.append((conn, msg))
            return True
        self._promote(conn, msg)
        return True

    def _promote(self, conn, msg) -> None:
        """Async copy-up from the base pool (promote_object +
        CopyFromCallback model): park the op, fetch data+xattrs+omap,
        install through the normal replicated write path, re-dispatch."""
        oid = msg.oid
        self._promote_waiting[oid] = [(conn, msg)]
        base = self.base_pool
        if base is None:
            self._promote_waiting.pop(oid, None)
            self._reply(conn, msg, -22, [])
            return
        self.osd.base_pool_op(
            base.id, oid,
            [("read", 0, 0), ("getxattrs",), ("omap_get",)],
            lambda reply: self.osd.op_wq.queue(
                self.pgid, self._finish_promote, oid, reply))

    def _finish_promote(self, oid: str, reply) -> None:
        with self.lock:
            waiters = self._promote_waiting.pop(oid, [])
            if not waiters:
                return
            if self.osd.store.exists(self.cid, oid):
                # a whole-object client write raced the base fetch and
                # fully defined the object — installing the (older)
                # base copy over it would lose the acked write
                for conn, m in waiters:
                    m._promoted = True
                    self.do_op(conn, m)
                return
            if reply is None:
                for conn, m in waiters:
                    self._reply(conn, m, -11, [])   # retryable
                return
            if reply.result != 0:
                # base miss: reads answer ENOENT; writes proceed and
                # create the object fresh in the tier
                for conn, m in waiters:
                    _r, writes = self._split_ops(m.ops)
                    if writes:
                        m._promoted = True
                        self.do_op(conn, m)
                    else:
                        self._reply(conn, m, reply.result, [])
                return
            data, xattrs, omap = (reply.outdata + [b"", {}, {}])[:3]
            ops: list = [("writefull", data or b"")]
            for k, v in (xattrs or {}).items():
                ops.append(("setxattr", k, v))
            if omap:
                ops.append(("omap_set", dict(omap)))

            def installed(result: int) -> None:
                with self.lock:
                    for conn, m in waiters:
                        if result == 0:
                            m._promoted = True
                            self.do_op(conn, m)
                        else:
                            self._reply(conn, m, result or -11, [])

            self._internal_write(oid, ops, installed)

    def _internal_write(self, oid: str, ops: list, done=None) -> None:
        """Write with no external client, through the NORMAL
        replicated path (version, log entry, fan-out) so tier
        replicas converge — a bare store txn would leave them
        inconsistent.  Caller holds self.lock."""
        msg = MOSDOp(tid=next(self._int_tid), pgid=str(self.pgid),
                     oid=oid, ops=ops, epoch=self.osd.osdmap.epoch)
        msg.src = f"osd.{self.osd.whoami}.cache.{self.pgid}"
        msg._cache_internal = True
        msg._internal_done = done
        self._do_write(None, msg)

    def _hit_set_record(self, oid: str) -> None:
        """Append the access to the current HitSet, rotating by
        hit_set_period and keeping hit_set_count sets (HitSet history;
        persisted in the pg meta omap on rotation, hit_set_persist)."""
        pool = self.pool
        period = float(pool.hit_set_period or 0)
        count = max(1, int(pool.hit_set_count or 1))
        now = self.osd.clock.now()
        rotate = (not self.hit_sets or
                  (period > 0 and now - self.hit_sets[-1][0] >= period)
                  # period<=0 misconfiguration: still bound the set
                  or len(self.hit_sets[-1][1]) >= 65536)
        if rotate:
            self.hit_sets.append([now, set()])
            del self.hit_sets[:-count]
            txn = Transaction().omap_setkeys(
                self.cid, "_pgmeta",
                {"hitsets": denc.dumps(
                    [[ts, sorted(s)] for ts, s in self.hit_sets])})
            try:
                self.osd.store.apply_transaction(txn)
            except StoreError:
                pass
        self.hit_sets[-1][1].add(oid)

    def _hot_oids(self) -> set:
        hot: set = set()
        for _ts, oids in self.hit_sets:
            hot |= oids
        return hot

    def agent_work(self, max_ops: int = 8) -> None:
        """Flush/evict agent tick (agent_work): bounded work per call;
        the heartbeat re-queues it while there is dirty state.

        Dirty/whiteout flushing runs in EVERY cache mode while the
        pool is linked as a tier — switching writeback -> readonly ->
        none must not strand un-flushed updates/deletes in the tier.
        Eviction is writeback-only.  Steady-state cost is bounded by
        the _agent_hints index (fed by the write path); a periodic
        full scan catches state from before a restart/failover."""
        with self.lock:
            if not (self.is_primary and self.active):
                return
            pool = self.pool
            if pool is None or pool.tier_of < 0:
                return
            base = self.base_pool
            if base is None:
                return
            self._agent_tick += 1
            target = int(pool.target_max_objects or 0)
            full = self._agent_tick == 1 or self._agent_tick % 20 == 0
            if not full and not self._agent_hints:
                return
            store = self.osd.store
            if full:
                try:
                    candidates = [
                        n for n in store.collection_list(self.cid)
                        if not n.startswith("_pgmeta") and "@" not in n]
                except StoreError:
                    return
            else:
                candidates = sorted(self._agent_hints)
            dirty, whiteouts, clean = [], [], []
            for name in candidates:
                if name in self._flushing:
                    continue
                try:
                    attrs = store.getattrs(self.cid, name)
                except StoreError:
                    self._agent_hints.discard(name)   # evicted/deleted
                    continue
                if WHITEOUT_KEY in attrs:
                    whiteouts.append(name)
                elif DIRTY_KEY in attrs:
                    dirty.append(name)
                else:
                    self._agent_hints.discard(name)   # observed clean
                    clean.append(name)
            for oid in whiteouts[:max_ops]:
                self._flushing.add(oid)
                self._flush_whiteout(oid, base)
            for oid in dirty[:max_ops]:
                self._flushing.add(oid)
                self._flush_dirty(oid, base)
            # eviction needs the complete clean census: full scans only
            if target > 0 and full and pool.cache_mode == "writeback":
                live = len(dirty) + len(clean)
                # pool-wide target split across this pool's PGs
                # (agent_choose_mode divides by pg count the same way)
                per_pg = target / max(1, pool.pg_num)
                excess = live - per_pg
                if excess > 0:
                    hot = self._hot_oids()
                    victims = sorted(clean, key=lambda o: o in hot)
                    n = min(int(excess + 0.999), max_ops, len(victims))
                    for oid in victims[:n]:
                        self._internal_write(oid, [("evict",)])

    def _flush_dirty(self, oid: str, base) -> None:
        """Push the tier copy to the base pool, then clear DIRTY —
        unless a newer write re-dirtied it mid-flight (start_flush
        dup-write guard)."""
        store = self.osd.store
        try:
            data = store.read(self.cid, oid)
            attrs = store.getattrs(self.cid, oid)
        except StoreError:
            self._flushing.discard(oid)
            return
        try:
            omap = store.omap_get(self.cid, oid)
        except StoreError:
            omap = {}
        version = self.pglog.objects.get(oid)
        ops: list = [("writefull", data)]
        for k, v in attrs.items():
            if k.startswith("u."):
                ops.append(("setxattr", k[2:], v))
        if omap:
            ops.append(("omap_set", dict(omap)))

        def flushed(reply) -> None:
            self.osd.op_wq.queue(self.pgid, self._finish_flush,
                                 oid, version, reply)

        self.osd.base_pool_op(base.id, oid, ops, flushed)

    def _finish_flush(self, oid: str, version, reply) -> None:
        with self.lock:
            self._flushing.discard(oid)
            if reply is None or reply.result != 0:
                return            # retried on a later agent tick
            if self.pglog.objects.get(oid) != version:
                return            # re-dirtied mid-flush; flush again
            self._internal_write(oid, [("rmattr_raw", DIRTY_KEY)])

    def _flush_whiteout(self, oid: str, base) -> None:
        """Propagate a whiteout as a base-pool delete, then drop the
        local marker object entirely."""
        def deleted(reply) -> None:
            self.osd.op_wq.queue(self.pgid, self._finish_whiteout,
                                 oid, reply)

        self.osd.base_pool_op(base.id, oid, [("delete",)], deleted)

    def _finish_whiteout(self, oid: str, reply) -> None:
        with self.lock:
            self._flushing.discard(oid)
            if reply is None:
                return
            if reply.result not in (0, -ENOENT):
                return
            try:
                self.osd.store.getattr(self.cid, oid, WHITEOUT_KEY)
            except StoreError:
                return    # a client write revived the object mid-
                          # flight; evicting now would drop acked data
            # base is clean (deleted or never had it): retire the
            # whiteout on the whole acting set
            self._internal_write(oid, [("evict",)])

