"""OSD scrub service: scheduled + commanded scrubs and repair.

Mixin half of the OSD daemon: interval-driven scrub scheduling
(OSD::sched_scrub, osd/OSD.cc:1054), shallow/deep scans (EC deep
scans batch shard CRCs through the fused device pass — the north
star's scrub-sized batches), authoritative-copy repair
(PGBackend.cc:501 be_select_auth_object) and EC shard rebuild repair
(test/osd/osd-scrub-repair.sh scenarios).
"""

from __future__ import annotations

import threading
from concurrent.futures import TimeoutError as FuturesTimeout

import numpy as np

from ..crush.map import ITEM_NONE
from ..ops import crc32c as crc_mod
from ..store.objectstore import StoreError, Transaction
from ..utils import denc
from .messages import MPGInfo
from .pg import HINFO_KEY, PG, VER_KEY, shard_oid


class ScrubService:
    def _sched_scrub(self, now: float) -> None:
        """Interval-driven scrubs (OSD::sched_scrub under
        sched_scrub_lock, osd/OSD.cc:1054): each heartbeat tick kicks
        up to osd_max_scrubs primary PGs whose stamps are past
        osd_scrub_min_interval (shallow) or osd_deep_scrub_interval
        (deep), gated on client load — a busy OSD defers."""
        if self._stopped:
            return
        load = self.op_tracker.dump_ops_in_flight()["num_ops"]
        if load >= int(self.conf.osd_scrub_load_threshold):
            return
        min_iv = float(self.conf.osd_scrub_min_interval)
        deep_iv = float(self.conf.osd_deep_scrub_interval)
        repair = bool(self.conf.osd_scrub_auto_repair)
        with self.pg_lock:
            pgs = list(self.pgs.values())
        for pg in pgs:
            if not pg.acting or pg.acting[0] != self.whoami \
                    or not getattr(pg, "active", False):
                continue
            deep = now - pg.last_deep_scrub_stamp >= deep_iv
            if not deep and now - pg.last_scrub_stamp < min_iv:
                continue
            # acquire the slot BEFORE stamping: a PG stamped by a
            # loser-of-the-race would silently skip its whole interval
            if not self._scrub_slots.acquire(blocking=False):
                break
            # stamp optimistically: a failing scrub must not re-fire
            # every tick (the next interval retries it)
            pg.last_scrub_stamp = now
            if deep:
                pg.last_deep_scrub_stamp = now

            def run(pg=pg, deep=deep):
                # dedicated thread: a scrub blocks on replica round-
                # trips, so it must neither occupy an op-queue shard
                # (cross-OSD shard deadlock when every OSD schedules
                # at once) nor run in the timer thread
                try:
                    result = pg.scrub(deep=deep, repair=repair)
                    self.log.info("scheduled %sscrub %s: %s",
                                  "deep-" if deep else "", pg.pgid,
                                  result)
                except Exception as e:
                    self.log.warn("scheduled scrub %s failed: %s",
                                  pg.pgid, e)
                finally:
                    self._scrub_slots.release()

            threading.Thread(target=run, daemon=True,
                             name=f"osd{self.whoami}-scrub").start()

    # -- scrub + repair ----------------------------------------------------

    def _scan_pg(self, pg: PG, deep: bool) -> dict:
        """Local scrub scan: {oid_or_shard: (size, crc|None)}."""
        out = {}
        try:
            names = self.store.collection_list(pg.cid)
        except StoreError:
            return out
        if pg.is_ec and deep:
            return self._scan_ec_deep(pg, names)
        for name in names:
            if name.startswith("_pgmeta") or "@" in name:
                continue          # pg meta + EC rollback stashes
            try:
                data = self.store.read(pg.cid, name)
            except StoreError:
                continue
            crc = crc_mod.crc32c(0, data) if deep else None
            out[name] = (len(data), crc)
        return out

    def _scan_ec_deep(self, pg: PG, names: list[str]) -> dict:
        """Device-batched shard verification through the shared EC device
        pipeline: shards group by size, every group's CRC batches are
        submitted up front (overlapped dispatches; concurrent scrubs
        on other PGs coalesce into the same mega-batches), results
        gather at the end (the north-star scrub path).

        HBM-cache fast path first: an object whose encoded stripes
        still sit on a card (committed at the object's current
        version, store-coherent — any non-attested shard mutation
        dropped the entry) has its shard CRC folded from the entry's
        per-stripe chunk CRCs: a host-side carry-less combine of
        4-byte values, ZERO bytes re-uploaded, zero device dispatches.
        Corrupted or out-of-band-mutated shards always miss and take
        the full read+fold path below."""
        from ..ops import hbm_cache
        from ..ops import pipeline as ec_pipeline
        from . import ecutil
        by_size: dict[int, list[tuple[str, bytes, int]]] = {}
        out = {}
        cached_folds: dict[str, list[int] | None] = {}

        def cache_folds(base: str):
            """Per-shard folded CRCs for `base` from the HBM cache
            (None = miss; memoized per scan so k+m shard files cost
            one lookup)."""
            if base in cached_folds:
                return cached_folds[base]
            folds = None
            with pg.lock:
                cur = pg.pglog.objects.get(base)
            if cur is not None:
                ent = hbm_cache.get().lookup(pg.cid, base,
                                             version=tuple(cur))
                if ent is not None:
                    folds = ecutil.fold_shard_crcs(ent.crcs,
                                                   ent.chunk_size)
            cached_folds[base] = folds
            return folds

        for name in names:
            if name.startswith("_pgmeta") or "@" in name:
                continue          # pg meta + EC rollback stashes
            base, _, sfx = name.rpartition(".s")
            if sfx.isdigit():
                folds = cache_folds(base)
                shard = int(sfx)
                if folds is not None and shard < len(folds):
                    try:
                        size = self.store.stat(pg.cid, name)["size"]
                        hinfo = denc.loads(self.store.getattr(
                            pg.cid, name, HINFO_KEY))
                    except StoreError:
                        continue
                    out[name] = (size, bool(folds[shard]
                                            == hinfo["crc"]))
                    continue
            try:
                data = self.store.read(pg.cid, name)
                hinfo = denc.loads(self.store.getattr(pg.cid, name,
                                                      HINFO_KEY))
            except StoreError:
                continue
            by_size.setdefault(len(data), []).append(
                (name, data, hinfo["crc"]))
        batch_max = int(self.conf.osd_deep_scrub_stripe_batch)
        pipe = ec_pipeline.get()
        pending: list = []

        def collect_one() -> None:
            size, chunk, fut = pending.pop(0)
            try:
                _path, (crcs,) = fut.result(
                    ec_pipeline.RESULT_TIMEOUT)
            except FuturesTimeout:
                # wedged pipeline (hung device fetch): the scrub fails
                # with the timeout counted; the CRCs are never folded
                # on the host instead
                pipe.note_result_timeout()
                raise TimeoutError(
                    f"deep scrub of pg {pg.pgid}: CRC batch of "
                    f"{len(chunk)} x {size} B not resolved within "
                    f"{ec_pipeline.RESULT_TIMEOUT:.0f}s") from None
            for (name, _d, expected), got in zip(chunk, crcs):
                out[name] = (size, bool(int(got) == expected))

        for size, group in by_size.items():
            if size == 0:
                for name, _d, expected in group:
                    out[name] = (0, 0 == expected)
                continue
            chan = ec_pipeline.crc_channel(size,
                                           max_coalesce=batch_max)
            for i in range(0, len(group), batch_max):
                chunk = group[i:i + batch_max]
                arr = np.stack([np.frombuffer(d, dtype=np.uint8)
                                for _n, d, _c in chunk])
                pending.append((size, chunk, pipe.submit(chan, arr)))
                # sliding window: keep a handful of batches in flight
                # for dispatch overlap without queueing a second copy
                # of the whole PG's shard bytes at once
                if len(pending) >= 8:
                    collect_one()
        while pending:
            collect_one()
        return out

    def scrub_replicated_pg(self, pg: PG, deep: bool) -> dict:
        my_scan = self._scan_pg(pg, deep)
        peers = [o for o in pg.acting_live() if o != self.whoami]
        scans = {self.whoami: my_scan}
        for osd_id in peers:
            reply = self._call(osd_id, MPGInfo(
                op="scan", pgid=str(pg.pgid), deep=deep,
                epoch=self.osdmap.epoch), timeout=20.0)
            if reply is not None:
                scans[osd_id] = reply.info
        inconsistent = []
        all_names = set()
        for scan in scans.values():
            all_names.update(scan)
        for name in sorted(all_names):
            variants = {osd: scan.get(name) for osd, scan in scans.items()}
            vals = set(variants.values())
            if len(vals) > 1:
                inconsistent.append({"object": name, "copies": variants})
        return {"checked": len(all_names), "inconsistent": inconsistent}

    def scrub_ec_pg(self, pg: PG) -> dict:
        """Each shard OSD verifies its shards against hinfo (deep);
        shards a holder should have but doesn't are flagged too."""
        my_scan = self._scan_pg(pg, deep=True)
        scans = {self.whoami: my_scan}
        for osd_id in pg.acting_live():
            if osd_id == self.whoami:
                continue
            reply = self._call(osd_id, MPGInfo(
                op="scan", pgid=str(pg.pgid), deep=True,
                epoch=self.osdmap.epoch), timeout=20.0)
            if reply is not None:
                scans[osd_id] = reply.info
        inconsistent = []
        checked = 0
        bases = set()
        for osd_id, scan in scans.items():
            for name, (size, ok) in scan.items():
                checked += 1
                base, _, sfx = name.rpartition(".s")
                if sfx.isdigit():
                    bases.add(base)
                if ok is False:
                    inconsistent.append({"object": name, "osd": osd_id})
        # a shard FILE a live holder lacks entirely never shows up in
        # its scan: cross-check expected placement (only for holders
        # whose scan we actually have — a scan timeout is not absence)
        for base in bases:
            if base not in pg.pglog.objects:
                continue
            for shard, holder in enumerate(pg.acting):
                if holder == ITEM_NONE or holder not in scans:
                    continue
                name = shard_oid(base, shard)
                if name not in scans[holder]:
                    inconsistent.append({"object": name, "osd": holder,
                                         "missing": True})
        return {"checked": checked, "inconsistent": inconsistent}

    def repair_replicated_pg(self, pg: PG, inconsistent: list) -> int:
        """Heal scrub findings: majority vote over the scan variants
        picks the authoritative copy (be_select_auth_object reduced —
        the reference prefers digest-clean copies; absent stored
        digests, agreement is the signal), the primary pulls it if a
        peer holds it, then pushes it to every divergent holder.

        Runs WITHOUT pg.lock held (push/fetch replies need it)."""
        my = self.whoami
        repaired = 0
        for item in inconsistent:
            name = item["object"]
            if "@" in name or name.startswith("_pgmeta"):
                continue
            variants = {o: (tuple(v) if v is not None else None)
                        for o, v in item["copies"].items()}
            counts: dict[tuple, list] = {}
            for osd_id, v in variants.items():
                if v is not None:
                    counts.setdefault(v, []).append(osd_id)
            if not counts:
                continue
            auth, holders = max(
                counts.items(), key=lambda kv: (len(kv[1]), my in kv[1]))
            bad = [o for o, v in variants.items() if v != auth]
            with pg.lock:
                version = pg.pglog.objects.get(name, (0, 0))
            if my not in holders:
                reply = self._call(holders[0], MPGInfo(
                    op="fetch_obj", pgid=str(pg.pgid), oid=name,
                    epoch=self.osdmap.epoch), timeout=10.0)
                if reply is None or reply.info.get("missing"):
                    continue
                with pg.lock:
                    txn = Transaction()
                    txn.try_remove(pg.cid, name)
                    txn.touch(pg.cid, name)
                    if reply.info["data"]:
                        txn.write(pg.cid, name, 0, reply.info["data"])
                    for k, v in reply.info["xattrs"].items():
                        txn.setattr(pg.cid, name, k, v)
                    if reply.info["omap"]:
                        txn.omap_setkeys(pg.cid, name,
                                         reply.info["omap"])
                    try:
                        self.store.apply_transaction(txn)
                    except StoreError:
                        continue
                bad = [o for o in bad if o != my]
                self.log.info("repair: pulled auth %s from osd.%d",
                              name, holders[0])
            healed = True
            for osd_id in bad:
                if osd_id != my:
                    # synchronous: the clean_after_repair re-scrub
                    # right after this must observe the healed copy
                    if not self.repair_push_object(pg, osd_id, name,
                                                   version,
                                                   shard=None):
                        healed = False
            if healed:
                repaired += 1
        return repaired

    def repair_ec_pg(self, pg: PG, inconsistent: list) -> int:
        """Shard-granular EC repair: decode each damaged object from
        its surviving shards (known-bad ones excluded) and rebuild the
        bad shards in place (osd-scrub-repair.sh
        TEST_corrupt_and_repair_jerasure/lrc scenarios)."""
        by_oid: dict[str, set] = {}
        for item in inconsistent:
            base, _, sfx = item["object"].rpartition(".s")
            if sfx.isdigit():
                by_oid.setdefault(base, set()).add(int(sfx))
        repaired = 0
        for oid, bad_shards in sorted(by_oid.items()):
            with pg.lock:
                version = pg.pglog.objects.get(oid, (0, 0))
                data = pg._ec_read_local(oid, exclude=bad_shards)
            if data is None:
                self.log.warn("repair: %s unrecoverable without "
                              "shards %s", oid, sorted(bad_shards))
                continue
            targets = [(s, pg.acting[s]) for s in sorted(bad_shards)
                       if s < len(pg.acting)
                       and pg.acting[s] != ITEM_NONE]
            self._ec_push_shards(pg, oid, version, targets, data)
            repaired += 1
        return repaired

