"""ECBackend: erasure-coded I/O engine
(osd/ECBackend.{h,cc} + osd/ECTransaction.{h,cc} reduced).

Mixed into PG (pg.py): whole-object encode fan-out, the O(tail)
partial-stripe append, rollback stashes + divergent rewind, shard
reads with version gating, reconstruct reads, and the superseded-skip
shard-rebuild heal.  Stripe math and the fused encode+CRC device pass
live in ecutil.py / ops/.
"""

from __future__ import annotations

from errno import EAGAIN, EIO

import numpy as np

from ..crush.map import ITEM_NONE
from ..erasure.interface import ErasureCodeError
from ..ops import crc32c as crc_mod
from ..ops import hbm_cache
from ..store.objectstore import ENOENT, StoreError, Transaction
from ..utils import denc
from ..utils.bufferlist import BufferList
from . import ecutil
from .messages import (MOSDECSubOpReadReply, MOSDECSubOpWrite,
                       MOSDECSubOpWriteReply, MPGInfo, sender_id)
from .pglog import (HINFO_KEY, VER_KEY, ZERO_EV, _parse_ev, shard_oid,
                    stash_oid)


class ECBackend:
    # ---- EC write path ---------------------------------------------------

    def _ec_codec(self):
        return self.osd.get_ec_codec(self.pool)

    def _ec_sinfo(self, codec=None) -> ecutil.StripeInfo:
        """Stripe geometry from the pool's EC profile (stripe_unit),
        rounded so a chunk holds whole codec alignment units."""
        codec = codec or self._ec_codec()
        pool = self.pool
        profile = self.osd.osdmap.ec_profiles.get(
            pool.erasure_code_profile or "", {})
        su = int(profile.get("stripe_unit", ecutil.DEFAULT_STRIPE_UNIT))
        k = codec.get_data_chunk_count()
        per_chunk = max(1, codec.get_alignment() // k)
        su = -(-su // per_chunk) * per_chunk
        return ecutil.StripeInfo(k, su)

    def _ec_object_payload(self, msg) -> tuple[str, object]:
        """EC pools accept whole-object payloads (writefull/append).

        Returns (kind, payload): kind is "data" (re-encode), "meta"
        (metadata-only vector — no encode needed) or "unsupported"
        (partial overwrite etc. -> EOPNOTSUPP).  The payload is a
        bytes-like or a BufferList rope (append = old bytes + delta as
        two shared segments, no concatenation copy) — the encode
        staging pass consumes either.
        """
        data = None
        has_data_op = False
        for op in msg.ops:
            if op[0] == "writefull":
                data = op[1]
                has_data_op = True
            elif op[0] == "append":
                cur = self._ec_read_local(msg.oid)
                data = BufferList()
                if cur:
                    data.append(cur)
                if len(op[1]):
                    data.append(op[1])
                has_data_op = True
            elif op[0] == "touch":
                if msg.oid in self.pglog.objects:
                    continue        # exists: metadata no-op, no encode
                has_data_op = True
                if data is None:
                    data = b""      # create-empty
            elif op[0] in ("delete", "setxattr", "omap_set",
                           "omap_rm"):
                continue
            else:
                return "unsupported", None
        return ("data" if has_data_op else "meta"), data

    def _ec_write(self, conn, msg, version: tuple, reqid) -> None:
        codec = self._ec_codec()
        km = codec.get_chunk_count()
        is_delete = any(op[0] == "delete" for op in msg.ops)
        if not is_delete and \
                self._ec_try_append(conn, msg, version, reqid, codec):
            return
        payload = None
        meta_only = False
        if not is_delete:
            kind_p, payload = self._ec_object_payload(msg)
            if kind_p == "unsupported":
                self._reply(conn, msg, -95, [])   # EOPNOTSUPP: EC overwrite
                return
            if kind_p == "meta":
                if msg.oid in self.pglog.objects:
                    # object exists, shard bytes untouched: no encode
                    meta_only = True
                else:
                    # replicated pools create on setxattr/omap — match
                    # that by creating an empty object here
                    payload = b""
        # stripe the payload and SUBMIT the fused encode+CRC batch to
        # the shared device pipeline (ECUtil::encode's loop, batched
        # onto the card); parity + scrub CRCs are collected below, after
        # the op's journal/metadata prep, so concurrent writes coalesce
        # into one amortized dispatch instead of serial round trips.
        # shard_data holds zero-copy memoryviews over ONE contiguous
        # shard-major layout (ecutil.EncodeHandle) — store writes and
        # peer sub-ops slice it, never materializing per-shard bytes
        shard_data: list = []
        crcs: list[int] = []
        prefix_crcs: list[int] = []
        obj_size = 0
        stripe_unit = 0
        encode = None
        if not is_delete and not meta_only:
            obj_size = len(payload)
            sinfo = self._ec_sinfo(codec)
            stripe_unit = sinfo.chunk_size
            # tag the encode for the HBM stripe cache: if it rides a
            # device, the uploaded data + computed parity stay on that
            # chip so deep scrub / recovery of this object never pay
            # another H2D; committed below once the shards are on disk
            encode = ecutil.encode_object_async(
                codec, sinfo, payload,
                cache=hbm_cache.CacheIntent(
                    self.cid, msg.oid, tuple(version), obj_size,
                    stripe_unit),
                qos=self.osd.qos_tag_of(self.pgid.pool))
        elif is_delete:
            # overwrite-by-delete: the cached stripes are history
            hbm_cache.get().invalidate(self.cid, msg.oid)
        prior = self.pglog.objects.get(msg.oid)
        kind = "delete" if is_delete else "modify"
        # EC mutations are rollback-able (ECTransaction.h:201 model):
        # each shard stashes its current object at `prior` before
        # applying, so a divergent entry can be rewound during peering
        entry = {"ev": version, "oid": msg.oid, "op": kind,
                 "prior": prior, "rollback": {"type": "stash"},
                 "shard": None, "reqid": reqid}
        if encode is not None:
            shard_data, stripe_crcs = encode.result()
            crcs = ecutil.fold_shard_crcs(stripe_crcs, stripe_unit)
            # crc over the full-stripe prefix: the chain seed a later
            # partial-stripe append continues from (HashInfo model)
            prefix_crcs = ecutil.fold_shard_crcs(
                stripe_crcs, stripe_unit,
                upto=obj_size // sinfo.stripe_width)
        peers = {}
        waiting = set()
        for shard, osd_id in enumerate(self.acting):
            if osd_id == ITEM_NONE:
                continue
            txn = Transaction()
            soid = shard_oid(msg.oid, shard)
            if prior is not None:
                txn.try_clone(self.cid, soid, stash_oid(soid, prior))
            if is_delete:
                txn.try_remove(self.cid, soid)
            else:
                if not meta_only:
                    hinfo = denc.dumps({"size": obj_size,
                                          "crc": crcs[shard],
                                          "crc_prefix": prefix_crcs[shard],
                                          "shard": shard,
                                          "stripe_unit": stripe_unit})
                    txn.truncate(self.cid, soid, 0)
                    txn.write(self.cid, soid, 0, shard_data[shard])
                    txn.setattr(self.cid, soid, HINFO_KEY, hinfo)
                txn.setattr(self.cid, soid, VER_KEY,
                            repr(version).encode())
                # the omap rides on every shard, as the xattrs do: a
                # copy on shard 0 alone is lost to reads while that
                # shard's holder is down (recovery_svc.ec_get_omap)
                for op in msg.ops:
                    if op[0] == "setxattr":
                        txn.setattr(self.cid, soid, "u." + op[1], op[2])
                    elif op[0] == "omap_set":
                        txn.omap_setkeys(self.cid, soid, op[1])
                    elif op[0] == "omap_rm":
                        txn.omap_rmkeys(self.cid, soid, op[1])
            if shard == self.role_of(self.osd.whoami):
                try:
                    self._apply_ec_sub_write(txn, entry, shard)
                except StoreError as e:
                    # local apply failed (e.g. pg removal raced the
                    # write): error the client now rather than letting
                    # the op dangle un-gathered until its timeout
                    self._reply(conn, msg, -e.errno, [])
                    return
            else:
                peers[osd_id] = (shard, txn)
                waiting.add(shard)
        if encode is not None:
            # our shard bytes are applied: disk and HBM agree, the
            # staged cache entry (if the encode ran on a device) may
            # serve scrubs/recoveries from now on.  Peer sub-writes
            # land the SAME version and are recognized as such by the
            # store-txn coherence scan.
            hbm_cache.get().commit(self.cid, msg.oid, tuple(version))
        # sub-ops carry the client op's trace id: shard apply
        # timelines on every peer correlate in merged trace dumps
        trk = getattr(msg, "_trk", None)
        trace = getattr(trk, "trace_id", "") if trk is not None else ""
        sub_msgs = {}
        for osd_id, (shard, txn) in peers.items():
            sub_msgs[shard] = (osd_id, MOSDECSubOpWrite(
                reqid=reqid, pgid=str(self.pgid), shard=shard, ops=txn.ops,
                log=entry, roll_forward_to=self.last_complete,
                trace=trace, epoch=self.osd.osdmap.epoch))
        state = {"waiting": waiting, "conn": conn, "msg": msg,
                 "version": version, "kind": "ec", "peers": sub_msgs,
                 "born": self.osd.clock.now(),
                 "applied": {self.role_of(self.osd.whoami)}}
        self._inflight[reqid] = state
        for osd_id, sub in sub_msgs.values():
            self.osd.send_osd(osd_id, sub)
        if trk is not None and state["waiting"]:
            # closes at reply time (trk.finish auto-close): the span
            # IS the shard sub-op round trip
            trk.span_begin("replica_wait", shards=len(waiting))
        self._maybe_commit(reqid)

    # ---- EC partial-stripe append (ECTransaction.h:201 model) -----------
    #
    # An append touches only the TAIL stripe(s): per-shard I/O is
    # O(append/k + chunk), not O(object/k).  The primary reads the old
    # partial tail stripe (k data-shard tail chunks), encodes
    # old_tail+delta as an independent stripe batch, and each shard
    # writes the new tail region at its full-stripe boundary.  CRCs
    # chain: every shard keeps crc_prefix (cumulative CRC of its
    # immutable full-stripe prefix) in its HashInfo and combines the
    # primary-computed tail CRCs into its own — no shard ever rereads
    # its file.  Rollback stashes only the old tail chunk + HashInfo
    # (rewind = truncate + restore tail), not a whole-object clone.

    def _ec_try_append(self, conn, msg, version: tuple, reqid,
                       codec) -> bool:
        """Attempt the O(tail) append path; False -> caller falls back
        to the whole-object re-encode path."""
        appends = [op for op in msg.ops if op[0] == "append"]
        if len(appends) != 1 or any(
                op[0] not in ("append", "setxattr", "omap_set", "omap_rm")
                for op in msg.ops):
            return False
        delta = appends[0][1]
        oid = msg.oid
        if oid not in self.pglog.objects or not delta:
            return False
        store = self.osd.store
        my_shard = self.role_of(self.osd.whoami)
        soid = shard_oid(oid, my_shard)
        try:
            hinfo = denc.loads(store.getattr(self.cid, soid, HINFO_KEY))
        except StoreError:
            return False
        sinfo = self._ec_sinfo(codec)
        k = codec.get_data_chunk_count()
        L = sinfo.chunk_size
        W = sinfo.stripe_width
        if "crc_prefix" not in hinfo or hinfo.get("stripe_unit") != L:
            return False          # pre-upgrade object: slow path once
        old_size = int(hinfo["size"])
        full_before = old_size // W
        chunk_off = full_before * L
        tail_len = old_size - full_before * W
        # -- old tail bytes: the k data shards' tail chunks ---------------
        old_tail = b""
        if tail_len:
            chunks: dict[int, bytes] = {}
            remote: list[tuple[int, int]] = []
            for i in range(k):
                holder = self.acting[i] if i < len(self.acting) \
                    else ITEM_NONE
                if holder == self.osd.whoami:
                    try:
                        chunks[i] = store.read(self.cid,
                                               shard_oid(oid, i),
                                               chunk_off, L)
                    except StoreError:
                        return False
                elif holder == ITEM_NONE or \
                        not self.osd.osdmap.is_up(holder):
                    return False  # degraded tail: slow path reconstructs
                else:
                    remote.append((i, holder))
            if remote:
                fetched = self.osd.ec_fetch_shards(
                    self.pgid, oid, remote, off=chunk_off, length=L)
                for i, _h in remote:
                    if i not in fetched:
                        return False
                    chunks[i] = fetched[i][0]
            for i in range(k):
                chunks[i] = chunks[i].ljust(L, b"\0")
            old_tail = b"".join(chunks[i] for i in range(k))[:tail_len]
        # -- encode the new tail region as its own stripe batch -----------
        # SUBMIT the tail encode to the shared device pipeline and
        # collect at the last moment: the op thread builds its log
        # entry/rollback bookkeeping while the stripes coalesce with
        # every other producer's (concurrent appends ride ONE
        # overlapped dispatch instead of a serial round trip each)
        # rope concat: the old tail and the delta ride as two shared
        # segments into the encode staging pass (no join copy)
        tail_payload = BufferList()
        if old_tail:
            tail_payload.append(old_tail)
        if len(delta):
            tail_payload.append(delta)
        new_size = old_size + len(delta)
        # APPEND WRITE-THROUGH: the cached whole-object stripes stay
        # valid AT THE OLD VERSION until the tail txn applies (lookups
        # are version-gated), and below the tail encode's stripes are
        # concatenated onto the resident prefix as a pending entry at
        # the NEW version — hot append streams keep their objects
        # cache-served instead of self-invalidating every append
        encode = ecutil.encode_object_async(
            codec, sinfo, tail_payload,
            qos=self.osd.qos_tag_of(self.pgid.pool))
        S_tail = sinfo.stripe_count(len(tail_payload))
        prefix_in_tail = new_size // W - full_before
        prior = self.pglog.objects.get(oid)
        entry = {"ev": version, "oid": oid, "op": "modify",
                 "prior": prior,
                 "rollback": {"type": "append", "chunk_off": chunk_off},
                 "shard": None, "reqid": reqid}
        waiting = set()
        sub_msgs = {}
        tail_shards, stripe_crcs = encode.result()
        tail_crcs = ecutil.fold_shard_crcs(stripe_crcs, L)
        tail_prefix_crcs = ecutil.fold_shard_crcs(stripe_crcs, L,
                                                  upto=prefix_in_tail)
        # write-through staging BEFORE the local apply: the store-txn
        # coherence scan at apply time sees the tail write attested at
        # `version`, keeps this pending entry and drops the old one.
        # Falls back to plain invalidation when the object was not
        # resident (append_through handles it).
        if prior is not None:
            km = codec.get_chunk_count()
            tail_rows = [np.frombuffer(tail_shards[c],
                                       dtype=np.uint8).reshape(-1, L)
                         for c in range(km)]
            hbm_cache.get().append_through(
                self.cid, oid, tuple(prior), tuple(version), new_size,
                L, full_before,
                np.stack(tail_rows[:k], axis=1),
                np.stack(tail_rows[k:], axis=1),
                np.asarray(stripe_crcs))
        else:
            hbm_cache.get().invalidate(self.cid, oid)
        for shard, osd_id in enumerate(self.acting):
            if osd_id == ITEM_NONE:
                continue
            txn = Transaction()
            txn.write(self.cid, shard_oid(oid, shard), chunk_off,
                      tail_shards[shard])
            txn.setattr(self.cid, shard_oid(oid, shard), VER_KEY,
                        repr(version).encode())
            for op in msg.ops:
                if op[0] == "setxattr":
                    txn.setattr(self.cid, shard_oid(oid, shard),
                                "u." + op[1], op[2])
                elif op[0] == "omap_set":
                    txn.omap_setkeys(self.cid, shard_oid(oid, shard),
                                     op[1])
                elif op[0] == "omap_rm":
                    txn.omap_rmkeys(self.cid, shard_oid(oid, shard),
                                    op[1])
            # each shard chains its OWN HashInfo from these
            ainfo = {"old_size": old_size, "new_size": new_size,
                     "chunk_off": chunk_off, "stripe_unit": L,
                     "tail_crc": tail_crcs[shard],
                     "tail_len": S_tail * L,
                     "tail_prefix_crc": tail_prefix_crcs[shard],
                     "tail_prefix_len": prefix_in_tail * L}
            if osd_id == self.osd.whoami:
                try:
                    self._apply_ec_sub_write(txn, entry, shard,
                                             append_info=ainfo)
                except StoreError as e:
                    self._reply(conn, msg, -e.errno, [])
                    return True
            else:
                trk = getattr(msg, "_trk", None)
                sub = MOSDECSubOpWrite(
                    reqid=reqid, pgid=str(self.pgid), shard=shard,
                    ops=txn.ops, log=entry,
                    roll_forward_to=self.last_complete,
                    trace=(getattr(trk, "trace_id", "")
                           if trk is not None else ""),
                    epoch=self.osd.osdmap.epoch)
                sub.append_info = ainfo
                sub_msgs[shard] = (osd_id, sub)
                waiting.add(shard)
        if prior is not None:
            # our tail bytes are applied: promote the write-through
            # entry (no-op if append_through fell back to invalidate)
            hbm_cache.get().commit(self.cid, oid, tuple(version))
        state = {"waiting": waiting, "conn": conn, "msg": msg,
                 "version": version, "kind": "ec", "peers": sub_msgs,
                 "born": self.osd.clock.now(),
                 "applied": {my_shard}}
        self._inflight[reqid] = state
        for osd_id, sub in sub_msgs.values():
            self.osd.send_osd(osd_id, sub)
        trk = getattr(msg, "_trk", None)
        if trk is not None and waiting:
            trk.span_begin("replica_wait", shards=len(waiting))
        self._maybe_commit(reqid)
        return True

    def _ec_apply_append_info(self, txn: Transaction, entry: dict,
                              shard: int, ainfo: dict) -> None:
        """Shard-local half of a partial append: chain the new
        HashInfo CRCs from this shard's own crc_prefix, and stash the
        old tail chunk + HashInfo so the entry can rewind."""
        store = self.osd.store
        soid = shard_oid(entry["oid"], shard)
        old_blob = store.getattr(self.cid, soid, HINFO_KEY)
        old = denc.loads(old_blob)
        if old.get("stripe_unit") != ainfo["stripe_unit"] or \
                int(old.get("size", -1)) != ainfo["old_size"] or \
                "crc_prefix" not in old:
            raise StoreError(5, f"append hinfo mismatch on {soid}")
        seed = old["crc_prefix"]
        new_crc = crc_mod.crc32c_combine(seed, ainfo["tail_crc"],
                                         ainfo["tail_len"])
        if ainfo["tail_prefix_len"]:
            new_prefix = crc_mod.crc32c_combine(
                seed, ainfo["tail_prefix_crc"], ainfo["tail_prefix_len"])
        else:
            new_prefix = seed
        # rollback stash: just the rewritten tail chunk + old HashInfo
        if entry.get("prior") is not None:
            stash = stash_oid(soid, tuple(entry["prior"]))
            chunk_off = ainfo["chunk_off"]
            try:
                old_len = store.stat(self.cid, soid)["size"]
                tail = store.read(self.cid, soid, chunk_off, 0) \
                    if old_len > chunk_off else b""
            except StoreError:
                old_len, tail = 0, b""
            pre = Transaction()
            pre.try_remove(self.cid, stash)
            pre.touch(self.cid, stash)
            if tail:
                pre.write(self.cid, stash, 0, tail)
            pre.setattr(self.cid, stash, "_alen", repr(old_len).encode())
            pre.setattr(self.cid, stash, "_ahinfo", old_blob)
            pre.setattr(self.cid, stash, "_aoff", repr(chunk_off).encode())
            txn.ops = pre.ops + txn.ops
        txn.setattr(self.cid, soid, HINFO_KEY, denc.dumps({
            "size": ainfo["new_size"], "crc": new_crc,
            "crc_prefix": new_prefix, "shard": shard,
            "stripe_unit": ainfo["stripe_unit"]}))

    def _apply_ec_sub_write(self, txn: Transaction, entry: dict,
                            shard: int, append_info: dict | None = None
                            ) -> None:
        """Apply a shard write + log entry (annotated with OUR shard so
        a later rewind knows which local files to restore)."""
        entry = dict(entry)
        entry["shard"] = shard
        if append_info is not None:
            self._ec_apply_append_info(txn, entry, shard, append_info)
        self._log_and_apply(txn, entry)

    def _request_ec_heal(self, oid: str, shard: int, msg) -> None:
        """Ask the primary to rebuild OUR shard of `oid` — it skipped
        a sub-op and may hold stale bytes that would silently mix
        generations into a decode."""
        cur = self.pglog.objects.get(oid)
        if cur is None:
            return
        sender = sender_id(msg)
        if sender is not None and sender != self.osd.whoami:
            self.osd.send_osd(sender, MPGInfo(
                op="rebuild_me", pgid=str(self.pgid),
                oid=oid, shard=shard, version=cur,
                epoch=self.osd.osdmap.epoch))

    def handle_ec_sub_write(self, conn, msg, _parked: bool = False) -> None:
        with self.lock:
            if self._already_applied(tuple(msg.log["ev"])):
                self.osd.send_osd_reply(conn, MOSDECSubOpWriteReply(
                    reqid=msg.reqid, pgid=str(self.pgid),
                    shard=msg.shard, result=0))
                return
            if self._superseded(msg.log):
                # this shard skipped op N but applied newer N+1 (park
                # expired or cap hit).  A meta-only N+1 over a missed
                # data write leaves STALE shard bytes — rebuild us.
                self._request_ec_heal(msg.log["oid"], msg.shard, msg)
                self.osd.send_osd_reply(conn, MOSDECSubOpWriteReply(
                    reqid=msg.reqid, pgid=str(self.pgid),
                    shard=msg.shard, result=0))
                return
            if not _parked and self._park_if_gap(conn, msg, "ec"):
                return            # replied when the gap fills/expires
            txn = Transaction()
            txn.ops = list(msg.ops)
            try:
                self._apply_ec_sub_write(
                    txn, msg.log, msg.shard,
                    append_info=getattr(msg, "append_info", None))
                result = 0
            except StoreError as e:
                result = -e.errno
            rf = getattr(msg, "roll_forward_to", None)
            if rf is not None:
                self._trim_rollback(tuple(rf))
            self.osd.send_osd_reply(conn, MOSDECSubOpWriteReply(
                reqid=msg.reqid, pgid=str(self.pgid), shard=msg.shard,
                result=result))
            if result == 0:
                self._flush_parked(msg.log["oid"])

    def _trim_rollback(self, to_ev: tuple) -> None:
        """Drop stash objects for entries fully acked cluster-wide.

        A high-water mark keeps this O(new entries) per call — without
        it every sub-write would rescan (and exists()-probe) the whole
        bounded log.
        """
        start = getattr(self, "_rolled_forward_to", ZERO_EV)
        if to_ev <= start:
            return
        store = self.osd.store
        txn = Transaction()
        dirty = False
        for e in self.pglog.entries:
            if e["ev"] > to_ev:
                break
            if e["ev"] <= start:
                continue
            if e.get("rollback") and e.get("prior") is not None \
                    and e.get("shard") is not None:
                soid = shard_oid(e["oid"], e["shard"])
                stash = stash_oid(soid, e["prior"])
                if store.exists(self.cid, stash):
                    txn.try_remove(self.cid, stash)
                    dirty = True
        self._rolled_forward_to = to_ev
        if dirty:
            try:
                store.apply_transaction(txn)
            except StoreError:
                pass

    def rewind_to(self, auth_ev: tuple) -> None:
        """Wire-facing rewind entry point: both pool types run the
        SAME shared core (peering.rewind_divergent_log -> PGLog.rewind);
        this backend only contributes the per-entry stash undo below."""
        self.rewind_divergent_log(auth_ev)

    def _ec_undo_divergent(self, txn: Transaction, e: dict) -> bool:
        """Store-level undo of one divergent EC shard entry
        (ECBackend rollback semantics): restore the stashed shard
        object (or stashed tail chunk + HashInfo for appends).
        Returns True when the prior bytes were restored locally —
        False (stash missing) re-enters the object in `missing` so a
        shard rebuild heals it instead of trusting stale bytes."""
        store = self.osd.store
        oid, prior, shard = e["oid"], e.get("prior"), e.get("shard")
        soid = shard_oid(oid, shard)
        rb = e.get("rollback") or {}
        if rb.get("type") == "append" and prior is not None:
            # tail-only undo: truncate back and restore the
            # stashed old tail chunk + HashInfo
            stash = stash_oid(soid, prior)
            try:
                old_len = int(store.getattr(
                    self.cid, stash, "_alen").decode())
                off = int(store.getattr(
                    self.cid, stash, "_aoff").decode())
                hin = store.getattr(self.cid, stash, "_ahinfo")
                tail = store.read(self.cid, stash)
            except StoreError:
                self.log.warn("append stash missing for %s", soid)
                txn.try_remove(self.cid, stash)
                return False
            txn.truncate(self.cid, soid, off)
            if tail:
                txn.write(self.cid, soid, off,
                          tail[: old_len - off])
            txn.truncate(self.cid, soid, old_len)
            txn.setattr(self.cid, soid, HINFO_KEY, hin)
            txn.try_remove(self.cid, stash)
            self.log.info("rewound append %s %s -> %s",
                          oid, e["ev"], prior)
            return True
        txn.try_remove(self.cid, soid)
        restored = False
        if prior is not None:
            stash = stash_oid(soid, prior)
            restored = store.exists(self.cid, stash)
            if not restored:
                self.log.warn("rollback stash missing for %s@%s",
                              soid, prior)
            txn.try_clone(self.cid, stash, soid)
            txn.try_remove(self.cid, stash)
        self.log.info("rewound divergent %s %s -> %s",
                      oid, e["ev"], prior)
        # prior None == divergent create: the removal above IS the
        # full restore.  Otherwise only a present stash counts — a
        # missing stash re-enters `missing` and rebuilds.
        return restored or prior is None

    def handle_ec_sub_write_reply(self, msg) -> None:
        with self.lock:
            state = self._inflight.get(msg.reqid)
            if state is None:
                return
            if msg.result != 0:
                state["failed"] = msg.result
            else:
                state.setdefault("applied", set()).add(msg.shard)
            state["waiting"].discard(msg.shard)
            self._maybe_commit(msg.reqid)

    # ---- EC read path ----------------------------------------------------

    def _ec_read_local(self, oid: str,
                       exclude: set | None = None,
                       need_ver: tuple | None = None,
                       qos: str | None = None) -> bytes | None:
        """Read + decode an EC object, fetching shards from peers.
        `exclude` drops known-bad shards (scrub repair: a corrupt
        local shard must not poison the reconstruction); `need_ver`
        version-gates every source shard (rebuild: a peer that has
        not applied the target version yet must not contribute);
        `qos` names the dmClock class any decode dispatch bills
        against (rebuild reads ride @recovery under the repair cap,
        like the rebuild's re-encode)."""
        exclude = exclude or set()
        # HBM stripe cache fast path: a committed entry at the
        # object's CURRENT version serves the whole payload straight
        # from the chip — no shard gather, no decode matmul, no H2D
        # (recovery/degraded reads of just-written objects).  The
        # entry is store-coherent: any non-attested shard mutation
        # (corruption included) invalidated it, so excluded-shard
        # callers still get pre-corruption truth.
        cur = self.pglog.objects.get(oid)
        if cur is not None and \
                (need_ver is None or tuple(need_ver) <= tuple(cur)):
            ent = hbm_cache.get().lookup(self.cid, oid,
                                         version=tuple(cur))
            if ent is not None:
                data = ent.data_bytes()
                if data is not None:
                    return data
        codec = self._ec_codec()
        k = codec.get_data_chunk_count()
        store = self.osd.store
        my_shard = self.role_of(self.osd.whoami)
        have: dict[int, bytes] = {}
        vers: dict[int, tuple] = {}      # shard -> applied version
        hinfo = None
        for shard, osd_id in enumerate(self.acting):
            if osd_id == ITEM_NONE or shard in exclude:
                continue
            soid = shard_oid(oid, shard)
            if osd_id == self.osd.whoami:
                try:
                    if need_ver is not None:
                        mine = _parse_ev(store.getattr(self.cid, soid,
                                                       VER_KEY))
                        if mine is None or mine < tuple(need_ver):
                            continue
                        vers[shard] = mine
                    have[shard] = store.read(self.cid, soid)
                    hinfo = denc.loads(store.getattr(self.cid, soid,
                                                     HINFO_KEY))
                except StoreError:
                    pass
            if len(have) >= k:
                break
        # fetch the rest synchronously from peers.  DEGRADED READS:
        # the gather early-completes once k shards exist — any k of
        # the k+m live shards reconstruct the object (ECBackend
        # get_min_avail_to_read_shards semantics), so a down holder
        # costs nothing when the live ones reach k, and is still
        # TRIED when they cannot (a wrongly-marked-down daemon may
        # well answer)
        if len(have) < k or hinfo is None:
            fetched = self.osd.ec_fetch_shards(
                self.pgid, oid,
                [(s, o) for s, o in enumerate(self.acting)
                 if o != ITEM_NONE and s not in have and s not in exclude
                 and o != self.osd.whoami],
                need_ver=need_ver,
                need=max(1, k - len(have)))
            for shard, (data, hi, ver) in fetched.items():
                have[shard] = data
                if ver is not None:
                    vers[shard] = tuple(ver)
                if hinfo is None and hi is not None:
                    hinfo = hi
        if hinfo is None or len(have) < k:
            # LAST-RESORT DEGRADED SWEEP: mid-remap (pg_temp release,
            # backfill in flight) shard files can sit on members the
            # acting order no longer points at; ask every up osd for
            # every missing shard id, version-gated so a stale
            # generation can never decode.  Valid for version-gated
            # callers too when the gate is at/under our recorded
            # version (the sweep serves exactly that version).
            cur = self.pglog.objects.get(oid)
            if cur is not None and (need_ver is None
                                    or tuple(need_ver) <= tuple(cur)):
                return self._ec_read_sweep(oid, exclude,
                                           strict_have=set(have),
                                           qos=qos)
            return None
        if need_ver is not None:
            # the >= gate alone is one-sided: a concurrent NEWER write
            # landing on some sources mid-collection would mix shard
            # generations into one decode.  Require every contributor
            # to report the SAME applied version (mismatch -> the
            # caller's retry/backoff takes another pass).
            got = {vers.get(s) for s in have}
            if len(got) != 1 or None in got:
                self.log.info("rebuild read of %s: mixed source "
                              "versions %s; retrying", oid, vers)
                return None
        # stripe-aware reassembly: intact data shards concatenate
        # directly; missing chunks rebuild in one batched pass
        sinfo = ecutil.StripeInfo(
            k, hinfo.get("stripe_unit") or len(next(iter(have.values()))))
        try:
            return ecutil.decode_object(codec, sinfo, have,
                                        hinfo["size"], qos=qos)
        except (ErasureCodeError, ValueError) as e:
            # the gathered shards cannot decode (too few of the right
            # size): the caller retries or sweeps.  A device or
            # pipeline failure (RuntimeError, TimeoutError) propagates
            self.log.warn("decode %s failed: %s (have %s, size %s)",
                          oid, e, sorted(have), hinfo.get("size"))
            return None

    def _ec_read_sweep(self, oid: str, exclude: set | None = None,
                       strict_have: set | None = None,
                       qos: str | None = None) -> bytes | None:
        """Broad degraded read: gather shards from ANY up osd, every
        source gated on the primary's recorded object version (the
        same-version rule below rejects mixed generations).  This is
        the fallback when the acting-indexed gather cannot reach k —
        the shards exist somewhere (a remap in flight moved the roles
        out from under the acting order) even though the acting set's
        holders do not serve them."""
        exclude = exclude or set()
        cur = self.pglog.objects.get(oid)
        if cur is None:
            return None
        need_ver = tuple(cur)
        codec = self._ec_codec()
        k = codec.get_data_chunk_count()
        km = codec.get_chunk_count()
        store = self.osd.store
        have: dict[int, bytes] = {}
        vers: dict[int, tuple] = {}
        hinfo = None
        for shard in range(km):        # any shard WE hold post-remap
            if shard in exclude:
                continue
            soid = shard_oid(oid, shard)
            try:
                mine = _parse_ev(store.getattr(self.cid, soid, VER_KEY))
                if mine is None or mine < need_ver:
                    continue
                have[shard] = store.read(self.cid, soid)
                vers[shard] = mine
                if hinfo is None:
                    hinfo = denc.loads(store.getattr(self.cid, soid,
                                                     HINFO_KEY))
            except StoreError:
                continue
        missing = [s for s in range(km)
                   if s not in have and s not in exclude]
        # every addressable osd is a candidate source — a wrongly-
        # marked-down daemon often still answers, and the `need`
        # early-exit keeps live replies from waiting on dead ones
        peers = [o for o in self.osd.osdmap.osds
                 if o != self.osd.whoami
                 and self.osd.osdmap.get_addr(o) is not None]
        if missing and peers:
            fetched = self.osd.ec_fetch_shards(
                self.pgid, oid, [(s, o) for s in missing for o in peers],
                need_ver=need_ver, need=max(1, k - len(have)))
            for shard, (data, hi, ver) in fetched.items():
                have[shard] = data
                if ver is not None:
                    vers[shard] = tuple(ver)
                if hinfo is None and hi is not None:
                    hinfo = hi
        if hinfo is None or len(have) < k:
            return None
        got = {vers.get(s) for s in have}
        if len(got) != 1 or None in got:
            self.log.info("degraded sweep of %s: mixed source "
                          "versions %s; retrying", oid, vers)
            return None
        sinfo = ecutil.StripeInfo(
            k, hinfo.get("stripe_unit") or len(next(iter(have.values()))))
        try:
            data = ecutil.decode_object(codec, sinfo, have,
                                        hinfo["size"], qos=qos)
        except (ErasureCodeError, ValueError) as e:
            # as in _ec_read_local: only the inputs' errors read as None
            self.log.warn("degraded sweep decode %s failed: %s "
                          "(have %s)", oid, e, sorted(have))
            return None
        self.log.info("degraded sweep read of %s served from shards "
                      "%s", oid, sorted(have))
        # read-triggered repair: the acting holders that failed the
        # strict pass are missing (or mis-rolled for) their shard —
        # queue a rebuild so placement converges instead of every
        # future read paying the sweep
        if strict_have is not None and getattr(self, "is_primary",
                                               False):
            misplaced = [(s, o) for s, o in enumerate(self.acting)
                         if o != ITEM_NONE and s not in strict_have
                         and s not in exclude]
            # one rebuild per shard: a joint rebuild excludes ALL its
            # target shard ids as sources, which can leave fewer than
            # k — rebuilding singly lets the other misplaced shards
            # serve as (version-gated, swept) sources
            for s, o in misplaced:
                self.osd.queue_ec_rebuild(self.pgid, oid, need_ver,
                                          [(s, o)])
        return data

    def handle_ec_sub_read(self, conn, msg) -> None:
        with self.lock:
            store = self.osd.store
            soid = shard_oid(msg.oid, msg.shard)
            off = getattr(msg, "off", 0) or 0
            length = getattr(msg, "length", 0) or 0
            need_ver = getattr(msg, "need_ver", None)
            if need_ver is not None:
                # version-gated source read (rebuild): refuse to serve
                # a shard that has not applied the target version yet —
                # mixing shard generations into one decode produces
                # silently wrong bytes (the reference gates recovery
                # reads via peer_missing / log versions, osd/ECBackend.cc)
                try:
                    have = _parse_ev(store.getattr(self.cid, soid,
                                                   VER_KEY))
                except StoreError:
                    have = None
                if have is None or have < tuple(need_ver):
                    reply = MOSDECSubOpReadReply(
                        reqid=msg.reqid, pgid=str(self.pgid),
                        shard=msg.shard, result=-11, data=b"",
                        hinfo=None)
                    reply.rpc_tid = getattr(msg, "rpc_tid", None)
                    self.osd.send_osd_reply(conn, reply)
                    return
                shard_ver = have
            try:
                if off or length:
                    # ranged read (partial-append tail fetch): serving
                    # O(range), so no whole-shard CRC pass here — deep
                    # scrub owns full verification
                    data = store.read(self.cid, soid, off, length)
                    hinfo = denc.loads(store.getattr(self.cid, soid,
                                                     HINFO_KEY))
                    result = 0
                else:
                    data = store.read(self.cid, soid)
                    hinfo = denc.loads(store.getattr(self.cid, soid,
                                                     HINFO_KEY))
                    # verify shard crc before serving (handle_sub_read
                    # behavior: EIO on checksum mismatch)
                    if crc_mod.crc32c(0, data) != hinfo["crc"]:
                        result, data, hinfo = -5, b"", None
                    else:
                        result = 0
            except StoreError as e:
                result, data, hinfo = -e.errno, b"", None
            reply = MOSDECSubOpReadReply(
                reqid=msg.reqid, pgid=str(self.pgid), shard=msg.shard,
                result=result, data=data, hinfo=hinfo,
                ver=(shard_ver if need_ver is not None else None))
            reply.rpc_tid = getattr(msg, "rpc_tid", None)
            self.osd.send_osd_reply(conn, reply)

    def _ec_local_shard(self, oid: str, shard: int | None = None) -> str:
        """The name of a shard file of `oid` that this OSD holds: the
        one at `shard` (default: our role), else any other at the
        object's current version.  Every shard carries the object's
        xattrs and omap, and a member going down can move the shard
        roles of the others (the role audit moves their files later):
        reads of either must not fail or read empty meanwhile."""
        store = self.osd.store
        want = shard_oid(oid, self.role_of(self.osd.whoami)
                         if shard is None else shard)
        if store.exists(self.cid, want):
            return want
        cur = self.pglog.objects.get(oid)
        for s in range(len(self.acting)):
            name = shard_oid(oid, s)
            try:
                ver = _parse_ev(store.getattr(self.cid, name, VER_KEY))
            except StoreError:
                continue
            if cur is not None and ver == tuple(cur):
                return name
        return want

    def _ec_write_gathering(self, oid: str) -> bool:
        return any(st.get("kind") == "ec" and st["msg"].oid == oid
                   for st in self._inflight.values())

    def _wake_reads_behind_writes(self, oid: str) -> None:
        """The last gathering write of `oid` finished (acked or
        failed): resume its parked reads through the op queue.  Caller
        holds self.lock."""
        if self._ec_write_gathering(oid):
            return
        for conn, msg in self._reads_behind_writes.pop(oid, ()):
            self.osd.op_wq.queue(self.pgid, self.osd._handle_op, conn,
                                 msg)

    def _drop_reads_behind_writes(self) -> None:
        """New interval: EAGAIN the parked reads (clients resend to
        the re-peered pg).  Caller holds self.lock."""
        parked = list(self._reads_behind_writes.values())
        self._reads_behind_writes.clear()
        for ops in parked:
            for conn, msg in ops:
                self._reply(conn, msg, -11, [])

    def _ec_unreadable(self, oid: str) -> StoreError:
        """The error of a read whose shard gather fell short: ENOENT only
        for an object the log does not hold.  One the log holds exists
        (its write was acked), and a gather that missed k shards (peers
        slower than the sub-read window) is worth a resend: EAGAIN."""
        if self.pglog.objects.get(oid) is None:
            return StoreError(ENOENT, "no such object")
        return StoreError(EAGAIN, f"EC object {oid}: shard gather short")

    def _ec_read(self, conn, msg) -> None:
        if self._ec_write_gathering(msg.oid):
            # a write of this object has its shards applied on some
            # holders and not yet on others: a gather across them
            # would decode two generations into one payload.  The read
            # waits for the write (the obc rw lock of PrimaryLogPG)
            self._reads_behind_writes.setdefault(msg.oid, []).append(
                (conn, msg))
            return
        out = []
        result = 0
        store = self.osd.store
        for op in msg.ops:
            try:
                if op[0] == "read":
                    data = self._ec_read_local(msg.oid)
                    if data is None:
                        raise self._ec_unreadable(msg.oid)
                    end = None if op[2] == 0 else op[1] + op[2]
                    out.append(data[op[1]: end])
                elif op[0] == "stat":
                    soid0 = shard_oid(msg.oid, 0)
                    # any shard's hinfo has the logical size
                    size = None
                    for shard, osd_id in enumerate(self.acting):
                        soid = shard_oid(msg.oid, shard)
                        if osd_id == self.osd.whoami:
                            try:
                                hinfo = denc.loads(
                                    store.getattr(self.cid, soid, HINFO_KEY))
                                size = hinfo["size"]
                                break
                            except StoreError:
                                continue
                    if size is None:
                        data = self._ec_read_local(msg.oid)
                        if data is None:
                            raise self._ec_unreadable(msg.oid)
                        size = len(data)
                    out.append({"size": size,
                                "version": self._obj_version(msg.oid)})
                elif op[0] == "getxattr":
                    out.append(store.getattr(
                        self.cid, self._ec_local_shard(msg.oid),
                        "u." + op[1]))
                elif op[0] == "getxattrs":
                    out.append({k[2:]: v for k, v in store.getattrs(
                        self.cid, self._ec_local_shard(msg.oid)).items()
                        if k.startswith("u.")})
                elif op[0] == "omap_get":
                    out.append(self.osd.ec_get_omap(self.pgid, msg.oid,
                                                    self.acting))
                elif op[0] == "omap_get_keys":
                    full = self.osd.ec_get_omap(self.pgid, msg.oid,
                                                self.acting)
                    out.append({k: full[k] for k in op[1] if k in full})
                elif op[0] == "omap_get_vals":
                    full = self.osd.ec_get_omap(self.pgid, msg.oid,
                                                self.acting)
                    sliced: dict = {}
                    for k in sorted(full):
                        if op[1] and k <= op[1]:
                            continue
                        if op[2] and not k.startswith(op[2]):
                            continue
                        sliced[k] = full[k]
                        if op[3] and len(sliced) >= op[3]:
                            break
                    out.append(sliced)
                elif op[0] == "call":
                    raise StoreError(95, "cls on EC pools unsupported")
                elif op[0] == "list":
                    names = store.collection_list(self.cid)
                    base = sorted({n.rsplit(".s", 1)[0] for n in names
                                   if ".s" in n and "@" not in n and
                                   not n.startswith("_pgmeta")})
                    out.append(base)
            except StoreError as e:
                result = -e.errno
                out.append(None)
                break
            except (RuntimeError, TimeoutError) as e:
                # the decode's device or pipeline failed: the client
                # gets EIO, never a read that looks like a missing object
                self.log.error("EC read of %s failed: %r", msg.oid, e)
                result = -EIO
                out.append(None)
                break
        self._reply(conn, msg, result, out)

    # -- replies -----------------------------------------------------------

