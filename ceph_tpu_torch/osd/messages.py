"""OSD wire messages (messages/MOSD*.h analogs)."""

from __future__ import annotations

from ..msg import Message, register_message


def sender_id(msg) -> int | None:
    """OSD id from a message's entity name ("osd.N"), None if absent
    or not an OSD peer."""
    src = getattr(msg, "src", None)
    if not isinstance(src, str):
        return None
    parts = src.split(".")
    if len(parts) < 2 or parts[0] != "osd":
        return None
    try:
        return int(parts[1])
    except ValueError:
        return None


@register_message
class MOSDOp(Message):
    """Client -> primary OSD op (messages/MOSDOp.h:34).

    fields: tid, pgid (str), oid, ops (list of op tuples), epoch
    op tuples: ("write", off, bytes) ("writefull", bytes)
               ("read", off, len) ("stat",) ("delete",)
               ("setxattr", name, val) ("getxattr", name)
               ("omap_set", {k: v}) ("omap_get",) ("append", bytes)
    """
    TYPE = 200


@register_message
class MOSDOpReply(Message):
    TYPE = 201
    # fields: tid, result, outdata (per-op list), version, epoch


@register_message
class MOSDRepOp(Message):
    """Primary -> replica transaction (messages/MOSDRepOp.h)."""
    TYPE = 202
    # fields: reqid, pgid, ops (Transaction.ops), log_entries, version,
    #         epoch


@register_message
class MOSDRepOpReply(Message):
    TYPE = 203
    # fields: reqid, pgid, result


@register_message
class MOSDECSubOpWrite(Message):
    """Primary -> shard k+m fan-out (messages/MOSDECSubOpWrite.h)."""
    TYPE = 204
    # fields: reqid, pgid, shard, ops, log_entries, version, epoch


@register_message
class MOSDECSubOpWriteReply(Message):
    TYPE = 205
    # fields: reqid, pgid, shard, result


@register_message
class MOSDECSubOpRead(Message):
    TYPE = 206
    # fields: reqid, pgid, shard, oid, off, length


@register_message
class MOSDECSubOpReadReply(Message):
    TYPE = 207
    # fields: reqid, pgid, shard, result, data, hinfo_crcs


@register_message
class MOSDPing(Message):
    """OSD <-> OSD heartbeat (messages/MOSDPing.h)."""
    TYPE = 208
    # fields: op ("ping"|"reply"), stamp, epoch


@register_message
class MPGInfo(Message):
    """Peering control plane (MOSDPGInfo / MOSDPGLog / MOSDPGQuery
    reduced to one op-tagged frame).

    ops and their fields:
      query/info      — info {last_update, log_tail,
                        last_epoch_started, last_backfill?,
                        backfilling, unknown?}: the exchanged LOG
                        BOUNDS (O(1) in object count) find_best_info
                        orders over
      get_log         — since (ev); reply op="log" info {entries,
                        last_update, contains_since} or {too_old}
                        (contains_since=False: the caller's head names
                        a divergent branch -> rewind, not merge)
      get_full_log    — reply op="log" info {entries, tail}
      rewind          — rewind_to (ev): rewind_divergent_log target
      activate        — les (epoch): primary activated this interval;
                        members stamp last_epoch_started
      backfill_start / backfill_progress {watermark} /
      backfill_done {entries, tail} — the last_backfill lifecycle
      scan_range / scanned_range, push_delete, pull, fetch_obj,
      request_peering, rebuild_me, ec_omap, shard_scan — recovery RPCs
    """
    TYPE = 209


@register_message
class MPGPush(Message):
    """Recovery: object payload push (MOSDPGPush analog)."""
    TYPE = 210
    # fields: pgid, oid, version, data, xattrs, omap, shard (EC), epoch


@register_message
class MPGPushReply(Message):
    TYPE = 211
    # fields: pgid, oid, shard


@register_message
class MOSDScrub(Message):
    TYPE = 212
    # fields: pgid, deep


@register_message
class MWatchNotify(Message):
    """OSD -> watching client: a notify fired on a watched object
    (messages/MWatchNotify.h)."""
    TYPE = 213
    # fields: oid, pool, notify_id, cookie, payload


@register_message
class MWatchNotifyAck(Message):
    """Watching client -> OSD: ack a notify, optionally with a reply
    payload gathered back to the notifier."""
    TYPE = 214
    # fields: oid, pgid, notify_id, cookie, reply
