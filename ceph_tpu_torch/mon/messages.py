"""Monitor wire messages (messages/MMon*.h analogs)."""

from __future__ import annotations

from ..msg import Message, register_message


@register_message
class MMonElection(Message):
    """op: propose | ack | victory (mon/Elector protocol)."""
    TYPE = 100
    # fields: op, epoch, rank, quorum (victory)


@register_message
class MMonPaxos(Message):
    """op: collect|last|begin|accept|commit|lease|lease_ack."""
    TYPE = 101
    # fields: op, pn, last_committed, first_committed, version,
    #         value (txn blob), lease_expire, commits {v: blob}


@register_message
class MMonCommand(Message):
    TYPE = 102
    # fields: tid, cmd (dict with "prefix" + args)


@register_message
class MMonCommandAck(Message):
    TYPE = 103
    # fields: tid, retval, out (str), data (bytes)


@register_message
class MMonSubscribe(Message):
    TYPE = 104
    # fields: what: {"osdmap": start_epoch, "monmap": ...}


@register_message
class MMonMap(Message):
    TYPE = 105
    # fields: monmap (bytes)


@register_message
class MOSDMapMsg(Message):
    """Full map or incrementals published to subscribers."""
    TYPE = 106
    # fields: full (bytes | None), incrementals (list[bytes]), epoch


@register_message
class MOSDBoot(Message):
    TYPE = 107
    # fields: osd_id, addr, heartbeat_addr


@register_message
class MOSDFailure(Message):
    TYPE = 108
    # fields: target_osd, reporter, failed_for (seconds)


@register_message
class MOSDAlive(Message):
    TYPE = 109
    # fields: osd_id, epoch


@register_message
class MPGTemp(Message):
    """Primary requests pg_temp overrides (MOSDPGTemp analog)."""
    TYPE = 110
    # fields: osd_id, pg_temp: {pgid_str: [osds]}


@register_message
class MMonGetVersion(Message):
    TYPE = 111
    # fields: tid, what


@register_message
class MMonGetVersionReply(Message):
    TYPE = 112
    # fields: tid, version


@register_message
class MMgrBeacon(Message):
    """mgr -> mon: i am (still) the active mgr (messages/MMgrBeacon.h)."""
    TYPE = 113
    # fields: name, addr


@register_message
class MMgrReport(Message):
    """daemon -> mgr: perf counter report (messages/MMgrReport.h)."""
    TYPE = 114
    # fields: entity, counters (perf dump dict), epoch


@register_message
class MMDSBeacon(Message):
    """mds -> mon: active mds registration (messages/MMDSBeacon.h).

    `rank` places the daemon in the multi-rank FSMap (metadata
    namespace sharded across ranks, SURVEY §2.3)."""
    TYPE = 115
    # fields: name, addr, rank (default 0)


@register_message
class MPGStats(Message):
    """osd -> mon: per-pg stats from primaries (messages/MPGStats.h);
    the PGMonitor/PGMap feed that health summaries aggregate."""
    TYPE = 116
    # fields: osd_id, epoch, stats {pgid_str: {"state", "objects",
    #         "live", "acting"}}


@register_message
class MLogMsg(Message):
    """daemon/client -> mon: cluster log entries (messages/MLog.h);
    the LogClient feed behind `ceph log last`."""
    TYPE = 117
    # fields: entries [{stamp, level, text}]
