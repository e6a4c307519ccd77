"""CephFS wire messages (messages/MClientRequest.h / MClientReply.h)."""

from __future__ import annotations

from ..msg import Message, register_message


@register_message
class MClientRequest(Message):
    """client -> mds metadata op.

    fields: tid, op (str), path (str), and op-specific args:
      mkdir/create: mode-ish ignored; rename: new_path;
      setattr: size/mtime; readdir/lookup/getattr: just path.
    """
    TYPE = 220


@register_message
class MClientReply(Message):
    TYPE = 221
    # fields: tid, result (0 or -errno), data (op-specific)


@register_message
class MClientCaps(Message):
    """mds -> client capability revoke (messages/MClientCaps.h,
    Locker.cc revocation reduced): the client must drop its cached
    dentries/attrs under each path (prefix semantics) and ack,
    flushing any buffered attr state in the ack."""
    TYPE = 222
    # fields: ack_id, paths (list[str])


@register_message
class MClientCapsAck(Message):
    TYPE = 223
    # fields: ack_id, flushes ({path: buffered size})
