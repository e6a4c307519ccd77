"""Bytes the write path copied on the host (the audited `ec.stage` and
`ec.shard_layout` sites) per client byte, over the window."""


def read(rec):
    if rec["entry"] != "write" or not rec["bytes"]:
        return None
    c = rec["delta"]["copies"]
    return (c.get("ec.stage", 0) + c.get("ec.shard_layout", 0)) / rec["bytes"]
