"""Logical object bytes returned by degraded reads that completed inside
the window, over the window's seconds; GB = 1e9 B."""


def read(rec):
    if rec["entry"] != "degraded_read":
        return None
    return rec["bytes"] / rec["window_s"] / 1e9
