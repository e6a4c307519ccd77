"""Client payload bytes whose encode (parity, every chunk CRC, shards laid
out) completed inside the window, over the window's seconds; GB = 1e9 B."""


def read(rec):
    if rec["entry"] != "write":
        return None
    return rec["bytes"] / rec["window_s"] / 1e9
