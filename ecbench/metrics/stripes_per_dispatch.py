"""Unpadded stripes per pipeline dispatch in the window: how far the
pipeline coalesced the op threads' items."""


def read(rec):
    p = rec["delta"]["pipe"]
    if not p["dispatches"]:
        return None
    return p["stripes"] / p["dispatches"]
