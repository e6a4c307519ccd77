"""Share of the pipeline's dispatches in the window that ran on the host
(a cold shape or a host route) rather than on the card, in %."""


def read(rec):
    p = rec["delta"]["pipe"]
    if not p["dispatches"]:
        return None
    return 100.0 * p["host_dispatches"] / p["dispatches"]
