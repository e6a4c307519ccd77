"""Share of the profiled stretch's device-idle gaps (between the card's
kernel and copy intervals) in which no work range of the port was open
on any thread, in %: idle time that no span of the port explains."""


def read(rec):
    tr = rec["trace"]
    if rec["entry"] != "write" or not tr or not tr.get("idle_gap_s"):
        return None
    return 100.0 * tr["idle_unattributed_s"] / tr["idle_gap_s"]
