"""Share of the profiled stretch in which no kernel or copy ran on the
card, in %: 1 - the union of the trace's device intervals."""


def read(rec):
    tr = rec["trace"]
    if not tr or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
