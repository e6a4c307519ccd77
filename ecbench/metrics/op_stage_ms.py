"""Mean milliseconds a write's op thread spent staging it, over the
window: the port's `ec.arena` (checking out the pinned arena) and
`ec.stage_copy` (the payload copy into it) spans, each over its own
count."""


def _mean(d, name):
    n = d.get(f"{name}/avgcount", 0)
    return d.get(f"{name}/sum", 0.0) / n if n else None


def read(rec):
    spans = rec["delta"].get("spans")
    if rec["entry"] != "write" or not spans:
        return None
    parts = [_mean(spans, n) for n in ("ec.arena", "ec.stage_copy")]
    return None if None in parts else 1e3 * sum(parts)
