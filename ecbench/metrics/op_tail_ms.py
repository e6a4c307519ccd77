"""Mean milliseconds of a write after its readback, over the window: the
encode item's `ec.tail` phase (cache staging, resolve, the op thread's
wake-up and its shard layout) and the op thread's `ec.cache_commit`
span, each over its own count."""


def read(rec):
    ph, spans = rec["delta"].get("phases"), rec["delta"].get("spans")
    if rec["entry"] != "write" or not ph or not spans:
        return None
    n_tail = ph.get("enc/ec.tail/avgcount", 0)
    n_commit = spans.get("ec.cache_commit/avgcount", 0)
    if not n_tail or not n_commit:
        return None
    return 1e3 * (ph["enc/ec.tail/sum"] / n_tail
                  + spans["ec.cache_commit/sum"] / n_commit)
