"""Mean milliseconds an encode item waited in the dispatch pipeline's
queues, over the items resolved in the window: its `ec.coalesce`
(submit to the dispatcher's pick) and `ec.lane_queue` (pick to the
stager's start) phases."""


def read(rec):
    ph = rec["delta"].get("phases")
    if rec["entry"] != "write" or not ph or not ph.get("enc/items"):
        return None
    s = sum(ph.get(f"enc/{n}/sum", 0.0)
            for n in ("ec.coalesce", "ec.lane_queue"))
    return 1e3 * s / ph["enc/items"]
