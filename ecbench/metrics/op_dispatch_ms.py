"""Mean milliseconds of an encode item's device dispatch, over the items
resolved in the window: its `ec.stage_h2d` (pinned staging and upload
issue), `ec.device_compute` (launch, the wait in the lane's window and
the stream's work) and `ec.d2h` (parity and CRC readback) phases."""


def read(rec):
    ph = rec["delta"].get("phases")
    if rec["entry"] != "write" or not ph or not ph.get("enc/items"):
        return None
    s = sum(ph.get(f"enc/{n}/sum", 0.0)
            for n in ("ec.stage_h2d", "ec.device_compute", "ec.d2h"))
    return 1e3 * s / ph["enc/items"]
