"""Median host-clock time of the window's writes, from the call into the
object path to the answer of `EncodeHandle.result` and the cache commit:
the time a client's whole-object write waits on the EC layer."""

import numpy as np


def read(rec):
    if rec["entry"] != "write" or not rec["latencies_s"]:
        return None
    return 1e3 * float(np.percentile(rec["latencies_s"], 50))
