"""95th percentile of the host-clock time of the window's ops, from the
call into the object path to its answer (a write's `result()`, the
`decode_object` return)."""

import numpy as np


def read(rec):
    lat = rec["latencies_s"]
    if len(lat) < 200:      # ten samples beyond the 95th percentile
        return None
    return 1e3 * float(np.percentile(lat, 95))
