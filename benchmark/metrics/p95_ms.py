"""p95_ms: the 95th percentile of the latency of the requests outside the
traced part of the window, from the client's call to the returned numpy
array (host clock)."""

import numpy as np


def read(run):
    lat = [e["latency_s"] for e in run.log if "rows" in e and not e["traced"]]
    return 1e3 * float(np.percentile(lat, 95)) if len(lat) >= 20 else None
