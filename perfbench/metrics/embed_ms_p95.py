"""embed_ms_p95: the 95th percentile of every request issued in the window,
timed at its client from the call to the reply; a request that failed, or
never came back, is infinite."""

import numpy as np


def read(run):
    lat = run.get("latencies_s")
    if lat is None:
        return None
    if not len(lat):
        return float("inf")
    return float(np.percentile(np.asarray(lat, np.float64), 95)) * 1e3
