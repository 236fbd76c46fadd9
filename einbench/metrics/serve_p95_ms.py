"""The 95th percentile, over every request due in the window, of the time
from when it was due to when its answer was on the host; a request never
answered enters with its age when the drain ended (host clock).  Exact:
numpy's linear interpolation over all latencies, no buckets."""

import numpy as np


def read(run):
    if run["kind"] != "serve" or not run["latency_s"]:
        return None
    return float(np.percentile(np.asarray(run["latency_s"]), 95)) * 1e3
