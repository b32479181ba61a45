"""The 95th percentile of all calls' latencies in the window, in ms: from
the call's start (its batch in pinned host memory) to its outputs on the
host.  The loop is closed, so the cell runs at its capacity, where a tail
swings with the host: a per-layer reading beside the rate, with no bound."""

import numpy as np


def read(trace):
    if not trace.latencies:
        return None
    return float(np.percentile(np.asarray(trace.latencies), 95)) * 1e3
