"""The 95th percentile of the untraced window's frame times, in ms: each
frame on the host clock from its host arrays handed over to its boxes on
the host. In a closed loop the system runs at its capacity, so the tail
is a per-layer reading beside `frame_ms`, not a bound of its own."""

import numpy as np


def read(run):
    if not run.frame_times_s:
        return None
    return float(np.percentile(run.frame_times_s, 95)) * 1e3
