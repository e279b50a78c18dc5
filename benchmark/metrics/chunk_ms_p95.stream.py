"""95th percentile of the window's per-chunk latencies (each ``feed`` of a
live session, from the call to its return), milliseconds."""

import numpy as np


def read(run):
    lat = run.window.get("chunk_s")
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
