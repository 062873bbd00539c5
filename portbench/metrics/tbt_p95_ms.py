"""tbt_p95_ms (ms): the 95th percentile of the gaps between consecutive
output tokens of one request, both stamped in the window."""
import numpy as np


def read(rec):
    gaps = [b - a for lg in rec.requests
            for a, b in zip(lg.stamps, lg.stamps[1:])
            if rec.in_window(a) and rec.in_window(b)]
    if not gaps:
        return None
    return float(np.percentile(gaps, 95)) * 1e3
