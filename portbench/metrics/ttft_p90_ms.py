"""ttft_p90_ms (ms): the 90th percentile of first-token stamp minus due
time over every request due in the window (the drain waits for their
first tokens)."""
import numpy as np


def read(rec):
    w0, w1 = rec.window
    ttft = [lg.stamps[0] - lg.due for lg in rec.requests
            if w0 <= lg.due < w1 and lg.stamps]
    if not ttft:
        return None
    return float(np.percentile(ttft, 90)) * 1e3
