"""device_idle_share (%): the share of the profiled slice with nothing
running on the device (the union of kernel, copy and set intervals)."""
from portbench.harness import busy_intervals


def read(rec):
    tr = rec.trace
    if tr is None or tr.t1 <= tr.t0:
        return None
    busy = sum(e - s for s, e in busy_intervals(tr.kernels, tr.t0, tr.t1))
    return 100.0 * (1.0 - busy / (tr.t1 - tr.t0))
