"""Helpers the metric readers share: the window's iterations and
tokens."""
from __future__ import annotations


def window_iters(rec, profiled=False):
    """Iterations with a model step inside the window; ``profiled``
    selects those inside the profiled slice, else those outside it."""
    return [it for it in rec.iters if it.model_s is not None
            and rec.in_window(it.t0, it.t1) and it.profiled == profiled]


def window_stamps(rec):
    """(request log, stamp) of every output token stamped in the window."""
    return [(lg, t) for lg in rec.requests for t in lg.stamps
            if rec.in_window(t)]
