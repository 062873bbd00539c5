"""host_ms_per_iter (ms): mean over the window's iterations (outside the
profiled slice) of the wall time around ``step()`` less that iteration's
model step and copy back (``iter_log``): the host's scheduling, admission,
planning and bookkeeping."""
from portbench.metrics._window import window_iters


def read(rec):
    its = window_iters(rec)
    if not its:
        return None
    return sum(it.t1 - it.t0 - it.model_s for it in its) / len(its) * 1e3
