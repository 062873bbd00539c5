"""decode_rows_per_iter (rows): mean decode rows (``iter_log``) of the
window's iterations outside the profiled slice."""
from portbench.metrics._window import window_iters


def read(rec):
    its = window_iters(rec)
    if not its:
        return None
    return sum(it.decode_rows for it in its) / len(its)
