"""step_ms (ms): mean model-step wall (``iter_log``) of the window's
iterations outside the profiled slice."""
from portbench.metrics._window import window_iters


def read(rec):
    its = window_iters(rec)
    if not its:
        return None
    return sum(it.model_s for it in its) / len(its) * 1e3
