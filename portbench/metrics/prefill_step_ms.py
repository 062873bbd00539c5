"""prefill_step_ms (ms): mean model-step wall (``iter_log``, the step and
its copy back) of the window's iterations that carry prompt rows, outside
the profiled slice."""
from portbench.metrics._window import window_iters


def read(rec):
    its = [it for it in window_iters(rec) if it.prefill_rows > 0]
    if not its:
        return None
    return sum(it.model_s for it in its) / len(its) * 1e3
