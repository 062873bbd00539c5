"""output_tokens_per_s (tokens/s): output tokens stamped in the window
(each once, however often a preemption made it again) over the window's
seconds."""
from portbench.metrics._window import window_stamps


def read(rec):
    w0, w1 = rec.window
    return len(window_stamps(rec)) / (w1 - w0)
