"""step_mfu (%): the window's model FLOPs (``flops.step_flops``: matmuls
of the real rows, attention over each row's keys, the head over the rows
whose logits make a token) over the model steps' wall time (``iter_log``)
times the card's bf16 peak; iterations outside the profiled slice."""
from portbench import flops, peaks
from portbench.metrics._window import window_iters


def read(rec):
    its = window_iters(rec)
    secs = sum(it.model_s for it in its)
    if not its or secs <= 0:
        return None
    work = 0
    for it in its:
        ctxs = [s + j + 1 for s, n in it.chunks for j in range(n)]
        work += flops.step_flops(rec.model, ctxs + it.decode_ctx,
                                 it.first_tokens + len(it.decode_ctx))
    return 100.0 * work / (secs * peaks.BF16_FLOPS)
