"""paged_attn_roofline (%): the least time of the profiled slice's
paged-attention calls (``flops.paged_call``: each request's K/V read once
per layer, queries and outputs once, the larger of bytes over the HBM
peak and FLOPs over the bf16 peak) over the device time of the kernels
named ``paged_*`` (plan, walks, combine) in the trace.

The paged backend makes one call a layer and iteration over its chunk and
decode rows; the slots backend one a layer for each prompt chunk and one
for the decode step over every slot (``slot_ctx``)."""
from portbench import flops
from portbench.metrics._window import window_iters


def _calls(rec, it):
    """[(table contexts, row contexts)] of one layer's calls."""
    chunk_rows = [[s + j + 1 for j in range(n)] for s, n in it.chunks]
    if rec.engine["backend"] == "paged":
        return [([r[-1] for r in chunk_rows] + it.decode_ctx,
                 [c for r in chunk_rows for c in r] + it.decode_ctx)]
    calls = [([r[-1]], r) for r in chunk_rows]
    if it.slot_ctx and it.decode_ctx:
        calls.append((it.slot_ctx, it.slot_ctx))
    return calls


def read(rec):
    its = window_iters(rec, profiled=True)
    if rec.trace is None or not its:
        return None
    # the kernels of these iterations: each step waits for its device
    # work before it returns
    lo, hi = min(it.t0 for it in its), max(it.t1 for it in its)
    device = sum(e - s for n, s, e in rec.trace.kernels
                 if "paged_" in n and lo <= s and e <= hi)
    least = 0.0
    for it in its:
        for tables, rows in _calls(rec, it):
            least += rec.model["n_layers"] * flops.least_seconds(
                *flops.paged_call(rec.model, tables, rows))
    if device <= 0 or least <= 0:
        return None
    return 100.0 * least / device
