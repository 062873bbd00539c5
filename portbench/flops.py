"""Operations and bytes from shapes: a step's model FLOPs (``step_mfu``)
and a paged-attention call's bytes and FLOPs (``paged_attn_roofline``).

``model`` is a configuration's ``model`` block.  A row is one token that
goes through the stack; its ``ctx`` is the number of keys it attends (its
position + 1).  A multiply-add counts 2 FLOPs.  Model FLOPs count the work
the served tokens need: the experts a token is routed to (not the
capacity buffer the program computes), real rows only (not padding), the
output head only for the rows whose logits are read.
"""
from __future__ import annotations

from portbench import peaks


def _dims(model):
    d, H, Hkv = model["d_model"], model["n_heads"], model["n_kv_heads"]
    return d, H, Hkv, model.get("head_dim") or d // H


def layer_params(model, moe: bool) -> int:
    """Weights one token multiplies by in one layer: the attention
    projections and the FFN's (a MoE layer's router, routed top-k and
    shared experts)."""
    d, H, Hkv, hd = _dims(model)
    attn = d * (H + 2 * Hkv) * hd + H * hd * d
    if moe:
        m = model["moe"]
        ffn = d * m["n_experts"] + m["top_k"] * 3 * d * m["d_ff_expert"]
        if m["n_shared_experts"]:
            ffn += 3 * d * m["d_ff_shared"]
    else:
        ffn = (3 if model.get("act", "silu") == "silu" else 2) \
            * d * model["d_ff"]
    return attn + ffn


def matmul_flops_per_token(model) -> int:
    """2 x the weights a token multiplies by over the stack (head out)."""
    n = model["n_layers"]
    k = model["moe"]["first_k_dense"] if model.get("moe") else n
    total = k * layer_params(model, False)
    if n > k:
        total += (n - k) * layer_params(model, True)
    return 2 * total


def attn_flops(model, ctxs) -> int:
    """QK^T and PV of rows attending ``ctxs`` keys, over every layer."""
    _, H, _, hd = _dims(model)
    return 4 * H * hd * int(sum(ctxs)) * model["n_layers"]


def step_flops(model, ctxs, logit_rows: int) -> int:
    """Model FLOPs of a step over rows attending ``ctxs`` keys, reading
    ``logit_rows`` rows of logits."""
    return (len(ctxs) * matmul_flops_per_token(model)
            + attn_flops(model, ctxs)
            + 2 * model["d_model"] * model["vocab_size"] * logit_rows)


def paged_call(model, table_ctxs, row_ctxs, kv_bytes=2, q_bytes=2):
    """(bytes, FLOPs) of one layer's paged-attention call: each table
    row's K and V read once up to its context (``table_ctxs``), each
    query row read once and its output written once, and the scores and
    weighted sums of rows attending ``row_ctxs`` keys."""
    _, H, Hkv, hd = _dims(model)
    nbytes = (int(sum(table_ctxs)) * Hkv * hd * 2 * kv_bytes
              + 2 * len(row_ctxs) * H * hd * q_bytes)
    return nbytes, 4 * H * hd * int(sum(row_ctxs))


def least_seconds(nbytes, flops) -> float:
    """The least time the card takes for this many bytes and FLOPs."""
    return max(nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.BF16_FLOPS)
