"""Plain float32 reference of DeepSeek-MoE: pre-norm RMSNorm, rotary MHA
over the whole prefix, the first ``first_k_dense`` layers with a SwiGLU
FFN, the rest with fine-grained experts: a router over every expert
(softmax of f32 logits), each token's ``top_k`` most probable experts
(ties to the lower index) weighted by their probabilities renormalised to
sum to one, each a SwiGLU of width ``d_ff_expert``, plus the shared
experts as one SwiGLU of width ``d_ff_shared`` on every token.  No token
is dropped.

Departure of the program's DeepSeek-MoE-16B from the published model,
which this reference follows (the configuration lists it under
``assumed``): the top-k weights are renormalised to sum to one.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from portbench.reference.common import Linear, exact_f32, run_stack


def _swiglu(h, w_gate, w_in, w_out, lin):
    return lin(F.silu(lin(h, w_gate)) * lin(h, w_in), w_out)


def _ffn(stage, i, moe, h, lin, *, k, route_bf16=False):
    f = stage["ffn"]
    if not moe:
        return _swiglu(h, lin.weight(f["w_gate"][i]),
                       lin.weight(f["w_in"][i]), lin.weight(f["w_out"][i]),
                       lin)
    E = f["router"].shape[-1]
    hr = h.bfloat16().float() if route_bf16 else h
    probs = torch.softmax(lin(hr, lin.weight(f["router"][i])), dim=-1)
    top, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, experts = top[:, :k], experts[:, :k]
    w = w / w.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(E):
        tok, slot = torch.nonzero(experts == e, as_tuple=True)
        if len(tok) == 0:
            continue
        y = _swiglu(h[tok], lin.weight(f["w_gate"][i, e]),
                    lin.weight(f["w_in"][i, e]), lin.weight(f["w_out"][i, e]),
                    lin)
        out.index_add_(0, tok, y * w[tok, slot][:, None])
    s = f["shared"]
    return out + _swiglu(h, lin.weight(s["w_gate"][i]),
                         lin.weight(s["w_in"][i]), lin.weight(s["w_out"][i]),
                         lin)


def logits(params, model, seqs, wants, *, fp8=False, device="cuda",
           route_bf16=False):
    """f32 logits at ``wants`` of each sequence; ``fp8``: the control;
    ``route_bf16``: the router's input rounded to bf16, the rest f32 (how
    far one rounding of the routing moves the reference itself)."""
    ffn = functools.partial(_ffn, k=model["moe"]["top_k"],
                            route_bf16=route_bf16)
    with exact_f32():
        return run_stack(params, model, seqs, wants, ffn, Linear(fp8),
                         device)
