"""Plain float32 reference of a dense GQA decoder (StarCoder2's layout as
the program runs it): pre-norm RMSNorm, rotary GQA attention over the
whole prefix, a two-matrix GELU (tanh) MLP, untied output head.

Departures of the program's StarCoder2-7B from the published model, which
this reference follows (the configuration lists them under ``assumed``):
RMSNorm in place of LayerNorm, no biases, no sliding window (every token
attends its whole prefix).
"""
from __future__ import annotations

import torch

from portbench.reference.common import Linear, exact_f32, run_stack


def _mlp(stage, i, moe, h, lin):
    f = stage["ffn"]
    a = lin(h, lin.weight(f["w_in"][i]))
    a = 0.5 * a * (1.0 + torch.tanh((2.0 / torch.pi) ** 0.5
                                    * (a + 0.044715 * a ** 3)))
    if "w_gate" in f:
        raise ValueError("dense_gqa: a gated FFN is another family")
    return lin(a, lin.weight(f["w_out"][i]))


def logits(params, model, seqs, wants, *, fp8=False, device="cuda"):
    """f32 logits at ``wants`` of each sequence (module docstring);
    ``fp8``: the control's fp8 weight products."""
    with exact_f32():
        return run_stack(params, model, seqs, wants, _mlp, Linear(fp8),
                         device)
