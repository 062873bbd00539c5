"""GQA parameter layout and int8 KV-cache quantization.

Port of ``repro/models/attention.py:33-40`` and ``:391-401``.  The dense
attention math of the serving path lives in the paged-attention kernels
(``repro_torch.kernels``).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import dense_init


def gqa_init(d_model, n_heads, n_kv_heads, head_dim, dtype,
             generator: torch.Generator, device):
    """wq/wk/wv (d_model, heads, head_dim), wo (n_heads, head_dim, d_model),
    each with fan-in taken on axis 0 as in the reference."""
    return {
        "wq": dense_init((d_model, n_heads, head_dim), dtype, generator,
                         device, fan_in=d_model),
        "wk": dense_init((d_model, n_kv_heads, head_dim), dtype, generator,
                         device, fan_in=d_model),
        "wv": dense_init((d_model, n_kv_heads, head_dim), dtype, generator,
                         device, fan_in=d_model),
        "wo": dense_init((n_heads, head_dim, d_model), dtype, generator,
                         device, fan_in=n_heads),
    }


def quantize_kv(x):
    """x: (..., D) -> (int8 values, per-(...,) bf16 scales).  Values are
    quantized with the f32 scale (absmax / 127, round half to even, clip
    to +-127); the scale is stored as bf16."""
    xf = x.float()
    amax = xf.abs().amax(-1)
    scale = amax.clamp_min(1e-6) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def dequantize_kv(q, scale, dtype=torch.bfloat16):
    return q.to(dtype) * scale[..., None].to(dtype)
