"""Shared building blocks: norms, MLPs, RoPE, embeddings, initialisers.

Port of ``repro/models/layers.py``.  Plain functions over nested-dict
parameter trees with the reference's layout; norm statistics and RoPE
angles are f32, results are cast back to the input dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# initialisers (same distributions and scales as the reference)
# ---------------------------------------------------------------------------
def dense_init(shape, dtype, generator: torch.Generator, device,
               fan_in: int = None):
    """Truncated-normal (-2, 2) fan-in init; ``fan_in`` defaults to
    ``shape[-2]`` (the reference's ``in_axis=-2``)."""
    if fan_in is None:
        fan_in = shape[-2] if len(shape) > 1 else shape[0]
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * (1.0 / max(fan_in, 1)) ** 0.5).to(dtype)


def embed_init(shape, dtype, generator: torch.Generator, device):
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.normal_(w, 0.0, 1.0, generator=generator)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm(params, x, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU for silu act, plain 2-layer for gelu)
# ---------------------------------------------------------------------------
def mlp(params, x, act):
    h = x @ params["w_in"]
    if act == "silu":
        h = F.silu(x @ params["w_gate"]) * h
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    return h @ params["w_out"]


# ---------------------------------------------------------------------------
# Rotary position embeddings (split-halves form)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim, theta, device=None):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)          # (head_dim//2,)


def apply_rope(x, positions, theta):
    """x: (..., S, H, D) or (..., S, D); positions: broadcastable to (..., S)."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., S, D/2)
    if x.ndim == angles.ndim + 1:              # head axis present
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Token embedding / logits head
# ---------------------------------------------------------------------------
def embed(params, tokens):
    return params["table"][tokens.long()]


def unembed(params, x):
    if "head" in params:
        return x @ params["head"]
    return x @ params["table"].T
