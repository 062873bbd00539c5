"""Shared building blocks: norms, MLPs, RoPE, embeddings, initialisers.

Port of ``repro/models/layers.py``.  Plain functions over nested-dict
parameter trees with the reference's layout; norm statistics and RoPE
angles are f32, results are cast back to the input dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# devices on which the model layer takes a kernel's plain version: the
# CPU (the tests) and ``meta`` (shapes only, no data: the dry-run counts a
# step's operations on it; the kernel wrappers themselves refuse meta);
# CUDA tensors go to the kernels
PLAIN_DEVICES = ("cpu", "meta")


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
def rmsnorm(params, x, eps=1e-6, tp=None):
    """``tp``: a serving plan over whose model axis ``x`` and ``scale``
    are split along the last dim (this rank's blocks): the f32 sum of
    squares is all-reduced."""
    xf = x.float()
    if tp is None:
        var = xf.square().mean(-1, keepdim=True)
    else:
        var = tp.reduce(xf.square().sum(-1, keepdim=True)) \
            / (x.shape[-1] * tp.m)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def matmul_f32(a, b):
    """``a @ b`` for a (..., K) and b (K, N) with f32 products and sums and
    the f32 result, not rounded to a's dtype: bf16 operands on CUDA take
    ``torch.bmm(..., out_dtype=float32)``, the rest f32 copies."""
    if a.dtype == torch.float32 or a.device.type in PLAIN_DEVICES:
        return a.float() @ b.float()
    out = torch.bmm(a.reshape(1, -1, a.shape[-1]), b[None],
                    out_dtype=torch.float32)
    return out.reshape(*a.shape[:-1], b.shape[-1])


# ---------------------------------------------------------------------------
# MLP (SwiGLU for silu act, plain 2-layer for gelu)
# ---------------------------------------------------------------------------
def mlp(params, x, act, tp=None):
    """The FFN; under a serving plan that splits it (``tp``: this rank's
    hidden block of ``w_in``/``w_gate`` columns and ``w_out`` rows) the
    partial products are summed over the model axis."""
    h = x @ params["w_in"]
    if act == "silu":
        h = F.silu(x @ params["w_gate"]) * h
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    out = h @ params["w_out"]
    return out if tp is None else tp.reduce(out)


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
def embed(params, tokens, tp=None):
    """The tokens' rows of the table.  Under a serving plan that splits
    the vocab (``tp``, ``tp.vocab_split``) the table is this rank's block
    of rows: tokens outside it look up zeros, and the rows are summed over
    the model axis."""
    table = params["table"]
    if tp is None or not tp.vocab_split:
        return table[tokens.long()]
    n = table.shape[0]
    local = tokens.long() - tp.r * n
    mine = (local >= 0) & (local < n)
    x = torch.where(mine[..., None], table[local.clamp(0, n - 1)],
                    table.new_zeros(()))
    return tp.reduce(x)


def unembed(params, x):
    """Logits from the head (or the tied table); under a serving plan that
    splits the vocab, this rank's block of them."""
    if "head" in params:
        return x @ params["head"]
    return x @ params["table"].T


# ---------------------------------------------------------------------------
# Chunked cross-entropy: never materialises (B, S, V) at once
# ---------------------------------------------------------------------------
def _chunk_nll(embed_params, xc, lc, mc):
    """(sum of masked NLL, sum of the mask) of one chunk, logits in f32."""
    logits = unembed(embed_params, xc).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lc[..., None].long())[..., 0]
    return ((logz - gold) * mc).sum(), mc.sum()


def chunked_ce_loss(embed_params, x, labels, chunk=512, mask=None):
    """x: (B, S, d) final hidden; labels: (B, S) int.  Mean token NLL: the
    masked sum over chunks of ``chunk`` positions divided by the mask's
    count (at least 1).  Each chunk runs under ``checkpoint``, as the
    reference's ``jax.checkpoint``: its (B, chunk, vocab) logits are
    recomputed in the backward pass instead of being kept."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    tot = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, chunk):
        t, c = checkpoint(_chunk_nll, embed_params, x[:, s0:s0 + chunk],
                          labels[:, s0:s0 + chunk], mask[:, s0:s0 + chunk],
                          use_reentrant=False)
        tot, cnt = tot + t, cnt + c
    return tot / cnt.clamp_min(1.0)
