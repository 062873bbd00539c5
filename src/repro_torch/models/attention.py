"""Attention: dense GQA (full or sliding-window masks), int8 KV quantization.

Port of ``repro/models/attention.py`` (GQA, not MLA or cross-attention).
Two implementations share one math definition:

- ``naive_attention`` materialises the scores; the smoke configs and the
  oracle of the flash kernel use it;
- ``flash_attention`` is the blockwise online-softmax attention: on CUDA
  tensors the hand-written kernel (``repro_torch.kernels.flash_attention``,
  the port of ``flash_attention_pallas``), on CPU tensors its plain
  version.  The reference's pure-JAX blockwise version and the Pallas
  kernel compute the same function; the port has this one.

Decode-step attention (one token against a cache) is a plain product:
scores are (B, H, 1, S), never quadratic.  Slot caches are written in
place (the reference returns updated copies); a write past the cache's
length is dropped, as the reference's masked select drops it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# GQA parameter init
# ---------------------------------------------------------------------------
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


def _group_heads(q, n_kv):
    """(B, S, Hq, D) -> (B, S, Hkv, G, D)."""
    B, S, Hq, D = q.shape
    return q.reshape(B, S, n_kv, Hq // n_kv, D)


def _project(x, w):
    """einsum("bsd,dhk->bshk"): x (B, S, d) by w (d, H, k)."""
    B, S, d = x.shape
    return (x @ w.reshape(d, -1)).reshape(B, S, w.shape[1], w.shape[2])


def _out_project(out, wo):
    """einsum("bshk,hkd->bsd")."""
    B, S, H, k = out.shape
    return out.reshape(B, S, H * k) @ wo.reshape(H * k, -1)


# ---------------------------------------------------------------------------
# Reference (naive) attention
# ---------------------------------------------------------------------------
def naive_attention(q, k, v, *, causal=True, window=0):
    """q: (B,Sq,Hq,Dk) k: (B,Skv,Hkv,Dk) v: (B,Skv,Hkv,Dv)."""
    B, Sq, Hq, Dk = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = _group_heads(q, Hkv)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) \
        * Dk ** -0.5
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(B, Sq, Hq, v.shape[-1]).to(q.dtype)


# ---------------------------------------------------------------------------
# Blockwise flash attention: the CUDA kernel on the card
# ---------------------------------------------------------------------------
def flash_attention(q, k, v, *, causal=True, window=0, block_q=512,
                    block_kv=512):
    """Prefill attention (Sq == Skv).  CUDA tensors launch the flash
    kernel; CPU tensors run its plain version."""
    S = q.shape[1]
    return flash_attention_kernel(q, k, v, causal=causal, window=window,
                                  block_q=min(block_q, S),
                                  block_kv=min(block_kv, S))


def attention(q, k, v, *, causal=True, window=0, impl="flash"):
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window)
    return flash_attention(q, k, v, causal=causal, window=window)


# ---------------------------------------------------------------------------
# GQA forward (prefill) and decode step
# ---------------------------------------------------------------------------
def gqa_prefill(params, x, positions, cfg, *, window=0):
    """Causal self-attention over the prompt.  Returns (out,
    (k_cache_entry, v_cache_entry))."""
    q = apply_rope(_project(x, params["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_project(x, params["wk"]), positions, cfg.rope_theta)
    v = _project(x, params["wv"])
    out = attention(q, k, v, causal=True, window=window, impl=cfg.attn_impl)
    return _out_project(out, params["wo"]), (k, v)


def gqa_prefill_chunk(params, x, k_cache, v_cache, start: int, cfg):
    """Incremental (chunked) prefill step for full-attention dense GQA.

    x: (B, C, d), one prompt chunk whose prefix [0, start) is already in
    ``k_cache``/``v_cache`` (B, S_cache, Hkv, D).  Writes the chunk's K/V
    at [start, start+C) in place (clamped into the cache as the
    reference's ``dynamic_update_slice`` clamps) and attends each chunk
    token causally over prefix + chunk, in f32."""
    B, C, _ = x.shape
    S_cache, Hkv = k_cache.shape[1], k_cache.shape[2]
    positions = (start + torch.arange(C, device=x.device))[None].expand(B, C)
    q = apply_rope(_project(x, params["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_project(x, params["wk"]), positions, cfg.rope_theta)
    v = _project(x, params["wv"])
    s0 = max(0, min(start, S_cache - C))
    k_cache[:, s0:s0 + C] = k.to(k_cache.dtype)
    v_cache[:, s0:s0 + C] = v.to(v_cache.dtype)
    qg = _group_heads(q, Hkv)                            # (B, C, Hkv, G, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k_cache.float()) \
        * q.shape[-1] ** -0.5
    valid = torch.arange(S_cache, device=x.device)[None, None, :] \
        <= positions[:, :, None]
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(v_cache.dtype).float(),
                       v_cache.float())
    out = out.reshape(B, C, -1, v_cache.shape[-1]).to(x.dtype)
    return _out_project(out, params["wo"]), (k_cache, v_cache)


def gqa_decode(params, x, k_cache, v_cache, pos, cfg, *, window=0):
    """One-token decode over fp caches.  x: (B, 1, d); caches
    (B, S_cache, Hkv, D), written in place; pos: (B,) int32 per-request
    positions (continuous batching).

    Full attention: write at index ``pos[b]``; valid = idx <= pos[b].
    Windowed: circular write at ``pos[b] % S_cache``; valid = newest
    ``window`` entries."""
    S_cache = k_cache.shape[1]
    posv = pos[:, None]
    q = apply_rope(_project(x, params["wq"]), posv, cfg.rope_theta)
    k = apply_rope(_project(x, params["wk"]), posv, cfg.rope_theta)
    v = _project(x, params["wv"])
    slot = pos % S_cache if window else pos
    _cache_write(k_cache, k[:, 0], slot)
    _cache_write(v_cache, v[:, 0], slot)
    valid = _decode_valid(S_cache, pos, window)
    out = decode_attention(q, k_cache, v_cache, valid)
    return _out_project(out, params["wo"]), (k_cache, v_cache)


# ---------------------------------------------------------------------------
# int8 KV-cache quantization (the paged backend's int8 pages)
# ---------------------------------------------------------------------------
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


def _cache_write(cache, token, slot):
    """Write one token per request at per-request slots, in place.

    cache (B, S, ...), token (B, ...), slot (B,).  A slot outside [0, S)
    writes nothing, as the reference's masked select writes nothing: the
    row's clamped slot gets its own value back.  No host sync."""
    B, S = cache.shape[:2]
    ok = ((slot >= 0) & (slot < S)).reshape((B,) + (1,) * (token.ndim - 1))
    idx = slot.clamp(0, S - 1).long()
    rows = torch.arange(B, device=cache.device)
    cache[rows, idx] = torch.where(ok, token.to(cache.dtype),
                                   cache[rows, idx])
    return cache


def _decode_valid(S_cache, pos, window):
    """(B, S_cache) validity mask for per-request positions."""
    idx = torch.arange(S_cache, device=pos.device)[None, :]
    if window:
        return idx < torch.clamp(pos[:, None] + 1, max=S_cache)
    return idx <= pos[:, None]


DECODE_BLOCK_THRESHOLD = 8192      # blockwise path for long caches


def decode_attention(q, k_cache, v_cache, valid):
    """q: (B,1,Hq,D); caches: (B,S,Hkv,D); valid: (B, S) bool.  Scores and
    products in f32 (the reference's ``preferred_element_type``); the
    softmax weights are rounded to the cache's dtype before the product
    with V, as in the reference.  Long caches stream through
    ``decode_attention_blocked``."""
    if k_cache.shape[1] >= DECODE_BLOCK_THRESHOLD:
        return decode_attention_blocked(q, k_cache, v_cache, valid)
    Hkv = k_cache.shape[2]
    qg = _group_heads(q, Hkv)                    # (B, 1, Hkv, G, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k_cache.float()) \
        * q.shape[-1] ** -0.5
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(v_cache.dtype).float(),
                       v_cache.float())
    B, _, _, Dv = v_cache.shape
    return out.reshape(B, 1, -1, Dv).to(q.dtype)


def decode_attention_blocked(q, k_cache, v_cache, valid, block=2048):
    """Flash-style streaming decode attention over cache blocks: running
    (m, l, acc) statistics, an O(block) working set at any context."""
    B, S, Hkv, Dk = k_cache.shape
    Dv = v_cache.shape[-1]
    qg = _group_heads(q, Hkv)[:, 0].float()      # (B, Hkv, G, D)
    G = qg.shape[2]
    acc = torch.zeros((B, Hkv, G, Dv), device=q.device)
    m = torch.full((B, Hkv, G), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G), device=q.device)
    for i in range(0, S, block):
        kb = k_cache[:, i:i + block].float()
        vb = v_cache[:, i:i + block]
        s = torch.einsum("bkgd,btkd->bkgt", qg, kb) * Dk ** -0.5
        s = torch.where(valid[:, None, None, i:i + block], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgt,btkd->bkgd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, 1, Hkv * G, Dv).to(q.dtype)
