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

Attention over a slot cache (a decode step, or a prefill chunk against
the prompt's cached prefix) keeps the cache in its dtype, as the
reference does with ``preferred_element_type=f32``: on CUDA tensors it
runs through the hand-written paged-attention kernels over a view of the
cache as a pool of pages (``slot_cache_attention``); on CPU tensors the
plain products below run, in f32.  Slot caches are written in place (the
reference returns updated copies); a write past the cache's length is
dropped, as the reference's masked select drops it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.ops import paged_attention
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
    token causally over prefix + chunk: through the paged kernels
    (``chunk_attention_paged``) on CUDA tensors, through
    ``chunk_attention_plain`` on CPU tensors."""
    B, C, _ = x.shape
    S_cache = k_cache.shape[1]
    positions = (start + torch.arange(C, device=x.device))[None].expand(B, C)
    q = apply_rope(_project(x, params["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_project(x, params["wk"]), positions, cfg.rope_theta)
    v = _project(x, params["wv"])
    s0 = max(0, min(start, S_cache - C))
    k_cache[:, s0:s0 + C] = k.to(k_cache.dtype)
    v_cache[:, s0:s0 + C] = v.to(v_cache.dtype)
    if x.device.type == "cpu":
        out = chunk_attention_plain(q, k_cache, v_cache, positions)
    else:
        out = chunk_attention_paged(q, k_cache, v_cache, positions)
    return _out_project(out.to(x.dtype), params["wo"]), (k_cache, v_cache)


def chunk_attention_paged(q, k_cache, v_cache, positions):
    """A prefill chunk's attention through ``slot_cache_attention``: q
    (B, C, Hq, D) at ``positions`` (B, C); chunk token (b, c) attends
    slots [0, positions[b, c] + 1) of cache row b, so the rows of one
    chunk share a table row (the kernels' tensor-core tiles)."""
    B, C = positions.shape
    ctx = torch.clamp(positions + 1, max=k_cache.shape[1]).reshape(B * C)
    rows = torch.arange(B, dtype=torch.int32,
                        device=q.device).repeat_interleave(C)
    out = slot_cache_attention(q.reshape(B * C, *q.shape[2:]), k_cache,
                               v_cache, ctx, row_map=rows)
    return out.reshape(B, C, -1, v_cache.shape[-1])


def chunk_attention_plain(q, k_cache, v_cache, positions):
    """Plain version of a prefill chunk's attention: q (B, C, Hq, D) at
    ``positions`` (B, C) over caches (B, S_cache, Hkv, D), scores and
    products in f32, the softmax weights rounded to the cache's dtype
    before the product with V, as in the reference."""
    B, C = positions.shape
    S_cache, Hkv = k_cache.shape[1], k_cache.shape[2]
    qg = _group_heads(q, Hkv)                            # (B, C, Hkv, G, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k_cache.float()) \
        * q.shape[-1] ** -0.5
    valid = torch.arange(S_cache, device=q.device)[None, None, :] \
        <= positions[:, :, None]
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, C, -1, v_cache.shape[-1]).to(q.dtype)


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
    out = decode_attention(q, k_cache, v_cache, _decode_ctx(S_cache, pos))
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


def _decode_ctx(S_cache, pos):
    """(B,) count of valid slots for per-request positions: the valid set
    is the prefix [0, min(pos + 1, S_cache)).  The reference's masks are
    this prefix: ``idx <= pos`` for full attention (every slot once the
    sequence outgrows the cache, whose writes are dropped), and ``idx <
    min(pos + 1, S_cache)`` for a ring cache (the whole ring once it
    wraps: softmax does not depend on the order of the slots)."""
    return torch.clamp(pos + 1, max=S_cache)


DECODE_BLOCK_THRESHOLD = 8192      # blockwise path for long caches


def slot_cache_attention(q, k_cache, v_cache, ctx, row_map=None):
    """Attention of query rows over contiguous slot caches, through the
    paged-attention kernels (``kernels.ops.paged_attention``).

    q (R, Hq, D); caches (B, S, Hkv, D), contiguous; row r attends
    slots [0, ctx[r]) of cache row ``row_map[r]`` (int32; default r).
    The caches are viewed, without a copy, as pools of B * S / page
    pages of page = gcd(S, 16) slots, with an identity block table:
    table row b holds pages [b * S / page, (b + 1) * S / page).  The
    kernels read the caches in their dtype and accumulate in f32; unlike
    the reference's product they keep the softmax weights in f32 (the
    tensor-core walk as a bf16 hi + lo pair) instead of rounding them to
    the cache's dtype, so outputs may differ from the plain version by
    2**-9 max|v| beyond one step of the output's dtype.  Returns
    (R, Hq, Dv) in q's dtype."""
    B, S, Hkv, D = k_cache.shape
    page = math.gcd(S, 16)
    W = S // page
    k_pool = k_cache.view(B * W, page, Hkv, D)
    v_pool = v_cache.view(B * W, page, Hkv, v_cache.shape[-1])
    tables = torch.arange(B * W, dtype=torch.int32,
                          device=q.device).view(B, W)
    return paged_attention(q.contiguous(), k_pool, v_pool, tables,
                           ctx.to(torch.int32), row_map=row_map)


def decode_attention(q, k_cache, v_cache, ctx):
    """q: (B,1,Hq,D); caches: (B,S,Hkv,D); row b attends slots [0,
    ctx[b]).  CUDA tensors go through ``decode_attention_paged`` (no copy
    of the caches); CPU tensors through ``decode_attention_plain``."""
    if q.device.type == "cpu":
        valid = torch.arange(k_cache.shape[1], device=q.device)[None, :] \
            < ctx[:, None]
        return decode_attention_plain(q, k_cache, v_cache, valid)
    return decode_attention_paged(q, k_cache, v_cache, ctx)


def decode_attention_paged(q, k_cache, v_cache, ctx):
    """``decode_attention`` through ``slot_cache_attention``: one row per
    request, each its own table row."""
    B, _, Hq, D = q.shape
    out = slot_cache_attention(q.reshape(B, Hq, D), k_cache, v_cache, ctx)
    return out.reshape(B, 1, Hq, -1)


def decode_attention_plain(q, k_cache, v_cache, valid):
    """Plain version of ``decode_attention``: valid (B, S) bool.  Scores
    and products in f32 (the reference's ``preferred_element_type``); the
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
