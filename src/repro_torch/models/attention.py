"""Attention: dense GQA (full or sliding-window masks), MLA, int8 KV
quantization, and the cross-attention of an encoder-decoder (Whisper).

Port of ``repro/models/attention.py``.
Two implementations share one math definition:

- ``naive_attention`` materialises the scores; the smoke configs and the
  oracle of the flash kernel use it;
- ``flash_attention`` is the blockwise online-softmax attention: on CUDA
  tensors the hand-written kernel (``repro_torch.kernels.flash_attention``,
  the port of ``flash_attention_pallas``), on CPU tensors its plain
  version.  The reference's pure-JAX blockwise version and the Pallas
  kernel compute the same function; the port has this one.  When a
  gradient is wanted (training) it goes through the kernel's autograd
  Function, whose backward is the hand-written backward kernel (the port
  of the reference's custom VJP); serving launches the forward alone.

Attention over a slot cache (a decode step, or a prefill chunk against
the prompt's cached prefix) keeps the cache in its dtype, as the
reference does with ``preferred_element_type=f32``: on CUDA tensors it
runs through the hand-written paged-attention kernels over a view of the
cache as a pool of pages (``slot_cache_attention``; int8 caches with
their bf16 scales too); on CPU tensors the plain products below run, in
f32.  A decode step's cross-attention over the encoder frames cached at
prefill (``cross_decode_attention``) takes the same kernels on CUDA
tensors and, as the reference's decode, ``naive_attention`` on CPU
tensors.  MLA decode attends in the latent space (``mla_decode``): its
cache (the latent ``c`` and the shared rotary key) has no page layout
the paged kernels take, so its products are ``torch.bmm`` calls with f32
outputs over the cache in place on CUDA, f32 products on the CPU (on a
mesh, ``mla_decode``, each rank's partial scores over its slice of the
latent rank, summed over the model axis before the softmax).  Slot
caches are written in place (the reference returns updated copies); a
write past the cache's length is dropped, as the reference's masked
select drops it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                 flash_attention_plain,
                                                 flash_attention_train)
from repro_torch.kernels.ops import paged_attention
from repro_torch.models.layers import (PLAIN_DEVICES, apply_rope, dense_init,
                                       rmsnorm)

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
    """Blockwise attention of Sq query rows over Skv keys (prefill: Sq ==
    Skv; cross-attention: Skv encoder frames).  CUDA tensors launch the
    flash kernel; CPU tensors run its plain version.  With a gradient
    wanted, through ``flash_attention_train`` (forward with lse, the
    backward kernel).  Meta tensors (the dry-run: shapes and operations
    only) take the plain version, which autograd differentiates."""
    fn = flash_attention_kernel
    if q.device.type == "meta":
        fn = flash_attention_plain
    elif torch.is_grad_enabled() and any(t.requires_grad
                                         for t in (q, k, v)):
        fn = flash_attention_train
    return fn(q, k, v, causal=causal, window=window,
              block_q=min(block_q, q.shape[1]),
              block_kv=min(block_kv, k.shape[1]))


def attention(q, k, v, *, causal=True, window=0, impl="flash"):
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window)
    return flash_attention(q, k, v, causal=causal, window=window)


# ---------------------------------------------------------------------------
# GQA forward (prefill) and decode step
# ---------------------------------------------------------------------------
def gqa_prefill(params, x, positions, cfg, *, window=0, causal=True,
                tp=None):
    """Self-attention over the prompt (causal; an encoder's is not).
    Returns (out, (k_cache_entry, v_cache_entry)).

    ``tp``: a serving plan that splits the layer over its model axis
    (``sharding.ServePlan``; None: one process).  Split heads run the
    layer on this rank's query and kv heads; a head-dim split all-gathers
    the slices into whole heads (the rotary embedding pairs dims half a
    head apart) for flash and keeps this rank's slice of k/v for the
    cache.  Either way ``wo``'s partial products are summed over the
    model axis."""
    if tp is not None and tp.splits_dims:
        return _gqa_prefill_dims(params, x, positions, cfg, window, causal,
                                 tp)
    q = apply_rope(_project(x, params["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_project(x, params["wk"]), positions, cfg.rope_theta)
    v = _project(x, params["wv"])
    out = attention(q, k, v, causal=causal, window=window,
                    impl=cfg.attn_impl)
    y = _out_project(out, params["wo"])
    return (y if tp is None else tp.reduce(y)), (k, v)


def _qkv_dims(params, x, positions, cfg, tp):
    """The projections of a layer whose k/v split the head dim: (q (B, T,
    H, D): whole heads, every query head (``"dim"``, its slices gathered)
    or this rank's (``"mixed"``); k (B, T, Hkv, D) whole; v (B, T, Hkv,
    D / m) this rank's dims), the rotary embedding applied to whole
    heads."""
    theta = cfg.rope_theta
    q = _project(x, params["wq"])
    if tp.layout == "dim":
        q = tp.gather_model(q, -1)
    k = tp.gather_model(_project(x, params["wk"]), -1)
    return (apply_rope(q, positions, theta), apply_rope(k, positions, theta),
            _project(x, params["wv"]))


def _gqa_prefill_dims(params, x, positions, cfg, window, causal, tp):
    """``gqa_prefill`` with k/v over the head dim: flash over every query
    head (``"dim"``) or over this rank's (``"mixed"``), on whole heads."""
    q, k, v = _qkv_dims(params, x, positions, cfg, tp)
    v = tp.gather_model(v, -1)
    if tp.layout == "dim":
        out = attention(q, k, v, causal=causal, window=window,
                        impl=cfg.attn_impl)
        y = _out_project(tp.dim_slice(out), params["wo"])
    else:
        out = attention(q, tp.kv_for_local_heads(k),
                        tp.kv_for_local_heads(v), causal=causal,
                        window=window, impl=cfg.attn_impl)
        y = _out_project(out, params["wo"])
    return tp.reduce(y), (tp.dim_slice(k), tp.dim_slice(v))


def _q_at_my_dims(q, tp):
    """Every query head at this rank's dims (B, T, Hq, D / m) from
    ``_qkv_dims``' q (``"mixed"``: this rank's heads gathered first)."""
    return tp.dim_slice(q if tp.layout == "dim" else tp.gather_model(q, 2))


def _out_dims(out, params, tp):
    """The layer's output from every query head's output at this rank's
    dims (B, T, Hq, D / m): through ``wo``'s rows of those dims
    (``"dim"``), or the heads' whole outputs gathered and this rank's
    heads through its ``wo`` (``"mixed"``); summed over the model axis."""
    if tp.layout == "dim":
        return tp.reduce(_out_project(out, params["wo"]))
    whole = tp.local_heads(tp.gather_model(out, -1))
    return tp.reduce(_out_project(whole, params["wo"]))


def split_dim_attention(q, k_cache, v_cache, valid, tp, head_dim,
                        k_scale=None, v_scale=None, round_weights=True):
    """Attention over caches split over the head dim: q (B, T, Hq, D / m),
    every query head at this rank's dims; caches (B, S, Hkv, D / m) this
    rank's slices (int8 with whole (B, S, Hkv) scales, dequantized to q's
    dtype as the reference's blocked route does); ``valid`` (B, T, S).
    Each rank's partial scores over its dims are summed over the model
    axis (f32) before the scale, mask and softmax; the weights are rounded
    to the values' dtype before their product with this rank's slice of
    V, as in the plain decode (``round_weights=False`` keeps them f32, as
    ``naive_attention`` does: the cross-attention's decode).  Returns (B,
    T, Hq, D / m): every head's output at this rank's dims.  A plain route
    in PyTorch, no kernel: the paged kernels take whole heads."""
    B, T, Hq, _ = q.shape
    Hkv = k_cache.shape[2]
    if k_scale is not None:
        k_cache = dequantize_kv(k_cache, k_scale, q.dtype)
        v_cache = dequantize_kv(v_cache, v_scale, q.dtype)
    qg = q.reshape(B, T, Hkv, Hq // Hkv, q.shape[-1])
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k_cache.float())
    s = tp.reduce(s) * head_dim ** -0.5
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    if round_weights:
        w = w.to(v_cache.dtype).float()
    out = torch.einsum("bkgst,btkd->bskgd", w, v_cache.float())
    return out.reshape(B, T, Hq, -1).to(q.dtype)


def gqa_prefill_chunk(params, x, k_cache, v_cache, start: int, cfg,
                      tp=None):
    """Incremental (chunked) prefill step for full-attention dense GQA.

    x: (B, C, d), one prompt chunk whose prefix [0, start) is already in
    ``k_cache``/``v_cache`` (B, S_cache, Hkv, D).  Writes the chunk's K/V
    at [start, start+C) in place (clamped into the cache as the
    reference's ``dynamic_update_slice`` clamps) and attends each chunk
    token causally over prefix + chunk: through the paged kernels
    (``chunk_attention_paged``) on CUDA tensors, through
    ``chunk_attention_plain`` on CPU tensors.  ``tp``: as ``gqa_prefill``;
    over a head-dim split the chunk attends through
    ``split_dim_attention``."""
    B, C, _ = x.shape
    S_cache = k_cache.shape[1]
    positions = (start + torch.arange(C, device=x.device))[None].expand(B, C)
    s0 = max(0, min(start, S_cache - C))
    if tp is not None and tp.splits_dims:
        q, k, v = _qkv_dims(params, x, positions, cfg, tp)
        q = _q_at_my_dims(q, tp)
        k_cache[:, s0:s0 + C] = tp.dim_slice(k).to(k_cache.dtype)
        v_cache[:, s0:s0 + C] = v.to(v_cache.dtype)
        valid = torch.arange(S_cache, device=x.device)[None, None, :] \
            <= positions[:, :, None]
        out = split_dim_attention(q, k_cache, v_cache, valid, tp,
                                  cfg.resolved_head_dim())
        return _out_dims(out, params, tp), (k_cache, v_cache)
    q = apply_rope(_project(x, params["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_project(x, params["wk"]), positions, cfg.rope_theta)
    v = _project(x, params["wv"])
    k_cache[:, s0:s0 + C] = k.to(k_cache.dtype)
    v_cache[:, s0:s0 + C] = v.to(v_cache.dtype)
    if x.device.type in PLAIN_DEVICES:
        out = chunk_attention_plain(q, k_cache, v_cache, positions)
    else:
        out = chunk_attention_paged(q, k_cache, v_cache, positions)
    y = _out_project(out.to(x.dtype), params["wo"])
    return (y if tp is None else tp.reduce(y)), (k_cache, v_cache)


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


def gqa_decode(params, x, k_cache, v_cache, pos, cfg, *, window=0,
               k_scale=None, v_scale=None, tp=None):
    """One-token decode.  x: (B, 1, d); caches (B, S_cache, Hkv, D),
    written in place; pos: (B,) int32 per-request positions (continuous
    batching).

    Full attention: write at index ``pos[b]``; valid = idx <= pos[b].
    Windowed: circular write at ``pos[b] % S_cache``; valid = newest
    ``window`` entries.  With ``cfg.kv_quant`` the caches are int8 with
    per-(token, head) bf16 scales ``k_scale``/``v_scale`` (B, S_cache,
    Hkv), written in place beside them.  ``tp``: as ``gqa_prefill``: on
    split heads this rank's heads and cache shards through the paged
    kernels; over a head-dim split ``split_dim_attention`` (the new
    token's k whole for the rotary embedding and its scale, v's scale from
    the absmax reduced over the model axis)."""
    S_cache = k_cache.shape[1]
    posv = pos[:, None]
    slot = pos % S_cache if window else pos
    quant = k_scale is not None
    if tp is not None and tp.splits_dims:
        q, k, v = _qkv_dims(params, x, posv, cfg, tp)
        q = _q_at_my_dims(q, tp)
        if quant:
            kq, ks = quantize_kv(k[:, 0])
            vq, vs = quantize_kv(v[:, 0], tp.reduce_max)
            new = ((k_cache, tp.dim_slice(kq)), (v_cache, vq),
                   (k_scale, ks), (v_scale, vs))
        else:
            new = ((k_cache, tp.dim_slice(k[:, 0])), (v_cache, v[:, 0]))
        for cache, t in new:
            _cache_write(cache, t, slot)
        valid = torch.arange(S_cache, device=x.device)[None, None, :] \
            < _decode_ctx(S_cache, pos)[:, None, None]
        out = split_dim_attention(q, k_cache, v_cache, valid, tp,
                                  cfg.resolved_head_dim(), k_scale, v_scale)
        y = _out_dims(out, params, tp)
        return y, tuple(cache for cache, _ in new)
    q = apply_rope(_project(x, params["wq"]), posv, cfg.rope_theta)
    k = apply_rope(_project(x, params["wk"]), posv, cfg.rope_theta)
    v = _project(x, params["wv"])
    if quant:
        kq, ks = quantize_kv(k[:, 0])
        vq, vs = quantize_kv(v[:, 0])
        for cache, new in ((k_cache, kq), (v_cache, vq), (k_scale, ks),
                           (v_scale, vs)):
            _cache_write(cache, new, slot)
    else:
        _cache_write(k_cache, k[:, 0], slot)
        _cache_write(v_cache, v[:, 0], slot)
    out = decode_attention(q, k_cache, v_cache, _decode_ctx(S_cache, pos),
                           k_scale=k_scale, v_scale=v_scale)
    y = _out_project(out, params["wo"])
    if tp is not None:
        y = tp.reduce(y)
    if quant:
        return y, (k_cache, v_cache, k_scale, v_scale)
    return y, (k_cache, v_cache)


# ---------------------------------------------------------------------------
# int8 KV-cache quantization (the paged backend's int8 pages)
# ---------------------------------------------------------------------------
def quantize_kv(x, reduce_amax=None):
    """x: (..., D) -> (int8 values, per-(...,) bf16 scales).  Values are
    quantized with the f32 scale (absmax / 127, round half to even, clip
    to +-127); the scale is stored as bf16.  ``reduce_amax``: where ``x``
    is a slice of each vector (a head-dim split), the reduction that makes
    the slice's absmax the whole vector's."""
    xf = x.float()
    amax = xf.abs().amax(-1)
    if reduce_amax is not None:
        amax = reduce_amax(amax)
    scale = amax.clamp_min(1e-6) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def dequantize_kv(q, scale, dtype=torch.bfloat16):
    return q.to(dtype) * scale[..., None].to(dtype)


def _cache_write(cache, token, slot):
    """Write one token per request at per-request slots, in place.

    cache (B, S, ...), token (B, ...), slot (B,); a cache of int8 values
    or of their (B, S, Hkv) scales alike.  A slot outside [0, S)
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


def slot_cache_attention(q, k_cache, v_cache, ctx, row_map=None,
                         k_scale=None, v_scale=None):
    """Attention of query rows over contiguous slot caches, through the
    paged-attention kernels (``kernels.ops.paged_attention``).

    q (R, Hq, D); caches (B, S, Hkv, D), contiguous; row r attends
    slots [0, ctx[r]) of cache row ``row_map[r]`` (int32; default r).
    The caches are viewed, without a copy, as pools of B * S / page
    pages of page = gcd(S, 16) slots, with an identity block table:
    table row b holds pages [b * S / page, (b + 1) * S / page).  int8
    caches pass their (B, S, Hkv) bf16 scales, viewed as (B * S / page,
    page, Hkv) by the same rule.  The kernels read the caches in their
    dtype and accumulate in f32; unlike the reference's product they keep
    the softmax weights in f32 (the tensor-core walk as a bf16 hi + lo
    pair) instead of rounding them to the cache's dtype, so outputs may
    differ from the plain version by 2**-9 max|v| beyond one step of the
    output's dtype; int8 values are dequantized in f32, where the
    reference rounds each to bf16 (``decode_attention_blocked``); in
    bf16 the two routes are held within 2**-7 |ref| + 2 x 2**-9 max|v|.
    Returns (R, Hq, Dv) in q's dtype."""
    B, S, Hkv, D = k_cache.shape
    page = math.gcd(S, 16)
    W = S // page
    k_pool = k_cache.view(B * W, page, Hkv, D)
    v_pool = v_cache.view(B * W, page, Hkv, v_cache.shape[-1])
    if k_scale is not None:
        k_scale = k_scale.view(B * W, page, Hkv)
        v_scale = v_scale.view(B * W, page, Hkv)
    tables = torch.arange(B * W, dtype=torch.int32,
                          device=q.device).view(B, W)
    return paged_attention(q.contiguous(), k_pool, v_pool, tables,
                           ctx.to(torch.int32), row_map=row_map,
                           k_scale=k_scale, v_scale=v_scale)


def decode_attention(q, k_cache, v_cache, ctx, k_scale=None, v_scale=None):
    """q: (B,1,Hq,D); caches: (B,S,Hkv,D); row b attends slots [0,
    ctx[b]).  int8 caches come with their (B, S, Hkv) bf16 scales.  CUDA
    tensors go through ``decode_attention_paged`` (no copy of the
    caches); CPU tensors through ``decode_attention_plain``."""
    if q.device.type in PLAIN_DEVICES:
        valid = torch.arange(k_cache.shape[1], device=q.device)[None, :] \
            < ctx[:, None]
        return decode_attention_plain(q, k_cache, v_cache, valid,
                                      k_scale=k_scale, v_scale=v_scale)
    return decode_attention_paged(q, k_cache, v_cache, ctx,
                                  k_scale=k_scale, v_scale=v_scale)


def decode_attention_paged(q, k_cache, v_cache, ctx, k_scale=None,
                           v_scale=None):
    """``decode_attention`` through ``slot_cache_attention``: one row per
    request, each its own table row."""
    B, _, Hq, D = q.shape
    out = slot_cache_attention(q.reshape(B, Hq, D), k_cache, v_cache, ctx,
                               k_scale=k_scale, v_scale=v_scale)
    return out.reshape(B, 1, Hq, -1)


def decode_attention_plain(q, k_cache, v_cache, valid, k_scale=None,
                           v_scale=None):
    """Plain version of ``decode_attention``: valid (B, S) bool.  Scores
    and products in f32 (the reference's ``preferred_element_type``); the
    softmax weights are rounded to the cache's dtype before the product
    with V, as in the reference.  Long caches and int8 caches stream
    through ``decode_attention_blocked``, as the reference sends them."""
    if k_cache.shape[1] >= DECODE_BLOCK_THRESHOLD or k_scale is not None:
        return decode_attention_blocked(q, k_cache, v_cache, valid,
                                        k_scale=k_scale, v_scale=v_scale)
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


def decode_attention_blocked(q, k_cache, v_cache, valid, block=2048,
                             k_scale=None, v_scale=None):
    """Flash-style streaming decode attention over cache blocks: running
    (m, l, acc) statistics, an O(block) working set at any context.  int8
    blocks are dequantized to q's dtype first (each value times its
    scale, rounded to that dtype, as the reference's ``dequantize_kv``),
    and the weights are rounded to that dtype before the product with V."""
    B, S, Hkv, Dk = k_cache.shape
    Dv = v_cache.shape[-1]
    qg = _group_heads(q, Hkv)[:, 0].float()      # (B, Hkv, G, D)
    G = qg.shape[2]
    acc = torch.zeros((B, Hkv, G, Dv), device=q.device)
    m = torch.full((B, Hkv, G), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G), device=q.device)
    for i in range(0, S, block):
        kb = k_cache[:, i:i + block]
        vb = v_cache[:, i:i + block]
        if k_scale is not None:
            kb = dequantize_kv(kb, k_scale[:, i:i + block], q.dtype)
            vb = dequantize_kv(vb, v_scale[:, i:i + block], q.dtype)
        s = torch.einsum("bkgd,btkd->bkgt", qg, kb.float()) * Dk ** -0.5
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


# ---------------------------------------------------------------------------
# Cross-attention (the Whisper decoder over the encoder's output)
# ---------------------------------------------------------------------------
def cross_init(d_model, n_heads, head_dim, dtype, generator: torch.Generator,
               device):
    """The reference's cross tree: wq/wk/wv (d_model, heads, head_dim), wo
    (heads, head_dim, d_model), as ``gqa_init`` with one kv head per query
    head."""
    return gqa_init(d_model, n_heads, n_heads, head_dim, dtype, generator,
                    device)


def cross_kv(params, enc_out):
    """The encoder output's keys and values, (B, T, H, hd) each: no rotary
    embedding, no mask.  Under a serving plan ``wk``/``wv`` are this
    rank's shards, so they are this rank's heads or head-dim slice: the
    cache's shards (``cache_specs``)."""
    return _project(enc_out, params["wk"]), _project(enc_out, params["wv"])


def cross_attn(params, x, enc_k, enc_v, impl="flash", tp=None):
    """x (B, S, d) attends every encoder frame, not causally: through
    ``attention`` (the flash kernel on CUDA at Sq = S, Skv = T).

    ``tp``: a serving plan over its model axis (``tp.cross_layout``):
    ``"heads"`` attends this rank's heads; ``"dim"`` gathers q's, k's and
    v's head-dim slices into whole heads for flash and keeps this rank's
    slice of the output for ``wo``'s rows.  Either way ``wo``'s partial
    products are summed over the model axis."""
    q = _project(x, params["wq"])
    dims = tp is not None and tp.cross_layout == "dim"
    if dims:
        q, enc_k, enc_v = (tp.gather_model(t, -1) for t in (q, enc_k, enc_v))
    out = attention(q, enc_k, enc_v, causal=False, impl=impl)
    if tp is None:
        return _out_project(out, params["wo"])
    return tp.reduce(_out_project(tp.dim_slice(out) if dims else out,
                                  params["wo"]))


def cross_decode(params, x, enc_k, enc_v, tp=None):
    """A decode step's cross-attention: x (B, 1, d) over the encoder
    frames cached at prefill, (B, T, H, hd) each.  ``tp`` as
    ``cross_attn``'s: this rank's heads, or over the head dim every head's
    partial scores over the caches' slice, summed over the model axis
    before the softmax (``split_dim_attention``, every frame valid, the
    weights kept f32; the query needs no gather: no rotary embedding);
    ``wo``'s partial products summed over the axis."""
    q = _project(x, params["wq"])
    if tp is not None and tp.cross_layout == "dim":
        B, T = enc_k.shape[:2]
        valid = torch.ones((B, 1, T), dtype=torch.bool, device=q.device)
        out = split_dim_attention(q, enc_k, enc_v, valid, tp,
                                  tp.cfg.resolved_head_dim(),
                                  round_weights=False)
    else:
        out = cross_decode_attention(q, enc_k, enc_v)
    y = _out_project(out, params["wo"])
    return y if tp is None else tp.reduce(y)


def cross_decode_attention(q, enc_k, enc_v):
    """q (B, 1, H, hd) over every frame of its row, the softmax weights
    kept in f32 as the reference's ``impl="naive"`` keeps them: on CUDA
    tensors ``slot_cache_attention`` with ctx = T for every row (the
    frames viewed as pages of gcd(T, 16) slots; split-K at T = 1500:
    375 pages of 4), on CPU tensors ``naive_attention``."""
    if q.device.type in PLAIN_DEVICES:
        return naive_attention(q, enc_k, enc_v, causal=False)
    B, _, H, hd = q.shape
    ctx = torch.full((B,), enc_k.shape[1], dtype=torch.int32,
                     device=q.device)
    out = slot_cache_attention(q.reshape(B, H, hd), enc_k, enc_v, ctx)
    return out.reshape(B, 1, H, -1)


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention): MiniCPM3 / DeepSeek-V2 style
# ---------------------------------------------------------------------------
def mla_init(cfg, dtype, generator: torch.Generator, device):
    """The reference's MLA tree: down- and up-projections of q
    (``wq_a``, ``q_norm``, ``wq_b``) and of the latent kv (``wkv_a``,
    ``kv_norm``, ``wkv_b``), then ``wo``; fan-in on axis 0."""
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim

    def w(shape):
        return dense_init(shape, dtype, generator, device, fan_in=shape[0])

    return {
        "wq_a": w((d, m.q_lora_rank)),
        "q_norm": {"scale": torch.ones((m.q_lora_rank,), dtype=dtype,
                                       device=device)},
        "wq_b": w((m.q_lora_rank, H, qk_hd)),
        "wkv_a": w((d, m.kv_lora_rank + m.qk_rope_head_dim)),
        "kv_norm": {"scale": torch.ones((m.kv_lora_rank,), dtype=dtype,
                                        device=device)},
        "wkv_b": w((m.kv_lora_rank, H, m.qk_nope_head_dim + m.v_head_dim)),
        "wo": w((H, m.v_head_dim, d)),
    }


def _mla_qkv(params, x, positions, cfg):
    """(q_nope (B,S,H,dn), q_rope (B,S,H,dr), c (B,S,r), k_rope (B,S,dr)):
    the rotary key is one per token, shared across heads."""
    m = cfg.mla
    cq = rmsnorm(params["q_norm"], x @ params["wq_a"], cfg.norm_eps)
    q = _project(cq, params["wq_b"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    ckv = x @ params["wkv_a"]
    c = rmsnorm(params["kv_norm"], ckv[..., :m.kv_lora_rank], cfg.norm_eps)
    k_rope = apply_rope(ckv[..., None, m.kv_lora_rank:], positions,
                        cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c, k_rope


def mla_prefill(params, x, positions, cfg, *, window=0, tp=None):
    """Expanded (non-absorbed) MLA for prefill: q = [q_nope, q_rope] and
    k = [k_nope, k_rope broadcast to every head] (D = dn + dr), v (Dv =
    v_head_dim) through ``attention`` (the flash kernel on CUDA, whose
    scale D**-0.5 is the reference's).  Returns (out, (c, k_rope)), the
    latent cache entry.

    ``tp``: a serving plan that splits the layer over its model axis
    (``sharding.mla_split``).  ``c`` and ``k_rope`` are computed whole
    (``wkv_a`` is whole) and the cache entry keeps this rank's slice of
    ``c``'s latent rank; ``"heads"`` attends this rank's heads (``wq_b``,
    ``wkv_b`` and ``wo`` its heads), ``"dim"`` every head, its output's
    ``v_head_dim`` slice through ``wo``'s; ``wo``'s partial products are
    summed over the model axis."""
    m = cfg.mla
    q_nope, q_rope, c, k_rope = _mla_qkv(params, x, positions, cfg)
    kv = _project(c, params["wkv_b"])
    k_nope = kv[..., :m.qk_nope_head_dim]
    # the kernel takes contiguous tensors only: one copy of the slice
    v = kv[..., m.qk_nope_head_dim:].contiguous()
    H = q_nope.shape[2]
    k_rope_h = k_rope[:, :, None, :].expand(*k_rope.shape[:2], H,
                                            m.qk_rope_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    out = attention(q, k, v, causal=True, window=window, impl=cfg.attn_impl)
    if tp is None:
        return _out_project(out, params["wo"]), (c, k_rope)
    if tp.layout == "dim":
        out = tp.dim_slice(out)
    return tp.reduce(_out_project(out, params["wo"])), (tp.dim_slice(c),
                                                         k_rope)


def mla_decode(params, x, c_cache, krope_cache, pos, cfg, *, window=0,
               tp=None):
    """Absorbed MLA decode: attend in latent space.

    c_cache (B, S, r), krope_cache (B, S, dr), written in place; pos
    (B,) int32.  ``q_lat = q_nope . W_UK`` in the model dtype; scores
    ``(q_lat . c^T + q_rope . k_rope^T) * (dn + dr)**-0.5`` and the
    softmax in f32; the weights rounded to the cache's dtype, ``w . c``
    in f32, cast to the model dtype, then ``. W_UV`` and ``wo``: the
    reference's rounding points.

    ``tp`` as ``mla_prefill``: c_cache is this rank's (B, S, r / m) slice.
    Every head's ``q_lat`` (``"heads"``: gathered with ``q_rope`` over the
    model axis) at this rank's slice of r forms partial scores, summed
    over the axis (f32) before the rotary term, the scale and the softmax;
    ``w . c`` is then this rank's exact slice of ``ctx_lat`` (the product
    sums over slots, not r), gathered along r; ``"heads"`` keeps its
    heads, ``"dim"`` the ``v_head_dim`` slice of ``W_UV`` that ``wo``'s
    rows take; ``wo``'s partial products are summed over the axis.  A
    plain route, as the reference's decode is ``einsum`` outside
    Pallas."""
    m = cfg.mla
    S_cache = c_cache.shape[1]
    q_nope, q_rope, c_new, krope_new = _mla_qkv(params, x, pos[:, None], cfg)
    slot = pos % S_cache if window else pos
    _cache_write(c_cache, c_new[:, 0] if tp is None
                 else tp.dim_slice(c_new[:, 0]), slot)
    _cache_write(krope_cache, krope_new[:, 0], slot)
    w_uk = params["wkv_b"][..., :m.qk_nope_head_dim]       # (r, H, dn)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, w_uk)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    ctx = _decode_ctx(S_cache, pos)
    w_uv = params["wkv_b"][..., m.qk_nope_head_dim:]       # (r, H, dv)
    if tp is None:
        ctx_lat = mla_decode_attention(q_lat, q_rope, c_cache, krope_cache,
                                       ctx, scale).to(x.dtype)
    else:
        r = q_lat.shape[-1]
        if tp.layout == "heads":
            q = tp.gather_model(torch.cat([q_lat, q_rope], dim=-1), 2)
            q_lat, q_rope = q[..., :r], q[..., r:]
        part = mla_decode_attention(tp.dim_slice(q_lat), q_rope, c_cache,
                                    krope_cache, ctx, scale,
                                    reduce=tp.reduce)
        ctx_lat = tp.gather_model(part.to(x.dtype), -1)
        if tp.layout == "heads":
            ctx_lat = tp.local_heads(ctx_lat)
        else:
            w_uv = tp.dim_slice(w_uv)
    v_out = torch.einsum("bshr,rhk->bshk", ctx_lat, w_uv)
    y = _out_project(v_out, params["wo"])
    return (y if tp is None else tp.reduce(y)), (c_cache, krope_cache)


def mla_decode_attention(q_lat, q_rope, c_cache, krope_cache, ctx, scale,
                         reduce=None):
    """Latent attention of one query per row: q_lat (B, 1, H, r), q_rope
    (B, 1, H, dr) over c_cache (B, S, r) and krope_cache (B, S, dr); row b
    attends slots [0, ctx[b]).  Returns ctx_lat (B, 1, H, r) in f32.
    ``reduce``: where q_lat and c_cache are one rank's slice of r, the sum
    of the latent scores over the ranks (f32, before the rotary term);
    ctx_lat is then that slice.  CUDA tensors go through
    ``mla_decode_attention_bmm`` (no copy of the cache); CPU tensors
    through ``mla_decode_attention_plain``."""
    if q_lat.device.type in PLAIN_DEVICES:
        return mla_decode_attention_plain(q_lat, q_rope, c_cache,
                                          krope_cache, ctx, scale, reduce)
    return mla_decode_attention_bmm(q_lat, q_rope, c_cache, krope_cache,
                                    ctx, scale, reduce)


def _bmm_f32(a, b):
    """``a @ b`` batched, f32 products and sums over a's dtype: bf16
    operands take ``torch.bmm(..., out_dtype=float32)`` (CUDA only)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    return torch.bmm(a, b, out_dtype=torch.float32)


def mla_decode_attention_bmm(q_lat, q_rope, c_cache, krope_cache, ctx,
                             scale, reduce=None):
    """``mla_decode_attention`` as cuBLAS products with f32 outputs over
    the caches in place: a batch over b is one stride of the cache and
    ``c^T`` a view, so no copy of the cache is made."""
    B, _, H, r = q_lat.shape
    S = c_cache.shape[1]
    s = _bmm_f32(q_lat.reshape(B, H, r), c_cache.transpose(1, 2))
    if reduce is not None:
        s = reduce(s)
    s.add_(_bmm_f32(q_rope.reshape(B, H, -1), krope_cache.transpose(1, 2)))
    s.mul_(scale)
    valid = torch.arange(S, device=ctx.device)[None, :] < ctx[:, None]
    s.masked_fill_(~valid[:, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1).to(c_cache.dtype)
    return _bmm_f32(w, c_cache).reshape(B, 1, H, r)


def mla_decode_attention_plain(q_lat, q_rope, c_cache, krope_cache, ctx,
                               scale, reduce=None):
    """Plain version of ``mla_decode_attention``: f32 products over f32
    copies of the operands, the weights rounded to the cache's dtype
    before the product with ``c``, as in the reference."""
    S = c_cache.shape[1]
    s = torch.einsum("bshr,btr->bhst", q_lat.float(), c_cache.float())
    if reduce is not None:
        s = reduce(s)
    s = (s + torch.einsum("bshk,btk->bhst", q_rope.float(),
                          krope_cache.float())) * scale
    valid = torch.arange(S, device=ctx.device)[None, :] < ctx[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,btr->bshr", w.to(c_cache.dtype).float(),
                        c_cache.float())
