"""Model assembly: the decoder stacks the port serves, behind the
reference's API.

Port of ``repro/models/model.py`` for stacks of GQA attention, full
(``ATTN``, e.g. Llama-2-7B) or sliding-window (``ATTN_LOCAL``, e.g.
Mixtral-8x7B), with dense or MoE FFNs (``models/moe.py``: Mixtral-8x7B,
DeepSeek-MoE-16B), of multi-head latent attention (``ATTN_MLA``,
MiniCPM3-4B), of Mamba-2 (``MAMBA2``) and of RG-LRU blocks beside
local attention (``RGLRU``, RecurrentGemma-2B's hybrid stack), and the
encoder-decoder Whisper large-v3 (``is_encoder_decoder``: a non-causal
encoder over stubbed audio frames, ``batch["frames"]`` (B, T, d), and a
decoder whose every layer adds cross-attention to the encoder's output),
and InternVL2's vision prefix (``vision_stub``: ``batch["patch_embeds"]``
(B, P, d) go before the token embeddings, positions count both, labels
only the tokens); GQA slot caches may be int8 with bf16 scales
(``cfg.kv_quant``; MLA caches ignore it, as in the reference).  The
stack is grouped into *stages*, maximal runs of layers with identical (kind, is_moe)
structure, each stage's per-layer parameters stacked on a leading axis;
a stage runs as a Python loop over that axis (the reference's
``lax.scan``).  Other kinds and options raise ``NotImplementedError``
naming the ``ROADMAP.md`` item that ports them.

    forward_hidden(params, batch, cfg, mode=) -> (hidden, aux, caches,
                                                 n_prefix)
    loss_fn(params, batch, cfg)             -> mean next-token NLL (+ MoE aux)
    prefill(params, batch, cfg, max_len)    -> (last_logits, cache)
    prefill_chunk(params, tokens, cfg, cache) -> (last_logits, cache)
    decode_step(params, tokens, cache, cfg) -> (logits, cache)
    init_cache(cfg, batch, max_len, device=..., enc_len=...) -> zeroed cache
    encode(params, frames, cfg)             -> the encoder's output
    long_context_variant(cfg)               -> the sliding-window rewrite

Caches keep the reference's layout (``{"pos": (B,), "stages":
{"stage_i": {...}}}`` with a leading layer axis; an encoder-decoder's
stages add ``cross_k``/``cross_v`` (L, B, T, H, hd), the encoder's keys
and values, written once by ``prefill``).  ``prefill_chunk`` and
``decode_step`` update the cache they are given in place and return it
with the new positions; ``prefill`` builds a new one.

Training (``mode="train"``, ``loss_fn``) runs with autograd: attention
through the flash kernel's autograd Function (its backward kernel),
decoder layer bodies under ``torch.utils.checkpoint`` when ``cfg.remat``
(one layer at a time, or groups of ``cfg.remat_group`` layers, as the
reference's ``jax.checkpoint``; an encoder runs without it, as the
reference's), the loss by ``chunked_ce_loss`` plus
``router_aux_coef`` times the MoE load-balance loss summed over the
layers; Mamba-2 layers through the SSD scan's autograd Function (its
backward kernel).  It trains every stack the port runs.  The serving
entry points run under ``torch.no_grad``.  On a mesh
(``train(mesh=...)``, ``models.sharding.ShardPlan``) the parameters are
shards, gathered whole where they are used: each layer's leaves inside
its (rematerialised) body, the embedding table for the inputs and the
head (or tied table) for the loss.

Serving on a mesh (``prefill``, ``prefill_chunk``, ``decode_step`` under
a ``models.sharding.ServePlan``, the reference's "plain TP+DP"): the
parameters and caches are this rank's shards and stay so; the layers
move activations only (``sharding.model_split`` hands them the plan as
``tp``), the batch's rows are this rank's, and the logits its vocab
block.  It serves every stack: GQA (dense or MoE, full or windowed
attention, bf16 or int8 caches), multi-head latent attention, Mamba-2 and
RG-LRU beside local attention (``sharding.serve_layouts`` names each
kind's layout and refuses the shapes it does not take), Whisper's
encoder-decoder (the encoder's layers split as the decoder's, over this
rank's rows of ``batch["frames"]``; the cross-attention over heads or
over the head dim, ``sharding.cross_split``, its caches this rank's
shards) and InternVL2's vision prefix (this rank's rows of
``batch["patch_embeds"]`` ahead of the tokens' vocab-split embedding).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, ATTN_MLA, MAMBA2,
                                      RGLRU, ModelConfig)
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import sharding
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (chunked_ce_loss, dtype_of, embed, mlp,
                                       rmsnorm, unembed)


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a stack the port cannot run: a
    layer kind or a frontend it has no counterpart of.  Every registered
    stack runs, on one process and under a ``sharding.ServePlan``."""
    for kind in sorted(set(cfg.layer_kinds())):
        if kind not in (ATTN, ATTN_LOCAL, ATTN_MLA, MAMBA2, RGLRU):
            raise NotImplementedError(f"{cfg.name}: layer kind {kind!r} is "
                                      "not ported")
    if cfg.frontend not in ("text", "audio_stub", "vision_stub"):
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} frontend "
                                  "is not ported")


def check_trainable(cfg: ModelConfig) -> None:
    """Training takes every stack the port runs (``check_ported``)."""
    check_ported(cfg)


# ---------------------------------------------------------------------------
# Stage structure
# ---------------------------------------------------------------------------
def model_stages(cfg: ModelConfig):
    """(kind, moe_flag, count) runs over the decoder stack."""
    kinds = cfg.layer_kinds()
    runs = []
    for i, k in enumerate(kinds):
        moe_flag = cfg.is_moe_layer(i) and k != MAMBA2
        if runs and runs[-1][0] == k and runs[-1][1] == moe_flag:
            runs[-1][2] += 1
        else:
            runs.append([k, moe_flag, 1])
    return [tuple(r) for r in runs]


def long_context_variant(cfg: ModelConfig) -> ModelConfig:
    """Sliding-window rewrite used for long_500k on full-attention archs
    (beyond-paper adaptation, see DESIGN.md §4)."""
    if cfg.supports_long_context():
        return cfg
    w = cfg.long_context_window
    changes = {"window": w if cfg.window == 0 else min(cfg.window, w)}
    if cfg.attn_kind == ATTN:
        changes["attn_kind"] = ATTN_LOCAL
    if cfg.layer_pattern:
        changes["layer_pattern"] = tuple(
            ATTN_LOCAL if k == ATTN else k for k in cfg.layer_pattern)
    return dataclasses.replace(cfg, **changes)


def window_for(cfg, kind):
    if kind in (ATTN_LOCAL, ATTN_MLA):
        return cfg.window
    return 0


def layer_params(tree, i):
    """Layer ``i`` of a stage's stacked parameter (or cache) tree."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def unbind_layers(tree):
    """The per-layer trees of a stage's stacked tree, from one ``unbind``
    per leaf.  Under autograd the gradients of the layers then come back
    as one ``stack`` per leaf, where indexing layer by layer
    (``layer_params``) would give each layer's gradient a zero-filled
    copy of the whole stacked leaf to add up."""
    if not isinstance(tree, dict):
        return tree.unbind(0)
    per_key = {k: unbind_layers(v) for k, v in tree.items()}
    n = len(next(iter(per_key.values())))
    return [{k: v[i] for k, v in per_key.items()} for i in range(n)]


def _stack(entries):
    """Per-layer dicts of tensors -> one dict with a leading layer axis."""
    return {k: torch.stack([e[k] for e in entries]) for k in entries[0]}


# ---------------------------------------------------------------------------
# Block forward (full sequence: prefill)
# ---------------------------------------------------------------------------
def ffn_forward(params, h, cfg, moe_flag, rows=sharding.WHOLE_BATCH,
                tp=None):
    """One layer's FFN: the MoE FFN on MoE layers, the MLP elsewhere.
    ``rows``: the batch's row split; ``tp``: the serving plan whose model
    axis splits the layer (``sharding.model_split``), or None."""
    if moe_flag:
        return moe_mod.moe_ffn(params, h, cfg, rows=rows, tp=tp)[0]
    return mlp(params, h, cfg.act, tp=tp)


def _block_forward(lp, x, cfg, kind, moe_flag, positions, *, causal=True,
                   enc_kv=None, want_cache=False, want_aux=False,
                   rows=sharding.WHOLE_BATCH,
                   channels=sharding.ALL_CHANNELS, tp=None):
    """Returns (x, aux, cache_entry_or_None).  ``enc_kv``: the encoder's
    output, which a decoder layer of an encoder-decoder attends after its
    self-attention (its keys and values join the cache entry).  ``aux``:
    an MoE layer's load-balance loss when ``want_aux`` (training), else
    None.  ``rows``: the batch's row split (``sharding.row_split``),
    which an MoE layer's statistics span.  ``channels``: an RG-LRU
    layer's ``sharding.ChannelSplit`` (``sharding.channel_split``) when
    its leaves are this rank's channel block (training's channel-parallel
    branch, or serving over a model axis), else ``sharding.ALL_CHANNELS``.
    ``tp``: a serving plan that splits the layer over its model axis
    (``sharding.model_split``), or None."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    window = window_for(cfg, kind)
    cache = None
    if kind in (ATTN, ATTN_LOCAL):
        y, (k, v) = attn_mod.gqa_prefill(lp["attn"], h, positions, cfg,
                                         window=window, causal=causal, tp=tp)
        if want_cache:
            cache = {"k": k, "v": v}
    elif kind == ATTN_MLA:
        y, (c, krope) = attn_mod.mla_prefill(lp["attn"], h, positions, cfg,
                                             window=window, tp=tp)
        if want_cache:
            cache = {"c": c, "k_rope": krope}
    elif kind == RGLRU:
        y, st = rglru_mod.rglru_prefill(lp["attn"], h, cfg,
                                        channels=channels)
        if want_cache:
            cache = st
    elif kind == MAMBA2:
        y, st = ssm_mod.mamba2_prefill(lp["attn"], h, cfg, tp=tp)
        if want_cache:
            cache = st
    else:
        raise NotImplementedError(f"layer kind {kind!r} is not ported")
    x = x + y
    if enc_kv is not None:
        hc = rmsnorm(lp["ln_cross"], x, cfg.norm_eps)
        ck, cv = attn_mod.cross_kv(lp["cross"], enc_kv)
        x = x + attn_mod.cross_attn(lp["cross"], hc, ck, cv,
                                    impl=cfg.attn_impl, tp=tp)
        if want_cache:
            cache = dict(cache or {}, cross_k=ck, cross_v=cv)
    aux = None
    if kind != MAMBA2:
        h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
        if moe_flag:
            f, aux = moe_mod.moe_ffn(lp["ffn"], h2, cfg, want_aux=want_aux,
                                     rows=rows, tp=tp)
        else:
            f = mlp(lp["ffn"], h2, cfg.act, tp=tp)
        x = x + f
    return x, aux, cache


def _fit_cache_seq(arr, S_cache):
    """Place a (B, S, ...) prefill cache tensor into an S_cache ring/buffer
    such that token t sits at slot t % S_cache (matches decode writes)."""
    S = arr.shape[1]
    if S == S_cache:
        return arr
    if S < S_cache:
        out = arr.new_zeros((arr.shape[0], S_cache) + arr.shape[2:])
        out[:, :S] = arr
        return out
    slots = torch.arange(S - S_cache, S, device=arr.device) % S_cache
    out = arr.new_zeros((arr.shape[0], S_cache) + arr.shape[2:])
    out[:, slots] = arr[:, S - S_cache:]
    return out


def _run_stage(stage_params, x, cfg, kind, moe_flag, count, positions, *,
               causal=True, enc_out=None, want_cache=False, remat=False,
               want_aux=False):
    """The stage's layers in order; returns (x, aux, stacked caches or
    None), ``aux`` the sum of the MoE layers' load-balance losses in
    layer order when ``want_aux`` (None on a stage without them).
    ``remat`` (training): each layer body under ``checkpoint``, or each
    group of ``cfg.remat_group`` layers when the group divides the stage
    and is smaller than it (the reference's grouped remat), so the
    backward saves only the group's input and reruns its forward; the
    checkpointed function returns (x, aux).  On a mesh
    (``train(mesh=...)``) each layer's leaves are gathered whole inside
    that function (``sharding.layer_gatherer``), so the backward gathers
    them again and no whole copy is kept between the passes; a
    channel-parallel RG-LRU branch keeps its channel block instead
    (``sharding.channel_split``).  Serving on a mesh
    (``sharding.ServePlan``) gathers nothing: each layer runs on this
    rank's shards (``sharding.model_split``).  The plan's pieces are taken
    here, outside ``checkpoint``, whose recompute runs where no plan is
    active."""
    per_layer = unbind_layers(stage_params)
    gather = sharding.layer_gatherer(stage_params)
    rows = sharding.row_split()
    channels = sharding.channel_split(stage_params)
    tp = sharding.model_split()

    def layers(x, lo, hi):
        aux, caches = None, []
        for i in range(lo, hi):
            x, a, cache = _block_forward(gather(per_layer[i]), x, cfg,
                                         kind, moe_flag, positions,
                                         causal=causal, enc_kv=enc_out,
                                         want_cache=want_cache,
                                         want_aux=want_aux, rows=rows,
                                         channels=channels, tp=tp)
            aux = a if aux is None else aux + a
            caches.append(cache)
        return x, aux, caches

    if not remat:
        x, aux, caches = layers(x, 0, count)
        return x, aux, _stack(caches) if want_cache else None
    G = cfg.remat_group
    step = G if G > 1 and count % G == 0 and count > G else 1
    aux = None
    for lo in range(0, count, step):
        x, a = checkpoint(lambda h, lo=lo: layers(h, lo, lo + step)[:2], x,
                          use_reentrant=False)
        aux = a if aux is None else aux + a
    return x, aux, None


# ---------------------------------------------------------------------------
# The audio frontend (a stub, as in the reference: frame embeddings come
# precomputed) and the encoder
# ---------------------------------------------------------------------------
def _sinusoid(positions, d):
    """(..., d) f32: sin then cos of positions times 10000**(-i / (d/2))."""
    half = d // 2
    freq = torch.exp(-torch.log(torch.tensor(10000.0)) * torch.arange(
        half, dtype=torch.float32) / half).to(positions.device)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def encode(params, frames, cfg):
    """The Whisper encoder over stubbed frame embeddings (B, T, d): the
    sinusoid added, ``n_encoder_layers`` non-causal attention layers
    (``params["enc"]``), the final norm.  Autograd records it when a
    gradient is wanted (training, without remat, as the reference's)."""
    dt = dtype_of(cfg)
    B, T, _ = frames.shape
    pos = torch.arange(T, device=frames.device)[None].expand(B, T)
    x = frames.to(dt) + _sinusoid(pos, cfg.d_model).to(dt)
    x, _, _ = _run_stage(params["enc"]["stages"]["stage_0"], x, cfg, ATTN,
                         False, cfg.n_encoder_layers, pos, causal=False)
    return rmsnorm(params["enc"]["final_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# The vision frontend (a stub, as in the reference: patch embeddings come
# precomputed)
# ---------------------------------------------------------------------------
def _embed_inputs(params, batch, cfg):
    """(x (B, S, d), positions (B, S), n_prefix): a ``vision_stub`` batch's
    ``patch_embeds`` (B, P, d) go first, then the token embeddings, and
    positions run 0..S-1 over both; n_prefix = P (0 without patches)."""
    dt = dtype_of(cfg)
    table = sharding.gather_at_use({"table": params["embed"]["table"]})
    x = embed(table, batch["tokens"], tp=sharding.model_split()).to(dt)
    n_prefix = 0
    if cfg.frontend == "vision_stub":
        patches = batch["patch_embeds"].to(dt)
        x = torch.cat([patches, x], dim=1)
        n_prefix = patches.shape[1]
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    return x, positions, n_prefix


# ---------------------------------------------------------------------------
# Full forward -> hidden states, and the training loss
# ---------------------------------------------------------------------------
def forward_hidden(params, batch, cfg, *, mode="train", want_cache=False):
    """Causal forward of a batch (an encoder-decoder's also takes
    ``batch["frames"]``, a vision stack's ``batch["patch_embeds"]``).
    Returns (hidden (B, S, d), aux, caches per stage (None per stage
    without ``want_cache``), n_prefix).  ``mode="train"`` applies
    ``cfg.remat``; autograd records whatever needs a gradient.  ``aux``
    (f32, 0-d) is the MoE load-balance loss summed over the layers, which
    only training reads: computed under ``mode="train"``, zero in the
    serving modes (and on stacks without MoE layers).

    ``cfg.seq_parallel`` is the reference's sharding constraint on the
    residual stream between blocks (its sequence over ``"model"``), which
    changes no value; the port's layers run on local tensors with the
    sequence whole and the weights gathered, so it has no effect here
    (a layout for speed: ROADMAP.md item 12c)."""
    check_ported(cfg)
    x, positions, n_prefix = _embed_inputs(params, batch, cfg)
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = encode(params, batch["frames"], cfg)
        x = x + _sinusoid(positions, cfg.d_model).to(x.dtype)
    remat = cfg.remat and mode == "train" and not want_cache
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for i, (kind, moe_flag, count) in enumerate(model_stages(cfg)):
        x, stage_aux, cache = _run_stage(
            params["stages"][f"stage_{i}"], x, cfg, kind, moe_flag, count,
            positions, enc_out=enc_out, want_cache=want_cache, remat=remat,
            want_aux=mode == "train")
        if stage_aux is not None:
            aux = aux + stage_aux
        caches.append(cache)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, aux, caches, n_prefix


def loss_fn(params, batch, cfg: ModelConfig):
    """Mean next-token NLL over the tokens (the vision prefix's rows are
    dropped; ``batch["mask"]`` optional), plus ``router_aux_coef`` times
    the MoE aux loss.  Differentiable in ``params``."""
    check_trainable(cfg)
    hidden, aux, _, n_prefix = forward_hidden(params, batch, cfg,
                                              mode="train")
    if n_prefix:
        hidden = hidden[:, n_prefix:]
    # the leaf the logits read (the head, or the tied table: gathered a
    # second time on a mesh, its gradient summed once)
    emb = params["embed"]
    head = {"head": emb["head"]} if "head" in emb else {"table": emb["table"]}
    nll = chunked_ce_loss(sharding.gather_at_use(head), hidden,
                          batch["labels"], mask=batch.get("mask"))
    coef = cfg.moe.router_aux_coef if cfg.moe is not None else 0.0
    return nll + coef * aux


# ---------------------------------------------------------------------------
# KV / state cache
# ---------------------------------------------------------------------------
def _cache_seq_len(cfg, kind, max_len):
    w = window_for(cfg, kind)
    return min(max_len, w) if w else max_len


def _stage_cache_zeros(cfg, kind, count, B, max_len, dt, device):
    hd = cfg.resolved_head_dim()
    S_c = _cache_seq_len(cfg, kind, max_len)
    if kind in (ATTN, ATTN_LOCAL):
        shape = (count, B, S_c, cfg.n_kv_heads, hd)
        if cfg.kv_quant:                 # int8 values, bf16 scales
            codes = dict(dtype=torch.int8, device=device)
            scales = dict(dtype=torch.bfloat16, device=device)
            return {"k": torch.zeros(shape, **codes),
                    "v": torch.zeros(shape, **codes),
                    "k_s": torch.zeros(shape[:-1], **scales),
                    "v_s": torch.zeros(shape[:-1], **scales)}
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
    if kind == ATTN_MLA:
        m = cfg.mla
        return {"c": torch.zeros((count, B, S_c, m.kv_lora_rank), dtype=dt,
                                 device=device),
                "k_rope": torch.zeros((count, B, S_c, m.qk_rope_head_dim),
                                      dtype=dt, device=device)}
    if kind == RGLRU:
        r = cfg.rglru
        d_rnn = r.d_rnn or cfg.d_model
        return {"conv_state": torch.zeros((count, B, r.conv_width - 1,
                                           d_rnn), dtype=dt, device=device),
                "h": torch.zeros((count, B, d_rnn), dtype=dt, device=device)}
    if kind == MAMBA2:
        s = cfg.ssm
        _, nh, conv_dim = ssm_mod.mamba2_dims(cfg)
        return {"conv_state": torch.zeros((count, B, s.conv_width - 1,
                                           conv_dim), dtype=dt, device=device),
                "ssm_state": torch.zeros((count, B, nh, s.head_dim,
                                          s.d_state), dtype=torch.float32,
                                         device=device)}
    raise NotImplementedError(f"layer kind {kind!r} is not ported")


@torch.no_grad()
def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               pos: int = 0, *, device, enc_len: int = 0):
    """Zeroed caches; an encoder-decoder's cross caches hold ``enc_len``
    frames.  Under a ``sharding.ServePlan`` (for its batch) each leaf has
    this rank's shape under ``cache_specs``, ``pos`` the whole batch's."""
    check_ported(cfg)
    plan = sharding.serving()
    if plan is None:
        return _init_cache(cfg, batch_size, max_len, pos, device, enc_len)
    if batch_size != plan.batch:
        raise ValueError(f"init_cache: batch {batch_size} under a ServePlan "
                         f"for batch {plan.batch}")
    whole = _init_cache(cfg, batch_size, max_len, pos, "meta", enc_len)
    specs = sharding.cache_specs(whole, cfg, plan.mesh, batch_size)

    def local(tree, specs):
        if isinstance(tree, dict):
            return {k: local(v, specs[k]) for k, v in tree.items()}
        return torch.zeros(sharding.local_shape(tree.shape, specs, plan.mesh),
                           dtype=tree.dtype, device=device)

    cache = local(whole, specs)
    cache["pos"].fill_(pos)
    return cache


def _init_cache(cfg, batch_size, max_len, pos, device, enc_len):
    dt = dtype_of(cfg)
    cache = {"pos": torch.full((batch_size,), pos, dtype=torch.int32,
                               device=device), "stages": {}}
    for i, (kind, _moe, count) in enumerate(model_stages(cfg)):
        c = _stage_cache_zeros(cfg, kind, count, batch_size, max_len, dt,
                               device)
        if cfg.is_encoder_decoder:
            shape = (count, batch_size, enc_len, cfg.n_heads,
                     cfg.resolved_head_dim())
            c["cross_k"] = torch.zeros(shape, dtype=dt, device=device)
            c["cross_v"] = torch.zeros(shape, dtype=dt, device=device)
        cache["stages"][f"stage_{i}"] = c
    return cache


# ---------------------------------------------------------------------------
# Prefill (returns last-token logits + populated cache)
# ---------------------------------------------------------------------------
@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig, max_len: int):
    """(last-token logits, a new cache).  Under a ``sharding.ServePlan``
    ``batch`` holds this rank's rows (``ServePlan.rows_of``), the logits
    are this rank's rows and vocab block, the cache this rank's shards and
    the whole batch's ``pos``."""
    hidden, _, caches, n_prefix = forward_hidden(
        params, batch, cfg, mode="prefill", want_cache=True)
    logits = unembed(params["embed"], hidden[:, -1])
    plan = sharding.serving()
    B = hidden.shape[0] if plan is None else plan.batch
    S = batch["tokens"].shape[1] + n_prefix
    # an int8 cache's scales span each whole head: over a head-dim split
    # the absmax is reduced over the model axis
    amax = plan.reduce_max if plan is not None and plan.splits_dims \
        else None
    cache = {"pos": torch.full((B,), S, dtype=torch.int32,
                               device=hidden.device), "stages": {}}
    for i, (kind, _moe, _count) in enumerate(model_stages(cfg)):
        sc = caches[i]
        S_c = _cache_seq_len(cfg, kind, max_len)
        fitted = {}
        for name, arr in sc.items():
            if (kind in (ATTN, ATTN_LOCAL) and name in ("k", "v")) or \
                    (kind == ATTN_MLA and name in ("c", "k_rope")):
                # (L, B, S, ...) -> fit each layer's (B, S, ...) slice
                L, rows = arr.shape[:2]
                fit = _fit_cache_seq(arr.reshape(L * rows, *arr.shape[2:]),
                                     S_c)
                fit = fit.reshape(L, rows, *fit.shape[1:])
                if cfg.kv_quant and kind != ATTN_MLA:
                    fitted[name], fitted[name + "_s"] = \
                        attn_mod.quantize_kv(fit, amax)
                else:
                    fitted[name] = fit
            else:
                fitted[name] = arr
        cache["stages"][f"stage_{i}"] = fitted
    return logits, cache


# ---------------------------------------------------------------------------
# Incremental (chunked) prefill: extend an existing cache by one chunk
# ---------------------------------------------------------------------------
def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Incremental prefill needs an append-only cache the chunk can attend
    into: uniform full-attention dense/MoE GQA stacks (the paper's Llama-2
    testbed shape, and everything the paged backend serves).  Recurrent,
    hybrid, windowed, MLA, encoder-decoder and modality-frontend stacks
    fall back to whole-prompt prefill in the engine."""
    return (set(cfg.layer_kinds()) == {ATTN}
            and not cfg.is_encoder_decoder
            and cfg.frontend == "text"
            and not cfg.kv_quant
            and cfg.window == 0)


@torch.no_grad()
def prefill_chunk(params, tokens, cfg: ModelConfig, cache):
    """Extend a ``prefill``/``init_cache``-layout cache by one prompt chunk,
    in place.

    tokens: (B, C) int at absolute positions [pos, pos+C) where
    ``pos = cache["pos"]`` (all rows equal: the engine runs one request
    per call).  Returns (last-token logits (B, V), the cache advanced to
    pos+C).  ``prefill(p)`` equals any sequence of ``prefill_chunk`` calls
    covering p.  Under a ``sharding.ServePlan`` as ``prefill``: this
    rank's rows, shards and vocab block."""
    assert supports_chunked_prefill(cfg), \
        f"{cfg.name}: architecture has no incremental-prefill support"
    check_ported(cfg)
    start = int(cache["pos"][0])
    B, C = tokens.shape
    tp, rows = sharding.model_split(), sharding.row_split()
    x = embed(params["embed"], tokens, tp=tp).to(dtype_of(cfg))
    for i, (_kind, moe_flag, count) in enumerate(model_stages(cfg)):
        sp = params["stages"][f"stage_{i}"]
        sc = cache["stages"][f"stage_{i}"]
        for li in range(count):
            lp = layer_params(sp, li)
            hn = rmsnorm(lp["ln1"], x, cfg.norm_eps)
            y, _ = attn_mod.gqa_prefill_chunk(lp["attn"], hn, sc["k"][li],
                                              sc["v"][li], start, cfg, tp=tp)
            x = x + y
            h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
            x = x + ffn_forward(lp["ffn"], h2, cfg, moe_flag, rows, tp)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(params["embed"], x[:, -1])
    return logits, {"pos": cache["pos"] + C, "stages": cache["stages"]}


# ---------------------------------------------------------------------------
# Decode: one token through every layer
# ---------------------------------------------------------------------------
def _block_decode(lp, x1, c, pos, cfg, kind, moe_flag,
                  rows=sharding.WHOLE_BATCH, tp=None,
                  channels=sharding.ALL_CHANNELS):
    """One layer of a decode step; ``rows``, ``tp`` and ``channels`` as
    ``_block_forward``'s."""
    h = rmsnorm(lp["ln1"], x1, cfg.norm_eps)
    window = window_for(cfg, kind)
    if kind in (ATTN, ATTN_LOCAL):
        y, _ = attn_mod.gqa_decode(lp["attn"], h, c["k"], c["v"], pos, cfg,
                                   window=window, k_scale=c.get("k_s"),
                                   v_scale=c.get("v_s"), tp=tp)
    elif kind == ATTN_MLA:
        y, _ = attn_mod.mla_decode(lp["attn"], h, c["c"], c["k_rope"], pos,
                                   cfg, window=window, tp=tp)
    elif kind == RGLRU:
        y, st = rglru_mod.rglru_decode(
            lp["attn"], h, {k: c[k] for k in ("conv_state", "h")}, cfg,
            channels=channels)
        c = dict(c, **st)
    elif kind == MAMBA2:
        y, st = ssm_mod.mamba2_decode(
            lp["attn"], h, {k: c[k] for k in ("conv_state", "ssm_state")}, cfg,
            tp=tp)
        c = dict(c, **st)
    else:
        raise NotImplementedError(f"layer kind {kind!r} is not ported")
    x1 = x1 + y
    if "cross_k" in c:
        hc = rmsnorm(lp["ln_cross"], x1, cfg.norm_eps)
        x1 = x1 + attn_mod.cross_decode(lp["cross"], hc, c["cross_k"],
                                        c["cross_v"], tp=tp)
    if kind != MAMBA2:
        h2 = rmsnorm(lp["ln2"], x1, cfg.norm_eps)
        x1 = x1 + ffn_forward(lp["ffn"], h2, cfg, moe_flag, rows, tp)
    return x1, c


@torch.no_grad()
def decode_step(params, tokens, cache, cfg: ModelConfig):
    """tokens: (B,) int.  Returns (logits (B, V), cache), the cache updated
    in place with ``pos`` advanced by one.

    ``cache['pos']`` is a per-request (B,) position vector, so a decode
    batch may mix requests at different sequence offsets (continuous
    batching).  Under a ``sharding.ServePlan`` ``tokens`` are this rank's
    rows, the logits its rows and vocab block, and ``pos`` stays the whole
    batch's (its spec is ``P()``), each rank reading its rows'."""
    check_ported(cfg)
    plan = sharding.serving()
    tp, rows = sharding.model_split(), sharding.row_split()
    pos_all = cache["pos"]
    pos = pos_all if plan is None else plan.rows_of(pos_all)
    x = embed(params["embed"], tokens, tp=tp)[:, None].to(dtype_of(cfg))
    if cfg.is_encoder_decoder:
        x = x + _sinusoid(pos[:, None], cfg.d_model).to(x.dtype)
    for i, (kind, moe_flag, count) in enumerate(model_stages(cfg)):
        sp = params["stages"][f"stage_{i}"]
        sc = cache["stages"][f"stage_{i}"]
        channels = sharding.channel_split(sp)
        for li in range(count):
            c = layer_params(sc, li)
            x, c_new = _block_decode(layer_params(sp, li), x, c, pos, cfg,
                                     kind, moe_flag, rows, tp, channels)
            for name, t in c_new.items():      # recurrent states are new
                if t.data_ptr() != c[name].data_ptr():  # tensors: store
                    sc[name][li].copy_(t)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(params["embed"], x[:, 0])
    return logits, {"pos": pos_all + 1, "stages": cache["stages"]}
