"""Analytic serving cost model (paper §2/Figure 2; DESIGN.md §3).

The paper measures wall-clock latency / throughput / GPU-utilization on
A100s; the engine's modeled clock derives those from a roofline over a
target ``Hardware`` preset (DESIGN.md §3, §8): prefill is compute-bound, decode is
HBM-bound (weights + KV reads), and every batch refresh pays a host
overhead — exactly the three mechanisms behind the paper's Figure 2
(monotone latency, non-monotone throughput, stepwise utilization).
It also supplies the ``PredictTime``/TPS/Util terms of the metric map
(DESIGN.md §5) and, via heterogeneous ``Hardware`` presets, the
per-replica timing of the cluster layer (DESIGN.md §7).

Everything is derived from the ``ModelConfig`` so architectures with
cheaper decode state (MLA latents, SSM constant state, sliding windows)
get correspondingly different cost curves — the heterogeneity Equinox's
metric map must capture.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, ATTN_MLA, MAMBA2, RGLRU,
                                ModelConfig)


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12          # bf16 / chip
    hbm_bw: float = 819e9               # B/s / chip
    link_bw: float = 50e9               # B/s / ICI link
    hbm_bytes: float = 16e9
    chips: int = 1
    prefill_eff: float = 0.55           # achievable MFU in prefill
    bw_eff: float = 0.75                # achievable HBM fraction in decode
    batch_overhead: float = 0.006       # s per batch refresh (host-bound)


V5E = Hardware()

# The paper's synthetic-workload testbed (§7.1): one A100-80GB.  The
# simulator reproduces the paper's figures against this preset; the
# dry-run/roofline deliverables use the TPU-v5e mesh.
A100_80G = Hardware(name="a100-80g", peak_flops=312e12, hbm_bw=1935e9,
                    link_bw=300e9, hbm_bytes=80e9, chips=1,
                    prefill_eff=0.5, bw_eff=0.8, batch_overhead=0.006)

# One NVIDIA H100 SXM (data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
# 80 GB, 900 GB/s NVLink).  The efficiency fields are NOT calibrated on
# the card: they repeat the A100 preset's guesses until a measured run
# replaces them.
H100_SXM = Hardware(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12,
                    link_bw=900e9, hbm_bytes=80e9, chips=1,
                    prefill_eff=0.5, bw_eff=0.8,     # uncalibrated
                    batch_overhead=0.006)            # uncalibrated


def kv_bytes_per_token(cfg: ModelConfig, bytes_per_el: int = 2,
                       kv_quant: bool = None):
    """(bytes per cached token, context cap per layer kind list).

    Returns a list of (per_token_bytes, window_or_0) per layer so decode
    read cost can respect sliding windows; recurrent layers contribute a
    fixed state instead (returned separately).

    int8 KV pages (DESIGN.md §16; ``kv_quant=None`` reads
    ``cfg.kv_quant``) store 1 byte per element plus one bf16 scale per
    (token, head) for K and for V — so an attention layer costs
    ``2 * Hkv * (hd + 2)`` instead of ``2 * Hkv * hd * 2`` per token:
    ~2x the tokens in the same HBM.  Recurrent/conv state stays fp."""
    quant = cfg.kv_quant if kv_quant is None else kv_quant
    per_layer = []
    fixed_state = 0
    hd = cfg.resolved_head_dim()
    for kind in cfg.layer_kinds():
        if kind == ATTN:
            per_layer.append((2 * cfg.n_kv_heads * (hd + 2) if quant
                              else 2 * cfg.n_kv_heads * hd * bytes_per_el,
                              0))
        elif kind == ATTN_LOCAL:
            per_layer.append((2 * cfg.n_kv_heads * (hd + 2) if quant
                              else 2 * cfg.n_kv_heads * hd * bytes_per_el,
                              cfg.window))
        elif kind == ATTN_MLA:
            m = cfg.mla
            rank = m.kv_lora_rank + m.qk_rope_head_dim
            per_layer.append((rank + 2 if quant else rank * bytes_per_el,
                              cfg.window))
        elif kind == RGLRU:
            d_rnn = cfg.rglru.d_rnn or cfg.d_model
            fixed_state += d_rnn * (cfg.rglru.conv_width + 1) * bytes_per_el
            per_layer.append((0, 0))
        elif kind == MAMBA2:
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            nh = d_in // s.head_dim
            fixed_state += (nh * s.head_dim * s.d_state * 4
                            + (d_in + 2 * s.n_groups * s.d_state)
                            * s.conv_width * bytes_per_el)
            per_layer.append((0, 0))
    return per_layer, fixed_state


def kv_read_bytes(cfg: ModelConfig, ctx_len: int) -> float:
    """Bytes of cache state read for ONE decode token at context ctx_len."""
    per_layer, fixed = kv_bytes_per_token(cfg)
    total = fixed
    for per_tok, window in per_layer:
        eff_ctx = min(ctx_len, window) if window else ctx_len
        total += per_tok * eff_ctx
    return float(total)


class CostModel:
    def __init__(self, cfg: ModelConfig, hw: Hardware = V5E):
        self.cfg = cfg
        self.hw = hw
        self.param_bytes = cfg.n_params() * 2          # bf16 weights
        self.flops_per_token = 2 * cfg.n_active_params()
        hd = cfg.resolved_head_dim()
        self.attn_flops_per_ctx = 4 * cfg.n_heads * hd * sum(
            1 for k in cfg.layer_kinds() if k in (ATTN, ATTN_LOCAL, ATTN_MLA))
        # Cached KV layout (pure function of cfg) so the macro-step fast
        # path does not rebuild the per-layer list on every call.
        self._kv_per_layer, self._kv_fixed = kv_bytes_per_token(cfg)
        # With no sliding windows the per-layer fold collapses to one
        # multiply; all quantities are ints, so the collapsed form is
        # exactly the sequential sum (integer arithmetic, < 2^53).
        self._kv_simple = (sum(pt for pt, _ in self._kv_per_layer)
                           if all(w == 0 for _, w in self._kv_per_layer)
                           else None)

    @classmethod
    def for_serving(cls, cfg: ModelConfig, min_kv_tokens: int = 50_000,
                    hw: Hardware = V5E) -> "CostModel":
        """Size the chip count so weights + a healthy KV budget fit —
        the v5e analogue of the paper's A100-80GB serving testbed."""
        per_layer, _fixed = kv_bytes_per_token(cfg)
        per_tok = sum(pt for pt, _ in per_layer)
        need = (cfg.n_params() * 2 + per_tok * min_kv_tokens) \
            / (1 - 0.35) / hw.hbm_bytes
        chips = max(1, int(-(-need // 1)))
        return cls(cfg, dataclasses.replace(hw, chips=chips))

    def _kv_read(self, ctx_len: int) -> float:
        """``kv_read_bytes(self.cfg, ctx_len)`` off the cached layout —
        bit-identical (integer arithmetic throughout), without
        rebuilding the per-layer list per call.  The hot multiplicand
        of every decode-step price: the per-iteration loop evaluates it
        once per running request."""
        if self._kv_simple is not None:
            return float(self._kv_fixed + self._kv_simple * ctx_len)
        total = self._kv_fixed
        for per_tok, window in self._kv_per_layer:
            eff_ctx = min(ctx_len, window) if window else ctx_len
            total += per_tok * eff_ctx
        return float(total)

    # -- phases ---------------------------------------------------------------
    def prefill_time(self, n_tokens: int, avg_ctx: float = 0.0) -> float:
        """Compute-bound: all prompt tokens in parallel."""
        flops = self.flops_per_token * n_tokens \
            + self.attn_flops_per_ctx * n_tokens * (avg_ctx or n_tokens) / 2
        t_comp = flops / (self.hw.chips * self.hw.peak_flops
                          * self.hw.prefill_eff)
        t_mem = self.param_bytes / (self.hw.chips * self.hw.hbm_bw
                                    * self.hw.bw_eff)
        return max(t_comp, t_mem)

    def decode_step_time(self, ctx_lens) -> float:
        """Memory-bound: one token for every running request."""
        b = len(ctx_lens)
        if b == 0:
            return 0.0
        bytes_moved = self.param_bytes + sum(
            self._kv_read(c) for c in ctx_lens)
        flops = b * self.flops_per_token + self.attn_flops_per_ctx \
            * sum(min(c, 10 ** 9) for c in ctx_lens)
        t_mem = bytes_moved / (self.hw.chips * self.hw.hbm_bw * self.hw.bw_eff)
        t_comp = flops / (self.hw.chips * self.hw.peak_flops)
        return max(t_mem, t_comp)

    def mixed_step_time(self, prefill_chunks, ctx_lens) -> float:
        """One continuous-batching iteration mixing prompt-chunk prefill
        with a batched decode step.  The weights stream from HBM ONCE for
        the fused pass — chunked prefill piggybacks on the decode batch's
        weight reads (the stall-free economics; pricing ``prefill_time``
        + ``decode_step_time`` separately double-charges the multi-GB
        weight stream every mixed iteration).

        ``prefill_chunks``: (n_tokens, avg_ctx) pairs, one per chunk,
        where avg_ctx is the mean context its tokens attend to (start +
        n/2 for a chunk at offset start — a late chunk of a long prompt
        still pays full-prefix attention).  The endpoints reduce exactly
        to ``prefill_time`` (single whole-prompt chunk, no decode) and
        ``decode_step_time`` (no chunks).

        Shared-prefix cache hits (DESIGN.md §9) are priced through the
        same contract: ``BatchCore`` plans chunks only for the uncached
        suffix — cached tokens never appear in ``n_tokens``, so their
        weight/MLP FLOPs are skipped — while each chunk's ``avg_ctx``
        spans the cached prefix, so attention *over* cached pages (the
        kernel really reads them) stays charged."""
        if not prefill_chunks and not ctx_lens:
            return 0.0                  # idle iteration: no weight stream
        pf_flops = sum(self.flops_per_token * n
                       + self.attn_flops_per_ctx * n * avg_ctx
                       for n, avg_ctx in prefill_chunks)
        b = len(ctx_lens)
        dec_flops = b * self.flops_per_token + self.attn_flops_per_ctx \
            * sum(min(c, 10 ** 9) for c in ctx_lens)
        bytes_moved = self.param_bytes + sum(
            self._kv_read(c) for c in ctx_lens)
        t_comp = (pf_flops / (self.hw.chips * self.hw.peak_flops
                              * self.hw.prefill_eff)
                  + dec_flops / (self.hw.chips * self.hw.peak_flops))
        t_mem = bytes_moved / (self.hw.chips * self.hw.hbm_bw
                               * self.hw.bw_eff)
        return max(t_comp, t_mem)

    def decode_macro_times(self, ctx_lens, k: int):
        """Step times for ``k`` consecutive pure-decode iterations, where
        every context grows by one token per iteration.

        Bit-identical to the sequential loop

            [self.mixed_step_time([], [c + i for c in ctx_lens])
             for i in range(k)]

        because every byte/FLOP quantity involved (``param_bytes``, per-
        token KV bytes, context lengths, decode FLOPs) is an integer far
        below 2**53 — so the float64 sums here are *exact* integers, and
        regrouping the per-request/per-layer summation cannot change
        them.  The only inexact operations are the final two divisions
        and the max, which this method performs with the same operand
        order as ``mixed_step_time`` (DESIGN.md §15).  Returns a float64
        array of length ``k``; the caller adds batch-refresh overhead
        (``BatchCore.iteration_time`` semantics) per iteration."""
        k = int(k)
        b = len(ctx_lens)
        if k <= 0:
            return np.zeros(0)
        if b == 0:
            return np.zeros(k)
        ctx0 = np.asarray(ctx_lens, dtype=np.float64)
        steps = np.arange(k, dtype=np.float64)
        # (k, b) matrix of context lengths: row i is iteration i.
        ctx = ctx0[None, :] + steps[:, None]
        # Decode FLOPs: b*flops_per_token + attn_flops_per_ctx*sum(min(c,1e9))
        dec_flops = (b * float(self.flops_per_token)
                     + float(self.attn_flops_per_ctx)
                     * np.minimum(ctx, 1e9).sum(axis=1))
        # Bytes moved: weights + fixed recurrent state + per-layer KV
        # reads (sliding windows clamp the effective context).
        bytes_moved = np.full(
            k, float(self.param_bytes) + float(self._kv_fixed) * b)
        groups: dict = {}
        for per_tok, window in self._kv_per_layer:
            if per_tok:
                groups[window] = groups.get(window, 0) + per_tok
        for window, per_tok in groups.items():
            eff = np.minimum(ctx, window) if window else ctx
            bytes_moved += float(per_tok) * eff.sum(axis=1)
        t_comp = dec_flops / (self.hw.chips * self.hw.peak_flops)
        t_mem = bytes_moved / (self.hw.chips * self.hw.hbm_bw
                               * self.hw.bw_eff)
        return np.maximum(t_comp, t_mem)

    # -- derived metrics -------------------------------------------------------
    def mfu(self, useful_tokens: float, elapsed: float) -> float:
        """Model-FLOP utilization of a window (the TPU 'Util' analogue)."""
        if elapsed <= 0:
            return 0.0
        util = (self.flops_per_token * useful_tokens
                / (elapsed * self.hw.chips * self.hw.peak_flops))
        return float(min(util / self.hw.prefill_eff, 1.0))

    def kv_budget_tokens(self, reserve: float = 0.35,
                         kv_quant: bool = None) -> int:
        """How many cached tokens fit in HBM after weights (canSchedule M).
        ``kv_quant=True`` prices int8 KV pages (DESIGN.md §16), roughly
        doubling the budget for dense-attention stacks."""
        per_layer, fixed = kv_bytes_per_token(self.cfg, kv_quant=kv_quant)
        per_tok = sum(pt for pt, _ in per_layer)
        free = self.hw.chips * self.hw.hbm_bytes * (1 - reserve) \
            - self.param_bytes
        if per_tok <= 0:
            return 10 ** 9                      # state-space: no KV growth
        return max(int(free / per_tok), 0)
