"""Model / shape / mesh configuration for the Equinox reproduction.

One ``ModelConfig`` dataclass covers every assigned architecture family:
dense (GQA / MLA / SWA), MoE (classic + fine-grained), SSM (Mamba-2 SSD),
hybrid (RG-LRU + local attention), encoder-decoder (Whisper) and VLM
(vision-stub + dense decoder).  Each ``src/repro/configs/<arch>.py`` file
instantiates it with the exact assigned numbers and also provides a
``smoke()`` reduced variant (<=2 layers, d_model<=512, <=4 experts) for
CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer kinds used in ``layer_pattern``
# ---------------------------------------------------------------------------
ATTN = "attn"            # global self attention (GQA / MHA)
ATTN_LOCAL = "attn_local"  # sliding-window self attention
ATTN_MLA = "attn_mla"    # multi-head latent attention (DeepSeek-V2 style)
RGLRU = "rglru"          # Griffin / RecurrentGemma gated linear recurrence
MAMBA2 = "mamba2"        # Mamba-2 SSD block (attention free)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention dims (MiniCPM3 / DeepSeek-V2 style)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    n_shared_experts: int = 0       # DeepSeek-MoE fine-grained shared experts
    d_ff_expert: int = 0            # per-expert hidden size
    d_ff_shared: int = 0            # total hidden of the shared experts
    first_k_dense: int = 0          # DeepSeek-MoE keeps the first layer dense
    capacity_factor: float = 1.0    # dispatch-impl capacity
    router_aux_coef: float = 0.01   # load-balance loss weight (training)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block dims."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2                 # d_inner = expand * d_model
    conv_width: int = 4
    n_groups: int = 1               # B/C groups
    chunk_size: int = 128           # SSD chunked-scan block length


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma recurrent-block dims."""
    d_rnn: int = 0                  # lru width (0 -> d_model)
    conv_width: int = 4
    block_width: int = 0            # unused placeholder for parity


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    # attention flavour ------------------------------------------------------
    attn_kind: str = ATTN           # default layer kind for attention layers
    window: int = 0                 # sliding window size (attn_local)
    long_context_window: int = 4096  # beyond-paper SWA fallback for long_500k
    rope_theta: float = 10_000.0
    # heterogeneous stacks ---------------------------------------------------
    layer_pattern: Tuple[str, ...] = ()   # repeating unit; () -> uniform
    # sub-configs ------------------------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    mla: Optional[MLAConfig] = None
    # encoder-decoder (whisper) ---------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_attn_kind: str = ATTN
    # modality frontend (stubbed per spec) -----------------------------------
    frontend: str = "text"          # text | audio_stub | vision_stub
    n_frontend_tokens: int = 0      # patches / audio frames in the prompt
    # misc --------------------------------------------------------------------
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"               # silu (swiglu) | gelu (plain mlp)
    dtype: str = "bfloat16"
    # implementation switches (tests force the simple paths) -----------------
    attn_impl: str = "flash"        # flash (blockwise lax.scan) | naive
    moe_impl: str = "dispatch"      # dispatch (sort-based) | dense
    remat: bool = True              # checkpoint layer bodies during training
    # distribution options (exercised by dryrun + §Perf iterations) -----------
    fsdp: bool = False              # shard params/opt over the data axis too
    seq_parallel: bool = False      # shard the residual stream's seq axis
    remat_group: int = 0            # >1: grouped (sqrt-style) remat scan
    kv_quant: bool = False          # int8 KV cache (per token×head scales) —
                                    # beyond-paper serving optimization (§Perf)
    train_batch_over_model: bool = True   # ZeRO-style batch spread; False for
                                          # channel-parallel recurrent stacks
    source: str = ""                # citation for the assigned config

    # -- derived -------------------------------------------------------------
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Full per-layer kind list for the decoder stack."""
        if not self.layer_pattern:
            return (self.attn_kind,) * self.n_layers
        pat = self.layer_pattern
        kinds = tuple(pat[i % len(pat)] for i in range(self.n_layers))
        return kinds

    def stages(self) -> Tuple[Tuple[str, int], ...]:
        """Group consecutive identical layer kinds into scan stages."""
        kinds = self.layer_kinds()
        out = []
        for k in kinds:
            if out and out[-1][0] == k:
                out[-1][1] += 1
            else:
                out.append([k, 1])
        return tuple((k, n) for k, n in out)

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        return layer_idx >= self.moe.first_k_dense

    def supports_long_context(self) -> bool:
        """Natively sub-quadratic (no SWA fallback needed)?"""
        kinds = set(self.layer_kinds())
        return ATTN not in kinds and ATTN_MLA not in kinds

    def n_params(self) -> int:
        """Approximate parameter count (embedding + stack + head)."""
        d, dff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim()
        total = V * d * (1 if self.tie_embeddings else 2)
        for i, kind in enumerate(self.layer_kinds()):
            if kind in (ATTN, ATTN_LOCAL):
                q = d * self.n_heads * hd
                kv = 2 * d * self.n_kv_heads * hd
                o = self.n_heads * hd * d
                total += q + kv + o
            elif kind == ATTN_MLA:
                m = self.mla or MLAConfig()
                qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
                total += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk_hd
                total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                total += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                total += self.n_heads * m.v_head_dim * d
            elif kind == RGLRU:
                r = self.rglru or RGLRUConfig()
                d_rnn = r.d_rnn or d
                total += 2 * d * d_rnn + d_rnn * d + r.conv_width * d_rnn + 2 * d_rnn
            elif kind == MAMBA2:
                s = self.ssm or SSMConfig()
                d_in = s.expand * d
                nh = d_in // s.head_dim
                proj_in = d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
                total += proj_in + d_in * d + s.conv_width * (d_in + 2 * s.n_groups * s.d_state)
            # FFN / MoE
            if kind != MAMBA2:
                if self.is_moe_layer(i):
                    m = self.moe
                    ne = m.n_experts
                    total += ne * 3 * d * m.d_ff_expert
                    if m.n_shared_experts:
                        total += 3 * d * m.d_ff_shared
                    total += d * ne  # router
                else:
                    mult = 3 if self.act == "silu" else 2
                    total += mult * d * dff
        if self.is_encoder_decoder:
            # encoder self-attn + ffn, decoder cross-attn
            q = d * self.n_heads * hd
            enc = self.n_encoder_layers * (4 * q + (3 if self.act == "silu" else 2) * d * dff)
            cross = self.n_layers * 4 * q
            total += enc + cross
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE top-k only)."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        m = self.moe
        full = self.n_params()
        n_moe_layers = sum(self.is_moe_layer(i) for i in range(self.n_layers))
        all_expert = n_moe_layers * m.n_experts * 3 * d * m.d_ff_expert
        active_expert = n_moe_layers * m.top_k * 3 * d * m.d_ff_expert
        return int(full - all_expert + active_expert)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""
    name: str
    seq_len: int
    global_batch: int
    mode: str                       # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# Registry filled in by repro_torch.configs.__init__ ------------------------------
_REGISTRY = {}


def register(fn):
    """Decorator: register a zero-arg config factory under its cfg.name."""
    cfg = fn()
    _REGISTRY[cfg.name] = fn
    return fn


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs():
    return sorted(_REGISTRY)
