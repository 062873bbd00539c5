"""Mixtral 8x7B — MoE 8 experts top-2, sliding-window attention
[arXiv:2401.04088]."""
from repro_torch.configs.base import ATTN_LOCAL, ModelConfig, MoEConfig, register


@register
def mixtral_8x7b() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        arch_type="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=32_000,
        attn_kind=ATTN_LOCAL,
        window=4096,                # Mixtral SWA -> native long_500k
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336),
        rope_theta=1_000_000.0,
        source="arXiv:2401.04088",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b-smoke",
        arch_type="moe",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        attn_kind=ATTN_LOCAL,
        window=32,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64),
        dtype="float32",
        attn_impl="naive",
        moe_impl="dense",
        remat=False,
        source="arXiv:2401.04088",
    )
