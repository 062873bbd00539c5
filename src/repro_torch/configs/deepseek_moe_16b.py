"""DeepSeek-MoE 16B — fine-grained MoE, 2 shared + 64 routed top-6
[arXiv:2401.06066]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register
def deepseek_moe_16b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        arch_type="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=10944,                 # the single dense (first) layer's FFN
        vocab_size=102_400,
        moe=MoEConfig(
            n_experts=64,
            top_k=6,
            n_shared_experts=2,
            d_ff_expert=1408,
            d_ff_shared=2 * 1408,
            first_k_dense=1,
        ),
        source="arXiv:2401.06066",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b-smoke",
        arch_type="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        moe=MoEConfig(
            n_experts=4,
            top_k=2,
            n_shared_experts=1,
            d_ff_expert=64,
            d_ff_shared=64,
            first_k_dense=1,
        ),
        dtype="float32",
        attn_impl="naive",
        moe_impl="dense",
        remat=False,
        source="arXiv:2401.06066",
    )
