"""MiniCPM3 4B — multi-head latent attention (MLA)
[hf:openbmb/MiniCPM3-4B]."""
from repro_torch.configs.base import (ATTN_MLA, MLAConfig, ModelConfig,
                                      register)


@register
def minicpm3_4b() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        arch_type="dense",
        n_layers=62,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        d_ff=6400,
        vocab_size=73_448,
        attn_kind=ATTN_MLA,
        mla=MLAConfig(
            q_lora_rank=768,
            kv_lora_rank=256,
            qk_nope_head_dim=64,
            qk_rope_head_dim=32,
            v_head_dim=64,
        ),
        source="hf:openbmb/MiniCPM3-4B",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b-smoke",
        arch_type="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        attn_kind=ATTN_MLA,
        mla=MLAConfig(
            q_lora_rank=48,
            kv_lora_rank=32,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
        ),
        dtype="float32",
        attn_impl="naive",
        remat=False,
        source="hf:openbmb/MiniCPM3-4B",
    )
