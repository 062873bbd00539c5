"""Granite 3.0 2B base — dense GQA [hf:ibm-granite/granite-3.0-2b-base]."""
from repro_torch.configs.base import ModelConfig, register


@register
def granite_3_2b() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b",
        arch_type="dense",
        n_layers=40,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=49_155,
        tie_embeddings=True,
        source="hf:ibm-granite/granite-3.0-2b-base",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b-smoke",
        arch_type="dense",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        tie_embeddings=True,
        dtype="float32",
        attn_impl="naive",
        remat=False,
        source="hf:ibm-granite/granite-3.0-2b-base",
    )
