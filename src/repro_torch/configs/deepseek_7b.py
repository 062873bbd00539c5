"""DeepSeek-LLM 7B — dense llama-arch [arXiv:2401.02954]."""
from repro_torch.configs.base import ModelConfig, register


@register
def deepseek_7b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b",
        arch_type="dense",
        n_layers=30,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_ff=11008,
        vocab_size=102_400,
        source="arXiv:2401.02954",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b-smoke",
        arch_type="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        dtype="float32",
        attn_impl="naive",
        remat=False,
        source="arXiv:2401.02954",
    )
