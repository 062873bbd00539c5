"""InternVL2 76B — VLM: InternViT (stub) + Llama-3-70B-class decoder
[arXiv:2404.16821].  ``input_specs`` feeds projected patch embeddings."""
from repro_torch.configs.base import ModelConfig, register


@register
def internvl2_76b() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b",
        arch_type="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        vocab_size=128_256,
        frontend="vision_stub",
        n_frontend_tokens=256,      # one image tile -> 256 projected patches
        rope_theta=500_000.0,
        source="arXiv:2404.16821",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b-smoke",
        arch_type="vlm",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        frontend="vision_stub",
        n_frontend_tokens=8,
        dtype="float32",
        attn_impl="naive",
        remat=False,
        source="arXiv:2404.16821",
    )
