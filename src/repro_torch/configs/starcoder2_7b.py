"""StarCoder2 7B — dense GQA(kv=4), RoPE [arXiv:2402.19173]."""
from repro_torch.configs.base import ModelConfig, register


@register
def starcoder2_7b() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        arch_type="dense",
        n_layers=32,
        d_model=4608,
        n_heads=36,
        n_kv_heads=4,
        d_ff=18432,
        vocab_size=49_152,
        rope_theta=1_000_000.0,
        act="gelu",
        source="arXiv:2402.19173",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b-smoke",
        arch_type="dense",
        n_layers=2,
        d_model=144,
        n_heads=6,
        n_kv_heads=2,
        d_ff=288,
        vocab_size=512,
        rope_theta=1_000_000.0,
        act="gelu",
        dtype="float32",
        attn_impl="naive",
        remat=False,
        source="arXiv:2402.19173",
    )
