"""Mamba-2 2.7B — SSD (state-space duality), attention-free
[arXiv:2405.21060]."""
from repro_torch.configs.base import MAMBA2, ModelConfig, SSMConfig, register


@register
def mamba2_2_7b() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        arch_type="ssm",
        n_layers=64,
        d_model=2560,
        n_heads=0,                  # attention free
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50_280,
        attn_kind=MAMBA2,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                      n_groups=1, chunk_size=128),
        source="arXiv:2405.21060",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b-smoke",
        arch_type="ssm",
        n_layers=2,
        d_model=128,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=512,
        attn_kind=MAMBA2,
        ssm=SSMConfig(d_state=16, head_dim=32, expand=2, conv_width=4,
                      n_groups=1, chunk_size=16),
        dtype="float32",
        remat=False,
        source="arXiv:2405.21060",
    )
