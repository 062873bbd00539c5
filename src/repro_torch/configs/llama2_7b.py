"""Llama-2 7B — the paper's own synthetic-workload serving model
(Equinox §7.1 runs Llama-2-7b on one A100-80GB)."""
from repro_torch.configs.base import ModelConfig, register


@register
def llama2_7b() -> ModelConfig:
    return ModelConfig(
        name="llama2-7b",
        arch_type="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_ff=11008,
        vocab_size=32_000,
        source="arXiv:2307.09288 (paper testbed model)",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama2-7b-smoke",
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
        source="arXiv:2307.09288",
    )
