"""RecurrentGemma 2B — Griffin: RG-LRU + local attention, 1 attn : 2 rec
[arXiv:2402.19427]."""
from repro_torch.configs.base import (ATTN_LOCAL, RGLRU, ModelConfig,
                                      RGLRUConfig, register)


@register
def recurrentgemma_2b() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        arch_type="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,               # MQA in the local-attention layers
        head_dim=256,
        d_ff=7680,
        vocab_size=256_000,
        window=2048,                # Griffin local-attention window
        layer_pattern=(RGLRU, RGLRU, ATTN_LOCAL),
        rglru=RGLRUConfig(d_rnn=2560, conv_width=4),
        train_batch_over_model=False,   # channel-parallel recurrence (§Perf B3)
        source="arXiv:2402.19427",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-smoke",
        arch_type="hybrid",
        n_layers=3,                 # one full (rec, rec, attn) unit
        d_model=128,
        n_heads=4,
        n_kv_heads=1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        window=32,
        layer_pattern=(RGLRU, RGLRU, ATTN_LOCAL),
        rglru=RGLRUConfig(d_rnn=128, conv_width=4),
        dtype="float32",
        attn_impl="naive",
        remat=False,
        source="arXiv:2402.19427",
    )
