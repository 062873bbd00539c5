"""Whisper large-v3 — encoder-decoder, conv/mel frontend stubbed
[arXiv:2212.04356].  ``input_specs`` feeds precomputed frame embeddings."""
from repro_torch.configs.base import ModelConfig, register


@register
def whisper_large_v3() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        arch_type="audio",
        n_layers=32,                # decoder layers
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        vocab_size=51_866,
        is_encoder_decoder=True,
        n_encoder_layers=32,
        frontend="audio_stub",
        n_frontend_tokens=1500,     # 30 s of audio at 50 fps
        act="gelu",
        source="arXiv:2212.04356",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3-smoke",
        arch_type="audio",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        is_encoder_decoder=True,
        n_encoder_layers=2,
        frontend="audio_stub",
        n_frontend_tokens=16,
        act="gelu",
        dtype="float32",
        attn_impl="naive",
        remat=False,
        source="arXiv:2212.04356",
    )
