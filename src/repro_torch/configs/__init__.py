"""Architecture config registry (the port serves the paper's Llama-2-7B
testbed model, the dense GQA stacks DeepSeek-7B, Granite-3-2B and
StarCoder2-7B, MiniCPM3-4B with multi-head latent attention, the
attention-free Mamba-2-2.7B, the MoE stacks DeepSeek-MoE-16B and
Mixtral-8x7B, the latter with sliding-window attention, and the hybrid
RecurrentGemma-2B: RG-LRU blocks beside local attention, the
encoder-decoder Whisper large-v3 over stubbed audio frames, and the
vision-language InternVL2-76B over stubbed patch embeddings)."""
from repro_torch.configs.base import (INPUT_SHAPES, ModelConfig, ShapeConfig,
                                      get_config, list_archs)
from repro_torch.configs import (deepseek_7b, deepseek_moe_16b, granite_3_2b,
                                 internvl2_76b, llama2_7b, mamba2_2_7b,
                                 minicpm3_4b, mixtral_8x7b, recurrentgemma_2b,
                                 starcoder2_7b, whisper_large_v3)

SMOKE_FACTORIES = {
    "deepseek-7b": deepseek_7b.smoke,
    "deepseek-moe-16b": deepseek_moe_16b.smoke,
    "granite-3-2b": granite_3_2b.smoke,
    "internvl2-76b": internvl2_76b.smoke,
    "llama2-7b": llama2_7b.smoke,
    "mamba2-2.7b": mamba2_2_7b.smoke,
    "minicpm3-4b": minicpm3_4b.smoke,
    "mixtral-8x7b": mixtral_8x7b.smoke,
    "recurrentgemma-2b": recurrentgemma_2b.smoke,
    "starcoder2-7b": starcoder2_7b.smoke,
    "whisper-large-v3": whisper_large_v3.smoke,
}

# the architectures the dry-run iterates (the registry also holds the
# paper's Llama-2-7B testbed model)
ASSIGNED_ARCHS = [
    "deepseek-7b", "deepseek-moe-16b", "whisper-large-v3",
    "recurrentgemma-2b", "mamba2-2.7b", "granite-3-2b", "starcoder2-7b",
    "minicpm3-4b", "mixtral-8x7b", "internvl2-76b",
]

__all__ = ["INPUT_SHAPES", "ModelConfig", "ShapeConfig", "get_config",
           "list_archs", "SMOKE_FACTORIES", "ASSIGNED_ARCHS"]
