"""Architecture config registry (the port serves the paper's Llama-2-7B
testbed model, the attention-free Mamba-2-2.7B and the MoE stacks
DeepSeek-MoE-16B and Mixtral-8x7B, the latter with sliding-window
attention)."""
from repro_torch.configs.base import ModelConfig, get_config, list_archs
from repro_torch.configs import (deepseek_moe_16b, llama2_7b, mamba2_2_7b,
                                 mixtral_8x7b)

SMOKE_FACTORIES = {
    "deepseek-moe-16b": deepseek_moe_16b.smoke,
    "llama2-7b": llama2_7b.smoke,
    "mamba2-2.7b": mamba2_2_7b.smoke,
    "mixtral-8x7b": mixtral_8x7b.smoke,
}

__all__ = ["ModelConfig", "get_config", "list_archs", "SMOKE_FACTORIES"]
