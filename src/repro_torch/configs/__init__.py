"""Architecture config registry (the port serves the paper's Llama-2-7B
testbed model)."""
from repro_torch.configs.base import ModelConfig, get_config, list_archs
from repro_torch.configs import llama2_7b

SMOKE_FACTORIES = {
    "llama2-7b": llama2_7b.smoke,
}

__all__ = ["ModelConfig", "get_config", "list_archs", "SMOKE_FACTORIES"]
