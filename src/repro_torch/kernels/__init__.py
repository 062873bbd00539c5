"""Hand-written CUDA kernels for the serving hot spot (serial and split-K
paged decode attention, with optional int8 KV pages).  Each kernel has a
plain PyTorch version beside it (``paged_attention.py``), an oracle in
``ref.py`` and a dispatching entry point in ``ops.py``."""
from repro_torch.kernels.ops import paged_attention

__all__ = ["paged_attention"]
