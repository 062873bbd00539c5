"""Hand-written CUDA kernels for the serving hot spots: serial and split-K
paged decode attention (with optional int8 KV pages), blockwise prefill
flash attention and the Mamba-2 chunked SSD scan.  Each kernel has a
plain PyTorch version beside it (``paged_attention.py``,
``flash_attention.py``, ``ssd_scan.py``), an oracle in ``ref.py`` and an
entry point in ``ops.py``."""
from repro_torch.kernels.ops import (flash_attention, paged_attention,
                                     paged_attention_splitk, ssd_scan)

__all__ = ["flash_attention", "paged_attention", "paged_attention_splitk",
           "ssd_scan"]
