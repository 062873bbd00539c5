"""Public entry points of the paged-attention kernels.

Port of ``repro/kernels/ops.py``: the split-K dispatch.  Block tables at
least ``SPLIT_K_THRESHOLD_PAGES`` wide go to the flash-decoding split-K
kernel; below it the serial page chain is short enough that the combine
would dominate.  CPU tensors run each kernel's plain version, CUDA
tensors the kernel itself.
"""
from __future__ import annotations

from repro_torch.kernels.paged_attention import (
    paged_attention_kernel, paged_attention_splitk_kernel)

SPLIT_K_THRESHOLD_PAGES = 8
DEFAULT_PAGES_PER_SPLIT = 4


def paged_attention(q, k_pool, v_pool, block_tables, ctx_lens, row_map=None,
                    k_scale=None, v_scale=None):
    """Serial below SPLIT_K_THRESHOLD_PAGES, split-K at or above it."""
    if block_tables.shape[1] >= SPLIT_K_THRESHOLD_PAGES:
        return paged_attention_splitk_kernel(
            q, k_pool, v_pool, block_tables, ctx_lens,
            pages_per_split=DEFAULT_PAGES_PER_SPLIT, row_map=row_map,
            k_scale=k_scale, v_scale=v_scale)
    return paged_attention_kernel(q, k_pool, v_pool, block_tables, ctx_lens,
                                  row_map=row_map, k_scale=k_scale,
                                  v_scale=v_scale)
