"""Public entry points of the port's kernels.

Port of ``repro/kernels/ops.py``: flash attention, the split-K dispatch
of paged attention, split-K paged attention whatever the table width,
and the SSD scan.  Block tables at least ``SPLIT_K_THRESHOLD_PAGES`` wide
go to the flash-decoding split-K kernel; below it the serial page chain
is short enough that the combine would dominate.  CPU tensors run each
kernel's plain version, CUDA tensors the kernel itself.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.paged_attention import (
    paged_attention_kernel, paged_attention_splitk_kernel)
from repro_torch.kernels.ssd_scan import ssd_scan_kernel

SPLIT_K_THRESHOLD_PAGES = 8
DEFAULT_PAGES_PER_SPLIT = 4


def flash_attention(q, k, v, *, causal=True, window=0, block_q=128,
                    block_kv=128):
    return flash_attention_kernel(q, k, v, causal=causal, window=window,
                                  block_q=block_q, block_kv=block_kv)


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


def paged_attention_splitk(q, k_pool, v_pool, block_tables, ctx_lens,
                           row_map=None, k_scale=None, v_scale=None, *,
                           pages_per_split=DEFAULT_PAGES_PER_SPLIT):
    """Always split-K, regardless of table width."""
    return paged_attention_splitk_kernel(
        q, k_pool, v_pool, block_tables, ctx_lens,
        pages_per_split=pages_per_split, row_map=row_map, k_scale=k_scale,
        v_scale=v_scale)


def ssd_scan(x, la, Bm, Cm, *, chunk=128):
    """(y, final_state); the Pallas kernel's chunk rule: min(chunk, S)."""
    return ssd_scan_kernel(x, la, Bm, Cm, chunk=min(chunk, x.shape[1]))
