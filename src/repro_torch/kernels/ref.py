"""Plain oracles for the port's kernels (port of ``repro/kernels/ref.py``).

``paged_attention_ref`` averages V on rows with ``ctx_lens == 0`` (softmax
over an all-masked row), where the kernels return zeros: hold the kernels
to each other and to the reference kernel, not to this oracle, on such
rows."""
from __future__ import annotations

import torch

from repro_torch.models.attention import naive_attention
from repro_torch.models.ssm import ssd_chunked


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    return naive_attention(q, k, v, causal=causal, window=window)


def paged_attention_ref(q, k_pool, v_pool, block_tables, ctx_lens):
    """Gather pages into contiguous caches, then run masked attention."""
    B, Hq, D = q.shape
    _, page, Hkv, _ = k_pool.shape
    n_pages = block_tables.shape[1]
    # (B, n_pages, page, Hkv, D) -> (B, S, Hkv, D)
    kc = k_pool[block_tables.long()].reshape(B, n_pages * page, Hkv, -1)
    vc = v_pool[block_tables.long()].reshape(B, n_pages * page, Hkv, -1)
    out = []
    for b in range(B):                            # oracle: clarity over speed
        valid = torch.arange(n_pages * page, device=q.device) < ctx_lens[b]
        G = Hq // Hkv
        qg = q[b].reshape(Hkv, G, D)
        s = torch.einsum("kgd,tkd->kgt", qg.float(), kc[b].float()) * D ** -0.5
        s = torch.where(valid[None, None], s, torch.full_like(s, -1e30))
        w = torch.exp(s - s.amax(-1, keepdim=True))
        w = w / w.sum(-1, keepdim=True)
        o = torch.einsum("kgt,tkd->kgd", w, vc[b].float())
        out.append(o.reshape(Hq, -1))
    return torch.stack(out).to(q.dtype)


def ssd_scan_ref(x, la, Bm, Cm, *, chunk=128):
    """Oracle = the model-layer chunked SSD."""
    return ssd_chunked(x, la, Bm, Cm, chunk)
