"""Ring flash attention: sequence-parallel exact attention.

Port of ``repro/models/ring_attention.py``.  With the sequence sharded
over a group of n ranks, each rank keeps its Q shard and the K/V shards
rotate one rank along the ring (``dist.batch_isend_irecv``), n - 1
times; rank ``idx`` at step t holds the shard of rank ``(idx - t) % n``.
Each step is one call of the hand-written flash kernel
(``kernels.flash_attention.flash_attention_kernel(..., return_lse=True)``;
its plain version on CPU tensors): causal on the diagonal (rank i owns
sequence chunk i, so equal offsets make the kernel's top-left alignment
the reference's ``kv_pos <= q_pos``), full over earlier shards, and,
under ``causal``, skipped for later shards, to which the reference gives
zero mass.  The partials are merged by their f32 log-sum-exp: ``L =
logsumexp_t lse_t``, ``out = sum_t exp(lse_t - L) o_t`` in f32, cast once
(the reference's ``(m, l, acc)`` merge, done once at the end).

Where the reference keeps one f32 accumulator, the kernel writes each
step's ``o_t`` normalised and rounded to q's dtype: in bf16 the merge
adds one rounding of a convex combination of v rows (at most half a bf16
step of max |v|: 2**-8 max |v|) to the output's own.  ``chip_smoke.py``
holds the bf16 ring to ``ring_tolerance``; f32 is held to the
reference's 1e-5.

``ring_step`` and ``ring_merge`` are the arithmetic of one rank, so
``ring_attention_shards`` runs the same steps over n shards in one
process; ``ring_attention_plain`` is the reference's own arithmetic in
f32 (one ``(m, l, acc)`` online softmax per query shard over the kv
shards in ring order), the ring's plain version.  Forward only: nothing
in the reference trains through the ring (its gradient: ROADMAP.md
item 12c).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (NEG_INF,
                                                 flash_attention_kernel)


def ring_order(idx: int, n: int):
    """The ranks whose kv shards rank ``idx`` of ``n`` sees, step by
    step."""
    return [(idx - t) % n for t in range(n)]


def ring_step(q, k_t, v_t, idx: int, src: int, *, causal=True):
    """Rank ``idx``'s partial over the kv shard of rank ``src``: (o, lse)
    from one flash call (causal on the diagonal, full below it), or None
    for a later shard under ``causal``."""
    if causal and src > idx:
        return None
    return flash_attention_kernel(q, k_t, v_t, causal=causal and src == idx,
                                  return_lse=True)


def ring_merge(parts, dtype):
    """``sum_t exp(lse_t - L) o_t`` with ``L = logsumexp_t lse_t``, in f32
    over the partials in order, cast once to ``dtype``.  One partial
    comes back as it went in."""
    lse = torch.stack([p[1] for p in parts])            # (T, B, S, H)
    m = lse.amax(0)
    big_l = m + torch.log(torch.exp(lse - m).sum(0))
    acc = None
    for o, l_t in parts:
        term = torch.exp(l_t - big_l)[..., None] * o.float()
        acc = term if acc is None else acc + term
    return acc.to(dtype)


def ring_flash_attention(q, k, v, group=None, *, causal=True):
    """Local shards: q (B, S_loc, Hq, D); k/v (B, S_loc, Hkv, D[v]), the
    sequence chunk of this rank of ``group`` (the default group when
    None).  Returns the local output shard (B, S_loc, Hq, Dv)."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    idx = dist.get_rank(group)

    def peer(i):
        i %= n
        return i if group is None else dist.get_global_rank(group, i)

    nxt, prv = peer(idx + 1), peer(idx - 1)
    k_t, v_t = k.contiguous(), v.contiguous()
    parts = []
    for t, src in enumerate(ring_order(idx, n)):
        reqs = []
        if t < n - 1:                  # NCCL cannot send to itself: n = 1
            k_n, v_n = torch.empty_like(k_t), torch.empty_like(v_t)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, k_t, nxt, group),
                dist.P2POp(dist.isend, v_t, nxt, group),
                dist.P2POp(dist.irecv, k_n, prv, group),
                dist.P2POp(dist.irecv, v_n, prv, group)])
        part = ring_step(q, k_t, v_t, idx, src, causal=causal)
        if part is not None:
            parts.append(part)
        for r in reqs:
            r.wait()
        if reqs:
            k_t, v_t = k_n, v_n
    return ring_merge(parts, q.dtype)


def ring_attention_sharded(q, k, v, mesh, axis_name: str = "data", *,
                           causal=True):
    """Global tensors (B, S, H, D) on every rank: each rank of the mesh's
    ``axis_name`` dimension takes its sequence chunk by its coordinate,
    runs the ring over that dimension's group, and the global output is
    gathered back (all-gather)."""
    import torch.distributed as dist

    group = mesh.get_group(axis_name)
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    idx = mesh.get_local_rank(axis_name)
    S = q.shape[1]
    if S % n:
        raise ValueError(f"ring attention: sequence {S} does not split "
                         f"over {n} ranks of {axis_name!r}")
    sl = slice(idx * S // n, (idx + 1) * S // n)
    out = ring_flash_attention(q[:, sl].contiguous(), k[:, sl].contiguous(),
                               v[:, sl].contiguous(), group, causal=causal)
    shards = [torch.empty_like(out) for _ in range(n)]
    dist.all_gather(shards, out, group=group)
    return torch.cat(shards, dim=1)


def ring_attention_shards(q, k, v, n: int, *, causal=True):
    """The ring over ``n`` sequence shards in one process: every rank's
    ``ring_step`` calls in ring order and its ``ring_merge``, the global
    (B, S, Hq, Dv) output concatenated (what ``ring_flash_attention``
    computes over n ranks, bit for bit)."""
    S = q.shape[1]
    if S % n:
        raise ValueError(f"ring attention: sequence {S} does not split "
                         f"over {n} shards")
    s = S // n
    qs, ks, vs = ([t[:, i * s:(i + 1) * s].contiguous() for i in range(n)]
                  for t in (q, k, v))
    outs = []
    for idx in range(n):
        parts = [ring_step(qs[idx], ks[src], vs[src], idx, src,
                           causal=causal) for src in ring_order(idx, n)]
        outs.append(ring_merge([p for p in parts if p is not None], q.dtype))
    return torch.cat(outs, dim=1)


def ring_attention_plain(q, k, v, n: int, *, causal=True):
    """The reference's ring arithmetic in f32 over ``n`` shards in one
    process: per query shard an ``(m, l, acc)`` online softmax over the
    kv shards in ring order, scores masked to NEG_INF by global position
    (later shards add zero mass), ``acc / max(l, 1e-30)``.  Returns f32
    (B, S, Hq, Dv)."""
    B, S, Hq, D = q.shape
    Hkv, Dv = k.shape[2], v.shape[-1]
    G = Hq // Hkv
    s = S // n
    scale = D ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    pos = torch.arange(S, device=q.device)
    outs = []
    for idx in range(n):
        qg = qf[:, idx * s:(idx + 1) * s].reshape(B, s, Hkv, G, D)
        q_pos = pos[idx * s:(idx + 1) * s]
        acc = torch.zeros((B, s, Hkv, G, Dv), device=q.device)
        m = torch.full((B, s, Hkv, G), NEG_INF, device=q.device)
        l = torch.zeros((B, s, Hkv, G), device=q.device)
        for src in ring_order(idx, n):
            kv = slice(src * s, (src + 1) * s)
            sc = torch.einsum("bskgd,btkd->bskgt", qg, kf[:, kv]) * scale
            if causal:
                mask = pos[kv][None, :] <= q_pos[:, None]
                sc = torch.where(mask[None, :, None, None, :], sc,
                                 torch.full_like(sc, NEG_INF))
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bskgt,btkd->bskgd", p, vf[:, kv])
            m = m_new
        outs.append((acc / l.clamp_min(1e-30)[..., None]).reshape(
            B, s, Hq, Dv))
    return torch.cat(outs, dim=1)


def ring_tolerance(v, dtype) -> float:
    """Elementwise bound on |ring - one flash call over the whole
    sequence| (and on |ring - ring_attention_plain|): in bf16 three half
    steps of max |v|, 3 * 2**-8 max |v| (each step's partial rounded
    once, the ring's output rounded once, the single call's output
    rounded once; a partial and an output are convex combinations of v
    rows, and the merge's weights sum to 1); in f32 the reference's
    1e-5."""
    if dtype == torch.bfloat16:
        return 3 * 2.0 ** -8 * float(v.float().abs().max())
    return 1e-5
