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

The gradient (``RingFlashAttentionFunction``; the reference gets its
own from ``jax.grad`` through ``ppermute``).  The ring's output is exact
attention over the whole sequence, ``O = sum_t exp(lse_t - L) o_t``, so
its gradient over the keys of shard t is the flash backward of that
shard taken with the global probabilities ``exp(s - L)`` and the global
``delta = rowsum(dO * O)``: ``flash_attention_bwd_kernel(q, k_t, v_t,
out=O, lse=L, dout=dO)``, under the forward's masks (causal on the
diagonal, full below it, later shards skipped).  The backward rotates
K/V around the ring again in the same order; dq is summed in f32 in ring
order, and each shard's dK/dV in f32 accumulators that travel with it
(the kernel's accumulate mode adds into them), one hop after every step,
so after the last step's hop each rank holds its own shard's; each
gradient is rounded once to its input's dtype.  Shard ``src``'s dK/dV
take their terms from ranks ``src, src + 1, ..., src + n - 1`` in that
order, wherever they run.

``ring_step`` / ``ring_step_bwd`` and ``ring_merge`` are the arithmetic of
one rank, so ``ring_attention_shards`` runs the same steps over n shards
in one process, forward and backward, bit for bit the n ranks' results;
``ring_attention_plain`` is the reference's own arithmetic in f32 (one
``(m, l, acc)`` online softmax per query shard over the kv shards in
ring order), the ring's plain version, which autograd differentiates.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import (NEG_INF,
                                                 flash_attention_bwd_kernel,
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


def ring_step_bwd(q, k_t, v_t, out, lse, dout, idx: int, src: int, acc,
                  *, causal=True):
    """Rank ``idx``'s backward over the kv shard of rank ``src``: the
    flash backward of that shard given the ring's merged output ``out``
    and log-sum-exp ``lse`` (so its probabilities and delta are the
    whole sequence's), its f32 gradients added into ``acc`` = (dq of
    rank ``idx``, dk and dv of shard ``src``).  Nothing for a later shard
    under ``causal``."""
    if causal and src > idx:
        return
    flash_attention_bwd_kernel(q, k_t, v_t, out, lse, dout,
                               causal=causal and src == idx, accumulate=acc)


def ring_merge(parts, dtype):
    """(out, L): ``sum_t exp(lse_t - L) o_t`` with ``L = logsumexp_t
    lse_t`` (f32, (B, S, H)), in f32 over the partials in order, cast once
    to ``dtype``.  One partial comes back as it went in."""
    lse = torch.stack([p[1] for p in parts])            # (T, B, S, H)
    m = lse.amax(0)
    big_l = m + torch.log(torch.exp(lse - m).sum(0))
    acc = None
    for o, l_t in parts:
        term = torch.exp(l_t - big_l)[..., None] * o.float()
        acc = term if acc is None else acc + term
    return acc.to(dtype), big_l


def _f32_zeros(t):
    return torch.zeros(t.shape, dtype=torch.float32, device=t.device)


def _ring_comm(group):
    """(n, idx, the next rank's and the previous rank's global ranks) of
    this rank of ``group`` (the default group when None)."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    idx = dist.get_rank(group)

    def peer(i):
        i %= n
        return i if group is None else dist.get_global_rank(group, i)

    return n, idx, peer(idx + 1), peer(idx - 1)


def _hop(tensors, nxt, prv, group):
    """Post one ``batch_isend_irecv``: each of ``tensors`` to the next
    rank, a tensor like it from the previous one.  Returns (the requests,
    the receive buffers)."""
    import torch.distributed as dist

    recv = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, r, prv, group) for r in recv]
    return dist.batch_isend_irecv(ops), recv


def _ring_forward(q, k, v, group, causal):
    """(out, L) of this rank: ``ring_flash_attention``'s steps and merge."""
    n, idx, nxt, prv = _ring_comm(group)
    k_t, v_t = k.contiguous(), v.contiguous()
    parts = []
    for t, src in enumerate(ring_order(idx, n)):
        reqs = []
        if t < n - 1:                  # NCCL cannot send to itself: n = 1
            reqs, (k_n, v_n) = _hop((k_t, v_t), nxt, prv, group)
        part = ring_step(q, k_t, v_t, idx, src, causal=causal)
        if part is not None:
            parts.append(part)
        for r in reqs:
            r.wait()
        if reqs:
            k_t, v_t = k_n, v_n
    return ring_merge(parts, q.dtype)


def _ring_backward(q, k, v, out, lse, dout, group, causal):
    """(dq, dk, dv) of this rank's shards: K/V rotate as in the forward
    (n - 1 hops), the f32 dK/dV accumulators of the shard held travel one
    hop after every step (n hops: the last brings each rank its own)."""
    n, idx, nxt, prv = _ring_comm(group)
    k_t, v_t = k.contiguous(), v.contiguous()
    dq, dk_t, dv_t = (_f32_zeros(t) for t in (q, k, v))
    for t, src in enumerate(ring_order(idx, n)):
        reqs = []
        if t < n - 1:
            reqs, (k_n, v_n) = _hop((k_t, v_t), nxt, prv, group)
        ring_step_bwd(q, k_t, v_t, out, lse, dout, idx, src,
                      (dq, dk_t, dv_t), causal=causal)
        for r in reqs:
            r.wait()
        if reqs:
            k_t, v_t = k_n, v_n
        if n > 1:                      # the accumulators follow their shard
            reqs, (dk_t, dv_t) = _hop((dk_t, dv_t), nxt, prv, group)
            for r in reqs:
                r.wait()
    return dq.to(q.dtype), dk_t.to(k.dtype), dv_t.to(v.dtype)


class RingFlashAttentionFunction(torch.autograd.Function):
    """``ring_flash_attention`` with its gradient: the forward saves the
    local q, k, v, the merged output (q's dtype) and L (f32); the
    backward runs the ring again (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        out, lse = _ring_forward(q, k, v, group, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal = group, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, out, lse, dout.contiguous(),
                                    ctx.group, ctx.causal)
        return dq, dk, dv, None, None


def ring_flash_attention(q, k, v, group=None, *, causal=True):
    """Local shards: q (B, S_loc, Hq, D); k/v (B, S_loc, Hkv, D[v]), the
    sequence chunk of this rank of ``group`` (the default group when
    None).  Returns the local output shard (B, S_loc, Hq, Dv), with its
    gradient through autograd (``RingFlashAttentionFunction``): every rank
    of the group runs the backward together."""
    return RingFlashAttentionFunction.apply(q, k, v, group, causal)


class _GatherSequence(torch.autograd.Function):
    """Every rank's output chunk, concatenated along the sequence (an
    all-gather over ``group``); the backward hands each rank the slice of
    its own output gradient that its chunk produced, unsummed."""

    @staticmethod
    def forward(ctx, out, group, n, idx):
        import torch.distributed as dist

        shards = [torch.empty_like(out) for _ in range(n)]
        dist.all_gather(shards, out.contiguous(), group=group)
        ctx.sl = slice(idx * out.shape[1], (idx + 1) * out.shape[1])
        return torch.cat(shards, dim=1)

    @staticmethod
    def backward(ctx, grad):
        return grad[:, ctx.sl], None, None, None


def ring_attention_sharded(q, k, v, mesh, axis_name: str = "data", *,
                           causal=True):
    """Global tensors (B, S, H, D) on every rank: each rank of the mesh's
    ``axis_name`` dimension takes its sequence chunk by its coordinate,
    runs the ring over that dimension's group, and the global output is
    gathered back (all-gather).

    Gradient: every rank holds the whole output, and a loss computed on it
    is one copy of the reference's global loss, so the all-gather's
    backward gives each rank the slice of its own output gradient that
    its chunk produced, and sums nothing over the ranks.  The gradient
    that reaches the global q, k, v on a rank is therefore its own
    chunk's (zeros elsewhere): the sum over the ranks is the reference's
    global gradient."""
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
    return _GatherSequence.apply(out, group, n, idx)


def _split(t, n):
    s = t.shape[1] // n
    return [t[:, i * s:(i + 1) * s].contiguous() for i in range(n)]


def _shards_forward(q, k, v, n, causal):
    """Every rank's (out, L) over ``n`` shards in one process."""
    qs, ks, vs = (_split(t, n) for t in (q, k, v))
    merged = []
    for idx in range(n):
        parts = [ring_step(qs[idx], ks[src], vs[src], idx, src,
                           causal=causal) for src in ring_order(idx, n)]
        merged.append(ring_merge([p for p in parts if p is not None],
                                 q.dtype))
    return merged


class _RingShardsFunction(torch.autograd.Function):
    """``ring_attention_shards`` with its gradient: the n ranks' backward
    steps in one process, step t of every rank before step t + 1, so each
    dq and each shard's dK/dV take their terms in the distributed ring's
    order (bit for bit its gradients)."""

    @staticmethod
    def forward(ctx, q, k, v, n, causal):
        merged = _shards_forward(q, k, v, n, causal)
        ctx.save_for_backward(q, k, v, *(o for o, _ in merged),
                              *(l for _, l in merged))
        ctx.n, ctx.causal = n, causal
        return torch.cat([o for o, _ in merged], dim=1)

    @staticmethod
    def backward(ctx, dout):
        n = ctx.n
        q, k, v, *saved = ctx.saved_tensors
        outs, lses = saved[:n], saved[n:]
        qs, ks, vs, dos = (_split(t, n) for t in (q, k, v, dout))
        dq, dk, dv = ([_f32_zeros(t) for t in ts] for ts in (qs, ks, vs))
        for t in range(n):
            for idx in range(n):
                src = (idx - t) % n
                ring_step_bwd(qs[idx], ks[src], vs[src], outs[idx],
                              lses[idx], dos[idx], idx, src,
                              (dq[idx], dk[src], dv[src]), causal=ctx.causal)
        return (torch.cat(dq, 1).to(q.dtype), torch.cat(dk, 1).to(k.dtype),
                torch.cat(dv, 1).to(v.dtype), None, None)


def ring_attention_shards(q, k, v, n: int, *, causal=True,
                          return_lse=False):
    """The ring over ``n`` sequence shards in one process: every rank's
    ``ring_step`` calls in ring order and its ``ring_merge``, the global
    (B, S, Hq, Dv) output concatenated (what ``ring_flash_attention``
    computes over n ranks, bit for bit), with its gradient through
    autograd: every rank's ``ring_step_bwd`` calls in the distributed
    ring's order (bit for bit the n ranks' gradients).  ``return_lse``:
    (out, L), the merged f32 log-sum-exp (B, S, Hq) beside the output,
    with no gradient."""
    S = q.shape[1]
    if S % n:
        raise ValueError(f"ring attention: sequence {S} does not split "
                         f"over {n} shards")
    if return_lse:
        merged = _shards_forward(q, k, v, n, causal)
        return (torch.cat([o for o, _ in merged], dim=1),
                torch.cat([l for _, l in merged], dim=1))
    return _RingShardsFunction.apply(q, k, v, n, causal)


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


def ring_bwd_tolerance(grad, dtype) -> float:
    """Elementwise bound on |the ring's gradient - one backward call over
    the whole sequence given the ring's output and L| (``grad``: the
    call's gradient).  Both sides add up the same f32 terms: the ring's
    probabilities ``exp(s - L)`` and ``delta = rowsum(dO * O)`` are the
    call's, and a (query, key) pair's products are formed alike.  They sum
    them in other orders (the call over its key tiles in one accumulator;
    the ring per shard, then over the shards in ring order: n additions
    apart, each within 2**-24 of its sum) and round the total once.  In
    bf16 each side's rounding is at most half a step of the element, so
    the two differ by at most one bf16 step of the largest |grad|,
    ``2**(floor(log2 max |grad|) - 7)``; in f32 by the summation order
    alone, held to the reference's 1e-5 of ``max(1, max |grad|)``.  A
    dropped step or a partial log-sum-exp in place of L changes a
    gradient by the size of a shard's share, many steps."""
    top = float(grad.float().abs().max())
    if dtype == torch.bfloat16:
        return 2.0 ** (math.floor(math.log2(top)) - 7) if top else 0.0
    return 1e-5 * max(1.0, top)
