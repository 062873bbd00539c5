"""Mixture-of-Experts FFN: classic (Mixtral) and fine-grained (DeepSeek-MoE).

Port of ``repro/models/moe.py``.  Expert weights are stacked on a leading
E axis: ``router (d, E)``, ``w_gate``/``w_in (E, d, f)``, ``w_out (E, f,
d)``, plus a SwiGLU ``shared`` MLP when the config has shared experts.
Two implementations of the routed experts, as in the reference:

- ``dense``: every expert runs on every token, masked by the gate; exact,
  O(E) compute (the smoke configs and the oracle of dispatch);
- ``dispatch``: sort-based capacity dispatch.  Assignments are grouped by
  expert with a stable sort, the first ``capacity`` of each expert are
  gathered into an (E, C, d) buffer, the per-expert products run batched
  (``torch.bmm``) and the gate-weighted results are summed back per
  token in a fixed order, without atomics; assignments past capacity are
  dropped.  ``capacity`` follows from the number of
  rows ``n`` that reach the layer, padding and idle rows included, so it
  needs no host sync.

Routing follows the reference to the bit where it can: router logits in
the activation dtype, widened to f32 after the product; the top k from a
stable descending sort, so among equal probabilities the lower expert
index wins, as in ``jax.lax.top_k``.

Every function returns ``(out, aux)``.  ``aux``, the switch-style
load-balance loss, is computed only for a caller that passes
``want_aux=True`` (training); the serving paths never read it, and it is
``None`` otherwise.

``rows`` says which block of the batch's rows this process holds: a
``sharding.RowSplit`` in training over several data ranks, else
``sharding.WHOLE_BATCH`` (block 0 of 1), and each computes what one
process computes over the whole batch.  The batch's token stream is the
blocks in order; each block's routed tokens are counted per expert (and
per chunk of ``DISPATCH_CHUNK_TOKENS`` tokens of the stream), and one
gather of those counts gives the capacity's token count, each token's
place in its expert's queue (the counts of the blocks before it added)
and the load-balance loss's expert fractions.  A rank's ``aux`` is its
own tokens' share, scaled so that the mean over the ranks is the loss
over the whole batch.

Serving over a model axis (``tp``, a ``sharding.ServePlan``): when E
divides the axis each rank holds E / m experts (expert parallelism),
else every expert's block of the hidden dim; the router is whole.  Every
rank routes every token of its rows and applies the same capacity rule;
it gathers and runs only its experts' buffers (``held``), sums their
gate-weighted share with the shared experts' partial product in f32,
and one all-reduce over the model axis and one rounding give the
layer's output.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, mlp
from repro_torch.models.sharding import WHOLE_BATCH

DISPATCH_CHUNK_TOKENS = 65_536


def moe_init(cfg, dtype, generator: torch.Generator, device):
    """The reference's distributions: fan-in truncated-normal weights,
    fan-in ``d`` for ``router``, ``w_gate`` and ``w_in``, ``f`` for
    ``w_out`` (``shape[-2]`` of each)."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.n_experts
    p = {"router": dense_init((d, E), dtype, generator, device),
         "w_gate": dense_init((E, d, f), dtype, generator, device),
         "w_in": dense_init((E, d, f), dtype, generator, device),
         "w_out": dense_init((E, f, d), dtype, generator, device)}
    if m.n_shared_experts:
        fs = m.d_ff_shared
        p["shared"] = {"w_in": dense_init((d, fs), dtype, generator, device),
                       "w_out": dense_init((fs, d), dtype, generator,
                                           device),
                       "w_gate": dense_init((d, fs), dtype, generator,
                                            device)}
    return p


def _route(params, x, m):
    """Returns (weights (..., top_k) in x's dtype, experts (..., top_k),
    probs (..., E) f32)."""
    logits = (x @ params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, experts = top[..., :m.top_k], experts[..., :m.top_k]
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return weights.to(x.dtype), experts, probs


def routed_counts(experts, n_experts):
    """(E,) int64: the routed assignments ``experts`` (..., top_k) to each
    expert (a scatter-add of ones: no host sync)."""
    flat = experts.reshape(-1)
    return torch.zeros(n_experts, dtype=torch.int64,
                       device=flat.device).scatter_add_(
                           0, flat, torch.ones_like(flat))


def load_balance_loss(probs, counts, n_tokens, n_experts):
    """Switch-transformer aux loss, E * sum_e f_e * P_e, over a batch of
    ``n_tokens`` tokens: f_e the shares of ``counts`` (E,), the batch's
    routed assignments to each expert, and P_e the router probabilities
    ``probs`` (..., E) summed over the tokens here and divided by
    ``n_tokens``.  Where ``probs`` are one rank's tokens of the batch,
    this is that rank's share of the batch's loss: the shares add up to
    it."""
    frac = counts.float()
    frac = frac / frac.sum().clamp_min(1e-9)
    imp = probs.reshape(-1, n_experts).sum(0) / n_tokens
    return n_experts * (frac * imp).sum()


def _expert_ffn(w_gate, w_in, w_out, x):
    """x: (E, C, d) batched per-expert SwiGLU."""
    h = F.silu(torch.bmm(x, w_gate)) * torch.bmm(x, w_in)
    return torch.bmm(h, w_out)


def moe_dense(params, x, m, *, want_aux=False, rows=WHOLE_BATCH, held=None):
    """O(E) masked dense evaluation (oracle / smoke path).  ``rows``: the
    batch's row split (module docstring).  ``held`` (first, count): the
    experts whose weights this rank holds (module docstring): their
    gate-weighted sum, in f32."""
    weights, experts, probs = _route(params, x, m)
    xf = x.reshape(-1, x.shape[-1])                       # (n, d)
    n = xf.shape[0]
    gate_full = torch.zeros((n, m.n_experts), dtype=x.dtype,
                            device=x.device)
    gate_full.scatter_add_(1, experts.reshape(n, m.top_k),
                           weights.reshape(n, m.top_k))
    first, count = (0, m.n_experts) if held is None else held
    out = torch.zeros_like(xf, dtype=x.dtype if held is None
                           else torch.float32)
    for e in range(count):
        y = _expert_ffn(params["w_gate"][e:e + 1], params["w_in"][e:e + 1],
                        params["w_out"][e:e + 1], xf[None])[0]
        out = out + (gate_full[:, first + e:first + e + 1] * y).to(out.dtype)
    if held is not None:
        return out.reshape(x.shape), None
    if not want_aux:
        return out.reshape(x.shape), None
    total = rows.gather(routed_counts(experts, m.n_experts)[None]).sum(0)[0]
    aux = load_balance_loss(probs, total, n * rows.count, m.n_experts)
    return out.reshape(x.shape), aux * rows.count


def _capacity(n, m):
    return min(max(int(n * m.top_k / m.n_experts * m.capacity_factor), 1),
               n)


def moe_dispatch(params, x, m, *, want_aux=False):
    """Sort-based capacity dispatch over all of ``x``'s tokens as one
    chunk (the reference's ``moe_dispatch``)."""
    return moe_dispatch_chunked(params, x, m, chunk=max(x[..., 0].numel(),
                                                         1),
                                want_aux=want_aux)


def _dispatch(params, xf, weights, experts, m, capacity, before,
              held=None):
    """The routed experts over the tokens ``xf`` (n, d): each expert's
    first ``capacity`` assignments in token order run, the rest drop.
    ``before`` (E,): assignments to each expert that precede these tokens
    in the same chunk (on the ranks before this one), which take the
    first places of its queue.  ``held`` (first, count): only those
    experts' buffers are gathered and run (this rank's weights), and their
    gate-weighted share of each token is returned in f32."""
    d = xf.shape[-1]
    n, k, E = xf.shape[0], m.top_k, m.n_experts
    dev = xf.device

    flat_e = experts.reshape(-1)                          # (n*k,)
    flat_w = weights.reshape(-1)
    flat_tok = torch.arange(n, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)            # group by expert
    se, sw, st = flat_e[order], flat_w[order], flat_tok[order]
    # position of each assignment within its expert group
    pos_in_e = torch.arange(n * k, device=dev) - torch.searchsorted(se, se)
    pos_in_e = pos_in_e + before[se]
    keep = pos_in_e < capacity
    first, count = (0, E) if held is None else held
    if held is not None:
        keep = keep & (se >= first) & (se < first + count)
    # past capacity (or another rank's): the overflow row, which is dropped
    slot = torch.where(keep, (se - first) * capacity + pos_in_e,
                       count * capacity)
    buf_tok = torch.full((count * capacity + 1,), n, dtype=torch.long,
                         device=dev)
    buf_tok[slot] = st
    xf_pad = torch.cat([xf, xf.new_zeros((1, d))])        # row n: zeros
    gathered = xf_pad[buf_tok[:-1]].reshape(count, capacity, d)
    y = _expert_ffn(params["w_gate"], params["w_in"], params["w_out"],
                    gathered).reshape(count * capacity, d)
    # combine, weighted by the gate: each token's k contributions summed
    # in increasing expert order in x's dtype (f32 for ``held``), the
    # order of the reference's scatter-add over the expert-sorted
    # assignments, with no atomics (dropped ones add exact zeros)
    y, gate = y[torch.where(keep, slot, 0)], (sw * keep)[:, None]
    contrib = (y * gate).to(xf.dtype) if held is None \
        else y.float() * gate.float()
    by_token = contrib[torch.argsort(st * E + se)].reshape(n, k, d)
    out = by_token[:, 0]
    for j in range(1, k):
        out = out + by_token[:, j]
    return out


def chunk_layout(n, chunk=None):
    """(C, nc): the dispatch over ``n`` tokens runs ``nc`` chunks of ``C``
    tokens, one chunk of all ``n`` where ``n <= chunk`` (default
    ``DISPATCH_CHUNK_TOKENS``), else chunks of ``chunk``, zero rows
    padding the last."""
    chunk = DISPATCH_CHUNK_TOKENS if chunk is None else chunk
    C = n if n <= chunk else chunk
    return C, -(-n // C)


def moe_dispatch_chunked(params, x, m, chunk=None, *, want_aux=False,
                         rows=WHOLE_BATCH, held=None):
    """The dispatch over token chunks of ``chunk`` rows (default
    ``DISPATCH_CHUNK_TOKENS``; zero rows pad the last), capacity enforced
    per chunk, as the reference's scan does; the aux loss is the mean over
    chunks.  The token stream is the batch's: ``rows``' blocks in order
    (module docstring), cut into chunks at its offsets, so a chunk may
    span ranks; the zero rows pad its end on the last block's rank.  This
    rank routes and dispatches its piece of each chunk it meets; one
    gather of every block's counts per (chunk, expert) gives each
    expert's queue ahead of a piece and the aux loss's fractions.
    ``held``: as ``_dispatch`` (the result in f32)."""
    d, E = x.shape[-1], m.n_experts
    xf = x.reshape(-1, d)
    n = xf.shape[0]
    C, nc = chunk_layout(n * rows.count, chunk)
    start = rows.index * n
    pad = nc * C - n * rows.count
    if pad and rows.index == rows.count - 1:
        xf = F.pad(xf, (0, 0, 0, pad))
    pieces, lo = [], 0
    while lo < xf.shape[0]:
        c = (start + lo) // C
        hi = min(xf.shape[0], (c + 1) * C - start)
        pieces.append((c, lo, hi))
        lo = hi
    routed = [_route(params, xf[lo:hi], m) for _, lo, hi in pieces]
    counts = torch.zeros((nc, E), dtype=torch.int64, device=x.device)
    for (c, _, _), (_, experts, _) in zip(pieces, routed):
        counts[c] += routed_counts(experts, E)
    every = rows.gather(counts)                      # (blocks, nc, E)
    before = every[:rows.index].sum(0)
    capacity = _capacity(C, m)
    ys = [_dispatch(params, xf[lo:hi], w, e, m, capacity, before[c], held)
          for (c, lo, hi), (w, e, _) in zip(pieces, routed)]
    y = torch.cat(ys)[:n].reshape(x.shape)
    if not want_aux:
        return y, None
    total = every.sum(0)
    aux = sum(load_balance_loss(p, total[c], C, E)
              for (c, _, _), (_, _, p) in zip(pieces, routed))
    return y, aux * (rows.count / nc)


def moe_ffn(params, x, cfg, *, want_aux=False, rows=WHOLE_BATCH, tp=None):
    """Full MoE FFN incl. DeepSeek-style shared experts.  Returns (y, aux).
    ``rows``: the batch's row split (module docstring).  ``tp``: a serving
    plan that splits the layer over its model axis (module docstring)."""
    m = cfg.moe
    if tp is not None:
        held = tp.experts_held(m.n_experts)
        if cfg.moe_impl == "dense":
            y, _ = moe_dense(params, x, m, held=held)
        else:
            y, _ = moe_dispatch_chunked(params, x, m, rows=rows, held=held)
        if m.n_shared_experts:
            y = y + mlp(params["shared"], x, "silu").float()
        return tp.reduce(y).to(x.dtype), None
    if cfg.moe_impl == "dense":
        y, aux = moe_dense(params, x, m, want_aux=want_aux, rows=rows)
    else:
        y, aux = moe_dispatch_chunked(params, x, m, want_aux=want_aux,
                                      rows=rows)
    if m.n_shared_experts:
        y = y + mlp(params["shared"], x, "silu")
    return y, aux
