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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, mlp

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


def load_balance_loss(probs, experts, n_experts):
    """Switch-transformer aux loss: E * sum_e f_e * P_e."""
    onehot = F.one_hot(experts, n_experts).float()
    frac = onehot.sum(-2).reshape(-1, n_experts).mean(0)
    frac = frac / frac.sum().clamp_min(1e-9)
    imp = probs.reshape(-1, n_experts).mean(0)
    return n_experts * (frac * imp).sum()


def _expert_ffn(w_gate, w_in, w_out, x):
    """x: (E, C, d) batched per-expert SwiGLU."""
    h = F.silu(torch.bmm(x, w_gate)) * torch.bmm(x, w_in)
    return torch.bmm(h, w_out)


def _aux(probs, experts, m, want_aux):
    return load_balance_loss(probs, experts, m.n_experts) if want_aux \
        else None


def moe_dense(params, x, m, *, want_aux=False):
    """O(E) masked dense evaluation (oracle / smoke path)."""
    weights, experts, probs = _route(params, x, m)
    xf = x.reshape(-1, x.shape[-1])                       # (n, d)
    n = xf.shape[0]
    gate_full = torch.zeros((n, m.n_experts), dtype=x.dtype,
                            device=x.device)
    gate_full.scatter_add_(1, experts.reshape(n, m.top_k),
                           weights.reshape(n, m.top_k))
    out = torch.zeros_like(xf)
    for e in range(m.n_experts):
        y = _expert_ffn(params["w_gate"][e:e + 1], params["w_in"][e:e + 1],
                        params["w_out"][e:e + 1], xf[None])[0]
        out = out + gate_full[:, e:e + 1] * y
    return out.reshape(x.shape), _aux(probs, experts, m, want_aux)


def moe_dispatch(params, x, m, *, want_aux=False):
    """Sort-based capacity dispatch (the deployable path)."""
    weights, experts, probs = _route(params, x, m)
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    n, k, E = xf.shape[0], m.top_k, m.n_experts
    capacity = min(max(int(n * k / E * m.capacity_factor), 1), n)
    dev = x.device

    flat_e = experts.reshape(-1)                          # (n*k,)
    flat_w = weights.reshape(-1)
    flat_tok = torch.arange(n, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)            # group by expert
    se, sw, st = flat_e[order], flat_w[order], flat_tok[order]
    # position of each assignment within its expert group
    pos_in_e = torch.arange(n * k, device=dev) - torch.searchsorted(se, se)
    keep = pos_in_e < capacity
    # past capacity: the overflow row E*C, which is dropped
    slot = torch.where(keep, se * capacity + pos_in_e, E * capacity)
    buf_tok = torch.full((E * capacity + 1,), n, dtype=torch.long,
                         device=dev)
    buf_tok[slot] = st
    xf_pad = torch.cat([xf, xf.new_zeros((1, d))])        # row n: zeros
    gathered = xf_pad[buf_tok[:-1]].reshape(E, capacity, d)
    y = _expert_ffn(params["w_gate"], params["w_in"], params["w_out"],
                    gathered).reshape(E * capacity, d)
    # combine, weighted by the gate: each token's k contributions summed
    # in increasing expert order in x's dtype, the order of the
    # reference's scatter-add over the expert-sorted assignments, with
    # no atomics (dropped ones add exact zeros)
    contrib = (y[torch.where(keep, slot, 0)] * (sw * keep)[:, None]).to(
        x.dtype)
    by_token = contrib[torch.argsort(st * E + se)].reshape(n, k, d)
    out = by_token[:, 0]
    for j in range(1, k):
        out = out + by_token[:, j]
    return out.reshape(x.shape), _aux(probs, experts, m, want_aux)


def moe_dispatch_chunked(params, x, m, chunk=DISPATCH_CHUNK_TOKENS, *,
                         want_aux=False):
    """The dispatch over token chunks of ``chunk`` rows (zero rows pad the
    last), capacity enforced per chunk, as the reference's scan does; the
    aux loss is the mean over chunks."""
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    n = xf.shape[0]
    if n <= chunk:
        return moe_dispatch(params, x, m, want_aux=want_aux)
    xf = F.pad(xf, (0, 0, 0, (-n) % chunk))
    ys, auxs = [], []
    for xb in xf.split(chunk):
        y, aux = moe_dispatch(params, xb, m, want_aux=want_aux)
        ys.append(y)
        auxs.append(aux)
    y = torch.cat(ys)[:n].reshape(x.shape)
    return y, (torch.stack(auxs).mean() if want_aux else None)


def moe_ffn(params, x, cfg, *, want_aux=False):
    """Full MoE FFN incl. DeepSeek-style shared experts.  Returns (y, aux)."""
    m = cfg.moe
    if cfg.moe_impl == "dense":
        y, aux = moe_dense(params, x, m, want_aux=want_aux)
    else:
        y, aux = moe_dispatch_chunked(params, x, m, want_aux=want_aux)
    if m.n_shared_experts:
        y = y + mlp(params["shared"], x, "silu")
    return y, aux
