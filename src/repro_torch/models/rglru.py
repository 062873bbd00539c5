"""RecurrentGemma / Griffin recurrent block: temporal conv + RG-LRU.

Port of ``repro/models/rglru.py``.  The recurrence and its gates follow
the Griffin paper [arXiv:2402.19427]:

    r_t = sigmoid(W_a u_t),  i_t = sigmoid(W_x u_t)
    log a_t = -c * softplus(lam) * r_t            (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The reference computes RG-LRU outside any Pallas kernel, so the port
computes it with PyTorch operations: the projections as matrix products,
the gates and the recurrence in f32, ``u``, ``gate`` and ``y`` in the
activation dtype, the cached ``h`` rounded to it at the end of prefill
and after every decode step, ``lam`` f32 in a bf16 model.

Training on a mesh whose batch stays off the model axis
(``cfg.train_batch_over_model=False``, the reference's "channel-parallel
recurrence", which it pins with ``_pin_channel_sharding``) hands
``rglru_prefill`` a ``sharding.ChannelSplit``: the leaves are this
rank's channel block, the projections, the conv, the scan and
``h * gate`` run on d_rnn / model channels, the gates take every channel
of the conv output (``channels.gather``), and the output's partial sums
are all-reduced (``channels.leave``).  Serving on a mesh
(``sharding.ServePlan``, ``sharding.rglru_split``) hands ``rglru_prefill``
and ``rglru_decode`` the same split, counted on the plan's collectives,
the ``h`` and ``conv_state`` caches this rank's channels.  Elsewhere
(``train()``, one process) ``channels`` is ``sharding.ALL_CHANNELS``,
whose calls return their input.

Prefill runs the diagonal linear recurrence as the reference does, in
tiles of ``chunk`` steps with the (B, d_rnn) boundary state carried from
tile to tile; inside a tile a Hillis-Steele scan over (a, b) pairs takes
log2(chunk) elementwise steps, so a layer costs tens of launches, not
one per token.  No ``cumprod``/division form: the product of ``a`` over
a tile underflows f32.  Decode is the O(1)-per-token step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import sharding
from repro_torch.models.layers import dense_init
from repro_torch.models.ssm import _conv_tail, causal_conv, conv_step

_C = 8.0
RGLRU_CHUNK = 256


def rglru_init(cfg, dtype, generator: torch.Generator, device):
    """The reference's distributions: fan-in truncated-normal projections,
    N(0, 0.1^2) conv taps, zero conv bias, and lam = softplus^-1(-log(u)
    / c) for u uniform on [0.9, 0.999], so that a^c spans roughly [0.9,
    0.999] at r = 1 (Griffin appendix).  lam stays f32 in a bf16 model."""
    r = cfg.rglru
    d = cfg.d_model
    d_rnn = r.d_rnn or d
    f32 = dict(dtype=torch.float32, device=device)
    u = torch.rand((d_rnn,), generator=generator, **f32) * (0.999 - 0.9) + 0.9
    conv_w = torch.randn((r.conv_width, d_rnn), generator=generator,
                         **f32) * 0.1
    return {
        "w_branch_x": dense_init((d, d_rnn), dtype, generator, device),
        "w_branch_gate": dense_init((d, d_rnn), dtype, generator, device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((d_rnn,), dtype=dtype, device=device),
        "w_gate_a": dense_init((d_rnn, d_rnn), dtype, generator, device),
        "w_gate_i": dense_init((d_rnn, d_rnn), dtype, generator, device),
        "lam": torch.log(torch.expm1(-torch.log(u) / _C)),
        "w_out": dense_init((d_rnn, d), dtype, generator, device),
    }


def _gates(params, u, channels=sharding.ALL_CHANNELS):
    """(a, b) of the recurrence, f32, from the conv output u (this rank's
    channels under a ``ChannelSplit``, whose gates read every channel)."""
    u_all = channels.gather(u)
    r_gate = torch.sigmoid((u_all @ params["w_gate_a"]).float())
    i_gate = torch.sigmoid((u_all @ params["w_gate_i"]).float())
    log_a = -_C * F.softplus(params["lam"]) * r_gate
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) \
        * i_gate * u.float()
    return a, b


def linear_scan(a, b, chunk=RGLRU_CHUNK):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 over axis 1 of (B, S, C)
    f32 tensors; returns h (B, S, C).  Tiles of ``chunk`` steps, padded
    with the identity element (a = 1, b = 0); within a tile, Hillis-Steele
    over the pairs, where (a1, b1) then (a2, b2) compose to (a1 a2, a2 b1
    + b2); across tiles, the state entering tile c is the last state of
    tile c - 1."""
    B, S, C = a.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        b = F.pad(b, (0, 0, 0, pad))
    nc = (S + pad) // chunk
    A = a.reshape(B, nc, chunk, C)
    Bs = b.reshape(B, nc, chunk, C)
    off = 1
    while off < chunk:
        Bs = torch.cat([Bs[:, :, :off],
                        A[:, :, off:] * Bs[:, :, :-off] + Bs[:, :, off:]], 2)
        A = torch.cat([A[:, :, :off], A[:, :, off:] * A[:, :, :-off]], 2)
        off *= 2
    h_in = [torch.zeros((B, C), dtype=a.dtype, device=a.device)]
    for c in range(nc - 1):                  # (B, C) steps, one per tile
        h_in.append(A[:, c, -1] * h_in[-1] + Bs[:, c, -1])
    h = A * torch.stack(h_in, 1)[:, :, None] + Bs
    return h.reshape(B, nc * chunk, C)[:, :S]


def rglru_prefill(params, x, cfg, initial=None, chunk=RGLRU_CHUNK,
                  channels=sharding.ALL_CHANNELS):
    """x: (B, S, d); ``initial``: a cache dict whose ``h`` (B, d_rnn) the
    recurrence starts from (zeros without it); ``channels``: a
    ``sharding.ChannelSplit`` when ``params`` are this rank's channel
    block (on a mesh; the cache is then this rank's channels).
    Returns (y, cache {conv_state, h})."""
    r = cfg.rglru
    x = channels.enter(x)
    u = x @ params["w_branch_x"]
    # jax.nn.gelu is the tanh approximation
    gate = F.gelu(x @ params["w_branch_gate"], approximate="tanh")
    u_pre = u
    u = causal_conv(u, params["conv_w"], params["conv_b"])
    a, b = _gates(params, u, channels)
    if initial is not None:
        # fold the initial hidden state into the first step's offset
        b[:, 0] += a[:, 0] * initial["h"].float()
    h = linear_scan(a, b, chunk)
    y = h.to(x.dtype) * gate
    out = channels.leave(y @ params["w_out"])
    cache = {"conv_state": _conv_tail(u_pre, r.conv_width),
             "h": h[:, -1].to(x.dtype)}
    return out, cache


def rglru_decode(params, x1, cache, cfg, channels=sharding.ALL_CHANNELS):
    """x1: (B, 1, d); ``channels`` as ``rglru_prefill``.  Returns (y, new
    cache dict)."""
    u = (x1 @ params["w_branch_x"])[:, 0]
    gate = F.gelu(x1 @ params["w_branch_gate"], approximate="tanh")[:, 0]
    u_c, conv_state = conv_step(u, cache["conv_state"], params["conv_w"],
                                params["conv_b"])
    a, b = _gates(params, u_c, channels)
    h = a * cache["h"].float() + b
    y = h.to(x1.dtype) * gate
    out = channels.leave(y @ params["w_out"])[:, None]
    return out, {"conv_state": conv_state, "h": h.to(x1.dtype)}
