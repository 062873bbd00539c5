"""Mamba-2 block with the SSD (state-space duality) chunked algorithm.

Port of ``repro/models/ssm.py``.  Prefill runs the chunked dual form
[arXiv:2405.21060 §6]: on CUDA tensors ``ssd_chunked`` launches the
hand-written SSD-scan kernel (``repro_torch.kernels.ssd_scan``, the port
of ``ssd_scan_pallas``), on CPU tensors its plain version; when a
gradient is wanted it goes through ``SSDScanFunction``, whose backward is
the hand-written SSD-scan backward kernel (the plain backward on CPU
tensors).  Decode runs
the O(1)-per-token diagonal recurrence.  Plain functions over the
reference's parameter layout; f32 wherever the reference computes in f32.

Serving on a mesh (``tp``: a ``sharding.ServePlan`` whose model axis
splits the layer, ``sharding.mamba2_split``): the leaves are this rank's
blocks.  ``in_proj``'s column block packs z, x, B, C and dt without
regard to heads, so its output is all-gathered; the depthwise conv runs
on this rank's channel block (its ``conv_state``) and its output is
all-gathered; the scan runs on this rank's heads (its ``ssm_state``, the
B/C groups of those heads); the gated norm's sum of squares spans every
channel and is all-reduced; ``out_proj``'s rows are those heads'
channels, and its partial products stay f32 until one all-reduce and one
rounding (one process rounds the whole product once).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import (ssd_scan_kernel, ssd_scan_plain,
                                          ssd_scan_train)
from repro_torch.models.layers import dense_init, matmul_f32, rmsnorm


def mamba2_dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return d_in, n_heads, conv_dim


def proj_width(cfg):
    """Columns of ``in_proj``: z, x, B, C and dt packed."""
    s = cfg.ssm
    d_in, nh, _ = mamba2_dims(cfg)
    return 2 * d_in + 2 * s.n_groups * s.d_state + nh


def mamba2_init(cfg, dtype, generator: torch.Generator, device):
    """The reference's distributions: fan-in truncated-normal projections,
    N(0, 0.1^2) conv taps, zero conv bias, A_log = log(1..H), dt_bias the
    inverse softplus of a log-uniform draw on [1e-3, 1e-1], D = 1.
    A_log, dt_bias and D stay f32 in a bf16 model."""
    s = cfg.ssm
    d = cfg.d_model
    d_in, nh, conv_dim = mamba2_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    u = torch.rand((nh,), generator=generator, **f32)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))     # inverse softplus
    conv_w = torch.randn((s.conv_width, conv_dim), generator=generator,
                         **f32) * 0.1
    return {
        "in_proj": dense_init((d, proj_width(cfg)), dtype, generator, device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.arange(1, nh + 1, **f32)),
        "dt_bias": dt_bias,
        "D": torch.ones((nh,), **f32),
        "norm": {"scale": torch.ones((d_in,), dtype=dtype, device=device)},
        "out_proj": dense_init((d_in, d), dtype, generator, device),
    }


def _split_proj(cfg, proj):
    s = cfg.ssm
    d_in, _, _ = mamba2_dims(cfg)
    gn = s.n_groups * s.d_state
    z = proj[..., :d_in]
    xbc = proj[..., d_in:2 * d_in + 2 * gn]
    dt_raw = proj[..., 2 * d_in + 2 * gn:]
    return z, xbc, dt_raw


def causal_conv(x, w, b):
    """Depthwise causal conv.  x: (B, S, C); w: (W, C).  The W taps are
    summed in f32 on shifted copies (no cuDNN, so no TF32)."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, W - 1, 0))
    wf = w.float()
    out = xp[:, 0:S] * wf[0]
    for t in range(1, W):
        out = out + xp[:, t:t + S] * wf[t]
    return (out + b.float()).to(x.dtype)


def _conv_tail(x, conv_width):
    """Last (W-1) raw conv inputs, left-padded with zeros if S < W-1."""
    need = conv_width - 1
    S = x.shape[1]
    if S >= need:
        return x[:, S - need:]
    return F.pad(x, (0, 0, need - S, 0))


def conv_step(x1, conv_state, w, b):
    """One-token conv.  x1: (B, C); conv_state: (B, W-1, C) past inputs."""
    window = torch.cat([conv_state, x1[:, None]], dim=1)     # (B, W, C)
    out = torch.einsum("bwc,wc->bc", window.float(), w.float()) + b.float()
    return out.to(x1.dtype), window[:, 1:]


def ssd_chunked(x, la, Bm, Cm, chunk, initial_state=None):
    """SSD dual form.  x: (B,S,H,P); la: (B,S,H) log-decay (<=0);
    Bm/Cm: (B,S,G,N).  Returns (y, final_state (B,H,P,N) f32).  CUDA
    tensors launch the SSD-scan kernel, initial state included; with grad
    mode on and an input that requires a gradient, through its autograd
    Function (the backward kernel).  Meta tensors (the dry-run: shapes
    and operations only) take the plain version, which autograd
    differentiates."""
    if x.device.type == "meta":
        return ssd_scan_plain(x, la, Bm, Cm, chunk=chunk,
                              initial_state=initial_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, la, Bm, Cm, initial_state)):
        return ssd_scan_train(x, la, Bm, Cm, chunk=chunk,
                              initial_state=initial_state)
    return ssd_scan_kernel(x, la, Bm, Cm, chunk=chunk,
                           initial_state=initial_state)


def ssd_step(x1, la1, B1, C1, state):
    """One-token recurrence.  x1: (B,H,P); la1: (B,H); B1/C1: (B,G,N);
    state: (B,H,P,N)."""
    H, G = x1.shape[1], B1.shape[1]
    Bh = B1.repeat_interleave(H // G, dim=1).float()         # (B,H,N)
    Ch = C1.repeat_interleave(H // G, dim=1).float()
    a = torch.exp(la1.float())[:, :, None, None]
    state = a * state + x1.float()[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return y.to(x1.dtype), state


def _gates(params, cfg, xbc_conv, dt_raw, lead, tp=None):
    """Split the conv output into x heads, B, C and the f32 step sizes;
    under ``tp`` this rank's heads and the B/C groups they use."""
    s = cfg.ssm
    d_in, nh, _ = mamba2_dims(cfg)
    gn = s.n_groups * s.d_state
    xh = xbc_conv[..., :d_in].reshape(*lead, nh, s.head_dim)
    Bm = xbc_conv[..., d_in:d_in + gn].reshape(*lead, s.n_groups, s.d_state)
    Cm = xbc_conv[..., d_in + gn:].reshape(*lead, s.n_groups, s.d_state)
    if tp is not None:
        xh = tp.local_heads(xh, len(lead))
        dt_raw = tp.local_heads(dt_raw, len(lead))
        Bm, Cm = (tp.groups_for_local_heads(t, nh) for t in (Bm, Cm))
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    la = -dt * torch.exp(params["A_log"])                    # log decay
    return xh, Bm, Cm, dt, la


def _conv_in(xbc, tp):
    """The conv's input channels this rank holds (all without ``tp``)."""
    return xbc if tp is None else tp.dim_slice(xbc)


def _gather(t, tp):
    """``t``'s column blocks from every model rank (``t`` without
    ``tp``)."""
    return t if tp is None else tp.gather_model(t, -1)


def _gated_out(params, y, z, cfg, tp):
    """rmsnorm(y * silu(z)) through ``out_proj``: y (..., d_in) this rank's
    heads' channels under ``tp`` (z's block beside them, the norm's sum of
    squares over every rank's, the partial products summed in f32)."""
    if tp is None:
        return rmsnorm(params["norm"], y * F.silu(z), cfg.norm_eps) \
            @ params["out_proj"]
    scale = {"scale": tp.dim_slice(params["norm"]["scale"])}
    y = rmsnorm(scale, y * F.silu(tp.dim_slice(z)), cfg.norm_eps, tp=tp)
    return tp.reduce(matmul_f32(y, params["out_proj"])).to(y.dtype)


def mamba2_prefill(params, x, cfg, initial=None, tp=None):
    """x: (B, S, d); ``initial``: a cache dict whose ``ssm_state`` (B, H, P,
    N) f32 the scan starts from (zeros without it); ``tp``: a serving plan
    that splits the layer (module docstring).  Returns (y, cache dict with
    conv_state + ssm_state)."""
    s = cfg.ssm
    Bsz, S, _ = x.shape
    proj = _gather(x @ params["in_proj"], tp)
    z, xbc, dt_raw = _split_proj(cfg, proj)
    xbc = _conv_in(xbc, tp)
    xbc_conv = F.silu(_gather(causal_conv(xbc, params["conv_w"],
                                          params["conv_b"]), tp))
    xh, Bm, Cm, dt, la = _gates(params, cfg, xbc_conv, dt_raw, (Bsz, S), tp)
    x_in = (xh * dt[..., None].to(xh.dtype)).contiguous()
    init_state = None if initial is None else initial["ssm_state"]
    y, final_state = ssd_chunked(x_in, la.contiguous(), Bm.contiguous(),
                                 Cm.contiguous(), s.chunk_size, init_state)
    y = y + (params["D"][:, None] * xh.float()).to(y.dtype)
    out = _gated_out(params, y.reshape(Bsz, S, -1), z, cfg, tp)
    cache = {"conv_state": _conv_tail(xbc, s.conv_width),
             "ssm_state": final_state}
    return out, cache


def mamba2_decode(params, x1, cache, cfg, tp=None):
    """x1: (B, 1, d); ``tp`` as ``mamba2_prefill``.  Returns (y, new cache
    dict)."""
    Bsz = x1.shape[0]
    proj = _gather((x1 @ params["in_proj"])[:, 0], tp)
    z, xbc, dt_raw = _split_proj(cfg, proj)
    xbc_c, conv_state = conv_step(_conv_in(xbc, tp), cache["conv_state"],
                                  params["conv_w"], params["conv_b"])
    xh, Bm, Cm, dt, la = _gates(params, cfg, F.silu(_gather(xbc_c, tp)),
                                dt_raw, (Bsz,), tp)
    y, state = ssd_step(xh * dt[..., None].to(xh.dtype), la, Bm, Cm,
                        cache["ssm_state"])
    y = y + (params["D"][:, None] * xh.float()).to(y.dtype)
    out = _gated_out(params, y.reshape(Bsz, 1, -1), z[:, None], cfg, tp)
    return out, {"conv_state": conv_state, "ssm_state": state}
