"""The roundings of the tensor-core tile routine (``csrc/attention_tile.cuh``),
emulated in torch on the CPU, against the plain versions the CUDA kernels
are held to.

This file documents the numerics of the design: no code of the kernels
runs here.  The ``cuda``-marked tests of ``test_torch_kernels_cuda.py``
and ``chip_smoke.py`` hold the kernels themselves to their plain versions.

The kernels take bf16 operands into ``mma.sync`` with f32 accumulation:
Q.K^T products are exact, so the scores differ from the plain f32 version
only in the order of their sums.  P (f32) has to go into the P.V product
as bf16 too.  Rounding P to one bf16 term puts outputs near zero far past
the elementwise bound ``|d| <= 2**-7 |plain| + 1e-5`` that ``chip_smoke.py``
holds the kernels to: about 131x at S = 1024, D = 128, four causal heads
on the draw that first showed it, 98.5x on this file's inputs
(``test_p_in_bf16_alone_misses``).  Split as ``hi = bf16(P)``,
``lo = bf16(P - hi)``, both multiplied into one f32 accumulator, P keeps
16 significant bits and every output is within the bound.  For int8 pages
the per-slot K scale multiplies the f32 score after the product and the
V scale is folded into P before the split, as the kernel does.  The paged
kernels send a tile of one (row, query head) pair, a decode row of an MHA
stack, through a one-row walk on the f32 FMA units instead: there P.V
takes P in f32, with no split.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.models.attention import quantize_kv

fa = importlib.import_module("repro_torch.kernels.flash_attention")
pa = importlib.import_module("repro_torch.kernels.paged_attention")

NEG_INF = -1e30
TOL = (2 ** -7, 1e-5)          # (rtol, atol): chip_smoke.py's BF16_TOL
KEYS = 64                      # keys per tile step


def tol_ratio(out, plain):
    """max |out - plain| / (atol + rtol |plain|): at most 1 when every
    element is within the bound."""
    d = (out.float() - plain.float()).abs()
    return (d / (TOL[1] + TOL[0] * plain.float().abs())).max().item()


def pv(p, v, split):
    """P.V as the kernel takes it: P as hi + lo bf16 terms (``split``) or
    as one bf16 term; v holds bf16-exact values; f32 accumulation."""
    hi = p.to(torch.bfloat16).float()
    out = hi @ v
    if split:
        out = out + (p - hi).to(torch.bfloat16).float() @ v
    return out


def emulate_flash(q, k, v, *, causal, window=0, split=True):
    """The bf16 flash kernel's arithmetic, (B, S, H, D) in and out."""
    _, S, Hq, D = q.shape
    G = Hq // k.shape[2]
    qf = q.float()[0].transpose(0, 1)                         # (Hq, S, D)
    kf = k.float()[0].repeat_interleave(G, 1).transpose(0, 1)
    vf = v.float()[0].repeat_interleave(G, 1).transpose(0, 1)
    qpos = torch.arange(S)[:, None]
    m = torch.full((Hq, S, 1), NEG_INF)
    l = torch.zeros((Hq, S, 1))
    acc = torch.zeros((Hq, S, vf.shape[-1]))
    for k0 in range(0, S, KEYS):
        kpos = torch.arange(k0, min(k0 + KEYS, S))[None, :]
        s = (qf @ kf[:, k0:k0 + KEYS].transpose(1, 2)) * D ** -0.5
        ok = kpos < S
        if causal:
            ok = ok & (kpos <= qpos)
        if window:
            ok = ok & (kpos > qpos - window)
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + pv(p, vf[:, k0:k0 + KEYS], split)
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.transpose(0, 1)[None].to(q.dtype)


def flash_inputs(S=1024, H=4, D=128, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, S, H, D))
                             .astype(np.float32)).to(torch.bfloat16)
            for _ in range(3)]


@pytest.mark.parametrize("window", [0, 256])
def test_flash_tile_roundings_within_bound(window):
    q, k, v = flash_inputs()
    out = emulate_flash(q, k, v, causal=True, window=window)
    plain = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    assert tol_ratio(out, plain) <= 1


def test_p_in_bf16_alone_misses():
    """The trap the hi/lo split avoids: P in one bf16 term."""
    q, k, v = flash_inputs()
    plain = fa.flash_attention_plain(q, k, v, causal=True)
    ratio = tol_ratio(emulate_flash(q, k, v, causal=True, split=False), plain)
    assert ratio > 10


def one_pair_rows(row_map, G, tile_pairs=64):
    """The rows the paged kernels walk one at a time on the FMA units:
    tiles of one (row, query head) pair.  A row leads a tile where its
    table row differs from the previous row's or at every (64 / G)-th row
    (the plan kernel's rule); a tile runs to the next leader."""
    cap = tile_pairs // G
    r = row_map.tolist()
    lead = [i % cap == 0 or r[i] != r[i - 1] for i in range(len(r))] + [True]
    return torch.tensor([G == 1 and lead[i] and lead[i + 1]
                         for i in range(len(r))])


def emulate_paged_splitk(q, k_pool, v_pool, tables, ctx, row_map, k_scale,
                         v_scale, pps):
    """The split-K path's arithmetic: per split of ``pps`` pages,
    S = Q.K^T (int8 K widened exactly, its scale on the f32 score),
    p = exp(s - m) times the mask, V's scale folded into p, P.V as
    hi + lo on the tensor cores (or, rows of one-pair tiles, in f32 on the
    FMA units); then the combine of the plain version."""
    B, Hq, D = q.shape
    page, Hkv = k_pool.shape[1], k_pool.shape[2]
    G = Hq // Hkv
    n = pps * page
    W = tables.shape[1]
    n_splits = -(-W // pps)
    tab = torch.nn.functional.pad(tables, (0, n_splits * pps - W))
    pages = tab[row_map.long()].long()                     # (B, n_splits*pps)
    k = k_pool[pages].float().reshape(B, n_splits, n, Hkv, D)
    v = v_pool[pages].float().reshape(B, n_splits, n, Hkv, D)
    qg = q.float().reshape(B, 1, Hkv, G, D)
    s = torch.einsum("bhgd,bsnhd->bshgn", qg[:, 0], k)      # exact products
    if k_scale is not None:
        ks = k_scale[pages].float().reshape(B, n_splits, n, Hkv)
        s = s * ks.permute(0, 1, 3, 2)[:, :, :, None]
    s = s * D ** -0.5
    pos = torch.arange(n_splits * n).reshape(n_splits, n)
    ok = (pos[None] < ctx.long()[:, None, None])[:, :, None, None]
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)                                          # (B, S, Hkv, G)
    p = torch.exp(s - m[..., None]) * ok
    l = p.sum(-1)
    if v_scale is not None:
        vs = v_scale[pages].float().reshape(B, n_splits, n, Hkv)
        p = p * vs.permute(0, 1, 3, 2)[:, :, :, None]
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    acc = (torch.einsum("bshgn,bsnhd->bshgd", hi, v)
           + torch.einsum("bshgn,bsnhd->bshgd", lo, v))
    thin = one_pair_rows(row_map, G)[:, None, None, None, None]
    acc = torch.where(thin, torch.einsum("bshgn,bsnhd->bshgd", p, v), acc)
    mm = m.amax(1, keepdim=True)
    alpha = torch.exp(m - mm)
    l = (l * alpha).sum(1)
    acc = (acc * alpha[..., None]).sum(1)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, Hq, -1).to(q.dtype)


@pytest.mark.parametrize("pools", ["bfloat16", "int8"])
def test_paged_mixed_tile_roundings_within_bound(pools):
    """A mixed launch as the paged engine lowers it: a prefill chunk from
    position 40 over table row 0 (tiles of 64, 64 and 22 rows), 8 decode
    rows (one-pair tiles: Hq = Hkv), padding rows (ctx 0)."""
    rng = np.random.default_rng(1)
    H, D, page, W, chunk = 4, 128, 16, 16, 150
    dec = rng.integers(1, page * W + 1, 8).tolist()
    ctx = list(range(41, 41 + chunk)) + dec + [0] * 10
    rmap = [0] * chunk + list(range(1, 9)) + [9] * 10
    n_pool = 10 * W + 1
    q = torch.from_numpy(rng.standard_normal((len(ctx), H, D))
                         .astype(np.float32)).to(torch.bfloat16)
    kp, vp = (torch.from_numpy(rng.standard_normal((n_pool, page, H, D))
                               .astype(np.float32)).to(torch.bfloat16)
              for _ in range(2))
    tables = torch.from_numpy(rng.permutation(n_pool)[:10 * W]
                              .reshape(10, W).astype(np.int32))
    ks = vs = None
    if pools == "int8":
        (kp, ks), (vp, vs) = quantize_kv(kp), quantize_kv(vp)
    ctx_t = torch.tensor(ctx, dtype=torch.int32)
    rmap_t = torch.tensor(rmap, dtype=torch.int32)
    assert one_pair_rows(rmap_t, 1).nonzero().flatten().tolist() \
        == list(range(chunk, chunk + 8))
    out = emulate_paged_splitk(q, kp, vp, tables, ctx_t, rmap_t, ks, vs, 4)
    plain = pa.paged_attention_splitk_plain(
        q, kp, vp, tables, ctx_t, pages_per_split=4, row_map=rmap_t,
        k_scale=ks, v_scale=vs)
    assert tol_ratio(out, plain) <= 1
    assert (out[ctx_t == 0] == 0).all()
