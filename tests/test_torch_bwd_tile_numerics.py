"""The roundings of the bf16 flash backward kernel (the tensor-core variant
of ``csrc/flash_attention_bwd.cu``), emulated in torch on the CPU, against
the plain version the kernel is held to, ``flash_attention_bwd_plain``.

This file documents the numerics of the design: no code of the kernel
runs here.  The ``cuda``-marked tests of ``test_torch_kernels_cuda.py``
and ``chip_smoke.py`` hold the kernel itself to its plain version.

The kernel feeds bf16 operands to ``mma.sync`` with f32 accumulation.
S = Q.K^T and dP = dO.V^T take the bf16 inputs, so their products are
exact and only the order of the f32 sums differs from the plain version.
P = exp(s - lse) and dS = P (dP - delta) scale are f32 and must go into
dV = P^T.dO, dK = dS^T.Q and dQ = dS.K as bf16: either as two terms,
``hi = bf16(x)`` and ``lo = bf16(x - hi)`` into one f32 accumulator (16
significant bits), or as one.  The gate (``chip_smoke.py``, the ``cuda``
tests) is one bf16 step of the largest |plain| gradient, after both sides
round to bf16.

What these inputs show (standard normal q, k, v, dO from a numpy seed;
``ratio`` = max |emulated - plain| over dq, dk, dv in units of that step):

| shape | split, rounded | split, f32 | P single, rounded / f32 | dS single, rounded / f32 |
|---|---|---|---|---|
| run P cut: S 2048, 8 heads over 2 of 64, causal | 0.25 | 0.0015 | 0.5 / 0.14 | 1.0 / 0.71 |
| S 512, 4 heads of 128, causal | 0.25 | 0.0006 | 0.5 / 0.23 | 1.0 / 0.42 |
| MLA: S 512, D 96, Dv 64, causal | 0.25 | 0.0006 | 1.0 / 0.41 | 1.0 / 0.28 |
| S 600, 10 heads over 1 of 256, window 128 | 0.25 | 0.0007 | 0.5 / 0.28 | 1.0 / 0.41 |

("f32": before the final rounding, against the plain version's f32
gradients.)  The rounded ratio is quantized: where a gradient element of
the top binade lies within the f32 difference of a rounding boundary,
the two sides round one step apart and the ratio reads 1.0 whatever the
f32 difference (the card reads 1.0 with the split at Llama-2-7B's and
RecurrentGemma-2B's S 4096, with millions of elements); the gate holds
while the f32 difference stays below about half a step.  So the margin is
the f32 column.  The split stays within 0.0015 of a step.  A single term
is 90-710x that and grows with S (dS: 0.25 of a step at S 1024, 0.71
at S 2048), so it would pass the gate's half-step line at the S 4096
the card runs: the kernel keeps the split for both P and dS.
"""
import functools
import importlib

import numpy as np
import pytest
import torch

fa = importlib.import_module("repro_torch.kernels.flash_attention")

# (Sq, Skv, Hq, Hkv, D, Dv, causal, window)
SHAPES = {
    "granite_cut_S2048_gqa4_d64": (2048, 2048, 8, 2, 64, 64, True, 0),
    "S512_d128": (512, 512, 4, 4, 128, 128, True, 0),
    "mla_S512_d96_dv64": (512, 512, 4, 4, 96, 64, True, 0),
    "rgemma_S600_gqa10_d256_window128": (600, 600, 10, 1, 256, 256, True,
                                         128),
}


def terms(x, split):
    """x (f32) as the kernel feeds it to a product: hi + lo bf16 terms
    (``split``) or one bf16 term, each exact in f32."""
    hi = x.to(torch.bfloat16).float()
    return (hi, (x - hi).to(torch.bfloat16).float()) if split else (hi,)


def emulate_bwd(q, k, v, out, lse, do, *, causal, window, split_p=True,
                split_ds=True):
    """(dq, dk, dv) by the kernel's arithmetic in q's dtype: S and dP as f32
    sums of exact products of the inputs, P = exp(s scale - lse) under the
    forward's mask (0 where masked), dS = P (dP - delta) scale with delta =
    rowsum(dO O) over the output in q's dtype, the three gradient products
    over P and dS as bf16 terms, f32 sums, one rounding at the end."""
    _, Sq, Hq, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = Hq // Hkv
    scale = D ** -0.5
    qf, dof = (t.float().permute(0, 2, 1, 3) for t in (q, do))
    kf, vf = (t.float().repeat_interleave(G, 2).permute(0, 2, 1, 3)
              for t in (k, v))
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1)[..., None]
    qpos, kpos = torch.arange(Sq)[:, None], torch.arange(Skv)[None]
    mask = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = qf @ kf.transpose(-1, -2)
    p = torch.where(mask, torch.exp(s * scale - lse.permute(0, 2, 1)[..., None]),
                    torch.zeros(()))
    ds = p * (dof @ vf.transpose(-1, -2) - delta) * scale
    dv = sum(t.transpose(-1, -2) @ dof for t in terms(p, split_p))
    dk = sum(t.transpose(-1, -2) @ qf for t in terms(ds, split_ds))
    dq = sum(t @ kf for t in terms(ds, split_ds))
    B = q.shape[0]
    dk = dk.reshape(B, Hkv, G, Skv, D).sum(2)
    dv = dv.reshape(B, Hkv, G, Skv, Dv).sum(2)
    return tuple(g.permute(0, 2, 1, 3).to(t.dtype)
                 for g, t in ((dq, q), (dk, k), (dv, v)))


def bf16_step(x):
    """One bf16 step (unit in the last place) at the largest |x|."""
    return 2.0 ** (np.floor(np.log2(x.float().abs().max().item())) - 7)


def ratio(got, want):
    """max |got - want| over the three gradients, in bf16 steps of each
    gradient's largest |want| (the gate's unit)."""
    return max((g.float() - w.float()).abs().max().item() / bf16_step(w)
               for g, w in zip(got, want))


@functools.lru_cache(maxsize=None)
def case(name, seed=0):
    """bf16 inputs from a numpy seed, the plain forward's output and lse,
    the plain backward in bf16 and its f32 gradients before the rounding."""
    Sq, Skv, Hq, Hkv, D, Dv, causal, window = SHAPES[name]
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, n, h, d))
                                    .astype(np.float32)).to(torch.bfloat16)
                   for n, h, d in ((Sq, Hq, D), (Skv, Hkv, D), (Skv, Hkv, Dv),
                                   (Sq, Hq, Dv)))
    out, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, return_lse=True)
    kw = dict(causal=causal, window=window)
    plain = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    f32 = [t.float() for t in (q, k, v, out)] + [lse, do.float()]
    plain_f32 = fa.flash_attention_bwd_plain(*f32, **kw)
    return (q, k, v, out, lse, do), f32, plain, plain_f32, kw


def ratios(name, split_p, split_ds):
    """(rounded, f32) ratios of the emulation against the plain version."""
    args, f32, plain, plain_f32, kw = case(name)
    flags = dict(split_p=split_p, split_ds=split_ds)
    return (ratio(emulate_bwd(*args, **kw, **flags), plain),
            ratio(emulate_bwd(*f32, **kw, **flags), plain_f32))


@pytest.mark.parametrize("name", list(SHAPES))
def test_split_roundings_within_bound(name):
    """P and dS as hi + lo: within the gate, and before the rounding far
    inside one step (at most 0.0015 of one on these inputs)."""
    rounded, f32 = ratios(name, True, True)
    assert rounded <= 1
    assert f32 <= 1 / 64


@pytest.mark.parametrize("term", ["p", "ds"])
def test_single_bf16_term_has_no_margin(term):
    """One bf16 term for P (or dS), the other split: before the rounding
    at least 50x the split's error at every shape (93x to 710x on these
    inputs), and at least 0.1 of a step at some shape (dS: 0.71 at S 2048,
    P: 0.41 at MLA's), where the gate reads its limit (rounded ratio
    1.0): the single term is not taken."""
    got = {name: ratios(name, term != "p", term != "ds") for name in SHAPES}
    for name, (_, f32) in got.items():
        assert f32 >= 50 * ratios(name, True, True)[1], name
    assert max(f for _, f in got.values()) >= 0.1
    assert max(r for r, _ in got.values()) >= 1
