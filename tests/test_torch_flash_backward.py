"""The gradient of the port's flash attention against the reference's
custom VJP (``repro.models.attention.flash_attention``, whose backward is
``_flash_core_bwd``), on the same inputs drawn from a numpy seed.

The plain backward (``flash_attention_bwd_plain``: what the wrapper runs
on CPU tensors, and what the CUDA backward kernel is held to on the
card), fed the plain forward's output and lse, against ``jax.grad``
through the reference, on a grid of causal, windowed and full masks, Sq
!= Skv both ways, G in {1, 4, 8}, D != Dv and lengths that are not
multiples of the blocks: f32 within 1e-4 of the largest gradient (both
sum in f32, in other orders; measured at most 9.9e-7), bf16 within two
bf16 steps of the largest (both compute in f32 and round once; the
reference's delta reads its f32 output where the port's reads the bf16
output; measured at most one step).  The forward's lse
against ``_flash_fwd_impl``'s (f32, 1e-5).  The autograd Function on
CPU tensors: its gradients are the plain backward's, bit for bit, and
within 1e-4 of autograd through the naive attention."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import _flash_fwd_impl
from repro.models.attention import flash_attention as j_flash
from repro_torch.models.attention import naive_attention

fa = importlib.import_module("repro_torch.kernels.flash_attention")

F32_REL = 1e-4
BF16_STEPS = 2
# (Sq, Skv, Hq, Hkv, D, Dv, causal, window, block_q, block_kv)
GRID = [
    (100, 100, 4, 4, 32, 32, True, 0, 32, 32),     # G = 1, ragged
    (96, 96, 8, 2, 32, 32, True, 24, 32, 32),      # G = 4, windowed
    (70, 70, 8, 1, 16, 16, False, 0, 32, 16),      # G = 8, full
    (50, 90, 4, 1, 32, 16, False, 0, 16, 32),      # Sq < Skv, D != Dv
    (90, 40, 8, 1, 16, 16, True, 0, 32, 32),       # Sq > Skv, causal
    (60, 60, 4, 4, 24, 40, False, 20, 16, 16),     # window, not causal
    (40, 75, 4, 2, 16, 16, True, 8, 16, 32),       # Sq != Skv, windowed
]


def inputs(Sq, Skv, Hq, Hkv, D, Dv, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, n, h, d)).astype(np.float32)
            for n, h, d in ((Sq, Hq, D), (Skv, Hkv, D), (Skv, Hkv, Dv),
                            (Sq, Hq, Dv))]


def bf16_step(x):
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


def assert_grad_close(got, want, dtype, name):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    if dtype == "float32":
        assert err <= F32_REL * np.abs(want).max(), (name, err)
    else:
        assert err <= BF16_STEPS * bf16_step(want), (name, err,
                                                     bf16_step(want))


# every case in f32; bf16 on G = 1, G = 4 windowed, Sq < Skv with D !=
# Dv, and the window without the causal mask
CASES = [(c, "float32") for c in GRID] + [
    (GRID[i], "bfloat16") for i in (0, 1, 3, 5)]


@pytest.mark.parametrize("case,dtype", CASES,
                         ids=lambda c: "-".join(map(str, c))
                         if isinstance(c, tuple) else c)
def test_plain_backward_matches_reference_vjp(case, dtype):
    Sq, Skv, Hq, Hkv, D, Dv, causal, window, bq, bkv = case
    arrs = inputs(Sq, Skv, Hq, Hkv, D, Dv, seed=Sq + Skv + D)
    jq, jk, jv, jdo = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrs)
    q, k, v, do = (torch.from_numpy(a).to(getattr(torch, dtype))
                   for a in arrs)

    def f(q, k, v):
        return j_flash(q, k, v, causal=causal, window=window, block_q=bq,
                       block_kv=bkv)

    _, vjp = jax.vjp(f, jq, jk, jv)
    want = vjp(jdo)
    out, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, block_q=bq,
                                        block_kv=bkv, return_lse=True)
    got = fa.flash_attention_bwd_kernel(q, k, v, out, lse, do, causal=causal,
                                        window=window, block_q=bq,
                                        block_kv=bkv)
    for name, g, w, t in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        assert_grad_close(g, w, dtype, name)


@pytest.mark.parametrize("case", GRID[:5], ids=lambda c: "-".join(map(str, c)))
def test_lse_matches_reference(case):
    Sq, Skv, Hq, Hkv, D, Dv, causal, window, bq, bkv = case
    q, k, v, _ = inputs(Sq, Skv, Hq, Hkv, D, Dv, seed=1)
    _, want = _flash_fwd_impl(causal, window, bq, bkv, jnp.asarray(q),
                              jnp.asarray(k), jnp.asarray(v))
    _, lse = fa.flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        window=window, block_q=bq, block_kv=bkv, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, Sq, Hq)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(want).reshape(2, Sq, Hq),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16), (False, 0)])
def test_autograd_function_on_cpu(causal, window):
    arrs = inputs(72, 72, 8, 2, 32, 32, seed=9)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs[:3])
    do = torch.from_numpy(arrs[3])
    out = fa.flash_attention_train(q, k, v, causal=causal, window=window,
                                   block_q=32, block_kv=32)
    grads = torch.autograd.grad(out, (q, k, v), do)
    with torch.no_grad():
        p_out, p_lse = fa.flash_attention_plain(
            q, k, v, causal=causal, window=window, block_q=32, block_kv=32,
            return_lse=True)
        plain = fa.flash_attention_bwd_plain(q, k, v, p_out, p_lse, do,
                                             causal=causal, window=window,
                                             block_q=32, block_kv=32)
    assert torch.equal(out, p_out)
    ref = torch.autograd.grad(naive_attention(q, k, v, causal=causal,
                                              window=window), (q, k, v), do)
    for g, p, r in zip(grads, plain, ref):
        assert torch.equal(g, p)
        assert (g - r).abs().max() <= F32_REL * r.abs().max()


def test_backward_refuses_mismatched_saved_tensors():
    q, k, v, do = (torch.from_numpy(a) for a in inputs(16, 16, 2, 2, 8, 8, 0))
    out, lse = fa.flash_attention_plain(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="lse must be f32"):
        fa.flash_attention_bwd_kernel(q, k, v, out, lse.double(), do)
    with pytest.raises(ValueError, match="dout"):
        fa.flash_attention_bwd_kernel(q, k, v, out, lse, do[:, :8])
