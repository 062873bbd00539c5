"""The port's attention at Sq != Skv (Whisper's cross-attention) against
the JAX package's, on the CPU.

- The flash kernel's plain version (what the port's wrapper runs on CPU
  tensors, and what the CUDA kernel is held to on the card) against
  ``flash_attention_pallas`` in interpret mode: non-causal, causal and
  windowed masks (aligned top-left: qpos and kpos count from 0), GQA,
  ragged lengths (Sq, Skv) = (20, 75), (16, 187), (75, 20) and Whisper's
  64 prompt rows over 1500 frames; f32 within 1e-5, bf16 within one bf16
  step (2**-7 relative: both sides compute in f32 and round once).  A
  window that leaves a query row no key is refused.
- ``cross_kv``, ``cross_attn`` (prefill, through ``attention``) and the
  decode step's ``cross_decode`` against ``repro.models.attention``'s on
  bridged weights, f32 within 1e-5.
- The decode step's CUDA route (``slot_cache_attention`` over the frames
  viewed as pages of gcd(T, 16) slots: 375 pages of 4 at T = 1500), run
  here through the paged kernels' plain versions, against the
  reference's ``impl="naive"`` attention: f32 within 1e-5; bf16 within
  2**-7 relative + 2**-9 max|v| (the paged route keeps the softmax
  weights in f32, as naive does, and rounds the output once).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as ja
from repro_torch.models import attention as ta
from repro_torch.weights import params_from_numpy

# the modules (the package exports functions of the same names)
fa = importlib.import_module("repro_torch.kernels.flash_attention")
pa = importlib.import_module("repro_torch.kernels.paged_attention")

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -7, 1e-5)}   # (rtol, atol)
# (Sq, Skv, Hq, Hkv, D, causal, window, block_q, block_kv)
CASES = [
    (20, 75, 4, 4, 64, False, 0, 32, 32),      # ragged, non-causal
    (20, 75, 4, 4, 64, True, 0, 32, 32),       # causal: row i sees 0..i
    (16, 187, 8, 2, 32, False, 0, 16, 64),     # GQA, ragged
    (16, 187, 8, 2, 32, True, 0, 16, 64),
    (20, 75, 4, 1, 32, True, 8, 32, 32),       # windowed, causal
    (20, 75, 4, 2, 32, False, 30, 16, 32),     # windowed, not causal
    (75, 20, 4, 4, 32, True, 0, 32, 16),       # more rows than keys
    (75, 20, 4, 2, 32, False, 60, 32, 16),     # rows 60..74 see the tail
    (64, 1500, 4, 4, 64, False, 0, 128, 128),  # Whisper's cross prefill
]


def arrays(shapes, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


def assert_within(out, want, dtype):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("Sq,Skv,Hq,Hkv,D,causal,window,bq,bkv", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_at_sq_ne_skv(Sq, Skv, Hq, Hkv, D, causal,
                                                 window, bq, bkv, dtype):
    (jq, jk, jv), (q, k, v) = arrays(
        [(2, Sq, Hq, D), (2, Skv, Hkv, D), (2, Skv, Hkv, D)], dtype,
        seed=Sq + Skv)
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                  block_q=bq, block_kv=bkv, interpret=True)
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention_kernel(q, k, v, causal=causal, window=window,
                                    block_q=bq, block_kv=bkv)
    assert fa.LAUNCHES == before              # CPU tensors: the plain version
    assert out.dtype == q.dtype and tuple(out.shape) == (2, Sq, Hq, D)
    assert_within(out, want, dtype)
    # the model's entry point (block sizes from its own rule) agrees
    assert_within(ta.flash_attention(q, k, v, causal=causal, window=window),
                  want, dtype)


def test_flash_refuses_rows_without_a_visible_key():
    """Sq >= Skv + window: rows Skv + window - 1.. see no key, and the TPU
    kernel's output there depends on its padding; one row fewer runs."""
    _, (q, k, v) = arrays([(1, 28, 2, 16), (1, 20, 2, 16), (1, 20, 2, 16)],
                          "float32", seed=1)
    with pytest.raises(ValueError, match="no visible key"):
        fa.flash_attention_kernel(q, k, v, causal=True, window=8)
    out = fa.flash_attention_kernel(q[:, :27], k, v, causal=True, window=8)
    assert torch.isfinite(out).all()


def cross_params(d, H, hd, dtype, seed=3):
    jp = ja.cross_init(jax.random.key(seed), d, H, hd, getattr(jnp, dtype))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("impl", ["flash", "naive"])
@pytest.mark.parametrize("S,T", [(9, 24), (40, 24)])
def test_cross_kv_and_attn_match_reference(S, T, impl):
    jp, tp = cross_params(64, 4, 16, "float32")
    (jx, je), (tx, te) = arrays([(2, S, 64), (2, T, 64)], "float32", seed=S)
    jk, jv = ja.cross_kv(jp, je)
    tk, tv = ta.cross_kv(tp, te)
    for got, want in ((tk, jk), (tv, jv)):
        assert tuple(got.shape) == want.shape == (2, T, 4, 16)
        assert_within(got, want, "float32")
    want = ja.cross_attn(jp, jx, jk, jv, impl=impl)
    got = ta.cross_attn(tp, tx, tk, tv, impl=impl)
    assert tuple(got.shape) == want.shape == (2, S, 64)
    assert_within(got, want, "float32")


def test_cross_decode_matches_reference_naive():
    """One decode row per request over T frames: the reference's decode
    runs ``cross_attn(..., impl="naive")``."""
    jp, tp = cross_params(64, 4, 16, "float32")
    (jx, je), (tx, te) = arrays([(3, 1, 64), (3, 24, 64)], "float32", seed=5)
    jk, jv = ja.cross_kv(jp, je)
    want = ja.cross_attn(jp, jx, jk, jv, impl="naive")
    got = ta.cross_decode(tp, tx, *ta.cross_kv(tp, te))
    assert tuple(got.shape) == (3, 1, 64)
    assert_within(got, want, "float32")


@pytest.mark.parametrize("T,page", [(1500, 4), (24, 8), (448, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_decode_slot_route_matches_naive(T, page, dtype):
    """The CUDA route of a decode step's cross-attention, through the
    paged kernels' plain versions: every row attends all T frames (ctx =
    T), the frames viewed as T / page pages of gcd(T, 16) slots (Whisper
    large-v3: 375 pages of 4), split-K at that width."""
    H, hd = 4, 64
    (jq, jk, jv), (q, k, v) = arrays(
        [(3, 1, H, hd), (3, T, H, hd), (3, T, H, hd)], dtype, seed=T)
    want = ja.naive_attention(jq, jk, jv, causal=False)
    ctx = torch.full((3,), T, dtype=torch.int32)
    before = dict(pa.LAUNCHES)
    got = ta.slot_cache_attention(q.reshape(3, H, hd), k, v, ctx)
    assert pa.LAUNCHES == before              # CPU tensors: the plain version
    assert np.gcd(T, 16) == page
    got = got.reshape(3, 1, H, hd)
    if dtype == "float32":
        assert_within(got, want, dtype)
    else:
        vmax = float(v.float().abs().max())
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=2 ** -7, atol=2 ** -9 * vmax)
    # the CPU route of the decode step itself is the naive attention
    assert_within(ta.cross_decode_attention(q, k, v), want, dtype)
