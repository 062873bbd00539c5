"""The port's flash attention against the JAX package's.

The plain version (what the port's wrapper runs on CPU tensors, and what
the CUDA kernel is held to on the card) against ``flash_attention_pallas``
in interpret mode and against the pure-JAX blockwise
``repro.models.attention.flash_attention``, on the grid of
``tests/test_kernels.py::test_flash_kernel``, at RecurrentGemma-2B's
shape (10 query heads over one kv head of 256, a window shorter than
S) and at Sq != Skv (Whisper's cross-attention: prompt rows over encoder
frames, causal and windowed masks aligned top-left): f32 within 1e-5,
bf16 within one bf16 step (both sides compute in f32 and round once)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import flash_attention as jax_flash_pallas
from repro.models.attention import flash_attention as jax_flash_blockwise
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn

fa = importlib.import_module("repro_torch.kernels.flash_attention")

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -7, 1e-5)}   # (rtol, atol)
GRID = [
    (128, 8, 2, 64, True, 0, 64, 64),
    (160, 8, 8, 32, True, 0, 64, 32),
    (96, 4, 1, 64, True, 48, 32, 32),
    (96, 4, 4, 32, False, 0, 32, 32),
    (100, 4, 2, 16, True, 0, 32, 32),       # ragged -> padding
    (96, 10, 1, 256, True, 40, 32, 32),     # RecurrentGemma-2B: MQA, D=256
    # (Sq, Skv): Whisper's cross-attention shape, fewer query rows than
    # keys, and more
    ((20, 75), 4, 4, 64, False, 0, 32, 32),
    ((75, 20), 4, 2, 32, True, 0, 32, 16),
]


def inputs(S, Hq, Hkv, D, dtype, seed=0):
    """``S`` is Sq == Skv, or a pair (Sq, Skv)."""
    Sq, Skv = S if isinstance(S, tuple) else (S, S)
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((2, n, h, D)).astype(np.float32)
            for n, h in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv))]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def assert_within(out, want, dtype):
    rtol, atol = TOL[dtype]
    got = out.float().numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("S,Hq,Hkv,D,causal,window,bq,bkv", GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(S, Hq, Hkv, D, causal, window, bq, bkv,
                                     dtype):
    (jq, jk, jv), (q, k, v) = inputs(S, Hq, Hkv, D, dtype)
    want = jax_flash_pallas(jq, jk, jv, causal=causal, window=window,
                            block_q=bq, block_kv=bkv)
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              block_q=bq, block_kv=bkv)
    assert out.dtype == q.dtype and out.shape == q.shape[:3] + (D,)
    assert_within(out, want, dtype)


@pytest.mark.parametrize("S,Hq,Hkv,D,causal,window,bq,bkv", GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_flash_matches_blockwise_reference(S, Hq, Hkv, D, causal,
                                                 window, bq, bkv, dtype):
    (jq, jk, jv), (q, k, v) = inputs(S, Hq, Hkv, D, dtype, seed=1)
    want = jax_flash_blockwise(jq, jk, jv, causal=causal, window=window)
    out = tattn.flash_attention(q, k, v, causal=causal, window=window)
    assert_within(out, want, dtype)
    # and the naive oracle agrees with both
    assert_within(tref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window), want, dtype)


def test_block_sizes_only_reorder_sums():
    _, (q, k, v) = inputs(100, 4, 2, 16, "float32", seed=2)
    a = fa.flash_attention_plain(q, k, v, block_kv=16)
    b = fa.flash_attention_plain(q, k, v, block_kv=128)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_wrapper_validates_and_counts_nothing_on_cpu():
    _, (q, k, v) = inputs(32, 4, 2, 16, "float32")
    before = dict(fa.LAUNCHES)
    fa.flash_attention_kernel(q, k, v)
    assert fa.LAUNCHES == before              # the plain version ran
    with pytest.raises(ValueError, match="group evenly"):
        fa.flash_attention_kernel(q, k[:, :, :1].repeat(1, 1, 3, 1),
                                  v[:, :, :1].repeat(1, 1, 3, 1))
    with pytest.raises(ValueError, match="k and v share B, their length"):
        fa.flash_attention_kernel(q, k, v[:, :16])
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention_kernel(q.to("meta"), k.to("meta"), v.to("meta"))
