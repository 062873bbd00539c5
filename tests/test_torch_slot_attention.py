"""Slot-cache attention through the paged-attention kernels (CPU).

On CUDA tensors the port's ``decode_attention`` and ``gqa_prefill_chunk``
take no f32 copy of the slot caches: they view each cache as a pool of
pages with an identity block table and run the paged kernels
(``decode_attention_paged``, ``chunk_attention_paged``).  On the CPU the
same functions run with the kernels' plain versions, so these tests hold
the view, the table, the per-row context and the row map of that route:

- in f32 against the reference's ``decode_attention`` (JAX) and the
  port's ``chunk_attention_plain`` at 1e-5;
- in bf16 against the same, within the bound of the reference's
  rounding of the softmax weights: the reference rounds each weight to
  bf16 (relative error at most 2**-9) before the product with V, the
  kernels keep it in f32, so the two differ by at most 2**-9 * max|v|
  before the outputs are rounded to bf16 (2**-9 of each output; 2**-7
  of the output is taken, as the kernel checks take for one bf16 step).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import decode_attention as j_decode_attention
from repro_torch.models import attention as A

F32_TOL = 1e-5


def weight_rounding_tol(v):
    """(rtol, atol) of the paged route against the reference's rounding
    of the softmax weights to bf16, for values ``v``."""
    return 2 ** -7, 2 ** -9 * float(v.float().abs().max()) + 1e-6


def assert_within(out, ref, tol):
    rtol, atol = tol
    d = (out.float() - ref.float()).abs()
    bound = atol + rtol * ref.float().abs()
    assert bool((d <= bound).all()), float((d / bound).max())


def caches(rng, B, S, Hkv, D, dtype):
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Hkv, D))
                             .astype(np.float32)).to(dtype)
            for _ in range(2))
    return k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,pos", [
    (3, 64, 4, 4, [0, 17, 63]),          # MHA, pages of 16
    (2, 40, 6, 2, [39, 5]),              # G = 3, pages of 8
    (2, 37, 9, 1, [36, 100]),            # G = 9, pages of 1; a sequence
                                         # past the cache attends all of it
    (2, 32, 4, 2, [31, 75]),             # a ring cache that wrapped
])
def test_decode_paged_matches_reference(B, S, Hq, Hkv, pos, dtype):
    rng = np.random.default_rng(B * S + Hq)
    dt = getattr(torch, dtype)
    D = 32
    q = torch.from_numpy(rng.standard_normal((B, 1, Hq, D))
                         .astype(np.float32)).to(dt)
    k, v = caches(rng, B, S, Hkv, D, dt)
    pos_t = torch.tensor(pos, dtype=torch.int32)
    ctx = A._decode_ctx(S, pos_t)
    out = A.decode_attention_paged(q, k, v, ctx)
    # the reference's validity mask for full attention (idx <= pos); for
    # a ring, idx < min(pos + 1, S): the same prefix
    valid = np.arange(S)[None] <= np.asarray(pos)[:, None]

    def jx(t):
        return jnp.asarray(t.float().numpy()).astype(dtype)

    ref = torch.from_numpy(np.array(j_decode_attention(
        jx(q), jx(k), jx(v), jnp.asarray(valid)), np.float32))
    assert out.shape == (B, 1, Hq, D) and out.dtype == dt
    tol = (F32_TOL, F32_TOL) if dtype == "float32" else weight_rounding_tol(v)
    assert_within(out, ref, tol)
    # the dispatch: the CPU runs the plain version, the same function
    plain = A.decode_attention(q, k, v, ctx)
    assert_within(plain, ref, (F32_TOL, F32_TOL) if dtype == "float32"
                  else (2 ** -7, 1e-6))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,C,start,S,Hq,Hkv", [
    (1, 16, 0, 48, 4, 4),                # the first chunk
    (2, 9, 20, 48, 6, 2),                # a later chunk, G = 3
    (1, 12, 40, 48, 9, 1),               # a chunk clamped at the cache end
])
def test_chunk_paged_matches_plain(B, C, start, S, Hq, Hkv, dtype):
    rng = np.random.default_rng(C + start)
    dt = getattr(torch, dtype)
    D = 32
    q = torch.from_numpy(rng.standard_normal((B, C, Hq, D))
                         .astype(np.float32)).to(dt)
    k, v = caches(rng, B, S, Hkv, D, dt)
    positions = (start + torch.arange(C))[None].expand(B, C)
    out = A.chunk_attention_paged(q, k, v, positions)
    plain = A.chunk_attention_plain(q, k, v, positions)
    assert out.shape == plain.shape == (B, C, Hq, D)
    tol = (F32_TOL, F32_TOL) if dtype == "float32" else weight_rounding_tol(v)
    assert_within(out, plain, tol)


def test_bf16_weights_alone_would_not_pass_one_step():
    """The bound above is needed: against the reference's rounding the
    paged route misses one bf16 step of the output's own value (outputs
    near zero carry the weights' rounding), while staying within the
    weight-rounding bound."""
    rng = np.random.default_rng(0)
    B, S, H, D = 4, 256, 8, 64
    q = torch.from_numpy(rng.standard_normal((B, 1, H, D))
                         .astype(np.float32)).to(torch.bfloat16)
    k, v = caches(rng, B, S, H, D, torch.bfloat16)
    ctx = torch.full((B,), S, dtype=torch.int32)
    out = A.decode_attention_paged(q, k, v, ctx)
    valid = torch.ones(B, S, dtype=torch.bool)
    plain = A.decode_attention_plain(q, k, v, valid)
    d = (out.float() - plain.float()).abs()
    assert bool((d > 2 ** -7 * plain.float().abs() + 1e-5).any())
    assert_within(out, plain, weight_rounding_tol(v))
