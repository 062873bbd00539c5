"""KV pools of the PyTorch port against ``repro.serving.kv_cache``:
``make_pools`` (fp and int8 with bf16 scales), the in-place
``scatter_prefill`` and ``write_token_to_pool``, and the copied host
``PagePool`` allocator under one sequence of operations."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import kv_cache as jkv
from repro_torch.serving import kv_cache as tkv


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("quantized", [False, True])
def test_make_pools(quantized):
    want = jkv.make_pools(2, 5, 4, 3, 8, jnp.float32, quantized=quantized)
    got = tkv.make_pools(2, 5, 4, 3, 8, torch.float32, quantized=quantized,
                         device="cpu")
    assert len(got) == len(want) == (4 if quantized else 2)
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert not g.any()


def test_scatter_prefill_in_place():
    L, S, Hkv, D, page = 2, 11, 3, 4, 4
    pool0 = rand(0, L, 6, page, Hkv, D)          # non-zero: tail zero-fill
    caches = rand(1, L, S, Hkv, D)
    pages = [4, 1, 3]
    for n_tokens in (None, 6):
        want = jkv.scatter_prefill(jnp.asarray(pool0), jnp.asarray(caches),
                                   pages, page, n_tokens=n_tokens)
        pool = torch.from_numpy(pool0.copy())
        got = tkv.scatter_prefill(pool, torch.from_numpy(caches), pages,
                                  page, n_tokens=n_tokens)
        assert got is pool
        np.testing.assert_array_equal(pool.numpy(), np.asarray(want))


def test_write_token_to_pool_in_place():
    pool0 = rand(2, 2, 6, 4, 3, 4)
    tok = rand(3, 2, 3, 4)
    want = jkv.write_token_to_pool(jnp.asarray(pool0), jnp.asarray(tok),
                                   [5, 2], 6, 4)
    pool = torch.from_numpy(pool0.copy())
    tkv.write_token_to_pool(pool, torch.from_numpy(tok), [5, 2], 6, 4)
    np.testing.assert_array_equal(pool.numpy(), np.asarray(want))


def test_page_pool_copy_agrees():
    pools = (jkv.PagePool(12, 4), tkv.PagePool(12, 4))
    for p in pools:
        p.alloc(0, 9)
        p.ensure(1, 5)
        p.extend(0, 9, 13)
        p.ensure(1, 12)
        p.free_request(0)
        p.alloc(2, 3)
        assert p.release_request(3) is False
    a, b = pools
    assert a.owned == b.owned and a.free == b.free
    np.testing.assert_array_equal(a.block_table([1, 2], 4),
                                  b.block_table([1, 2], 4))
    with pytest.raises(ValueError, match="double free"):
        b.free_request(0)
