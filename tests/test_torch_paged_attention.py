"""Paged-attention kernels of the PyTorch port against the Pallas kernels.

The port's plain versions (what its wrappers run on CPU tensors) are held
to ``paged_attention_pallas`` / ``paged_attention_splitk_pallas`` in
interpret mode on the grids of ``tests/test_paged_kernels.py``: ragged
contexts, GQA groups, ``row_map`` launches, int8 pools, ctx-0 rows and the
(m, l) statistics, at the f32 tolerance of 1e-5.  The CUDA kernels
themselves are held to the plain versions on the card
(``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``).
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels.paged_attention  # noqa: F401  (module, not the op)
from repro.kernels.ops import paged_attention as jax_ops_paged_attention
from repro.kernels.paged_attention import (paged_attention_pallas,
                                           paged_attention_splitk_pallas)
from repro.models.attention import quantize_kv as jax_quantize_kv
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.weights import params_from_numpy

pa = sys.modules["repro_torch.kernels.paged_attention"]

ATOL = 1e-5


def make_case(seed, B, Hq, Hkv, D, page, npages, npool):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((npool, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((npool, page, Hkv, D)).astype(np.float32)
    bt = rng.integers(0, npool, (B, npages)).astype(np.int32)
    return q, kp, vp, bt


def ragged_ctxs(page, npages):
    return np.asarray([1, page, page + 1, page * npages,
                       page * (npages - 1) - 1], np.int32)


def to_t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrays]


def to_j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


CASES = [
    # B is fixed at 5 = len(ragged_ctxs): (Hq, Hkv, D, page, npages, npool)
    (4, 4, 16, 8, 5, 12),       # MHA
    (8, 2, 16, 8, 5, 12),       # GQA G=4
    (6, 2, 32, 4, 7, 16),       # GQA G=3, odd page count
]


@pytest.mark.parametrize("Hq,Hkv,D,page,npages,npool", CASES)
def test_serial_plain_matches_pallas(Hq, Hkv, D, page, npages, npool):
    q, kp, vp, bt = make_case(0, 5, Hq, Hkv, D, page, npages, npool)
    cl = ragged_ctxs(page, npages)
    o_j, m_j, l_j = paged_attention_pallas(*to_j(q, kp, vp, bt, cl),
                                           return_stats=True, interpret=True)
    o_t, m_t, l_t = pa.paged_attention_kernel(*to_t(q, kp, vp, bt, cl),
                                              return_stats=True)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), atol=ATOL)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), rtol=1e-5)
    # the oracle agrees too (no ctx=0 rows in this grid)
    ref = tref.paged_attention_ref(*to_t(q, kp, vp, bt, cl))
    np.testing.assert_allclose(o_t.numpy(), ref.numpy(), atol=ATOL)


@pytest.mark.parametrize("pages_per_split", [1, 2, 4])
@pytest.mark.parametrize("Hq,Hkv,D,page,npages,npool", CASES)
def test_splitk_plain_matches_pallas(Hq, Hkv, D, page, npages, npool,
                                     pages_per_split):
    q, kp, vp, bt = make_case(1, 5, Hq, Hkv, D, page, npages, npool)
    cl = ragged_ctxs(page, npages)
    o_j = paged_attention_splitk_pallas(*to_j(q, kp, vp, bt, cl),
                                        pages_per_split=pages_per_split,
                                        interpret=True)
    o_t = pa.paged_attention_splitk_kernel(*to_t(q, kp, vp, bt, cl),
                                           pages_per_split=pages_per_split)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL)


def test_splitk_stats_bitwise_m_vs_serial():
    """The split-K combine's m equals the serial m bit for bit; l agrees
    to rounding (the port's two plain versions, as the two kernels)."""
    q, kp, vp, bt = make_case(2, 5, 8, 2, 16, 8, 6, 12)
    cl = ragged_ctxs(8, 6)
    o_s, m_s, l_s = pa.paged_attention_plain(*to_t(q, kp, vp, bt, cl),
                                             return_stats=True)
    for pps in (2, 3):
        o_k, m_k, l_k = pa.paged_attention_splitk_plain(
            *to_t(q, kp, vp, bt, cl), pages_per_split=pps,
            return_stats=True)
        assert torch.equal(m_s, m_k)
        np.testing.assert_allclose(l_s.numpy(), l_k.numpy(), rtol=1e-6)
        np.testing.assert_allclose(o_s.numpy(), o_k.numpy(), atol=ATOL)


def test_ctx_zero_rows_return_exact_zeros():
    q, kp, vp, bt = make_case(3, 5, 4, 4, 16, 8, 4, 8)
    cl = np.asarray([0, 3, 0, 8, 0], np.int32)
    for fn, kw in ((pa.paged_attention_kernel, {}),
                   (pa.paged_attention_splitk_kernel,
                    {"pages_per_split": 2})):
        out = fn(*to_t(q, kp, vp, bt, cl), **kw).numpy()
        assert (out[[0, 2, 4]] == 0).all()
        assert np.abs(out[[1, 3]]).max() > 0
    # the Pallas kernel agrees on every row, zeros included
    o_j = paged_attention_pallas(*to_j(q, kp, vp, bt, cl), interpret=True)
    np.testing.assert_allclose(out, np.asarray(o_j), atol=ATOL)


def test_row_map_matches_pallas_and_per_row_launches():
    q, kp, vp, bt = make_case(4, 5, 8, 2, 16, 8, 5, 12)
    bt = bt[:2]
    rm = np.asarray([0, 0, 0, 1, 1], np.int32)
    cl = np.asarray([3, 17, 1, 40, 33], np.int32)
    o_j = paged_attention_pallas(*to_j(q, kp, vp, bt, cl),
                                 row_map=jnp.asarray(rm), interpret=True)
    qt, kt, vt, btt, clt, rmt = to_t(q, kp, vp, bt, cl, rm)
    for fn, kw in ((pa.paged_attention_kernel, {}),
                   (pa.paged_attention_splitk_kernel,
                    {"pages_per_split": 2})):
        out = fn(qt, kt, vt, btt, clt, row_map=rmt, **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(o_j), atol=ATOL)
        for i in range(5):
            one = fn(qt[i:i + 1], kt, vt, btt[rm[i]:rm[i] + 1],
                     clt[i:i + 1], **kw)
            np.testing.assert_allclose(out[i].numpy(), one[0].numpy(),
                                       atol=1e-6)


def test_int8_pools_match_pallas_and_quant_noise():
    q, kp, vp, bt = make_case(5, 5, 8, 2, 16, 8, 5, 12)
    cl = ragged_ctxs(8, 5)
    kq, ks = jax_quantize_kv(jnp.asarray(kp))
    vq, vs = jax_quantize_kv(jnp.asarray(vp))
    np_q = [np.asarray(a) for a in (kq, ks, vq, vs)]
    ref_fp = tref.paged_attention_ref(*to_t(q, kp, vp, bt, cl)).numpy()
    for pallas, port, kw in (
            (paged_attention_pallas, pa.paged_attention_kernel, {}),
            (paged_attention_splitk_pallas, pa.paged_attention_splitk_kernel,
             {"pages_per_split": 2})):
        o_j = pallas(jnp.asarray(q), kq, vq, jnp.asarray(bt), jnp.asarray(cl),
                     k_scale=ks, v_scale=vs, interpret=True, **kw)
        qt, btt, clt = to_t(q, bt, cl)
        kqt, kst, vqt, vst = (params_from_numpy(a, "cpu") for a in np_q)
        o_t = port(qt, kqt, vqt, btt, clt, k_scale=kst, v_scale=vst, **kw)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL)
        err = np.abs(o_t.numpy() - ref_fp).max()
        assert err < 0.15 * ref_fp.std()


def test_validation_errors():
    q, kp, vp, bt = make_case(6, 2, 4, 4, 16, 8, 3, 6)
    cl = np.asarray([3, 9], np.int32)
    qt, kt, vt, btt, clt = to_t(q, kp, vp, bt, cl)
    q5 = torch.cat([qt, qt[:, :1]], dim=1)                # Hq=5, Hkv=4
    ks = torch.ones(kt.shape[:-1], dtype=torch.bfloat16)
    for fn in (pa.paged_attention_kernel, pa.paged_attention_splitk_kernel,
               pa.paged_attention_plain, pa.paged_attention_splitk_plain):
        with pytest.raises(ValueError, match="group evenly"):
            fn(q5, kt, vt, btt, clt)
        with pytest.raises(ValueError, match="n_pages"):
            fn(qt, kt, vt, btt[:, :0], clt)
        with pytest.raises(ValueError, match="row_map"):
            fn(qt, kt, vt, btt[:1], clt)
        with pytest.raises(ValueError, match="together"):
            fn(qt, kt, vt, btt, clt, k_scale=ks)
    with pytest.raises(ValueError, match="no kernel"):
        pa.paged_attention_kernel(*(t.to("meta") for t in
                                    (qt, kt, vt, btt, clt)))


@pytest.mark.parametrize("width", [7, 8])
def test_ops_dispatch_at_split_k_threshold(width, monkeypatch):
    """Serial below SPLIT_K_THRESHOLD_PAGES, split-K at it, and the
    dispatched result equals the reference ``ops.paged_attention``."""
    assert ops.SPLIT_K_THRESHOLD_PAGES == 8
    assert ops.DEFAULT_PAGES_PER_SPLIT == 4
    q, kp, vp, bt = make_case(9, 3, 4, 2, 16, 4, width, 40)
    cl = np.asarray([1, 4 * width, 4 * width - 5], np.int32)
    called = []
    for name in ("paged_attention_kernel", "paged_attention_splitk_kernel"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _fn=fn, _n=name, **k:
                            called.append(_n) or _fn(*a, **k))
    out = ops.paged_attention(*to_t(q, kp, vp, bt, cl))
    assert called == ["paged_attention_splitk_kernel" if width >= 8
                      else "paged_attention_kernel"]
    o_j = jax_ops_paged_attention(*to_j(q, kp, vp, bt, cl))
    np.testing.assert_allclose(out.numpy(), np.asarray(o_j), atol=ATOL)
