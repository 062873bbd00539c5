"""The port's CUDA paged-attention kernels against their plain versions,
on the card.  Imports only torch and numpy, so it runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Without a GPU every test skips (the CUDA kernels have no CPU mode; their
plain versions are held to the Pallas kernels in
``tests/test_torch_paged_attention.py``)."""
import sys

import numpy as np
import pytest
import torch

import repro_torch.kernels.paged_attention  # noqa: F401  (module, not the op)
from repro_torch.models.attention import quantize_kv

pa = sys.modules["repro_torch.kernels.paged_attention"]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def ragged_case(device, pools, seed=10):
    """A ragged row_map launch with ctx-0 rows, GQA G=4, two table rows
    sharing rows, contexts off and on page boundaries."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((6, 8, 32)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((40, 16, 2, 32))
                          .astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((40, 16, 2, 32))
                          .astype(np.float32))
    bt = torch.from_numpy(rng.integers(0, 40, (6, 9)).astype(np.int32))
    cl = torch.tensor([0, 1, 16, 17, 144, 0], dtype=torch.int32)
    rm = torch.tensor([0, 0, 1, 2, 3, 5], dtype=torch.int32)
    q, kp, vp, bt, cl, rm = (t.to(device) for t in (q, kp, vp, bt, cl, rm))
    ks = vs = None
    if pools == "int8":
        (kp, ks), (vp, vs) = quantize_kv(kp), quantize_kv(vp)
    else:
        kp, vp = kp.to(getattr(torch, pools)), vp.to(getattr(torch, pools))
    return (q, kp, vp, bt, cl), dict(row_map=rm, k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("pools", ["float32", "bfloat16", "int8"])
def test_kernels_match_plain(cuda, pools):
    args, kw = ragged_case(cuda, pools)
    before = dict(pa.LAUNCHES)
    o_s, m_s, l_s = pa.paged_attention_kernel(*args, return_stats=True, **kw)
    o_k, m_k, l_k = pa.paged_attention_splitk_kernel(
        *args, pages_per_split=4, return_stats=True, **kw)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_attention"] == before["paged_attention"] + 1
    assert pa.LAUNCHES["paged_attention_splitk"] == \
        before["paged_attention_splitk"] + 1
    p_s, pm, pl = pa.paged_attention_plain(*args, return_stats=True, **kw)
    # f32 queries give f32 outputs for every pool type: both sides
    # dequantize and compute in f32, so they differ by summation order only
    torch.testing.assert_close(o_s, p_s, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(o_k, p_s, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(l_s, pl, atol=0, rtol=1e-5)
    assert torch.equal(m_s, m_k)
    zero = args[4] == 0
    assert (o_s[zero] == 0).all() and (o_k[zero] == 0).all()


def test_bf16_queries(cuda):
    args, kw = ragged_case(cuda, "bfloat16")
    q = args[0].to(torch.bfloat16)
    out = pa.paged_attention_kernel(q, *args[1:], **kw)
    plain = pa.paged_attention_plain(q, *args[1:], **kw)
    assert out.dtype == torch.bfloat16
    # both round the same f32 result once to bf16: one bf16 step apart
    torch.testing.assert_close(out.float(), plain.float(), atol=1e-5,
                               rtol=2 ** -7)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    args, kw = ragged_case(cuda, "float32")
    q, kp, vp, bt, cl = args
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention_kernel(q, kp, vp, bt.long(), cl, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention_kernel(q.transpose(0, 1).contiguous()
                                  .transpose(0, 1), kp, vp, bt, cl, **kw)
    with pytest.raises(ValueError, match="pools"):
        pa.paged_attention_kernel(q, kp, vp.half(), bt, cl, **kw)
