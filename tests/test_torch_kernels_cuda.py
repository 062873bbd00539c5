"""The port's CUDA kernels (paged attention, flash attention, the SSD
scan) against their plain versions, on the card.  Imports only torch and numpy, so it runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Without a GPU every test skips (the CUDA kernels have no CPU mode; their
plain versions are held to the Pallas kernels in
``tests/test_torch_paged_attention.py``, ``test_torch_flash_attention.py``
and ``test_torch_ssd_scan.py``)."""
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


# ---------------------------------------------------------------------------
# flash attention and the SSD scan
# ---------------------------------------------------------------------------
import repro_torch.kernels.flash_attention  # noqa: E402,F401
import repro_torch.kernels.ssd_scan  # noqa: E402,F401

fa = sys.modules["repro_torch.kernels.flash_attention"]
ss = sys.modules["repro_torch.kernels.ssd_scan"]

# kernel vs plain version on the same inputs, |d| <= atol + rtol |plain|:
# both compute in f32 and round once, so bf16 outputs may differ by one
# bf16 step and f32 outputs by summation order only
FLASH_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -7, 1e-5)}
SSD_TOL = {torch.float32: (0.0, 5e-4), torch.bfloat16: (2 ** -7, 1e-4)}


def within(out, plain, tol):
    rtol, atol = tol
    d = (out.float() - plain.float()).abs()
    return bool((d <= atol + rtol * plain.float().abs()).all()), \
        d.max().item()


@pytest.mark.parametrize("S,Hq,Hkv,D,causal,window", [
    (128, 8, 2, 64, True, 0),
    (160, 8, 8, 32, True, 0),
    (96, 4, 1, 64, True, 48),
    (96, 4, 4, 32, False, 0),
    (100, 4, 2, 16, True, 0),               # ragged
    (200, 4, 4, 128, True, 0),
    (130, 2, 2, 128, False, 70),            # windowed, not causal
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, S, Hq, Hkv, D, causal, window,
                                    dtype):
    rng = np.random.default_rng(S + D)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, S, h, D))
                                .astype(np.float32)).to(cuda, dtype)
               for h in (Hq, Hkv, Hkv))
    before = fa.LAUNCHES["flash_attention"]
    out = fa.flash_attention_kernel(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    plain = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype and out.shape == plain.shape
    ok, err = within(out, plain, FLASH_TOL[dtype])
    assert ok, err


@pytest.mark.parametrize("S,H,P,G,N,chunk", [
    (96, 4, 32, 2, 16, 32),
    (100, 2, 16, 1, 8, 32),      # ragged
    (64, 8, 64, 2, 32, 16),
    (300, 4, 64, 1, 128, 128),   # Mamba-2-2.7B's head and state dims
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_kernel_matches_plain(cuda, S, H, P, G, N, chunk, dtype,
                                  with_state):
    rng = np.random.default_rng(S + P)
    x = torch.from_numpy(rng.standard_normal((2, S, H, P)).astype(
        np.float32)).to(cuda, dtype)
    la = -torch.from_numpy(np.abs(rng.standard_normal((2, S, H))).astype(
        np.float32) * 0.1).to(cuda)
    Bm, Cm = (torch.from_numpy(rng.standard_normal((2, S, G, N)).astype(
        np.float32) * 0.3).to(cuda, dtype) for _ in range(2))
    init = None
    if with_state:
        init = torch.from_numpy(rng.standard_normal((2, H, P, N)).astype(
            np.float32)).to(cuda)
    before = dict(ss.LAUNCHES)
    y, st = ss.ssd_scan_kernel(x, la, Bm, Cm, chunk=chunk,
                               initial_state=init)
    torch.cuda.synchronize()
    assert ss.LAUNCHES["ssd_scan"] == before["ssd_scan"] + 1
    variant = ss.VARIANTS[dtype]                 # bf16: mma, f32: fma
    assert ss.LAUNCHES[f"ssd_scan:{variant}"] == \
        before[f"ssd_scan:{variant}"] + 1
    py, pst = ss.ssd_scan_plain(x, la, Bm, Cm, chunk=chunk,
                                initial_state=init)
    assert y.dtype == dtype and st.dtype == torch.float32
    ok, err = within(y, py, SSD_TOL[dtype])
    assert ok, err
    ok, err = within(st, pst, (1e-5, 5e-4))
    assert ok, err


def test_unsupported_dtype_raises_and_runs_no_plain_version(cuda,
                                                            monkeypatch):
    """A CUDA tensor the kernels do not take is refused: the wrapper never
    hands it to the plain version."""
    def boom(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(fa, "flash_attention_plain", boom)
    monkeypatch.setattr(ss, "ssd_scan_plain", boom)
    q = torch.zeros((1, 16, 2, 32), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_kernel(q, q, q)
    x = torch.zeros((1, 16, 2, 16), device=cuda, dtype=torch.float16)
    la = torch.zeros((1, 16, 2), device=cuda)
    bc = torch.zeros((1, 16, 1, 8), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        ss.ssd_scan_kernel(x, la, bc, bc, chunk=16)


# ---------------------------------------------------------------------------
# the tensor-core variants (bf16 queries): ragged mixed launches as the
# paged engine lowers them, and flash attention off the 64-row grid
# ---------------------------------------------------------------------------
BF16_TOL = (2 ** -7, 1e-5)


def mixed_launch(device, segments, pools, *, Hq=4, Hkv=4, D=128, page=16,
                 W=24, seed=20):
    """A ragged launch built from ``segments``: ("chunk", start, length)
    rows of one prefill chunk at positions start .. start + length - 1,
    each attending its causal prefix (ctx = position + 1) over one table
    row; ("decode", ctx) one row over a table row of its own; ("pad", n)
    n rows with ctx 0 over a spare table row."""
    rng = np.random.default_rng(seed)
    ctx, rmap, n_tab = [], [], 0
    for seg in segments:
        if seg[0] == "chunk":
            _, start, length = seg
            ctx += list(range(start + 1, start + length + 1))
            rmap += [n_tab] * length
        elif seg[0] == "decode":
            ctx.append(seg[1])
            rmap.append(n_tab)
        else:
            ctx += [0] * seg[1]
            rmap += [n_tab] * seg[1]
        n_tab += 1
    assert max(ctx) <= W * page
    n_pool = n_tab * W + 1
    q = rng.standard_normal((len(ctx), Hq, D)).astype(np.float32)
    kp = rng.standard_normal((n_pool, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((n_pool, page, Hkv, D)).astype(np.float32)
    bt = rng.permutation(n_pool)[:n_tab * W].reshape(n_tab, W)
    q, kp, vp = (torch.from_numpy(a).to(device, torch.bfloat16)
                 for a in (q, kp, vp))
    bt, cl, rm = (torch.tensor(a, dtype=torch.int32, device=device)
                  for a in (bt, ctx, rmap))
    ks = vs = None
    if pools == "int8":
        (kp, ks), (vp, vs) = quantize_kv(kp), quantize_kv(vp)
    return (q, kp, vp, bt, cl), dict(row_map=rm, k_scale=ks, v_scale=vs)


MIXED = {
    # a later chunk of a prompt: ctx starts at 81, not 1
    "chunk_start_gt0": ([("chunk", 80, 100), ("decode", 200)], {}),
    # two chunks over two table rows, side by side, then decode rows
    "two_chunks": ([("chunk", 0, 70), ("chunk", 33, 90), ("decode", 5),
                    ("decode", 384)], {}),
    # 150 chunk rows from launch row 10 cross the 64-row tiles at 64, 128
    "crosses_tiles": ([("decode", 17), ("chunk", 200, 150)], {}),
    # padding rows with ctx 0 after the chunk and decode rows, GQA G = 4
    "padding_gqa": ([("chunk", 16, 40), ("decode", 33), ("pad", 23)],
                    dict(Hq=8, Hkv=2, D=64)),
    # 2132 rows: the plan kernel stages its 2048-row blocks twice, and
    # the block boundary (launch row 2048) falls inside the chunk
    "over_plan_rows": ([("decode", 100), ("chunk", 0, 2100), ("decode", 900),
                        ("pad", 31)], dict(W=140)),
}


@pytest.mark.parametrize("pools", ["bfloat16", "int8"])
@pytest.mark.parametrize("case", sorted(MIXED))
def test_mma_mixed_launch_matches_plain(cuda, case, pools):
    """Serial and split-K on the tensor cores against their plain versions
    at one bf16 step, m bitwise equal between the two, ctx-0 rows exact
    zeros; each launch counted under the ``mma`` variant."""
    segments, shape = MIXED[case]
    args, kw = mixed_launch(cuda, segments, pools, **shape)
    before = dict(pa.LAUNCHES)
    o_s, m_s, l_s = pa.paged_attention_kernel(*args, return_stats=True, **kw)
    o_k, m_k, l_k = pa.paged_attention_splitk_kernel(
        *args, pages_per_split=4, return_stats=True, **kw)
    torch.cuda.synchronize()
    for name in ("paged_attention", "paged_attention_splitk"):
        assert pa.LAUNCHES[f"{name}:mma"] == before[f"{name}:mma"] + 1
        assert pa.LAUNCHES[f"{name}:fma"] == before[f"{name}:fma"]
    p_s = pa.paged_attention_plain(*args, **kw)
    p_k = pa.paged_attention_splitk_plain(*args, pages_per_split=4, **kw)
    for out, plain in ((o_s, p_s), (o_k, p_k)):
        ok, err = within(out, plain, BF16_TOL)
        assert ok, err
    assert torch.equal(m_s, m_k)
    torch.testing.assert_close(l_s, l_k, atol=0, rtol=1e-5)
    zero = args[4] == 0
    assert (o_s[zero] == 0).all() and (o_k[zero] == 0).all()
    assert (m_s[zero] == -1e30).all() and (l_s[zero] == 0).all()


@pytest.mark.parametrize("S,Hkv,window", [
    (1000, 4, 0),        # ragged: the last q and kv tiles are partial
    (777, 2, 130),       # ragged, windowed, GQA G = 4
    (300, 8, 64),        # the window spans exactly one kv tile
])
def test_mma_flash_ragged_and_windowed(cuda, S, Hkv, window):
    rng = np.random.default_rng(S)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, S, h, 128))
                                .astype(np.float32)).to(cuda, torch.bfloat16)
               for h in (8, Hkv, Hkv))
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention_kernel(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention:mma"] == \
        before["flash_attention:mma"] + 1
    plain = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    ok, err = within(out, plain, FLASH_TOL[torch.bfloat16])
    assert ok, err


# ---------------------------------------------------------------------------
# the SSD scan on the tensor cores (bf16 x): chunks in parallel, the state
# handed from chunk to chunk inside the launch
# ---------------------------------------------------------------------------
def ssd_inputs(device, Bsz, S, H, P, G, N, with_state, seed):
    """bf16 x, B and C, f32 decays as the model makes them (la = -dt A, dt
    log-uniform on [1e-3, 1e-1], A from 1 to H) and an optional f32
    initial state."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bsz, S, H, P))
    dt = np.exp(rng.random((Bsz, S, H)) * np.log(100.0) + np.log(1e-3))
    la = -dt * np.arange(1, H + 1)
    Bm, Cm = (0.3 * rng.standard_normal((Bsz, S, G, N)) for _ in range(2))
    init = rng.standard_normal((Bsz, H, P, N)) if with_state else None
    x, Bm, Cm = (torch.from_numpy(a.astype(np.float32)).to(
        device, torch.bfloat16) for a in (x, Bm, Cm))
    la = torch.from_numpy(la.astype(np.float32)).to(device)
    if init is not None:
        init = torch.from_numpy(init.astype(np.float32)).to(device)
    return x, la, Bm, Cm, init


MMA_SSD = {
    # Mamba-2-2.7B's heads: 10 and 32 chunks chained per head
    "S1280_H80": (1, 1280, 80, 64, 1, 128, 128),
    "S4096_H80": (1, 4096, 80, 64, 1, 128, 128),
    # ragged, and a chunk below 128 that is not a multiple of 16
    "ragged_chunk50": (2, 1001, 8, 64, 1, 128, 50),
    # G > 1; P and N not multiples of 8 (8-byte copies); chunk 40
    "groups_narrow": (2, 257, 6, 12, 3, 20, 40),
    # one chunk shorter than a 16-row tile
    "short": (1, 7, 4, 32, 2, 16, 128),
}


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("case", sorted(MMA_SSD))
def test_mma_ssd_matches_plain(cuda, case, with_state):
    Bsz, S, H, P, G, N, chunk = MMA_SSD[case]
    x, la, Bm, Cm, init = ssd_inputs(cuda, Bsz, S, H, P, G, N, with_state,
                                     seed=S + P)
    before = dict(ss.LAUNCHES)
    y, st = ss.ssd_scan_kernel(x, la, Bm, Cm, chunk=chunk,
                               initial_state=init)
    torch.cuda.synchronize()
    assert ss.LAUNCHES["ssd_scan:mma"] == before["ssd_scan:mma"] + 1
    assert ss.LAUNCHES["ssd_scan:fma"] == before["ssd_scan:fma"]
    py, pst = ss.ssd_scan_plain(x, la, Bm, Cm, chunk=chunk,
                                initial_state=init)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    assert torch.isfinite(y.float()).all() and torch.isfinite(st).all()
    ok, err = within(y, py, SSD_TOL[torch.bfloat16])
    assert ok, err
    ok, err = within(st, pst, (0.0, 5e-4))
    assert ok, err


def test_mma_ssd_back_to_back_calls(cuda):
    """Calls queued without a sync in between, of growing and shrinking
    (batch x heads), share the one workspace: each takes fresh tickets and
    sequence numbers, so no call reads a flag or a slot of another."""
    shapes = [(1, 600, 8, 64, 1, 128, 64), (3, 900, 16, 64, 1, 128, 128),
              (1, 300, 4, 32, 2, 64, 32), (3, 900, 16, 64, 1, 128, 128)]
    calls = [ssd_inputs(cuda, *shape[:6], with_state=i % 2 == 1, seed=i)
             for i, shape in enumerate(shapes)]
    outs = [ss.ssd_scan_kernel(x, la, Bm, Cm, chunk=shape[6],
                               initial_state=init)
            for shape, (x, la, Bm, Cm, init) in zip(shapes, calls)]
    torch.cuda.synchronize()
    for shape, (x, la, Bm, Cm, init), (y, st) in zip(shapes, calls, outs):
        py, pst = ss.ssd_scan_plain(x, la, Bm, Cm, chunk=shape[6],
                                    initial_state=init)
        ok, err = within(y, py, SSD_TOL[torch.bfloat16])
        assert ok, (shape, err)
        ok, err = within(st, pst, (0.0, 5e-4))
        assert ok, (shape, err)


# the slot caches' attention through the paged kernels (models/attention.py)
SLOT_CASES = {"mha_S1280": (8, 1280, 32, 32), "gqa9_S512": (8, 512, 36, 4),
              "gqa4_ring4096": (4, 4096, 32, 8)}


@pytest.mark.parametrize("case", sorted(SLOT_CASES))
def test_slot_decode_attention_takes_no_f32_copy(cuda, case):
    """``decode_attention`` on bf16 slot caches: the paged kernels, no
    full-cache f32 copy (the extra peak memory of the call stays below
    one f32 copy of the caches; the plain version's exceeds it), values
    within the bound of the reference's bf16 rounding of the softmax
    weights (2**-7 relative + 2**-9 max|v|, tests/
    test_torch_slot_attention.py)."""
    from repro_torch.models import attention as A

    B, S, Hq, Hkv = SLOT_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn(B, 1, Hq, 128, generator=g, device=cuda).bfloat16()
    k = torch.randn(B, S, Hkv, 128, generator=g, device=cuda).bfloat16()
    v = torch.randn(B, S, Hkv, 128, generator=g, device=cuda).bfloat16()
    pos = torch.randint(0, S + 64, (B,), generator=g, device=cuda)
    ctx = A._decode_ctx(S, pos)
    f32_copy = 2 * k.numel() * 4
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = pa.LAUNCHES["paged_attention_splitk:mma"]
    out = A.decode_attention(q, k, v, ctx)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert extra < f32_copy, (extra, f32_copy)
    assert pa.LAUNCHES["paged_attention_splitk:mma"] == before + 1
    valid = torch.arange(S, device=cuda)[None] < ctx[:, None]
    torch.cuda.reset_peak_memory_stats()
    plain = A.decode_attention_plain(q, k, v, valid)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base >= f32_copy
    ok, err = within(out, plain, (2 ** -7, 2 ** -9 * float(
        v.float().abs().max())))
    assert ok, err


def test_slot_chunk_attention_matches_plain(cuda):
    """A 512-row prefill chunk of StarCoder2-7B's shape (G = 9) over a
    slot cache, through the paged kernels' tensor-core tiles."""
    from repro_torch.models import attention as A

    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(1, 512, 36, 128, generator=g, device=cuda).bfloat16()
    k = torch.randn(1, 1280, 4, 128, generator=g, device=cuda).bfloat16()
    v = torch.randn(1, 1280, 4, 128, generator=g, device=cuda).bfloat16()
    positions = (300 + torch.arange(512, device=cuda))[None]
    out = A.chunk_attention_paged(q, k, v, positions)
    plain = A.chunk_attention_plain(q, k, v, positions)
    ok, err = within(out, plain, (2 ** -7, 2 ** -9 * float(
        v.float().abs().max())))
    assert ok, err
