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


def test_f32_kernels_at_head_dim_256(cuda):
    """The FMA kernels loop over D: RecurrentGemma-2B's G = 10 at D = 256
    in f32 holds 1e-5, serial and split-K."""
    args, kw = mixed_launch(cuda, [("decode", 300), ("chunk", 10, 30)],
                            "bfloat16", Hq=10, Hkv=1, D=256)
    args = tuple(t.float() if t.is_floating_point() else t for t in args)
    o_s = pa.paged_attention_kernel(*args, **kw)
    o_k = pa.paged_attention_splitk_kernel(*args, pages_per_split=4, **kw)
    torch.cuda.synchronize()
    plain = pa.paged_attention_plain(*args, **kw)
    torch.testing.assert_close(o_s, plain, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(o_k, plain, atol=1e-5, rtol=1e-5)


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
    # (Sq, Skv): Whisper's cross-attention (prompt rows over 1500 frames),
    # more rows than keys, a causal window aligned top-left
    ((64, 1500), 4, 4, 64, False, 0),
    ((20, 75), 4, 2, 64, True, 8),
    ((75, 20), 4, 2, 32, True, 0),
    ((100, 70), 4, 4, 64, False, 40),       # rows 70..99 see the tail only
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, S, Hq, Hkv, D, causal, window,
                                    dtype):
    Sq, Skv = S if isinstance(S, tuple) else (S, S)
    rng = np.random.default_rng(Sq + Skv + D)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, n, h, D))
                                .astype(np.float32)).to(cuda, dtype)
               for n, h in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))
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
    # the f32 kernel's tiles are 128 wide; bf16 takes 256, and nothing wider
    q = torch.zeros((1, 16, 2, 256), device=cuda)
    with pytest.raises(ValueError, match=r"\[4, 128\] for torch.float32"):
        fa.flash_attention_kernel(q, q, q)
    q = torch.zeros((1, 16, 2, 264), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"\[8, 256\]"):
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
    # head dim 256 (RecurrentGemma-2B: 10 query heads over one kv head):
    # Q in shared memory, two page steps in flight
    "d256_gqa10": ([("chunk", 0, 90), ("decode", 300), ("decode", 17),
                    ("pad", 5)], dict(Hq=10, Hkv=1, D=256)),
    # head dim 256, MHA: decode rows take the one-row walk, two columns a
    # thread
    "d256_mha": ([("decode", 200), ("decode", 33), ("chunk", 5, 20)],
                 dict(Hq=2, Hkv=2, D=256)),
    # head dims below 128 over more than 32 splits: the combine's lanes
    # past Dv relay the split weights of its shuffles (Whisper large-v3's
    # decode: Dv = 64, 94 splits over its 1500 frames)
    "d64_mha_many_splits": ([("decode", 2500), ("decode", 700)],
                            dict(Hq=2, Hkv=2, D=64, W=160)),
    "d32_gqa_many_splits": ([("decode", 2000), ("chunk", 0, 30)],
                            dict(Hq=8, Hkv=2, D=32, W=160)),
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
    check_mma_flash(cuda, S, 8, Hkv, 128, window)


@pytest.mark.parametrize("S,window", [
    (1000, 0),          # ragged, inside no window
    (777, 300),         # ragged, the window shorter than S
])
def test_mma_flash_head_dim_256(cuda, S, window):
    """RecurrentGemma-2B's prefill shape: 10 query heads over one kv head
    of 256, Q in shared memory, one block per SM."""
    check_mma_flash(cuda, S, 10, 1, 256, window)


def check_mma_flash(cuda, S, Hq, Hkv, D, window):
    rng = np.random.default_rng(S)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, S, h, D))
                                .astype(np.float32)).to(cuda, torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
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


@pytest.mark.parametrize("T,page", [(1500, 4), (448, 16)])
def test_whisper_decode_attention_through_split_k(cuda, T, page):
    """Whisper large-v3's decode shapes (20 heads of 64, 8 rows): the
    cross-attention over 1500 frames viewed as 375 pages of 4 (a 64-key
    step of the tensor-core walk spans 16 pages), and the self-attention
    over 448 slots, 28 pages of 16; every row attends all T slots, one
    split-K launch, against the naive attention (softmax weights in f32
    on both sides)."""
    from repro_torch.models import attention as A

    g = torch.Generator(device=cuda).manual_seed(T)
    q = torch.randn(8, 1, 20, 64, generator=g, device=cuda).bfloat16()
    k = torch.randn(8, T, 20, 64, generator=g, device=cuda).bfloat16()
    v = torch.randn(8, T, 20, 64, generator=g, device=cuda).bfloat16()
    assert np.gcd(T, 16) == page
    before = pa.LAUNCHES["paged_attention_splitk:mma"]
    out = A.cross_decode_attention(q, k, v)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_attention_splitk:mma"] == before + 1
    want = A.naive_attention(q, k, v, causal=False)
    ok, err = within(out, want, (2 ** -7, 2 ** -9 * float(
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


@pytest.mark.parametrize("S", [256, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_mla_head_dims(cuda, S, dtype):
    """MLA prefill's shape (MiniCPM3-4B: D = 96 for q and k, Dv = 64 for
    v, Hq = Hkv): the bf16 tile is 128 wide, so columns 96-127 of Q/K and
    64-127 of V are zero-filled and the store keeps to Dv."""
    rng = np.random.default_rng(S)
    q, k = (torch.from_numpy(rng.standard_normal((1, S, 8, 96))
                             .astype(np.float32)).to(cuda, dtype)
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((1, S, 8, 64))
                         .astype(np.float32)).to(cuda, dtype)
    before = fa.LAUNCHES["flash_attention"]
    out = fa.flash_attention_kernel(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    plain = fa.flash_attention_plain(q, k, v, causal=True)
    assert out.shape == (1, S, 8, 64) and out.dtype == dtype
    ok, err = within(out, plain, FLASH_TOL[dtype])
    assert ok, err


def test_slot_decode_attention_int8(cuda):
    """``decode_attention`` on int8 slot caches with their bf16 scales
    (``cfg.kv_quant``): the split-K kernel over int8 pools (counted under
    ``/int8``), within one bf16 step of the kernels' plain version on the
    same view, within 2**-7 |ref| + 2 x 2**-9 max|v| of the reference's
    route (the plain version, each dequantized value and weight rounded to
    bf16) and outside it with the last valid slot dropped, and less extra
    memory than one bf16 copy of the caches."""
    from repro_torch.models import attention as A

    B, S, H, D = 8, 1280, 32, 128
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(B, 1, H, D, generator=g, device=cuda).bfloat16()
    (k, ks), (v, vs) = (A.quantize_kv(torch.randn(
        B, S, H, D, generator=g, device=cuda).bfloat16()) for _ in range(2))
    ctx = A._decode_ctx(S, torch.randint(0, S, (B,), generator=g,
                                         device=cuda))
    bf16_copy = 2 * k.numel() * 2
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = pa.LAUNCHES["paged_attention_splitk/int8"]
    out = A.decode_attention(q, k, v, ctx, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < bf16_copy
    assert pa.LAUNCHES["paged_attention_splitk/int8"] == before + 1
    page = 16
    tables = torch.arange(B * S // page, dtype=torch.int32,
                          device=cuda).view(B, -1)
    same = pa.paged_attention_splitk_plain(
        q[:, 0], k.view(-1, page, H, D), v.view(-1, page, H, D), tables,
        ctx.to(torch.int32), k_scale=ks.view(-1, page, H),
        v_scale=vs.view(-1, page, H))
    ok, err = within(out[:, 0], same, FLASH_TOL[torch.bfloat16])
    assert ok, err
    valid = torch.arange(S, device=cuda)[None] < ctx[:, None]
    ref = A.decode_attention_plain(q, k, v, valid, k_scale=ks, v_scale=vs)
    vmax = (v.float().abs().amax(-1) * vs.float())[valid].max().item()
    ok, err = within(out, ref, (2 ** -7, 2 * 2 ** -9 * vmax))
    assert ok, err
    dropped = A.decode_attention(q, k, v, (ctx - 1).clamp(min=1),
                                 k_scale=ks, v_scale=vs)
    ok, err = within(dropped, ref, (2 ** -7, 2 * 2 ** -9 * vmax))
    assert not ok, err


def test_mla_latent_attention_bmm(cuda):
    """MLA's absorbed decode products at MiniCPM3-4B's shape (8 slots of
    1280, 40 heads, latent 256, rotary 32): ``torch.bmm`` with f32
    outputs over the bf16 cache in place, against the plain version (f32
    products over f32 copies; the weights rounded to bf16 in both, so a
    weight whose f32 value moves in the last bits may round the other
    way: 2**-8 max|c|); less extra memory than one f32 copy of ``c``."""
    from repro_torch.models import attention as A

    B, S, H, r, dr = 8, 1280, 40, 256, 32
    g = torch.Generator(device=cuda).manual_seed(6)
    q_lat = torch.randn(B, 1, H, r, generator=g, device=cuda).bfloat16()
    q_rope = torch.randn(B, 1, H, dr, generator=g, device=cuda).bfloat16()
    c = torch.randn(B, S, r, generator=g, device=cuda).bfloat16()
    kr = torch.randn(B, S, dr, generator=g, device=cuda).bfloat16()
    ctx = torch.randint(1, S + 1, (B,), generator=g, device=cuda)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = A.mla_decode_attention(q_lat, q_rope, c, kr, ctx, 96 ** -0.5)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < c.numel() * 4
    plain = A.mla_decode_attention_plain(q_lat, q_rope, c, kr, ctx,
                                         96 ** -0.5)
    assert out.dtype == torch.float32 and out.shape == plain.shape
    ok, err = within(out, plain, (1e-5, 2 ** -8 * float(
        c.float().abs().max())))
    assert ok, err


# ---------------------------------------------------------------------------
# the flash backward (csrc/flash_attention_bwd.cu) and the forward's lse
# ---------------------------------------------------------------------------
# f32: both sides sum in f32 in other orders, max |kernel - plain| within
# 1e-4 of the largest |plain|; bf16: the kernel's products take the bf16
# inputs exactly and P and dS as hi + lo bf16 terms (16 significant bits;
# tests/test_torch_bwd_tile_numerics.py), both sides sum in f32 and round
# once, so within one bf16 step of the largest |plain|
BWD_REL = {torch.float32: 1e-4}
LSE_TOL = 2e-5                   # f32 lse: |kernel - plain| <= tol (1 + |lse|)


def bf16_step(x):
    """One bf16 step (unit in the last place) at the largest |x|."""
    return 2.0 ** (np.floor(np.log2(x.float().abs().max().item())) - 7)


def bwd_within(got, want):
    d = (got.float() - want.float()).abs().max().item()
    if got.dtype == torch.bfloat16:
        return d <= bf16_step(want), d / bf16_step(want)
    return d <= BWD_REL[got.dtype] * want.float().abs().max().item(), \
        d / want.float().abs().max().item()


def bwd_case(device, Sq, Skv, Hq, Hkv, D, Dv, dtype, seed, B=2):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, n, h, d))
                                    .astype(np.float32)).to(device, dtype)
                   for n, h, d in ((Sq, Hq, D), (Skv, Hkv, D), (Skv, Hkv, Dv),
                                   (Sq, Hq, Dv)))
    return q, k, v, do


@pytest.mark.parametrize("S,Hq,Hkv,D,Dv,causal,window", [
    (256, 8, 2, 64, 64, True, 0),            # Granite-3-2B's G = 4, D = 64
    (200, 8, 1, 128, 128, True, 0),          # ragged, G = 8, D = 128
    (130, 9, 1, 32, 32, True, 40),           # StarCoder2's G = 9, windowed
    (100, 4, 4, 96, 64, True, 0),            # D != Dv (MLA's 96 / 64)
    (96, 4, 2, 64, 64, False, 0),            # full
    (150, 4, 2, 64, 64, False, 33),          # windowed, not causal
    ((64, 300), 4, 4, 64, 64, False, 0),     # Sq < Skv (cross-attention)
    ((90, 40), 4, 2, 32, 32, True, 0),       # Sq > Skv
    (300, 10, 1, 256, 256, True, 128),       # RecurrentGemma's G = 10, D = 256,
                                             # S past the window
    ((100, 170), 4, 2, 256, 256, False, 0),  # D = 256, full, Sq != Skv
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernel_matches_plain(cuda, S, Hq, Hkv, D, Dv, causal,
                                             window, dtype):
    """The kernel against its plain version, both fed the forward kernel's
    output and lse; f32 past head dim 128 (D = 256) is refused by name."""
    Sq, Skv = S if isinstance(S, tuple) else (S, S)
    q, k, v, do = bwd_case(cuda, Sq, Skv, Hq, Hkv, D, Dv, dtype, Sq + D)
    if max(D, Dv) > fa.MAX_BWD_HEAD_DIM[dtype]:
        with pytest.raises(ValueError, match="above 128"):
            fa.flash_attention_bwd_kernel(q, k, v, do, torch.zeros(
                do.shape[:3], device=cuda), do, causal=causal, window=window)
        return
    out, lse = fa.flash_attention_kernel(q, k, v, causal=causal,
                                         window=window, return_lse=True)
    p_out, p_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window, return_lse=True)
    before = dict(fa.LAUNCHES)
    grads = fa.flash_attention_bwd_kernel(q, k, v, out, lse, do,
                                          causal=causal, window=window)
    torch.cuda.synchronize()
    variant = "mma" if dtype == torch.bfloat16 else "fma"
    assert fa.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    assert fa.LAUNCHES[f"flash_attention_bwd:{variant}"] == \
        before[f"flash_attention_bwd:{variant}"] + 1
    assert (lse - p_lse).abs().max().item() <= \
        LSE_TOL * (1 + p_lse.abs().max().item())
    plain = fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                         causal=causal, window=window)
    for name, got, want in zip(("dq", "dk", "dv"), grads, plain):
        assert got.dtype == dtype and got.shape == want.shape, name
        ok, ratio = bwd_within(got, want)
        assert ok, (name, ratio)


def test_flash_autograd_through_the_kernels(cuda):
    """The autograd Function on CUDA tensors launches the forward (with
    lse) and the backward kernel, and its gradients are the plain
    versions'."""
    q, k, v, do = bwd_case(cuda, 192, 192, 8, 2, 64, 64, torch.float32, 3)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention_train(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert fa.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    with torch.no_grad():
        p_out, p_lse = fa.flash_attention_plain(q, k, v, return_lse=True)
        plain = fa.flash_attention_bwd_plain(q, k, v, p_out, p_lse, do)
    for got, want in zip(grads, plain):
        ok, ratio = bwd_within(got, want)
        assert ok, ratio


def test_flash_backward_bf16_repeats_bit_for_bit(cuda):
    """No atomics: two calls of the bf16 backward on the same inputs give
    the same bits (run P's G = 4 at D = 64, and G = 10 at D = 256 with a
    window)."""
    for S, Hq, Hkv, D, window in ((512, 8, 2, 64, 0), (300, 10, 1, 256, 128)):
        q, k, v, do = bwd_case(cuda, S, S, Hq, Hkv, D, D, torch.bfloat16, 7)
        out, lse = fa.flash_attention_kernel(q, k, v, causal=True,
                                             window=window, return_lse=True)
        first = fa.flash_attention_bwd_kernel(q, k, v, out, lse, do,
                                              causal=True, window=window)
        again = fa.flash_attention_bwd_kernel(q, k, v, out, lse, do,
                                              causal=True, window=window)
        torch.cuda.synchronize()
        for a, b in zip(first, again):
            assert torch.equal(a, b), (S, D)


def test_flash_backward_refuses_and_runs_no_plain_version(cuda,
                                                          monkeypatch):
    """Head dims past a variant's tiles are refused by name: f32 above 128
    (the FMA kernels), bf16 above 256 (the tensor-core tiles); the plain
    version never runs on a CUDA tensor."""
    def boom(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(fa, "flash_attention_bwd_plain", boom)
    lse = torch.zeros((1, 16, 2), device=cuda)
    q = torch.zeros((1, 16, 2, 256), device=cuda, dtype=torch.float32)
    with pytest.raises(ValueError, match="above 128"):
        fa.flash_attention_bwd_kernel(q, q, q, q, lse, q)
    q = torch.zeros((1, 16, 2, 264), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="above 256"):
        fa.flash_attention_bwd_kernel(q, q, q, q, lse, q)
    q = torch.zeros((1, 16, 2, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_bwd_kernel(q, q, q, q, lse, q)


# ---------------------------------------------------------------------------
# the SSD scan's backward (csrc/ssd_scan_bwd.cu): bf16 on the tensor cores
# (``mma``), f32 on the FMA units (``fma_f32``)
# ---------------------------------------------------------------------------
# kernel vs plain backward, each gradient's max |d| within a share of its
# largest |plain|: f32 sums in other orders and compensated la_cum (1e-4);
# bf16 dx, dB, dC rounded once each (2**-7: one bf16 step at the top)
SSD_BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}
SSD_BWD = {
    # (B, S, H, P, G, N, chunk, with initial state, with dstate)
    "mamba2_heads": (1, 300, 80, 64, 1, 128, 128, False, False),
    "ragged_init_dstate": (2, 1001, 8, 64, 1, 128, 128, True, True),
    "groups_chunk50": (2, 257, 6, 12, 3, 20, 50, True, False),
    "chunk_past_S": (1, 40, 4, 32, 2, 16, 128, False, True),
    "short_chunk16": (2, 70, 4, 16, 4, 8, 16, True, True),
    # the narrowest shapes, one position a chunk; widths that are not
    # multiples of 8 (8-byte copies) at a chunk of 100
    "tiny_p4_n4_chunk1": (1, 5, 2, 4, 1, 4, 1, True, True),
    "p60_n124_chunk100": (1, 333, 4, 60, 2, 124, 100, True, True),
}


def ssd_bwd_inputs(device, dtype, Bsz, S, H, P, G, N, with_state,
                   with_dstate, seed):
    """x, B, C, dy in ``dtype`` and f32 decays as ``ssd_inputs`` draws
    them; an optional initial state and dstate, f32 unit normals."""
    rng = np.random.default_rng(seed)
    x, dy = (rng.standard_normal((Bsz, S, H, P)) for _ in range(2))
    dt = np.exp(rng.random((Bsz, S, H)) * np.log(100.0) + np.log(1e-3))
    la = -dt * np.arange(1, H + 1)
    Bm, Cm = (0.3 * rng.standard_normal((Bsz, S, G, N)) for _ in range(2))
    init, dstate = (rng.standard_normal((Bsz, H, P, N)) if on else None
                    for on in (with_state, with_dstate))
    x, dy, Bm, Cm = (torch.from_numpy(a.astype(np.float32)).to(device, dtype)
                     for a in (x, dy, Bm, Cm))
    la, init, dstate = (None if a is None else torch.from_numpy(
        a.astype(np.float32)).to(device) for a in (la, init, dstate))
    return x, la, Bm, Cm, dy, init, dstate


def ssd_bwd_ratios(got, want, dtype):
    """Each gradient's max |got - want| over SSD_BWD_REL of its largest
    |want| (at most 1 within tolerance)."""
    out = []
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.isfinite(g.float()).all()
        top = max(w.float().abs().max().item(), 1e-30)
        out.append((g.float() - w.float()).abs().max().item()
                   / (SSD_BWD_REL[dtype] * top))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(SSD_BWD))
def test_ssd_backward_kernel_matches_plain(cuda, case, dtype):
    Bsz, S, H, P, G, N, chunk, with_state, with_dstate = SSD_BWD[case]
    x, la, Bm, Cm, dy, init, dstate = ssd_bwd_inputs(
        cuda, dtype, Bsz, S, H, P, G, N, with_state, with_dstate, S + P)
    _, _, cs = ss.ssd_scan_kernel(x, la, Bm, Cm, chunk=chunk,
                                  initial_state=init,
                                  return_chunk_states=True)
    _, _, p_cs = ss.ssd_scan_plain(x, la, Bm, Cm, chunk=chunk,
                                   initial_state=init,
                                   return_chunk_states=True)
    ok, err = within(cs, p_cs, (0.0, 5e-4))
    assert ok, err
    before = dict(ss.LAUNCHES)
    got = ss.ssd_scan_bwd_kernel(x, la, Bm, Cm, dy, dstate, chunk=chunk,
                                 initial_state=init, chunk_states=cs)
    torch.cuda.synchronize()
    variant = ss.BWD_VARIANTS[dtype]
    assert ss.LAUNCHES["ssd_scan_bwd"] == before["ssd_scan_bwd"] + 1
    assert ss.LAUNCHES[f"ssd_scan_bwd:{variant}"] == \
        before[f"ssd_scan_bwd:{variant}"] + 1
    assert ss.LAUNCHES["ssd_scan"] == before["ssd_scan"]
    want = ss.ssd_scan_bwd_plain(x, la, Bm, Cm, dy, dstate, chunk=chunk,
                                 initial_state=init)
    ratios = ssd_bwd_ratios(got, want, dtype)
    assert max(ratios) <= 1, dict(zip(("dx", "dla", "dB", "dC", "dinit"),
                                      ratios))


def test_ssd_backward_launch_counts_per_variant(cuda):
    """One call, one count under its input type's variant and none under
    the other's; the forward's counts do not move."""
    for dtype in (torch.bfloat16, torch.float32, torch.bfloat16):
        x, la, Bm, Cm, dy, _, _ = ssd_bwd_inputs(
            cuda, dtype, 1, 64, 4, 16, 1, 8, False, False, 1)
        _, _, cs = ss.ssd_scan_kernel(x, la, Bm, Cm, chunk=32,
                                      return_chunk_states=True)
        before = dict(ss.LAUNCHES)
        ss.ssd_scan_bwd_kernel(x, la, Bm, Cm, dy, None, chunk=32,
                               chunk_states=cs)
        torch.cuda.synchronize()
        moved = {k: ss.LAUNCHES[k] - before[k] for k in ss.LAUNCHES
                 if ss.LAUNCHES[k] != before[k]}
        assert moved == {"ssd_scan_bwd": 1,
                         f"ssd_scan_bwd:{ss.BWD_VARIANTS[dtype]}": 1}


def test_ssd_autograd_runs_no_plain_version(cuda, monkeypatch):
    """Autograd through the SSD scan on CUDA tensors launches the forward
    kernel (writing the chunk states) and the backward kernel, with both
    plain versions made to raise; its gradients are the plain backward's,
    and the backward refuses what it does not take."""
    x, la, Bm, Cm, dy, init, dstate = ssd_bwd_inputs(
        cuda, torch.bfloat16, 2, 200, 8, 64, 2, 32, True, True, 5)
    want = ss.ssd_scan_bwd_plain(x, la, Bm, Cm, dy, dstate, chunk=64,
                                 initial_state=init)

    def boom(*a, **k):
        raise AssertionError("a plain version ran on a CUDA tensor")

    monkeypatch.setattr(ss, "ssd_scan_plain", boom)
    monkeypatch.setattr(ss, "ssd_scan_bwd_plain", boom)
    leaves = [t.detach().requires_grad_() for t in (x, la, Bm, Cm, init)]
    before = dict(ss.LAUNCHES)
    y, st = ss.ssd_scan_train(*leaves[:4], chunk=64, initial_state=leaves[4])
    got = torch.autograd.grad((y, st), leaves, (dy, dstate))
    torch.cuda.synchronize()
    assert ss.LAUNCHES["ssd_scan:mma"] == before["ssd_scan:mma"] + 1
    assert ss.LAUNCHES["ssd_scan_bwd:mma"] == \
        before["ssd_scan_bwd:mma"] + 1
    assert max(ssd_bwd_ratios(got, want, torch.bfloat16)) <= 1
    with pytest.raises(ValueError, match="chunk_states"):
        ss.ssd_scan_bwd_kernel(x, la, Bm, Cm, dy, None, chunk=64)
    with pytest.raises(ValueError, match="dy must be"):
        ss.ssd_scan_bwd_kernel(x, la, Bm, Cm, dy.float(), None, chunk=64)


@pytest.mark.parametrize("case", sorted(SSD_BWD))
def test_ssd_backward_bf16_launches_no_fma_variant(cuda, case):
    """Every shape the backward takes in bf16 (chunks up to 128, P up to
    64 and N up to 128 in multiples of 4, G | H, a ragged tail) goes to
    the tensor-core kernels: no FMA variant's count moves."""
    Bsz, S, H, P, G, N, chunk, with_state, with_dstate = SSD_BWD[case]
    x, la, Bm, Cm, dy, init, dstate = ssd_bwd_inputs(
        cuda, torch.bfloat16, Bsz, S, H, P, G, N, with_state, with_dstate,
        3)
    _, _, cs = ss.ssd_scan_kernel(x, la, Bm, Cm, chunk=chunk,
                                  initial_state=init,
                                  return_chunk_states=True)
    before = dict(ss.LAUNCHES)
    ss.ssd_scan_bwd_kernel(x, la, Bm, Cm, dy, dstate, chunk=chunk,
                           initial_state=init, chunk_states=cs)
    torch.cuda.synchronize()
    moved = {k: ss.LAUNCHES[k] - before[k] for k in ss.LAUNCHES
             if ss.LAUNCHES[k] != before[k]}
    assert moved == {"ssd_scan_bwd": 1, "ssd_scan_bwd:mma": 1}


def test_ssd_backward_mma_attrs(cuda):
    """The bf16 backward's chunk kernel as its source note states it: no
    spills, two blocks an SM (at most 255 registers and ~113 KB of shared
    memory a block); the inject kernel spills nothing either."""
    a = ss.bwd_mma_attrs()
    assert a["spill_bytes"] == 0 and a["inject_spill_bytes"] == 0, a
    assert a["blocks_per_sm"] == 2, a
    assert a["registers"] <= 255 and a["smem_bytes"] <= 113 * 1024, a


def test_ssd_backward_bf16_repeats_bit_for_bit(cuda):
    """No atomics: two backward calls on one input give the same bits, dB
    and dC summed over 80 heads of one group included."""
    x, la, Bm, Cm, dy, _, _ = ssd_bwd_inputs(
        cuda, torch.bfloat16, 2, 520, 80, 64, 1, 128, False, False, 9)
    _, _, cs = ss.ssd_scan_kernel(x, la, Bm, Cm, chunk=128,
                                  return_chunk_states=True)
    first = ss.ssd_scan_bwd_kernel(x, la, Bm, Cm, dy, None, chunk=128,
                                   chunk_states=cs)
    again = ss.ssd_scan_bwd_kernel(x, la, Bm, Cm, dy, None, chunk=128,
                                   chunk_states=cs)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_serving_prefill_launches_no_backward(cuda, monkeypatch):
    """A Mamba-2 prefill without a gradient (serving) launches the
    forward kernel once a layer, asks it for no chunk states and launches
    no backward."""
    from repro_torch.configs import SMOKE_FACTORIES
    from repro_torch.models import model as tm
    from repro_torch.weights import init_params

    asked = []
    cuda_fwd = ss._ssd_cuda

    def spy(*args, **kw):
        asked.append(args[6] if len(args) > 6 else kw.get("chunk_states",
                                                          False))
        return cuda_fwd(*args, **kw)

    monkeypatch.setattr(ss, "_ssd_cuda", spy)
    cfg = SMOKE_FACTORIES["mamba2-2.7b"]()
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda)
    before = dict(ss.LAUNCHES)
    logits, _ = tm.prefill(params, {"tokens": tokens}, cfg, max_len=64)
    torch.cuda.synchronize()
    assert torch.isfinite(logits.float()).all()
    assert asked == [False] * cfg.n_layers
    assert ss.LAUNCHES["ssd_scan"] == before["ssd_scan"] + cfg.n_layers
    assert ss.LAUNCHES["ssd_scan_bwd"] == before["ssd_scan_bwd"]
