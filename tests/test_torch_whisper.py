"""The port's Whisper large-v3 (``repro_torch.models.model`` with
``is_encoder_decoder``) against ``repro.models`` on the smoke config (2
encoder + 2 decoder layers, d_model 128, 4 heads of 32, GELU MLP) with
``attn_impl="flash"``, so the flash kernel's plain version runs at Sq !=
Skv in every decoder layer's cross-attention, and weights bridged with
``params_from_numpy``; on the CPU.  Frames are (B, T, d) standard
normal, drawn with numpy as ``tests/test_decode_consistency.py`` draws
them.

- The bridge carries the reference's tree bit for bit, and the port's
  ``init_params`` draws a tree of the same keys, shapes and dtypes
  (``ln_cross``/``cross`` in every decoder layer, ``enc.{stages.stage_0,
  final_norm}``); ``init_cache`` builds the reference's caches,
  ``cross_k``/``cross_v`` of ``enc_len`` frames included.
- f32: ``encode``, ``prefill`` logits and caches, and three
  ``decode_step``s (their cross-attention over the cached frames) within
  1e-5 of the largest reference value; a decode batch of rows at
  different positions too.
- bf16: not bit-equal, with the reference's GELU rounding emulated
  (``gelu_rounded_per_op``) or not: XLA:CPU's bf16 products round other
  elements than torch's (the first MLP product of the encoder's first
  layer differs by one bf16 step), and each such step travels through
  the stack.  Logits stay within 2 bf16 steps (2 x 2**-7) of the largest
  |logit| (measured: at most 0.79 steps over 4 weight seeds), the
  encoder's output and the caches within 3 (measured: at most 1.69).
- The port alone, f32: prefill(S - 1) then one decode step equals
  prefill(S) within 1e-4.
- The serving engine refuses encoder-decoder stacks by name, on both
  backends (its requests carry no frames).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import SMOKE_FACTORIES
from repro.models import decode_step as j_decode
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro.models.model import encode as j_encode
from repro_torch.configs import SMOKE_FACTORIES as T_SMOKE
from repro_torch.models import model as tm
from repro_torch.weights import init_params, params_from_numpy
from test_torch_rglru import gelu_rounded_per_op

ARCH = "whisper-large-v3"
F32_TOL = 1e-5
BF16_STEP = 2 ** -7
B, T = 2, 16

_MODELS = {}


def model(dtype):
    """(jax cfg, port cfg, jax params, port params) at ``dtype``."""
    if dtype not in _MODELS:
        jcfg, tcfg = (dataclasses.replace(f[ARCH](), attn_impl="flash",
                                          dtype=dtype)
                      for f in (SMOKE_FACTORIES, T_SMOKE))
        jp = j_init_params(jax.random.key(7), jcfg)
        _MODELS[dtype] = (jcfg, tcfg, jp,
                          params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu"))
    return _MODELS[dtype]


def batch(cfg, S, seed):
    """Tokens and frames drawn with numpy; (jax batch, torch batch)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
            {"tokens": torch.from_numpy(toks),
             "frames": torch.from_numpy(frames)})


def f32(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor)
                      else a, np.float32)


def assert_close(got, want, tol):
    """Within ``tol`` of the largest |want|."""
    want = f32(want)
    np.testing.assert_allclose(f32(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


def assert_caches(tcache, jcache, tol):
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for key, stage in jcache["stages"].items():
        assert tcache["stages"][key].keys() == stage.keys()
        for name, want in stage.items():
            got = tcache["stages"][key][name]
            assert tuple(got.shape) == want.shape, name
            assert_close(got, want, tol)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def test_params_bridge_bit_for_bit_and_init_draws_the_same_tree():
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg, jp, tp = model(dtype)
        want = dict(_leaves(jax.tree.map(np.asarray, jp)))
        got = dict(_leaves(tp))
        assert got.keys() == want.keys()
        assert "enc.stages.stage_0.attn.wq" in got
        assert "stages.stage_0.cross.wo" in got
        for name, a in want.items():
            t = got[name]
            assert tuple(t.shape) == a.shape, name
            bits = t.view(torch.int16) if t.dtype == torch.bfloat16 \
                else t.view(torch.int32)
            np.testing.assert_array_equal(bits.numpy(), a.view(
                bits.numpy().dtype), err_msg=name)
        drawn = dict(_leaves(init_params(tcfg, torch.Generator().manual_seed(
            0), "cpu")))
        assert drawn.keys() == got.keys()
        for name, t in drawn.items():
            assert (t.shape, t.dtype) == (got[name].shape, got[name].dtype), \
                name
            assert torch.isfinite(t.float()).all(), name


def test_init_cache_matches_reference_shapes():
    jcfg, tcfg, _, _ = model("float32")
    jc = j_init_cache(jcfg, B, 32, enc_len=T)
    tc = tm.init_cache(tcfg, B, 32, device="cpu", enc_len=T)
    assert tc["stages"].keys() == jc["stages"].keys()
    for key, stage in jc["stages"].items():
        assert tc["stages"][key].keys() == stage.keys() == {
            "k", "v", "cross_k", "cross_v"}
        for name, want in stage.items():
            got = tc["stages"][key][name]
            assert (tuple(got.shape), str(got.dtype).split(".")[-1]) == \
                (want.shape, str(want.dtype)), name
    assert tc["stages"]["stage_0"]["cross_k"].shape == (
        tcfg.n_layers, B, T, tcfg.n_heads, tcfg.resolved_head_dim())
    # ``pos`` keeps its place: enc_len is keyword-only
    assert (tm.init_cache(tcfg, B, 32, 5, device="cpu")["pos"] == 5).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_reference(dtype):
    jcfg, tcfg, jp, tp = model(dtype)
    jb, tb = batch(jcfg, 9, seed=1)
    want = j_encode(jp, jb["frames"], jcfg)
    got = tm.encode(tp, tb["frames"], tcfg)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == \
        want.shape == (B, T, jcfg.d_model)
    assert_close(got, want, F32_TOL if dtype == "float32" else 3 * BF16_STEP)


def run_prefill_decode(dtype, S, seed):
    """Prefill then three decode steps on both sides; yields (port logits,
    reference logits, port cache, reference cache) after each call."""
    jcfg, tcfg, jp, tp = model(dtype)
    jb, tb = batch(jcfg, S, seed)
    jl, jc = j_prefill(jp, jb, jcfg, 64)
    tl, tc = tm.prefill(tp, tb, tcfg, 64)
    yield tl, jl, tc, jc
    rng = np.random.default_rng(seed + 100)
    for _ in range(3):
        nxt = rng.integers(0, jcfg.vocab_size, (B,)).astype(np.int32)
        jl, jc = j_decode(jp, jnp.asarray(nxt), jc, jcfg)
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
        yield tl, jl, tc, jc


@pytest.mark.parametrize("S", [9, 37])
def test_prefill_and_decode_match_reference_f32(S):
    """S = 9 prompt rows over 16 frames (Sq < Skv), S = 37 (Sq > Skv)."""
    for tl, jl, tc, jc in run_prefill_decode("float32", S, seed=S):
        assert tuple(tl.shape) == jl.shape == (B, 512)
        assert_close(tl, jl, F32_TOL)
        assert_caches(tc, jc, F32_TOL)


@pytest.mark.parametrize("gelu", ["as_shipped", "reference_rounding"])
@pytest.mark.parametrize("S", [9, 37])
def test_prefill_and_decode_match_reference_bf16(S, gelu, monkeypatch):
    if gelu == "reference_rounding":
        monkeypatch.setattr(F, "gelu", gelu_rounded_per_op)
    for tl, jl, tc, jc in run_prefill_decode("bfloat16", S, seed=S + 1):
        assert tl.dtype == torch.bfloat16
        assert_close(tl, jl, 2 * BF16_STEP)
        assert_caches(tc, jc, 3 * BF16_STEP)


def test_mixed_position_decode_matches_reference():
    """Continuous batching: rows at different positions in one decode
    batch, each attending its own frames."""
    jcfg, tcfg, jp, tp = model("float32")
    jb, tb = batch(jcfg, 20, seed=3)
    _, jc = j_prefill(jp, jb, jcfg, 32)
    _, tc = tm.prefill(tp, tb, tcfg, 32)
    jc = dict(jc, pos=jnp.asarray([20, 4], jnp.int32))
    tc = dict(tc, pos=torch.tensor([20, 4], dtype=torch.int32))
    nxt = np.asarray([7, 9], np.int32)
    jl, jc = j_decode(jp, jnp.asarray(nxt), jc, jcfg)
    tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
    assert_close(tl, jl, F32_TOL)
    assert_caches(tc, jc, F32_TOL)


@pytest.mark.parametrize("S", [17, 40])
def test_prefill_then_decode_equals_longer_prefill(S):
    """The port alone, f32, in the style of
    tests/test_decode_consistency.py: prefill(tokens[:-1]) then
    decode(tokens[-1]) equals prefill(tokens) at the last position."""
    _, tcfg, _, tp = model("float32")
    _, tb = batch(tcfg, S, seed=S + 9)
    full, _ = tm.prefill(tp, tb, tcfg, S + 4)
    _, cache = tm.prefill(tp, dict(tb, tokens=tb["tokens"][:, :-1]), tcfg,
                          S + 4)
    step, cache = tm.decode_step(tp, tb["tokens"][:, -1], cache, tcfg)
    torch.testing.assert_close(step, full, atol=1e-4, rtol=1e-4)
    assert torch.equal(cache["pos"], torch.full((B,), S, dtype=torch.int32))


@pytest.mark.parametrize("backend", ["slots", "paged"])
def test_engine_refuses_encoder_decoder(backend):
    from repro_torch.core import make_scheduler
    from repro_torch.serving.engine import ServingEngine
    _, tcfg, _, tp = model("float32")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        ServingEngine(tcfg, make_scheduler("fcfs"), params=tp, max_len=64,
                      backend=backend, device="cpu")
