"""Multi-head latent attention (MiniCPM3-4B's smoke config) in the port
against ``repro.models`` on bridged weights (CPU).

- ``mla_prefill`` (the expanded form: q and k of D = dn + dr, v of Dv,
  through the flash kernel's plain version) and ``mla_decode`` (the
  absorbed form over the latent cache, ``mla_decode_attention_plain``),
  with the reference on ``attn_impl`` ``"flash"`` and ``"naive"``: f32
  within 1e-5; bf16 within one bf16 step of the largest output value
  (the two round at the same points, their f32 sums run in other
  orders), and the port's RMS error against the f32 forward of the same
  bf16 weights within 1.01x the reference's own;
- the model's ``prefill`` and ``decode_step``: f32 logits within 1e-5 of
  the largest logit (caches within 1e-5); bf16 logits within two bf16
  steps of the largest logit (a flipped rounding in one layer reaches
  the logits through the rest of the stack), the port's RMS error
  against the f32 forward within 1.25x the reference's;
- decode consistency of the port on its own: prefill + one absorbed
  decode step against prefill of the longer prompt;
- on CUDA tensors the absorbed products are ``torch.bmm`` calls with f32
  outputs (``mla_decode_attention_bmm``), whose ``out_dtype`` overload
  the CPU does not have: the CPU takes the plain version by device.

XLA:CPU has no bf16 x bf16 -> f32 dot for the reference's ``w . c``
contraction (``src/repro/models/attention.py:604``), so the bf16 cases
feed the reference's ``einsum`` f32 copies of bf16 operands wherever it
asks for an f32 result: the products of two bf16 values are exact in
f32, so the function is the same.  The copies are rounded to bf16 once
more with ``lax.reduce_precision`` (exact on bf16 values): XLA:CPU drops
an f32 -> bf16 -> f32 round trip (excess precision), which would skip
the reference's rounding of the softmax weights.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_FACTORIES
from repro.models import attention as JA
from repro.models import decode_step as j_decode
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro_torch.configs import SMOKE_FACTORIES as T_SMOKE
from repro_torch.models import attention as TA
from repro_torch.models import model as tm
from repro_torch.weights import init_params, params_from_numpy

F32_TOL = 1e-5
BF16_STEP = 2 ** -7


class _F32Dots:
    """``jax.numpy`` with ``einsum(..., preferred_element_type=f32)`` over
    f32 copies of bf16 operands, kept at bf16 precision (exact: see the
    module's docstring)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [jax.lax.reduce_precision(o.astype(jnp.float32), 8, 7)
                   if o.dtype == jnp.bfloat16 else o for o in ops]
        return jnp.einsum(spec, *ops,
                          preferred_element_type=preferred_element_type, **kw)


@pytest.fixture(autouse=True)
def reference_dots(monkeypatch):
    monkeypatch.setattr(JA, "jnp", _F32Dots())


def configs(dtype, impl):
    """MiniCPM3-4B's smoke config, the reference's and the port's."""
    return tuple(dataclasses.replace(f["minicpm3-4b"](), dtype=dtype,
                                     attn_impl=impl)
                 for f in (SMOKE_FACTORIES, T_SMOKE))


def bridged(seed, dtype, impl="flash"):
    """(jcfg, tcfg, reference params, the same params in torch, the f32
    reference config and params: the same bf16 values, upcast)."""
    jcfg, tcfg = configs(dtype, impl)
    jp = j_init_params(jax.random.key(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    fcfg = dataclasses.replace(jcfg, dtype="float32")
    fp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jcfg, tcfg, jp, tp, fcfg, fp


def layer0(tree):
    return jax.tree.map(lambda a: a[0], tree["stages"]["stage_0"]["attn"])


def np32(a):
    return np.array(a.float().numpy() if isinstance(a, torch.Tensor)
                    else np.asarray(a, np.float32), np.float32)


def rms(a):
    return float(np.sqrt(np.mean(np.square(a))))


def assert_bf16_close(got, ref, f32, steps, rms_ratio):
    """``got`` within ``steps`` bf16 steps of the largest |ref|, and its
    RMS error against ``f32`` within ``rms_ratio`` of ref's own."""
    got, ref, f32 = np32(got), np32(ref), np32(f32)
    assert np.abs(got - ref).max() <= steps * BF16_STEP * np.abs(ref).max()
    assert rms(got - f32) <= rms_ratio * rms(ref - f32) + 1e-12


def assert_f32_close(got, ref):
    got, ref = np32(got), np32(ref)
    np.testing.assert_allclose(got, ref, rtol=F32_TOL,
                               atol=F32_TOL * np.abs(ref).max())


@pytest.mark.parametrize("impl", ["flash", "naive"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_matches_reference(dtype, impl):
    jcfg, tcfg, jp, tp, fcfg, fp = bridged(1, dtype, impl)
    rng = np.random.default_rng(2)
    B, S = 2, 19
    x = jnp.asarray(rng.standard_normal((B, S, jcfg.d_model)),
                    jnp.float32).astype(jcfg.dtype)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jy, (jc, jk) = JA.mla_prefill(layer0(jp), x, jnp.asarray(pos), jcfg)
    ty, (tc, tk) = TA.mla_prefill(layer0(tp), torch.from_numpy(np32(x)).to(
        getattr(torch, dtype)), torch.from_numpy(pos), tcfg)
    assert ty.dtype == getattr(torch, dtype) and tuple(ty.shape) == jy.shape
    assert tuple(tc.shape) == jc.shape and tuple(tk.shape) == jk.shape
    if dtype == "float32":
        for got, want in ((ty, jy), (tc, jc), (tk, jk)):
            assert_f32_close(got, want)
        return
    fy, (fc, fk) = JA.mla_prefill(layer0(fp), x.astype(jnp.float32),
                                  jnp.asarray(pos), fcfg)
    for got, want, f32 in ((ty, jy, fy), (tc, jc, fc), (tk, jk, fk)):
        assert_bf16_close(got, want, f32, 1, 1.01)


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_reference(dtype, window):
    """The absorbed decode over a latent cache of 32 slots at rows of
    positions 5 and 30 (and, windowed, a ring of 16 that wrapped), the
    new token written in place at the reference's slot."""
    jcfg, tcfg, jp, tp, fcfg, fp = bridged(3, dtype)
    m = jcfg.mla
    rng = np.random.default_rng(4)
    B, S = 2, 16 if window else 32
    pos = np.array([5, 30], np.int32)

    def draw(*shape):
        return jnp.asarray(rng.standard_normal(shape),
                           jnp.float32).astype(jcfg.dtype)

    x, c, kr = (draw(B, 1, jcfg.d_model), draw(B, S, m.kv_lora_rank),
                draw(B, S, m.qk_rope_head_dim))

    def t(a):
        return torch.from_numpy(np32(a)).to(getattr(torch, dtype))

    tc, tk = t(c), t(kr)
    jy, (jc, jk) = JA.mla_decode(layer0(jp), x, c, kr, jnp.asarray(pos),
                                 jcfg, window=window)
    ty, (oc, ok) = TA.mla_decode(layer0(tp), t(x), tc, tk,
                                 torch.from_numpy(pos), tcfg, window=window)
    assert oc is tc and ok is tk                     # written in place
    # the caches hold the reference's new latent at the reference's slot
    np.testing.assert_array_equal(np32(tc) != np32(c), np32(jc) != np32(c))
    if dtype == "float32":
        for got, want in ((ty, jy), (tc, jc), (tk, jk)):
            assert_f32_close(got, want)
        return
    f = (lambda a: a.astype(jnp.float32))
    fy, (fc, fk) = JA.mla_decode(layer0(fp), f(x), f(c), f(kr),
                                 jnp.asarray(pos), fcfg, window=window)
    for got, want, f32 in ((ty, jy, fy), (tc, jc, fc), (tk, jk, fk)):
        assert_bf16_close(got, want, f32, 1, 1.01)


@pytest.mark.parametrize("impl", ["flash", "naive"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_model_matches_reference(dtype, impl):
    """``prefill`` then three ``decode_step`` calls on the whole smoke
    stack, with the rows at different positions in the last step."""
    jcfg, tcfg, jp, tp, fcfg, fp = bridged(5, dtype, impl)
    toks = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (2, 23)).astype(np.int32)
    jl, jc = j_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, 40)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, 40)
    fl, fc = j_prefill(fp, {"tokens": jnp.asarray(toks)}, fcfg, 40)
    steps = [(jl, tl, fl)]
    for step in range(3):
        nxt = np.asarray([3 + step, 9], np.int32)
        if step == 2:                 # continuous batching: mixed positions
            jc = dict(jc, pos=jnp.asarray([25, 7], jnp.int32))
            fc = dict(fc, pos=jnp.asarray([25, 7], jnp.int32))
            tc = dict(tc, pos=torch.tensor([25, 7], dtype=torch.int32))
        jl, jc = j_decode(jp, jnp.asarray(nxt), jc, jcfg)
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
        fl, fc = j_decode(fp, jnp.asarray(nxt), fc, fcfg)
        steps.append((jl, tl, fl))
    assert tc["stages"]["stage_0"].keys() == {"c", "k_rope"}
    for name in ("c", "k_rope"):
        got, want = tc["stages"]["stage_0"][name], jc["stages"]["stage_0"][name]
        assert tuple(got.shape) == want.shape
        assert got.dtype == getattr(torch, dtype)
    for jl, tl, fl in steps:
        if dtype == "float32":
            assert_f32_close(tl, jl)
        else:
            assert_bf16_close(tl, jl, fl, 2, 1.25)
    if dtype == "float32":
        for name in ("c", "k_rope"):
            assert_f32_close(tc["stages"]["stage_0"][name],
                             jc["stages"]["stage_0"][name])


@pytest.mark.parametrize("S", [17, 40])
def test_mla_decode_matches_forward(S):
    """prefill(tokens[:-1]) then one absorbed decode step equals the
    expanded prefill(tokens), in f32 (S = 40 runs past the 32-slot
    smoke prompt the other tests use)."""
    _, cfg = configs("float32", "flash")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, S)))
    full, _ = tm.prefill(params, {"tokens": toks}, cfg, S + 4)
    _, cache = tm.prefill(params, {"tokens": toks[:, :-1]}, cfg, S + 4)
    step, cache = tm.decode_step(params, toks[:, -1], cache, cfg)
    torch.testing.assert_close(step, full, atol=1e-4, rtol=1e-4)
    assert torch.equal(cache["pos"], torch.full((2,), S, dtype=torch.int32))


def test_mla_latent_attention_routes_by_device(monkeypatch):
    """CPU tensors take the plain version; the bmm route is the same
    function (held here with f32 operands, whose ``torch.bmm`` the CPU
    has; bf16 operands take ``bmm``'s ``out_dtype`` overload, which the
    card runs in ``tests/test_torch_kernels_cuda.py``)."""
    rng = np.random.default_rng(9)
    B, S, H, r, dr = 3, 24, 4, 32, 8
    q_lat, q_rope = (torch.from_numpy(rng.standard_normal((B, 1, H, d))
                                      .astype(np.float32)) for d in (r, dr))
    c = torch.from_numpy(rng.standard_normal((B, S, r)).astype(np.float32))
    kr = torch.from_numpy(rng.standard_normal((B, S, dr)).astype(np.float32))
    ctx = torch.tensor([1, 13, 24], dtype=torch.int32)
    calls = []
    plain = TA.mla_decode_attention_plain
    monkeypatch.setattr(TA, "mla_decode_attention_plain",
                        lambda *a: calls.append(1) or plain(*a))
    out = TA.mla_decode_attention(q_lat, q_rope, c, kr, ctx, 40 ** -0.5)
    assert calls == [1] and out.shape == (B, 1, H, r)
    assert out.dtype == torch.float32
    bmm = TA.mla_decode_attention_bmm(q_lat, q_rope, c, kr, ctx, 40 ** -0.5)
    torch.testing.assert_close(bmm, out, atol=F32_TOL, rtol=F32_TOL)
    # row 0 attends slot 0 alone: its latent context is c[0, 0]
    torch.testing.assert_close(out[0, 0], c[0, 0].expand(H, r))
