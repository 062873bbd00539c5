"""int8 slot caches (``cfg.kv_quant``) in the port against the reference
(CPU): the port's counterparts of ``tests/test_kv_quant.py`` for
Llama-2-7B and Mixtral-8x7B (sliding-window ring caches), and the bound
that holds the card's route to the reference.

- cache structure: int8 ``k``/``v`` with bf16 per-(slot, head) scales
  ``k_s``/``v_s``, as ``repro.models.init_cache`` lays them out;
- ``gqa_decode`` with scales, and ``prefill`` + ``decode_step`` on the
  smoke stacks, against the reference on bridged weights.  The CPU runs
  the reference's own route (every scaled cache streams through
  ``decode_attention_blocked``, each block dequantized to q's dtype), so
  f32 agrees to summation order, except where the two frameworks' f32
  projections differ in the last bit and a value rounds to the
  neighbouring int8 code: codes are held within one, logits within 5e-3
  (as ``tests/test_torch_engine.py`` holds int8 pages); bf16 outputs
  within one bf16 step of the largest value;
- int8 against fp caches in the port: logits within 0.15 x the fp
  logits' std, greedy tokens equal (``test_kv_quant.py``'s gate);
- the divergence of the card's route.  On CUDA tensors
  ``slot_cache_attention`` hands the int8 caches and their scales, viewed
  as pages, to the paged kernels, which dequantize in f32 and keep the
  softmax weights in f32; the reference rounds each dequantized value and
  each weight to bf16.  In bf16 the two are held within 2**-7 |ref| (one
  bf16 step of the output) + 2 x 2**-9 max|v| (2**-9 for the reference's
  rounding of each dequantized value, 2**-9 for its rounding of the
  weights, whose changes sum to at most 2**-9); the change that bf16's
  rounding of K makes to the scores is not in the bound.  The paged plain
  version (the kernels' function) is held to it against the reference in
  bf16, and to 1e-5 in f32, where the reference's dequantized values are
  exact.  Planted faults (a V code one too large, V scales 4 bf16 steps
  too large or taken from the neighbouring head, the last valid slot
  dropped) fall outside it.
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
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro_torch.configs import SMOKE_FACTORIES as T_SMOKE
from repro_torch.models import attention as TA
from repro_torch.models import model as tm
from repro_torch.weights import params_from_numpy

BF16_STEP = 2 ** -7
F32_TOL = 1e-5
QUANT_LOGIT_TOL = 5e-3
ARCHS = ["llama2-7b", "mixtral-8x7b"]


def configs(arch, kv_quant=True, dtype="float32"):
    """``arch``'s smoke config, the reference's and the port's."""
    return tuple(dataclasses.replace(f[arch](), kv_quant=kv_quant,
                                     dtype=dtype, attn_impl="flash")
                 for f in (SMOKE_FACTORIES, T_SMOKE))


def np32(a):
    return np.array(a.float().numpy() if isinstance(a, torch.Tensor)
                    else np.asarray(a, np.float32), np.float32)


def to_torch(a):
    """numpy or jax array -> torch, dtype kept (bf16 included)."""
    return params_from_numpy(np.asarray(a), "cpu")


def assert_cache_close(tcache, jcache):
    """int8 codes within one of the reference's, scales within a bf16
    step, every other leaf within 1e-5."""
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for key, stage in jcache["stages"].items():
        assert tcache["stages"][key].keys() == stage.keys()
        for name, want in stage.items():
            got = tcache["stages"][key][name]
            assert tuple(got.shape) == want.shape, name
            want = np.asarray(want)
            if want.dtype == np.int8:
                assert got.dtype == torch.int8, name
                d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
                assert d.max() <= 1 and (d > 0).mean() < 1e-3, name
            elif name.endswith("_s"):
                assert got.dtype == torch.bfloat16, name
                np.testing.assert_allclose(np32(got), np32(want),
                                           rtol=BF16_STEP, err_msg=name)
            else:
                np.testing.assert_allclose(np32(got), np32(want),
                                           atol=F32_TOL, rtol=F32_TOL,
                                           err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_quant_cache_structure(arch):
    jcfg, tcfg = configs(arch)
    jst = j_init_cache(jcfg, 2, 32)["stages"]["stage_0"]
    tst = tm.init_cache(tcfg, 2, 32, device="cpu")["stages"]["stage_0"]
    assert tst.keys() == jst.keys() == {"k", "v", "k_s", "v_s"}
    for name, want in jst.items():
        assert tuple(tst[name].shape) == want.shape, name
    assert tst["k"].dtype == tst["v"].dtype == torch.int8
    assert tst["k_s"].dtype == tst["v_s"].dtype == torch.bfloat16
    assert tst["k_s"].shape == tst["k"].shape[:-1]


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scaled_gqa_decode_matches_reference(dtype, window):
    """One decode step over int8 caches at rows of positions 7 and 29
    (windowed: a ring of 16 that wrapped), the new token's codes and
    scales written in place at the reference's slot."""
    jcfg, tcfg = configs("llama2-7b", dtype=dtype)
    jp = j_init_params(jax.random.key(2), jcfg)
    lp = jax.tree.map(lambda a: a[0], jp["stages"]["stage_0"]["attn"])
    tlp = params_from_numpy(jax.tree.map(np.asarray, lp), "cpu")
    rng = np.random.default_rng(3)
    B, S, H, D = 2, 16 if window else 32, jcfg.n_kv_heads, \
        jcfg.resolved_head_dim()
    pos = np.array([7, 29], np.int32)
    x = jnp.asarray(rng.standard_normal((B, 1, jcfg.d_model)),
                    jnp.float32).astype(jcfg.dtype)
    kq, ks = JA.quantize_kv(jnp.asarray(rng.standard_normal((B, S, H, D)),
                                        jnp.float32))
    vq, vs = JA.quantize_kv(jnp.asarray(rng.standard_normal((B, S, H, D)),
                                        jnp.float32))
    jy, jc = JA.gqa_decode(lp, x, kq, vq, jnp.asarray(pos), jcfg,
                           window=window, k_scale=ks, v_scale=vs)
    tc = [to_torch(a) for a in (kq, vq, ks, vs)]
    ty, oc = TA.gqa_decode(tlp, to_torch(x), tc[0], tc[1],
                           torch.from_numpy(pos), tcfg, window=window,
                           k_scale=tc[2], v_scale=tc[3])
    assert all(o is t for o, t in zip(oc, tc))       # written in place
    for got, want, old in zip(tc, jc, (kq, vq, ks, vs)):
        changed = np.asarray(want) != np.asarray(old)
        assert (np32(got) != np32(old))[~changed].sum() == 0
        d = np.abs(np32(got) - np32(want))
        if got.dtype == torch.int8:
            assert d.max() <= 1
        else:
            np.testing.assert_allclose(np32(got), np32(want), rtol=BF16_STEP)
    ref = np32(jy)
    if dtype == "float32":
        np.testing.assert_allclose(np32(ty), ref, atol=QUANT_LOGIT_TOL,
                                   rtol=QUANT_LOGIT_TOL)
    else:
        assert np.abs(np32(ty) - ref).max() <= BF16_STEP * np.abs(ref).max()


@pytest.mark.parametrize("arch,S", [("llama2-7b", 20), ("mixtral-8x7b", 37)])
def test_quant_decode_steps_match_reference(arch, S):
    """``prefill`` (the caches quantized after the fit: Mixtral's S = 37
    wraps its ring of 32) and three ``decode_step`` calls, the last at
    mixed positions."""
    jcfg, tcfg = configs(arch)
    jp = j_init_params(jax.random.key(4), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, S)).astype(np.int32)
    jl, jc = j_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, 48)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, 48)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    assert_cache_close(tc, jc)
    for step in range(3):
        nxt = np.asarray([3 + step, 9], np.int32)
        if step == 2:
            jc = dict(jc, pos=jnp.asarray([S + 2, 4], jnp.int32))
            tc = dict(tc, pos=torch.tensor([S + 2, 4], dtype=torch.int32))
        jl, jc = j_decode(jp, jnp.asarray(nxt), jc, jcfg)
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=QUANT_LOGIT_TOL, rtol=QUANT_LOGIT_TOL)
        assert_cache_close(tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_decode_close_to_fp(arch):
    """The port alone, as ``test_kv_quant.py`` holds the reference: int8
    caches against fp caches after prefill + four decode steps, logits
    within 0.15 x the fp logits' std, greedy tokens identical."""
    _, tcfg = configs(arch, kv_quant=False)
    jp = j_init_params(jax.random.key(0), SMOKE_FACTORIES[arch]())
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (2, 20)))
    outs = {}
    for quant in (False, True):
        cfg = dataclasses.replace(tcfg, kv_quant=quant)
        logits, cache = tm.prefill(tp, {"tokens": toks}, cfg, 40)
        seq = [int(logits[0].argmax())]
        nxt = logits.argmax(-1)
        for _ in range(4):
            logits, cache = tm.decode_step(tp, nxt, cache, cfg)
            nxt = logits.argmax(-1)
            seq.append(int(nxt[0]))
        outs[quant] = logits.numpy(), seq
    err = np.abs(outs[True][0] - outs[False][0]).max()
    assert err < 0.15 * np.std(outs[False][0])
    assert outs[True][1] == outs[False][1]


ROUTE_CASES = [
    (3, 64, 4, 4, [0, 17, 63]),          # MHA, pages of 16
    (2, 40, 6, 2, [39, 5]),              # G = 3, pages of 8
    (2, 32, 4, 2, [31, 75]),             # a ring cache that wrapped
]


def route_case(B, S, Hq, Hkv, pos, dtype):
    """q, int8 K/V codes with their bf16 scales, ctx, and the reference's
    ``decode_attention`` over the same codes and scales."""
    rng = np.random.default_rng(B * S + Hq)
    D = 32
    q = torch.from_numpy(rng.standard_normal((B, 1, Hq, D))
                         .astype(np.float32)).to(getattr(torch, dtype))
    kq, ks = TA.quantize_kv(torch.from_numpy(
        rng.standard_normal((B, S, Hkv, D)).astype(np.float32) * 2))
    vq, vs = TA.quantize_kv(torch.from_numpy(
        rng.standard_normal((B, S, Hkv, D)).astype(np.float32)))
    ctx = TA._decode_ctx(S, torch.tensor(pos, dtype=torch.int32))
    valid = np.arange(S)[None] <= np.asarray(pos)[:, None]
    ref = np32(JA.decode_attention(
        jnp.asarray(np32(q)).astype(dtype), jnp.asarray(kq.numpy()),
        jnp.asarray(vq.numpy()), jnp.asarray(valid),
        k_scale=jnp.asarray(np32(ks)).astype(jnp.bfloat16),
        v_scale=jnp.asarray(np32(vs)).astype(jnp.bfloat16)))
    return q, kq, ks, vq, vs, ctx, ref


def route_ratio(out, ref, vq, vs, ctx):
    """The largest |out - ref| over 2**-7 |ref| + 2 x 2**-9 max|v| (the
    bf16 bound of the card's int8 route): at most 1 within the bound."""
    valid = torch.arange(vq.shape[1])[None] < ctx[:, None]
    vmax = float((vq.float().abs().amax(-1) * vs.float())[valid].max())
    d = np.abs(np32(out) - ref)
    return float((d / (2 * 2 ** -9 * vmax + 2 ** -7 * np.abs(ref))).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,pos", ROUTE_CASES)
def test_paged_route_within_divergence_bound(B, S, Hq, Hkv, pos, dtype):
    """``decode_attention_paged`` (the card's route: int8 caches and
    scales viewed as pages, here through the paged kernels' plain
    versions) against the reference's ``decode_attention`` over the same
    codes and scales."""
    q, kq, ks, vq, vs, ctx, ref = route_case(B, S, Hq, Hkv, pos, dtype)
    out = TA.decode_attention_paged(q, kq, vq, ctx, k_scale=ks, v_scale=vs)
    assert out.shape == q.shape and out.dtype == q.dtype
    if dtype == "float32":
        np.testing.assert_allclose(np32(out), ref, atol=F32_TOL,
                                   rtol=F32_TOL)
    else:
        assert route_ratio(out, ref, vq, vs, ctx) <= 1
    # the dispatch: the CPU runs the reference's route, the same function
    plain = TA.decode_attention(q, kq, vq, ctx, k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(np32(plain), ref, atol=F32_TOL,
                               rtol=F32_TOL if dtype == "float32"
                               else BF16_STEP)


def _v_code_plus_one(kq, ks, vq, vs, ctx):
    vq = (vq.to(torch.int16) + 1).clamp(max=127).to(torch.int8)
    return kq, ks, vq, vs, ctx


def _v_scale_4_steps(kq, ks, vq, vs, ctx):
    return kq, ks, vq, (vs.float() * (1 + 4 * BF16_STEP)).bfloat16(), ctx


def _v_scale_other_head(kq, ks, vq, vs, ctx):
    return kq, ks, vq, vs.roll(1, -1), ctx


def _last_slot_dropped(kq, ks, vq, vs, ctx):
    return kq, ks, vq, vs, (ctx - 1).clamp(min=1)


@pytest.mark.parametrize("fault", [_v_code_plus_one, _v_scale_4_steps,
                                   _v_scale_other_head, _last_slot_dropped],
                         ids=lambda f: f.__name__.lstrip("_"))
@pytest.mark.parametrize("B,S,Hq,Hkv,pos", ROUTE_CASES)
def test_divergence_bound_fails_planted_fault(B, S, Hq, Hkv, pos, fault):
    """The bf16 bound has teeth: the route run on faulty codes, scales or
    lengths falls outside it against the reference on the true ones."""
    q, kq, ks, vq, vs, ctx, ref = route_case(B, S, Hq, Hkv, pos, "bfloat16")
    fk, fks, fv, fvs, fctx = fault(kq, ks, vq, vs, ctx)
    out = TA.decode_attention_paged(q, fk, fv, fctx, k_scale=fks,
                                    v_scale=fvs)
    assert route_ratio(out, ref, vq, vs, ctx) > 1
