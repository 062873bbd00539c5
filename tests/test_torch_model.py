"""The port's model assembly (``repro_torch.models.model``) against
``repro.models`` on bridged smoke weights (f32, CPU): ``prefill``,
``prefill_chunk`` and ``decode_step`` logits within 1e-4 and caches
within 1e-5, for Llama-2, the dense GQA stacks DeepSeek-7B (MHA, a
102 400-token vocabulary), Granite-3-2B (tied embeddings) and
StarCoder2-7B (GELU MLP, G = 3 at smoke size), DeepSeek-MoE (a dense first layer, then MoE
layers with shared experts) and Mixtral (MoE, sliding-window attention
whose ring caches wrap) with ``attn_impl="flash"``, so the flash kernel's
plain version runs, the MoE stacks under ``moe_impl`` ``dense`` and
``dispatch``, and Mamba-2 (the SSD scan's plain version); decode
consistency of the port on its own; and the stacks it refuses."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs.base as tbase
from repro.configs import SMOKE_FACTORIES
from repro.models import decode_step as j_decode
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro.models import prefill_chunk as j_prefill_chunk
from repro.models.model import model_stages as j_model_stages
from repro_torch.models import model as tm
from repro_torch.weights import init_params, params_from_numpy

LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5
MOE = ["deepseek-moe-16b/dense", "deepseek-moe-16b/dispatch",
       "mixtral-8x7b/dense", "mixtral-8x7b/dispatch"]
DENSE = ["deepseek-7b", "granite-3-2b", "starcoder2-7b"]
ARCHS = ["llama2-7b", "mamba2-2.7b"] + DENSE + MOE


def port_config(cfg):
    """The same ModelConfig, built from the port's copy of the classes."""
    def conv(v):
        if dataclasses.is_dataclass(v):
            cls = getattr(tbase, type(v).__name__)
            return cls(**{f.name: conv(getattr(v, f.name))
                          for f in dataclasses.fields(v)})
        return v
    return conv(cfg)


def configs(arch):
    """``arch`` or ``arch/moe_impl``; attention stacks take the flash
    path."""
    name, _, impl = arch.partition("/")
    cfg = SMOKE_FACTORIES[name]()
    if name != "mamba2-2.7b":
        cfg = dataclasses.replace(cfg, attn_impl="flash")
    if impl:
        cfg = dataclasses.replace(cfg, moe_impl=impl)
    return cfg, port_config(cfg)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, tcfg = configs(request.param)
    jp = j_init_params(jax.random.key(5), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return request.param, jcfg, tcfg, jp, tp


def tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def assert_cache_close(tcache, jcache):
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for key, stage in jcache["stages"].items():
        assert tcache["stages"][key].keys() == stage.keys()
        for name, want in stage.items():
            got = tcache["stages"][key][name]
            assert tuple(got.shape) == want.shape, name
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       atol=CACHE_TOL, rtol=CACHE_TOL,
                                       err_msg=name)


def test_prefill_then_decode_match_reference(model):
    _, jcfg, tcfg, jp, tp = model
    toks = tokens(jcfg, 2, 37)
    jl, jc = j_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, 64)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, 64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    assert_cache_close(tc, jc)
    for step in range(3):                     # three decode steps
        nxt = tokens(jcfg, 2, 1, seed=10 + step)[:, 0]
        jl, jc = j_decode(jp, jnp.asarray(nxt), jc, jcfg)
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        assert_cache_close(tc, jc)


def test_mixed_position_decode_matches_reference(model):
    """Continuous batching: one decode batch over rows at different
    positions (fresh rows at 0 next to prefilled ones)."""
    _, jcfg, tcfg, jp, tp = model
    toks = tokens(jcfg, 2, 20, seed=3)
    _, jc = j_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, 32)
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, 32)
    jc = dict(jc, pos=jnp.asarray([20, 0], jnp.int32))
    tc = dict(tc, pos=torch.tensor([20, 0], dtype=torch.int32))
    nxt = np.asarray([7, 9], np.int32)
    jl, jc = j_decode(jp, jnp.asarray(nxt), jc, jcfg)
    tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    assert_cache_close(tc, jc)


SPLITS = [[37], [16, 16, 5], [1, 30, 6]]


@pytest.mark.parametrize("split", SPLITS)
def test_prefill_chunk_matches_reference(split):
    check_prefill_chunk("llama2-7b", split)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("arch", ["deepseek-moe-16b/dense",
                                  "deepseek-moe-16b/dispatch"])
def test_moe_prefill_chunk_matches_reference(arch, split):
    """DeepSeek-MoE chunks (a dense first stage, then MoE layers)."""
    check_prefill_chunk(arch, split)


def check_prefill_chunk(arch, split):
    """Chunks cover the prompt.  Dispatch capacity follows the rows that
    reach the layer, so a split prompt drops other assignments than the
    whole one: for MoE stacks the whole-prompt logits are compared only
    on the dense path and for one chunk."""
    jcfg, tcfg = configs(arch)
    jp = j_init_params(jax.random.key(6), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = tokens(jcfg, 1, sum(split), seed=4)
    jc = j_init_cache(jcfg, 1, 64)
    tc = tm.init_cache(tcfg, 1, 64, device="cpu")
    at = 0
    for c in split:
        part = toks[:, at:at + c]
        jl, jc = j_prefill_chunk(jp, jnp.asarray(part), jcfg, jc)
        tl, tc = tm.prefill_chunk(tp, torch.from_numpy(part), tcfg, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        assert_cache_close(tc, jc)
        at += c
    if tcfg.moe is None or tcfg.moe_impl == "dense" or len(split) == 1:
        wl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                           64)
        torch.testing.assert_close(tl, wl, atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("arch,S", [
    ("llama2-7b", 17), ("mamba2-2.7b", 33),
    ("deepseek-moe-16b/dense", 17), ("deepseek-moe-16b/dispatch", 17),
    ("mixtral-8x7b/dense", 49), ("mixtral-8x7b/dispatch", 49)])
def test_decode_matches_forward(arch, S):
    """Port only, in the style of tests/test_decode_consistency.py:
    prefill(tokens[:-1]) then decode(tokens[-1]) equals prefill(tokens).
    Mixtral's S = 49 wraps its ring caches (window 32).  Dispatch
    capacity follows the rows that reach the layer, so prefill and decode
    would drop different assignments: the dispatch cases run at a
    capacity factor of E / top_k, where nothing drops."""
    _, cfg = configs(arch)
    if cfg.moe_impl == "dispatch" and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(tokens(cfg, 2, S, seed=8))
    full, _ = tm.prefill(params, {"tokens": toks}, cfg, S + 4)
    _, cache = tm.prefill(params, {"tokens": toks[:, :-1]}, cfg, S + 4)
    step, cache = tm.decode_step(params, toks[:, -1], cache, cfg)
    torch.testing.assert_close(step, full, atol=1e-4, rtol=1e-4)
    assert torch.equal(cache["pos"], torch.full((2,), S, dtype=torch.int32))


def test_supports_chunked_prefill_matches_reference():
    from repro.models import supports_chunked_prefill as j_supports
    for arch in SMOKE_FACTORIES:
        cfg = SMOKE_FACTORIES[arch]()
        assert tm.supports_chunked_prefill(port_config(cfg)) == \
            j_supports(cfg), arch
        assert tm.model_stages(port_config(cfg)) == j_model_stages(cfg), \
            arch


@pytest.mark.parametrize("arch,item", [
    ("minicpm3-4b", "6c"), ("recurrentgemma-2b", "6"),
    ("whisper-large-v3", "6e"), ("internvl2-76b", "6g"),
])
def test_unported_stacks_raise(arch, item):
    cfg = port_config(SMOKE_FACTORIES[arch]())
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md Queue A item {item}"):
        tm.init_cache(cfg, 1, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        init_params(cfg, torch.Generator().manual_seed(0), "cpu")
