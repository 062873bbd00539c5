"""Serving over a mesh (``models.sharding.ServePlan``; CPU, f32, smoke
configs; gloo ranks, a process each over a ``FileStore``: no network).
Each rank holds its shard of every parameter under ``param_specs`` and of
every cache leaf under ``cache_specs``, and ``prefill``, ``decode_step``
and ``prefill_chunk`` move activations only: the embedding's and each
row-parallel product's all-reduce over ``"model"``, and over a head-dim
split the k/q slices gathered and the partial scores all-reduced.  The
cases (``SERVE_CASES``), one set of rank processes per mesh size:

- ``(1, 2)``: Llama-2 (heads split), Granite-3-2B (8 query heads over 2
  kv heads), Mixtral (E = 4 over the model axis, window 32, a prompt past
  it), DeepSeek-MoE (experts over the model axis through the dispatch, a
  shared expert, a dense first stage), Llama-2 with int8 slot caches,
  MiniCPM3 (MLA over heads, the latent cache over its rank), Mamba-2
  (in_proj's 552 columns, 276 a rank, not head-aligned; 4 of 8 heads),
  the same with 2 B/C groups, RecurrentGemma (the RG-LRU branch on 64 of
  128 channels, local attention "mixed", window 32, a prompt past it),
  Whisper (2 of 4 heads a rank in the encoder, the decoder and the
  cross-attention, 16 frames) and InternVL2 (8 patches ahead of the
  tokens, 4 of 8 query heads over 1 of 2 kv heads);
- ``(2, 1)``: Llama-2 and Whisper with their batch (and frames, and
  cross caches) over the data axis;
- ``(1, 4)``: StarCoder2 (6 heads of 24 over 2 kv heads: every projection
  over the head dim), Granite (q over heads, k/v over the head dim), the
  same with int8 caches, Mixtral with 2 experts (their hidden dim
  split), MiniCPM3 with 2 heads (``wq_b``/``wkv_b`` whole, ``wo`` over
  ``v_head_dim``), Mamba-2 (2 heads a rank), Whisper with 2 heads of 64
  (every projection of the encoder, the decoder and the cross-attention
  over the head dim) and InternVL2 ("mixed").

Each case's prefill, ``SERVE_DECODE`` teacher-forced decode steps and one
``prefill_chunk`` (where the stack takes it) against one process's on the
same weights, logits within ``REL`` (1e-5) of the largest |logit|; each
rank's cache shards after the last call against its slice of the one
process's cache within ``REL`` of the leaf's largest; each rank's
parameter and cache bytes equal the placements' local bytes exactly; each
call's counted collectives equal ``ServePlan.serve_schedule``, kind for
kind.  Llama-2, Mixtral, MiniCPM3, Mamba-2, RecurrentGemma, Whisper and
InternVL2 on ``(1, 2)`` are held against the reference's one-device
``prefill`` and ``decode_step`` too, on the same weights (the port's
draw, handed to JAX leaf for leaf: the trees share the reference's
layout) and frames or patches, at ``LOGIT_TOL`` of
``tests/test_torch_model.py``.  Each layout a layer kind does not take
is refused by name; the dry-run writes serving collectives from the
plan's schedule."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import SMOKE_FACTORIES as J_SMOKE
from repro.models import decode_step as j_decode
from repro.models import prefill as j_prefill
from repro_torch.configs import SMOKE_FACTORIES
from repro_torch.configs.base import (ATTN, ATTN_LOCAL, ATTN_MLA, MAMBA2,
                                      RGLRU, ShapeConfig)
from repro_torch.launch import dryrun
from repro_torch.models import model as tm
from repro_torch.models.sharding import (ServePlan, cache_specs,
                                         cross_split, serve_layouts,
                                         shard_index)
from repro_torch.weights import init_params

from _torch_dist_ranks import (SERVE_CASES, SERVE_MAX_LEN, flat, serve_case,
                               serve_inputs, start_ranks, unflat,
                               wait_ranks)
from test_torch_model import LOGIT_TOL, port_config

REL = 1e-5
JAX_CASES = ("llama_model2", "mixtral_model2", "minicpm3_model2",
             "mamba2_model2", "rgemma_model2", "whisper_model2",
             "internvl_model2")
WORLDS = sorted({d * m for _, (d, m), _ in SERVE_CASES.values()})


def _jax_config(name):
    import dataclasses

    cfg, _ = serve_case(name)
    jcfg = dataclasses.replace(J_SMOKE[SERVE_CASES[name][0]](),
                               dtype="float32", attn_impl="flash")
    assert port_config(jcfg) == cfg
    return jcfg


def _one_process(name, params):
    """One process's logits of every call and its final cache."""
    cfg, _ = serve_case(name)
    prompt, steps, chunk, stub = serve_inputs(cfg)
    out = {}
    logits, cache = tm.prefill(params, {k: torch.from_numpy(v) for k, v in
                                        dict(stub, tokens=prompt).items()},
                               cfg, SERVE_MAX_LEN)
    out["logits/prefill"] = logits.numpy()
    for i, toks in enumerate(steps):
        logits, cache = tm.decode_step(params, torch.from_numpy(toks), cache,
                                       cfg)
        out[f"logits/decode{i}"] = logits.numpy()
    if chunk is not None:
        logits, cache = tm.prefill_chunk(params, torch.from_numpy(chunk), cfg,
                                         cache)
        out["logits/chunk"] = logits.numpy()
    return out, cache


def _reference(name, params):
    """The reference's one-device logits of the case's prefill and decode
    steps, from the port's ``params``."""
    jcfg = _jax_config(name)
    jparams = jax.tree.map(jnp.asarray, unflat(flat(params)))
    prompt, steps, _, stub = serve_inputs(serve_case(name)[0])
    out = {}
    batch = {k: jnp.asarray(v) for k, v in stub.items()}
    logits, cache = j_prefill(jparams, dict(batch, tokens=jnp.asarray(
        prompt, jnp.int32)), jcfg, SERVE_MAX_LEN)
    out["logits/prefill"] = np.asarray(logits)
    for i, toks in enumerate(steps):
        logits, cache = j_decode(jparams, jnp.asarray(toks, jnp.int32),
                                 cache, jcfg)
        out[f"logits/decode{i}"] = np.asarray(logits)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both jobs started at once; while they run, each case in one process
    (from ``init_params`` at seed 0, as the ranks draw it) and the
    reference's steps.  Returns {case: (one process's logits, its cache,
    [each rank's (arrays, JSON part)], the reference's logits or None)}."""
    tmp = tmp_path_factory.mktemp("serve")
    jobs = {world: start_ranks(f"serve_tp{world}", world, tmp)
            for world in WORLDS}
    try:
        single, reference = {}, {}
        for name in SERVE_CASES:
            cfg, _ = serve_case(name)
            params = init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
            single[name] = _one_process(name, params)
            if name in JAX_CASES:
                reference[name] = _reference(name, params)
    finally:
        for procs, _ in jobs.values():
            wait_ranks(procs, timeout=240)
    out = {}
    for name, (_, (data, model), _) in SERVE_CASES.items():
        path = jobs[data * model][1]
        per_rank = []
        for r in range(data * model):
            with np.load(f"{path}.rank{r}.npz") as f:
                arrays = {k[len(name) + 1:]: f[k] for k in f.files
                          if k.startswith(f"{name}/")}
            res = json.loads(open(f"{path}.rank{r}.json").read())[name]
            per_rank.append((arrays, res))
        out[name] = (*single[name], per_rank, reference.get(name))
    return out


def _rows(a, res):
    """The block of ``a``'s rows (dim 0) a rank holds."""
    index, count = res["rows"]
    n = a.shape[0] // count
    return a[index * n:(index + 1) * n]


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("name", SERVE_CASES)
def test_logits_match_one_process(ranks, name):
    want, _, per_rank, _ = ranks[name]
    cfg, _ = serve_case(name)
    assert ("logits/chunk" in want) == tm.supports_chunked_prefill(cfg)
    for arrays, res in per_rank:
        assert sorted(k for k in arrays if k.startswith("logits/")) == \
            sorted(want)
        for key, w in want.items():
            assert _rel(arrays[key], _rows(w, res)) <= REL, (key, res)


@pytest.mark.parametrize("name", SERVE_CASES)
def test_cache_shards_match_one_process(ranks, name):
    """Each rank's cache after the last call is its block, under
    ``cache_specs``, of the one process's (``pos`` whole)."""
    _, cache, per_rank, _ = ranks[name]
    cfg, (data, model) = serve_case(name)

    class Mesh:
        axis_names, shape = ("data", "model"), {"data": data, "model": model}

    specs = flat_specs(cache_specs(cache, cfg, Mesh, cache["pos"].shape[0]))
    want = {k: v.float().numpy() for k, v in _flat_tensors(cache).items()}
    for r, (arrays, res) in enumerate(per_rank):
        coords = {"data": r // model, "model": r % model}
        got = {k[len("cache/"):]: v for k, v in arrays.items()
               if k.startswith("cache/")}
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            for d, entry in enumerate(specs[path]):
                index, count = shard_index(entry, Mesh, coords)
                n = w.shape[d] // count
                w = w.take(range(index * n, (index + 1) * n), axis=d)
            assert got[path].shape == w.shape, path
            scale = max(np.abs(w).max(), 1e-30)
            assert np.abs(got[path] - w).max() <= REL * scale, path


def flat_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_specs(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _flat_tensors(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tensors(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("name", SERVE_CASES)
def test_rank_bytes_equal_placements(ranks, name):
    """What each rank holds is its placements' local bytes, exactly: the
    parameters as ``ServePlan.shard_params`` cut them, the cache after the
    last call and as ``init_cache`` made it under the plan; a model axis
    above 1 holds less than one process."""
    _, cache, per_rank, _ = ranks[name]
    cfg, (data, model) = serve_case(name)
    for _, res in per_rank:
        b = res["bytes"]
        assert b["params"] == b["params_placed"]
        assert b["cache"] == b["init_cache"] == b["cache_placed"]
        if model > 1:
            whole = sum(t.numel() * t.element_size() for t in
                        _flat_tensors(init_params(
                            cfg, torch.Generator(), "meta")).values())
            assert b["params"] < whole


@pytest.mark.parametrize("name", SERVE_CASES)
def test_counted_collectives_equal_schedule(ranks, name):
    """Every call's collectives as the rank counted them equal
    ``serve_schedule``'s, kind for kind in bytes and calls; a model axis
    above 1 all-reduces in every call."""
    _, _, per_rank, _ = ranks[name]
    cfg, (_, model) = serve_case(name)
    for _, res in per_rank:
        calls = res["calls"]
        assert len(calls) == 1 + 4 + tm.supports_chunked_prefill(cfg)
        for call in calls:
            assert call["counted"] == call["schedule"]
            if model > 1:
                assert call["counted"]["counts"]["all-reduce"] > 0


def test_layouts(ranks):
    """The attention layout each case takes."""
    want = {"starcoder_model4": "dim", "granite_model4": "mixed",
            "granite_model4_int8": "mixed", "mixtral_e2_model4": "mixed",
            "rgemma_model2": "mixed", "minicpm3_h2_model4": "dim",
            "whisper_h2_model4": "dim", "internvl_model4": "mixed"}
    for name in SERVE_CASES:
        for _, res in ranks[name][2]:
            assert res["layout"] == want.get(name, "heads"), name
            cross = name.startswith("whisper") and (
                "dim" if name == "whisper_h2_model4" else "heads")
            assert res["cross_layout"] == (cross or None), name


@pytest.mark.parametrize("name", JAX_CASES)
def test_logits_match_reference(ranks, name):
    """The ranks' logits against the reference's one-device ``prefill``
    and ``decode_step`` on the same weights."""
    _, _, per_rank, reference = ranks[name]
    for arrays, _ in per_rank:
        for key, w in reference.items():
            np.testing.assert_allclose(arrays[key], w, atol=LOGIT_TOL,
                                       rtol=LOGIT_TOL, err_msg=key)


@pytest.mark.parametrize("arch,what", [
    ("minicpm3-4b", {ATTN_MLA: "heads"}),
    ("mamba2-2.7b", {MAMBA2: "heads"}),
    ("recurrentgemma-2b", {RGLRU: "channels", ATTN_LOCAL: "mixed"}),
    ("whisper-large-v3", {ATTN: "heads"}),
    ("internvl2-76b", {ATTN: "heads"}),
])
def test_out_of_slice_stacks_refused(arch, what):
    """Every stack is taken on a model axis of 2, each kind with its
    layout: MLA, Mamba-2, RG-LRU beside local attention, the
    encoder-decoder (its cross-attention over heads) and the vision
    prefix; ``check_ported`` refuses none."""
    cfg = SMOKE_FACTORIES[arch]()
    tm.check_ported(cfg)
    assert serve_layouts(cfg, 2) == what
    if cfg.is_encoder_decoder:
        assert cross_split(cfg, 2) == "heads"


def _with(arch, **fields):
    import dataclasses

    cfg = SMOKE_FACTORIES[arch]()
    for name, sub in (("ssm", ("n_groups", "head_dim", "d_state")),
                      ("mla", ("kv_lora_rank", "v_head_dim")),
                      ("rglru", ("d_rnn",))):
        inner = {k: fields.pop(k) for k in sub if k in fields}
        if inner:
            fields[name] = dataclasses.replace(getattr(cfg, name), **inner)
    return dataclasses.replace(cfg, **fields)


@pytest.mark.parametrize("cfg,model,what", [
    # 8 Mamba-2 heads over 3 ranks (in_proj, the conv and the heads split
    # unevenly)
    (_with("mamba2-2.7b"), 3, "8 Mamba-2 heads"),
    # 4 heads a rank across groups of 3 (12 heads in 4 groups over 3
    # ranks: in_proj's 492 columns and the conv's 288 channels divide)
    (_with("mamba2-2.7b", head_dim=16, d_model=96, n_groups=4,
           d_state=12), 3,
     "4 Mamba-2 heads a rank across 4 B/C groups"),
    # a latent rank of 30 over 4 ranks: c whole on every rank
    (_with("minicpm3-4b", kv_lora_rank=30), 4, "latent rank 30"),
    # 4 MLA heads over 8 ranks beside v_head_dim 12: wo split unevenly
    (_with("minicpm3-4b", v_head_dim=12), 8,
     "4 latent-attention heads, head dim 32 and v_head_dim 12"),
    # an RG-LRU width of 100 over 8 ranks: replicated
    (_with("recurrentgemma-2b", d_rnn=100), 8, "RG-LRU width 100"),
])
def test_layouts_refused_by_name(cfg, model, what):
    """A shape that a layer kind's layout does not take (where the
    reference's specs replicate a leaf or split it unevenly) is refused by
    name, from the plan and from ``serve_layouts``."""
    class Mesh:
        axis_names, shape = ("data", "model"), {"data": 1, "model": model}

    match = f"serving over a model axis of {model} ranks with {what}"
    with pytest.raises(NotImplementedError, match=match):
        serve_layouts(cfg, model)
    with pytest.raises(NotImplementedError, match=match):
        ServePlan(Mesh, cfg, 2)


def _fake_mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=shape[0] * shape[1])
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def test_dryrun_serving_collectives(ranks):
    """The dry-run's serving collectives on a fake (1, 2) group: a decode
    step of the GQA, the Mamba-2 and the encoder-decoder case as their
    ranks counted it, labelled with the plan's schedule."""
    names = ("llama_model2", "mamba2_model2", "whisper_model2")
    shape = ShapeConfig("d", SERVE_MAX_LEN, 2, "decode")
    try:
        mesh = _fake_mesh((1, 2))
        got = {name: dryrun.serve_collectives(serve_case(name)[0], shape,
                                              mesh) for name in names}
    finally:
        dist.destroy_process_group()
    for name in names:
        counted = ranks[name][2][0][1]["calls"][1]["counted"]
        coll, why = got[name]
        assert why is None
        assert {k: coll[k] for k in ("bytes", "counts")} == counted
        assert coll["total_bytes"] == sum(counted["bytes"].values())
        assert "serve_schedule" in coll["schedule"]


@pytest.mark.parametrize("arch,counts", [
    # 40 MLA heads over 16: the head-dim layout (no query gather): per
    # layer the partial scores, wo's and the MLP's all-reduces, the latent
    # context's all-gather; the vocab (73 448) does not divide 16
    ("minicpm3-4b", {"all-gather": 62, "all-reduce": 3 * 62}),
    # per layer the projection's and the conv output's all-gathers, the
    # norm's and out_proj's all-reduces; the vocab does not divide 16
    ("mamba2-2.7b", {"all-gather": 2 * 64, "all-reduce": 2 * 64}),
    # 18 RG-LRU layers (one all-gather, two all-reduces each) and 8 local
    # attention layers over the head dim (k and q gathered; the scores,
    # wo and the MLP all-reduced); the embedding's all-reduce
    ("recurrentgemma-2b", {"all-gather": 18 + 2 * 8,
                           "all-reduce": 1 + 2 * 18 + 3 * 8}),
    # 20 heads of 64 over 16: every projection over the head dim; per
    # decoder layer the self-attention's k and q gathered, its scores and
    # wo all-reduced, the cross-attention's scores (its query needs no
    # gather) and wo all-reduced, the MLP's; no encoder in decode; the
    # vocab (51 866) does not divide 16
    ("whisper-large-v3", {"all-gather": 2 * 32, "all-reduce": 5 * 32}),
    # 64 query heads over 8 kv heads: "mixed"; per layer k and q gathered
    # and every head's output, the scores, wo and the MLP all-reduced; the
    # embedding's all-reduce (128 256 = 16 x 8016)
    ("internvl2-76b", {"all-gather": 3 * 80, "all-reduce": 1 + 3 * 80}),
])
def test_dryrun_production_serving_collectives(arch, counts):
    """The dry-run's decode_32k collectives on the fake 16 x 16 production
    group, from the plan's schedule, derived layer by layer."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch.mesh import make_production_mesh

    try:
        mesh = make_production_mesh(fake=True)
        got, why = dryrun.serve_collectives(
            get_config(arch), INPUT_SHAPES["decode_32k"], mesh)
    finally:
        dist.destroy_process_group()
    assert why is None
    assert {k: v for k, v in got["counts"].items() if v} == counts
    assert got["total_bytes"] == sum(got["bytes"].values()) > 0
