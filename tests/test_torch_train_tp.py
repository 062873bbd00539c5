"""Training with the weights gathered at use (``train(mesh=...)`` on every
mesh the reference's takes; CPU, f32, smoke configs, 3 steps; gloo ranks,
a process each over a ``FileStore``: no network).  Each rank keeps its
shard of every parameter, gathers a layer's leaves whole where the layer
uses them and scatters their gradient back (``models.sharding.
ShardPlan``); rows are split over the batch's axes.  Against
``train()`` in one process (itself held to the reference's ``train`` in
``tests/test_torch_training.py``), ``TP_CASES``:

- ``(1, 2)`` meshes: Llama-2 (its smoke vocab of 512 shards the table),
  Granite-3-2B (GQA, tied embeddings, remat: the gathers inside the
  checkpointed layers), Mamba-2, MiniCPM3 (MLA), Whisper (the encoder's
  layers too), InternVL2 (the vision prefix) and RecurrentGemma with
  ``train_batch_over_model=False`` (both model ranks hold the same rows,
  and the RG-LRU branch runs channel-parallel: each rank keeps its
  channel block of the branch's leaves; ``tests/test_torch_train_
  channels.py`` holds its gradients and widths);
- ``(2, 1)`` with ``fsdp=True``; ``(2, 2)`` with fsdp and remat, where a
  weight is split over both axes (Llama-2, and RecurrentGemma
  channel-parallel);
- DeepSeek-MoE over ``(2, 1)``, ``moe_impl`` dense and dispatch (capacity
  factor 1.0: assignments drop), the dispatch once with chunks of 48 of
  the 128 tokens, so a chunk spans both ranks.

Three cases start from the reference's weights (drawn by JAX, bridged)
and are also held to the reference's ``train`` itself, as
``tests/_torch_train_parity.py`` holds ``train()``: ``(2, 2)`` with fsdp
and remat, the MoE dispatch in chunks of 48 over ``(2, 1)`` (the
reference's chunk set to 48 for the run), and channel-parallel
RecurrentGemma over ``(1, 2)`` (its losses).

The losses step for step within ``DP_LOSS_REL`` (1e-6) relative; the
final parameters, gathered whole, within ``PARAM_REL`` (1e-5) of the
tree's largest weight (Adam moves an element whose gradient sits at
rounding level by a few 1e-6 either way, as in
``tests/_torch_train_parity.py``).  Also: the clip's norm (at a clip that
binds) against ``train()``'s, the checkpoint a ``(1, 2)`` run writes
against ``train()``'s file, every rank's shards of a ``(2, 2)`` run
against ``shard_index``'s blocks, and one step's collectives as the ranks
counted them against the dry-run's schedule (``launch.dryrun.
step_collectives`` on a fake ``(2, 2)`` group) and, for the MoE cases,
``ShardPlan.step_schedule``."""
import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.models.moe as jm
import repro.training as J

from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models import moe
from repro_torch.models.model import loss_fn
from repro_torch.models.sharding import param_specs, shard_index
from repro_torch.training import train
from repro_torch.training.checkpoint import restore
from repro_torch.training.data import batches
from repro_torch.training.optim import global_norm, tree_leaves
from repro_torch.weights import init_params

from _torch_dist_ranks import (TP_CASES, flat, reference_weights_path,
                               start_ranks, tp_case, wait_ranks)
from _torch_train_parity import LOSS_REL, bridge, port_config, smoke
from repro.models import init_params as j_init_params

DP_LOSS_REL = 1e-6
PARAM_REL = 1e-5


REFERENCE_CASES = [n for n, c in TP_CASES.items() if c[3].get("reference")]


def _reference_config(name):
    """The reference's config of a ``TP_CASES`` case (f32), and its
    TrainConfig's fields."""
    arch, _, fields, _ = TP_CASES[name]
    cfg, tc, _, _ = tp_case(name)
    jcfg = smoke(arch, dtype="float32", **fields)
    assert port_config(jcfg) == cfg
    return jcfg, {f.name: getattr(tc, f.name)
                  for f in dataclasses.fields(J.TrainConfig)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The reference cases' initial weights (the reference's
    ``init_params`` from the case's seed) written where their ranks read
    them; both jobs (2 and 4 ranks) started at once; while they run, each
    case's ``train()`` in this process (from the same weights; the
    checkpoint case's writing its file, ``single/final.npz``), the clip
    case's step-0 norm and the reference's ``train`` of each reference
    case.  Returns ({case: (result, OUT, (flat final parameters,
    losses))}, the norm, the directory, {reference case: (flat final
    parameters, losses) of the reference's ``train``})."""
    tmp = tmp_path_factory.mktemp("tp")
    start = {}
    for name in REFERENCE_CASES:
        jcfg, jtc = _reference_config(name)
        weights = jax.tree.map(np.asarray, j_init_params(
            jax.random.key(jtc["seed"]), jcfg))
        start[name] = weights
        world = TP_CASES[name][1][0] * TP_CASES[name][1][1]
        np.savez(reference_weights_path(tmp / f"tp{world}.out", name),
                 **flat(bridge(weights)))
    jobs = [start_ranks(f"tp{world}", world, tmp) for world in (2, 4)]
    try:
        want = {name: _train(name, params=bridge(start[name])
                             if name in start else None,
                             **({"ckpt_path": str(tmp / "single")}
                                if TP_CASES[name][3].get("ckpt") else {}))
                for name in TP_CASES}
        norm = _step0_norm("llama_model2_clip")
        reference = {name: _reference_train(name) for name in start}
    finally:
        out = {}
        for procs, path in jobs:
            wait_ranks(procs, timeout=300)
            out.update({name: (res, path) for name, res in
                        json.loads(path.read_text()).items()})
    assert set(out) == set(TP_CASES)
    return ({name: (*out[name], (flat(want[name][0]), want[name][1]))
             for name in TP_CASES}, norm, tmp, reference)


def _train(name, params=None, **tc_kw):
    """``train()`` of case ``name`` in this process (from ``params``, else
    from the case's seed)."""
    cfg, tc, _, opts = tp_case(name)
    chunk = moe.DISPATCH_CHUNK_TOKENS
    moe.DISPATCH_CHUNK_TOKENS = opts.get("chunk", chunk)
    try:
        return train(cfg, dataclasses.replace(tc, **tc_kw),
                     log=lambda m: None, device="cpu", params=params)
    finally:
        moe.DISPATCH_CHUNK_TOKENS = chunk


def _reference_train(name):
    """The reference's ``train`` of case ``name`` (its MoE dispatch in the
    case's chunks): (flat final parameters, losses)."""
    jcfg, jtc = _reference_config(name)
    chunk = TP_CASES[name][3].get("chunk")
    with pytest.MonkeyPatch.context() as mp:
        if chunk:
            mp.setattr(jm, "moe_dispatch_chunked", functools.partial(
                jm.moe_dispatch_chunked, chunk=chunk))
        params, losses = J.train(jcfg, J.TrainConfig(**jtc),
                                 log=lambda m: None)
    return flat(bridge(params)), losses


def _step0_norm(name):
    """The whole step-0 gradient's norm in one process."""
    cfg, tc, _, _ = tp_case(name)
    params = init_params(cfg, torch.Generator().manual_seed(tc.seed), "cpu")
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    b = next(batches(cfg.vocab_size, tc.batch, tc.seq_len, 1, tc.seed))
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    return float(global_norm(list(torch.autograd.grad(
        loss_fn(params, batch, cfg), leaves))))


@pytest.mark.parametrize("name", list(TP_CASES))
def test_case_matches_train(ranks, name):
    res, out, (want_p, want) = ranks[0][name]
    got = res["losses"]
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 1, 2]
    for (_, a), (_, b) in zip(got, want):
        assert abs(a - b) <= DP_LOSS_REL * abs(b), (name, got, want)
    whole = np.load(f"{out}.{name}.npz")
    assert sorted(whole.files) == sorted(want_p)
    top = max(np.abs(w).max() for w in want_p.values())
    for k, w in want_p.items():
        assert whole[k].shape == w.shape, k
        err = np.abs(whole[k] - w).max()
        assert err <= PARAM_REL * top, (name, k, err, top)


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_case_matches_reference_train(ranks, name):
    """A reference case's losses within LOSS_REL (1e-5) relative of the
    reference's ``train`` step for step, and its final parameters,
    gathered whole, within 1e-5 absolute (``check_train``'s bounds; a
    ``"losses"`` case's parameters are held to ``train()``'s by
    ``test_case_matches_train``)."""
    res, out, _ = ranks[0][name]
    want_p, want = ranks[3][name]
    got = res["losses"]
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 1, 2]
    for (_, a), (_, b) in zip(got, want):
        assert a == pytest.approx(b, rel=LOSS_REL), (name, got, want)
    if TP_CASES[name][3]["reference"] == "losses":
        return
    whole = np.load(f"{out}.{name}.npz")
    assert sorted(whole.files) == sorted(want_p)
    for k, w in want_p.items():
        np.testing.assert_allclose(whole[k], w, rtol=0, atol=1e-5,
                                   err_msg=k)


def test_clip_norm_matches_train(ranks):
    """Step 0's gradient norm from the shards (each leaf's sum of squares
    summed over the axes that split it) against the whole gradient's in
    one process, at a clip that binds."""
    name = "llama_model2_clip"
    want = ranks[1]
    got = ranks[0][name][0]["step0_norm"]
    assert want > tp_case(name)[1].grad_clip
    assert abs(got - want) <= DP_LOSS_REL * want, (got, want)


def test_checkpoint_of_a_model_axis_run_is_trains(ranks):
    """A (1, 2) run's final checkpoint holds whole leaves: the file
    ``train()`` writes, within PARAM_REL."""
    _, out, _ = ranks[0]["granite_model2_remat"]
    want = flat(restore(str(ranks[2] / "single" / "final.npz")))
    got = flat(restore(f"{out}.ckpt/final.npz"))
    assert sorted(got) == sorted(want)
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert np.abs(got[k] - w).max() <= PARAM_REL * top, k


class _Mesh2x2:
    shape = {"data": 2, "model": 2}
    axis_names = ("data", "model")
    size = 4


def test_shards_are_shard_index_blocks(ranks):
    """Every rank's initial shard of every leaf of the (2, 2) fsdp run is
    ``shard_index``'s block of each split dimension (ranks data-major:
    rank = 2 data + model); the split leaves cover both axes."""
    name = "llama_fsdp_2x2_remat"
    _, out, _ = ranks[0][name]
    cfg, tc, _, _ = tp_case(name)
    params = init_params(cfg, torch.Generator().manual_seed(tc.seed), "cpu")
    specs = flat_specs(param_specs(params, cfg, _Mesh2x2()))
    whole = flat(params)
    both = [k for k, s in specs.items()
            if {"data", "model"} <= {e for e in s if e}]
    assert both, specs
    for rank in range(4):
        coords = {"data": rank // 2, "model": rank % 2}
        shard = np.load(f"{out}.{name}.shard{rank}.npz")
        for k, w in whole.items():
            for d, entry in enumerate(specs[k]):
                i, n = shard_index(entry, _Mesh2x2(), coords)
                size = w.shape[d] // n
                w = np.take(w, range(i * size, (i + 1) * size), axis=d)
            np.testing.assert_array_equal(shard[k], w, err_msg=k)


def flat_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_specs(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_dryrun_collectives_equal_a_2x2_step(ranks):
    """The dry-run's collectives of a training shape (the port's
    schedule, on a fake (2, 2) group in this process) equal, kind for
    kind in bytes and counts, what a (2, 2) gloo step moved."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    name = "llama_fsdp_2x2_remat"
    counted = ranks[0][name][0]["collectives"]["counted"]
    cfg, tc, _, _ = tp_case(name)
    shape = ShapeConfig("tp", tc.seq_len, tc.batch, "train")
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        got = dryrun.step_collectives(cfg, shape, mesh)
    finally:
        dist.destroy_process_group()
    assert got["bytes"] == counted["bytes"]
    assert got["counts"] == counted["counts"]
    assert got["total_bytes"] == sum(counted["bytes"].values())
    assert counted["counts"]["all-gather"] > 0 and \
        counted["counts"]["reduce-scatter"] > 0
    assert "not XLA's" in got["schedule"]


def test_channel_collectives_as_scheduled(ranks):
    """Channel-parallel RecurrentGemma over (2, 2) with fsdp and remat:
    one step's collectives, the branch's all-gathers, reduce-scatters and
    all-reduces of activations included, as ``ShardPlan.step_schedule``
    derives them."""
    c = ranks[0]["rgemma_fsdp_2x2_remat"][0]["collectives"]
    assert c["counted"] == c["schedule"]
    branch = c["channel_terms"]["counts"]
    assert branch["all-gather"] > 0 and branch["reduce-scatter"] > 0


@pytest.mark.parametrize("name", ["moe_dense_data2",
                                  "moe_dispatch_chunk48_data2"])
def test_moe_collectives_as_scheduled(ranks, name):
    """An MoE step over two data ranks: the routed-token counts' one
    all-gather per MoE layer and forward, and the replicated gradients'
    all-reduces, as ``ShardPlan.step_schedule`` derives them."""
    c = ranks[0][name][0]["collectives"]
    assert c["counted"] == c["schedule"]
    assert c["counted"]["counts"]["all-gather"] >= 1
