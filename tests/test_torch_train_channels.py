"""Channel-parallel RG-LRU in ``train(mesh=...)`` (CPU, f32, smoke
RecurrentGemma with ``train_batch_over_model=False``; gloo ranks, a
process each over a ``FileStore``: no network), ``CHANNEL_CASES``: a
``(1, 2)`` mesh, and ``(2, 2)`` with fsdp and remat.  The RG-LRU branch's
leaves stay each model rank's channel block (``models.sharding.
ChannelSplit``); the recurrence runs on d_rnn / model channels.  Against
``train()`` in one process:

- step 0's gradients, reduced as ``train(mesh=...)`` reduces them and
  gathered whole, within 1e-5 of each leaf's largest (a missing
  all-reduce of the branch's input gradient, or of its output, or a
  wrong scale of a channel-local leaf's gradient, is far outside);
- every ``linear_scan`` a rank runs is d_rnn / model channels wide;
- no RG-LRU leaf is gathered over ``"model"`` (its ``"data"`` steps under
  fsdp stay), and only they keep a local split;
- one step's collectives as the ranks counted them equal
  ``ShardPlan.step_schedule``'s, and, on the ``(2, 2)`` mesh, the
  dry-run's (``launch.dryrun.step_collectives`` on a fake group);
- a model axis that does not divide d_rnn is refused by name.

The losses of these cases over three steps, and a ``(1, 2)`` case from the
reference's weights against the reference's ``train``, are in
``tests/test_torch_train_tp.py``."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import RGLRU, ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models.model import loss_fn, model_stages
from repro_torch.models.rglru import rglru_init
from repro_torch.training.data import batches
from repro_torch.training.optim import tree_leaves
from repro_torch.weights import init_params

from _torch_dist_ranks import (CHANNEL_CASES, flat, start_ranks, tp_case,
                               wait_ranks)

GRAD_REL = 1e-5


def _grads_one_process(name):
    """Step 0's gradients of ``train()`` in this process, flat."""
    cfg, tc, _, _ = tp_case(name)
    params = init_params(cfg, torch.Generator().manual_seed(tc.seed), "cpu")
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    b = next(batches(cfg.vocab_size, tc.batch, tc.seq_len, 1, tc.seed))
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    grads = iter(torch.autograd.grad(loss_fn(params, batch, cfg), leaves))

    def like(tree):
        if isinstance(tree, dict):
            return {k: like(v) for k, v in tree.items()}
        return next(grads)

    return flat(like(params))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both jobs (2 and 4 ranks) at once; while they run, each case's
    one-process gradients.  Returns {case: (result, OUT, gradients)}."""
    import json

    jobs = [start_ranks("channels", world,
                        tmp_path_factory.mktemp(f"channels{world}"))
            for world in (2, 4)]
    try:
        want = {name: _grads_one_process(name) for name in CHANNEL_CASES}
    finally:
        out = {}
        for procs, path in jobs:
            wait_ranks(procs, timeout=300)
            out.update({name: (res, path) for name, res in
                        json.loads(path.read_text()).items()})
    assert set(out) == set(CHANNEL_CASES)
    return {name: (*out[name], want[name]) for name in CHANNEL_CASES}


@pytest.mark.parametrize("name", CHANNEL_CASES)
def test_step0_gradients_match_train(ranks, name):
    _, out, want = ranks[name]
    got = np.load(f"{out}.{name}.grads.npz")
    assert sorted(got.files) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        err = float(np.abs(got[k] - w).max())
        assert err <= GRAD_REL * float(np.abs(w).max()), (name, k, err)


@pytest.mark.parametrize("name", CHANNEL_CASES)
def test_recurrence_runs_on_a_channel_block(ranks, name):
    """Each RG-LRU layer's scan (again under remat's recompute) on
    d_rnn / model channels."""
    res, _, _ = ranks[name]
    cfg, _, (_, model), _ = tp_case(name)
    n_rec = sum(n for kind, _, n in model_stages(cfg) if kind == RGLRU)
    assert n_rec == 2
    runs = n_rec * (2 if cfg.remat else 1)
    assert res["scan_widths"] == [cfg.rglru.d_rnn // model] * runs


@pytest.mark.parametrize("name", CHANNEL_CASES)
def test_rglru_leaves_are_not_gathered_over_model(ranks, name):
    res, _, _ = ranks[name]
    cfg, _, (data, _), _ = tp_case(name)
    steps = res["rglru_steps"]
    keys = rglru_init(cfg, torch.float32, torch.Generator().manual_seed(0),
                      "cpu")
    assert {k.split("/")[-1] for k in steps} == set(keys)
    assert sorted(steps) == res["local"]
    for path, st in steps.items():
        assert all(axis != "model" for _, axis in st), (path, st)
    if cfg.fsdp and data > 1:              # fsdp's data steps still gather
        assert any(st for st in steps.values())


@pytest.mark.parametrize("name", CHANNEL_CASES)
def test_counted_collectives_equal_schedule(ranks, name):
    c = ranks[name][0]["collectives"]
    assert c["counted"] == c["schedule"]
    assert c["counted"]["counts"]["all-reduce"] > 0


def _fake_mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=shape[0] * shape[1])
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def test_dryrun_channel_terms_equal_a_2x2_step(ranks):
    """The dry-run's collectives of the (2, 2) case's step (the schedule
    on a fake (2, 2) group in this process) equal what its ranks counted;
    its channel-parallel RG-LRU terms (``ShardPlan.channel_schedule``)
    are the two layers' activations: each conv output all-gathered and
    each output all-reduced in both forwards (remat), each conv output's
    gradient reduce-scattered and each input's gradient all-reduced
    once."""
    from repro_torch.launch.specs import param_structs
    from repro_torch.models.sharding import (ShardPlan, batch_axes,
                                             param_specs)

    name = "rgemma_fsdp_2x2_remat"
    res = ranks[name][0]["collectives"]
    cfg, tc, _, _ = tp_case(name)
    try:
        mesh = _fake_mesh((2, 2))
        got = dryrun.step_collectives(
            cfg, ShapeConfig("tp", tc.seq_len, tc.batch, "train"), mesh)
        plan = ShardPlan(mesh, batch_axes(tc.batch, mesh), cfg)
        params = param_structs(cfg)
        plan.shard(params, param_specs(params, cfg, mesh))
        terms = plan.channel_schedule(tc.batch * tc.seq_len)
    finally:
        dist.destroy_process_group()
    assert got["bytes"] == res["counted"]["bytes"]
    assert got["counts"] == res["counted"]["counts"]
    assert terms == res["channel_terms"]
    rows, d, d_rnn = tc.batch // 2 * tc.seq_len, cfg.d_model, cfg.rglru.d_rnn
    assert terms["counts"] == {"all-gather": 4, "all-reduce": 6,
                               "reduce-scatter": 2, "all-to-all": 0,
                               "collective-permute": 0}
    assert terms["bytes"]["all-gather"] == 4 * rows * d_rnn * 4
    assert terms["bytes"]["reduce-scatter"] == 2 * rows * d_rnn // 2 * 4
    assert terms["bytes"]["all-reduce"] == 6 * rows * d * 4


def test_model_axis_must_divide_d_rnn():
    import dataclasses

    cfg, tc, _, _ = tp_case("rgemma_model2_channels")
    cfg = dataclasses.replace(cfg, rglru=dataclasses.replace(
        cfg.rglru, d_rnn=cfg.rglru.d_rnn + 2))
    try:
        mesh = _fake_mesh((1, 4))
        with pytest.raises(ValueError, match="d_rnn 130 .* model axis of 4"):
            dryrun.step_collectives(
                cfg, ShapeConfig("tp", tc.seq_len, tc.batch, "train"), mesh)
    finally:
        dist.destroy_process_group()
