"""Training on a mesh in the port (``train(mesh=...)``, CPU, f32):

- at world size 1 (a gloo host mesh in this process) ``train(mesh=...)``
  is ``train()`` bit for bit, losses and final parameters, from the
  reference's weights bridged (``params=``) and from the port's own draw;
- over two gloo ranks (a process each, a ``FileStore``: no network) each
  rank takes half of every batch's rows, the gradients and the loss are
  averaged over the ranks: the losses step for step within 1e-6 relative
  of ``train()`` (a mean of two half-batch means rounds apart from the
  whole batch's by an ulp or two of f32);
- what the refusals of the data-parallel slice now run (their names
  kept): a ``"model"`` axis of 2 over two gloo ranks, the weights
  gathered at use, within 1e-6 of ``train()``; ``cfg.fsdp`` at world size
  1, ``train()`` bit for bit; an MoE stack over two data ranks, its
  capacity and load-balance loss over the whole batch, within 1e-6 of
  ``train()``.  ``tests/test_torch_train_tp.py`` covers every mesh and
  family.  ``train()`` itself is held to the reference's ``train`` in
  ``tests/test_torch_training.py``."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.training as T
from repro.configs import SMOKE_FACTORIES
from repro.models import init_params as j_init_params
from repro_torch.training.optim import tree_leaves
from repro_torch.weights import params_from_numpy

from _torch_dist_ranks import (TRAIN_STEPS, moe_config, start_ranks,
                               train_config, wait_ranks)
from _torch_train_parity import port_config

DP_LOSS_REL = 1e-6


def _quiet(_msg):
    pass


@pytest.fixture(scope="module")
def rank_losses(tmp_path_factory):
    """The losses of the two-rank jobs ``train``, ``train_model_axis`` and
    ``train_moe``, started together (each a process a rank over its own
    ``FileStore``)."""
    tmp = tmp_path_factory.mktemp("ranks")
    jobs = {job: start_ranks(job, 2, tmp)
            for job in ("train", "train_model_axis", "train_moe")}
    for procs, _ in jobs.values():
        wait_ranks(procs)
    return {job: json.loads(out.read_text())
            for job, (_, out) in jobs.items()}


@pytest.fixture
def host_mesh():
    from repro_torch.launch.mesh import make_host_mesh

    assert not dist.is_initialized()
    mesh = make_host_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_train_on_world_size_1_mesh_is_train(host_mesh):
    cfg, tc = train_config()
    assert tc.steps == TRAIN_STEPS
    p0, l0 = T.train(cfg, tc, log=_quiet, device="cpu")
    p1, l1 = T.train(cfg, tc, mesh=host_mesh, log=_quiet, device="cpu")
    assert l1 == l0 and len(l0) == TRAIN_STEPS
    for a, b in zip(tree_leaves(p0), tree_leaves(p1)):
        assert torch.equal(a, b)


def test_train_on_world_size_1_mesh_from_reference_weights(host_mesh):
    """Granite-3-2B's smoke config (tied embeddings) from the reference's
    f32 weights, bridged."""
    jcfg = dataclasses.replace(SMOKE_FACTORIES["granite-3-2b"](),
                               dtype="float32")
    cfg = port_config(jcfg)
    tc = T.TrainConfig(batch=2, seq_len=16, steps=2, warmup=1, log_every=1)
    weights = jax.tree.map(np.asarray, j_init_params(jax.random.key(0),
                                                     jcfg))
    p0, l0 = T.train(cfg, tc, log=_quiet, device="cpu",
                     params=params_from_numpy(weights, "cpu"))
    p1, l1 = T.train(cfg, tc, mesh=host_mesh, log=_quiet, device="cpu",
                     params=params_from_numpy(weights, "cpu"))
    assert l1 == l0
    for a, b in zip(tree_leaves(p0), tree_leaves(p1)):
        assert torch.equal(a, b)


def test_train_over_two_data_ranks(rank_losses):
    got = rank_losses["train"]
    cfg, tc = train_config()
    _, want = T.train(cfg, tc, log=_quiet, device="cpu")
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert abs(a - b) <= DP_LOSS_REL * abs(b), (got, want)


def _losses_match_train(got, cfg, tc):
    _, want = T.train(cfg, tc, log=_quiet, device="cpu")
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert abs(a - b) <= DP_LOSS_REL * abs(b), (got, want)


def test_refuses_a_model_axis(rank_losses):
    """No longer refused: a (1, 2) mesh, a ``"model"`` axis of 2 over two
    ranks (the weights gathered at use, the rows split over the model
    axis), trains as ``train()``."""
    _losses_match_train(rank_losses["train_model_axis"], *train_config())


def test_refuses_fsdp(host_mesh):
    """No longer refused: ``cfg.fsdp`` at world size 1 (a data axis of 1
    shards nothing) is ``train()`` bit for bit, losses and parameters."""
    cfg, tc = train_config()
    cfg = dataclasses.replace(cfg, fsdp=True)
    p0, l0 = T.train(cfg, tc, log=_quiet, device="cpu")
    p1, l1 = T.train(cfg, tc, mesh=host_mesh, log=_quiet, device="cpu")
    assert l1 == l0
    for a, b in zip(tree_leaves(p0), tree_leaves(p1)):
        assert torch.equal(a, b)


def test_refuses_moe_over_two_data_ranks(rank_losses):
    """No longer refused: smoke DeepSeek-MoE over two data ranks, its
    load-balance loss over the whole batch, trains as ``train()``."""
    _losses_match_train(rank_losses["train_moe"], *moe_config())


def test_moe_on_world_size_1_mesh_is_train(host_mesh):
    """At one data rank the whole batch is the rank's: MoE trains, equal
    to ``train()`` bit for bit."""
    cfg = port_config(dataclasses.replace(
        SMOKE_FACTORIES["deepseek-moe-16b"](), dtype="float32"))
    tc = T.TrainConfig(batch=2, seq_len=16, steps=2, warmup=1, log_every=1)
    _, l0 = T.train(cfg, tc, log=_quiet, device="cpu")
    _, l1 = T.train(cfg, tc, mesh=host_mesh, log=_quiet, device="cpu")
    assert l1 == l0
