"""Data-parallel training in the port (``train(mesh=...)``, CPU, f32):

- at world size 1 (a gloo host mesh in this process) ``train(mesh=...)``
  is ``train()`` bit for bit, losses and final parameters, from the
  reference's weights bridged (``params=``) and from the port's own draw;
- over two gloo ranks (a process each, a ``FileStore``: no network) each
  rank takes half of every batch's rows, the gradients and the loss are
  averaged by all-reduce: the losses step for step within 1e-6 relative
  of ``train()`` (a mean of two half-batch means rounds apart from the
  whole batch's by an ulp or two of f32);
- the refusals, by name and ROADMAP item 12b: a ``"model"`` axis above
  1, ``cfg.fsdp``, and an MoE stack over two data ranks (its capacity and
  load-balance loss are functions of the whole batch).  ``train()``
  itself is held to the reference's ``train`` in
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

from _torch_dist_ranks import TRAIN_STEPS, run_ranks, train_config
from _torch_train_parity import port_config

DP_LOSS_REL = 1e-6


def _quiet(_msg):
    pass


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


def test_train_over_two_data_ranks(tmp_path):
    out = run_ranks("train", 2, tmp_path)
    got = json.loads(out.read_text())
    cfg, tc = train_config()
    _, want = T.train(cfg, tc, log=_quiet, device="cpu")
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert abs(a - b) <= DP_LOSS_REL * abs(b), (got, want)


class _TensorParallelMesh:
    shape = {"data": 1, "model": 2}
    axis_names = ("data", "model")
    size = 2


def test_refuses_a_model_axis():
    cfg, tc = train_config()
    with pytest.raises(NotImplementedError,
                       match=r"'model' axis of 2.*ROADMAP.md item 12b"):
        T.train(cfg, tc, mesh=_TensorParallelMesh(), log=_quiet,
                device="cpu")


def test_refuses_fsdp(host_mesh):
    cfg, tc = train_config()
    with pytest.raises(NotImplementedError,
                       match=r"cfg.fsdp.*ROADMAP.md item 12b"):
        T.train(dataclasses.replace(cfg, fsdp=True), tc, mesh=host_mesh,
                log=_quiet, device="cpu")


def test_refuses_moe_over_two_data_ranks(tmp_path):
    msg = run_ranks("train_moe", 2, tmp_path).read_text()
    assert "MoE stack" in msg and "ROADMAP.md item 12b" in msg, msg


def test_moe_on_world_size_1_mesh_is_train(host_mesh):
    """At one data rank the whole batch is the rank's: MoE trains, equal
    to ``train()`` bit for bit."""
    cfg = port_config(dataclasses.replace(
        SMOKE_FACTORIES["deepseek-moe-16b"](), dtype="float32"))
    tc = T.TrainConfig(batch=2, seq_len=16, steps=2, warmup=1, log_every=1)
    _, l0 = T.train(cfg, tc, log=_quiet, device="cpu")
    _, l1 = T.train(cfg, tc, mesh=host_mesh, log=_quiet, device="cpu")
    assert l1 == l0
