"""Training loop: AdamW steps over a decoder stack on the card.

Port of ``repro/training/trainer.py``.  A step is the loss
(``models.loss_fn``: the forward with remat, attention through the flash
kernel's autograd Function, chunked cross-entropy), its gradient by
``torch.autograd.grad`` (the flash backward kernel inside) and the AdamW
update in place.  The weights are drawn by ``weights.init_params`` from
``TrainConfig.seed`` on the device (``cuda`` unless the caller asks for
the CPU), or handed in (``params=``: the tests bridge the reference's).
Mamba-2 stacks train through the SSD scan's backward kernel.

With a ``mesh`` (a ``DeviceMesh`` over the default process group, e.g.
``launch.mesh.make_host_mesh``) training runs on every mesh the
reference's ``train(mesh=...)`` takes: a ``"model"`` axis, ``cfg.fsdp``
over ``"data"``, both, MoE stacks over several data ranks.  Each rank
keeps only its shard of every parameter (``models.param_specs``, cut by
``models.sharding.ShardPlan``), gathers it whole where a layer uses it
and scatters the gradient back (the reference's "weights are gathered at
use"); each rank takes its block of every batch's rows by
``batch_specs(..., include_model=cfg.train_batch_over_model)`` (in JAX's
order, ``models.sharding.shard_index``); the gradients are summed over
the ranks and divided by the world size before ``AdamW.update``, whose
clip sees the whole tree's norm, and the logged loss is the ranks' mean.
An MoE layer's capacity and load-balance loss span the whole batch
(``models.moe``).  A stack that keeps its batch off the model axis
(``train_batch_over_model=False``: RecurrentGemma-2B) runs its RG-LRU
branch channel-parallel over ``"model"``, the reference's layout (batch
over ``"data"`` x channels over ``"model"``): each model rank keeps its
channel block of the branch's leaves, never gathers it, and runs the
recurrence on d_rnn / model channels (``models.sharding.ChannelSplit``);
that stack's attention and MLP layers gather their weights as the
others do.  A checkpoint holds whole leaves, as ``train()``'s.  At
world size 1 this is ``train()`` bit for bit.  A vision stack's
batches carry stubbed patch embeddings (``patch_embeds``), an
encoder-decoder's (``audio_stub``, Whisper) stubbed frame embeddings
(``frames``), each (batch, ``n_frontend_tokens``, d_model) standard
normals drawn with numpy from the step's data seed: the reference's
``train`` feeds neither, so it cannot train such a stack.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import check_trainable, loss_fn
from repro_torch.models.sharding import ShardPlan, activate, gather_tree
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import batches
from repro_torch.training.optim import AdamW, cosine_schedule, tree_leaves
from repro_torch.weights import init_params, resolve_device


@dataclasses.dataclass
class TrainConfig:
    batch: int = 8
    seq_len: int = 256
    steps: int = 200
    peak_lr: float = 3e-4
    warmup: int = 20
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    log_every: int = 10
    ckpt_every: int = 0               # 0 = only final
    ckpt_path: str = ""
    seed: int = 0


# the batch key of a frontend stub's embeddings
STUB_INPUTS = {"vision_stub": "patch_embeds", "audio_stub": "frames"}


def stub_embeddings(cfg: ModelConfig, tc: TrainConfig, step: int):
    """Step ``step``'s stubbed patch or frame embeddings: (batch,
    ``n_frontend_tokens``, d_model) f32 standard normals from the step's
    data seed."""
    return np.random.default_rng(tc.seed * 100_003 + step).standard_normal(
        (tc.batch, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)


def make_train_step(cfg: ModelConfig, opt: AdamW, plan=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``; ``params`` are leaves that require a gradient, updated in
    place, and ``loss`` is a 0-d tensor on the device (read it to
    synchronise).  ``plan``: ``train(mesh=...)``'s ``ShardPlan`` (active
    around the step), whose gradients are summed over the ranks, and the
    loss averaged, before the update; over several ranks the clip reads
    the plan's norm of the whole tree from the shards."""
    if plan is not None and plan.world > 1:
        opt = dataclasses.replace(opt, norm=plan.global_norm)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        loss = loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        if plan is not None:
            plan.reduce_grads_(grads)
            loss = plan.mean_loss(loss)
        it = iter(grads)
        grad_tree = _like(params, it)
        params, opt_state = opt.update(grad_tree, opt_state, params)
        return params, opt_state, loss

    return train_step


def _like(tree, it):
    if isinstance(tree, dict):
        return {k: _like(v, it) for k, v in tree.items()}
    return next(it)


def train(cfg: ModelConfig, tc: TrainConfig = TrainConfig(), mesh=None,
          log=print, *, params=None, device=None):
    """``tc.steps`` AdamW steps on ``training.data.batches``; returns
    (params, [(step, loss), ...] at every ``log_every``-th step and the
    last).  ``params``: a tree to start from (on ``device``), else
    ``init_params`` from ``tc.seed``.  ``mesh``: over its ranks (module
    docstring); each rank returns its shards of the parameters."""
    check_trainable(cfg)
    device = resolve_device(device)
    mt = MeshTrainer(cfg, tc, mesh) if mesh is not None else None
    opt = AdamW(lr=cosine_schedule(tc.peak_lr, tc.warmup, tc.steps),
                weight_decay=tc.weight_decay, grad_clip=tc.grad_clip)
    if params is None:
        params = init_params(cfg, torch.Generator(device=device).manual_seed(
            tc.seed), device)
    if mt is not None:
        params = mt.place(params)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    opt_state = opt.init(params)
    plan = None if mt is None else mt.plan
    step_fn = make_train_step(cfg, opt, plan)

    def save(name):
        tree = params if mt is None else gather_tree(params, mt.specs,
                                                     mesh)
        if mt is None or mt.rank == 0:
            ckpt.save(f"{tc.ckpt_path}/{name}", tree)

    losses = []
    t0 = time.time()
    with activate(plan):
        for i, b in enumerate(batches(cfg.vocab_size, tc.batch, tc.seq_len,
                                      tc.steps, tc.seed)):
            stub = STUB_INPUTS.get(cfg.frontend)
            if stub:
                b[stub] = stub_embeddings(cfg, tc, i)
            if mt is not None:
                b = mt.rows(b)
            batch = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
            params, opt_state, loss = step_fn(params, opt_state, batch)
            if i % tc.log_every == 0 or i == tc.steps - 1:
                lv = float(loss)
                losses.append((i, lv))
                log(f"step {i:5d} loss {lv:.4f} "
                    f"({(time.time() - t0) / max(i, 1):.2f}s/step)")
            if tc.ckpt_every and tc.ckpt_path and i and \
                    i % tc.ckpt_every == 0:
                save(f"step_{i}.npz")
    if tc.ckpt_path:
        save("final.npz")
    return params, losses


class MeshTrainer:
    """``train(mesh=...)``'s placement of parameters (``ShardPlan``) and
    of batch rows over a ``DeviceMesh`` that spans the default process
    group: weights gathered at use, and, for a stack with
    ``train_batch_over_model=False``, the RG-LRU branch's leaves left in
    their channel blocks over ``"model"`` (the channel-parallel layout;
    a model axis that does not divide d_rnn is refused)."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, mesh):
        import torch.distributed as dist

        from repro_torch.models.sharding import batch_axes, mesh_axes

        axes = mesh_axes(mesh)
        world = dist.get_world_size()
        if axes.size != world:
            raise ValueError(f"train(mesh=...): the mesh holds {axes.size} "
                             f"of the group's {world} ranks")
        self.cfg, self.axes, self.rank = cfg, axes, dist.get_rank()
        self.plan = ShardPlan(mesh, batch_axes(
            tc.batch, axes, include_model=cfg.train_batch_over_model), cfg)

    def place(self, params):
        """Each leaf replaced, in the tree, by this rank's shard under its
        ``param_specs`` entry (``ShardPlan.shard``)."""
        from repro_torch.models.sharding import param_specs

        self.specs = param_specs(params, self.cfg, self.axes)
        return self.plan.shard(params, self.specs)

    def rows(self, batch):
        """This rank's block of every leaf's rows (numpy)."""
        index, count = self.plan.rows.index, self.plan.rows.count
        out = {}
        for k, v in batch.items():
            n = v.shape[0] // count
            out[k] = v[index * n:(index + 1) * n]
        return out
