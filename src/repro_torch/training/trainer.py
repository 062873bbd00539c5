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
``launch.mesh.make_host_mesh``) training is data-parallel, as the
reference's ``train(mesh=...)`` with a model axis of 1: each parameter is
placed by ``models.param_specs`` (``distribute_tensor``) and the step runs
on its local tensor; each rank takes its block of every batch's rows by
``batch_specs(..., include_model=cfg.train_batch_over_model)`` (in JAX's
order, ``models.sharding.shard_index``); the gradients are averaged over
the ranks by all-reduce before ``AdamW.update``, so the clip sees the
global norm, and the logged loss is the ranks' mean.  At world size 1
this is ``train()`` bit for bit.  A ``"model"`` axis above 1 and
``cfg.fsdp`` need collectives inside the layers (tensor parallelism), and
an MoE stack's capacity and load-balance loss are functions of the whole
batch: these are refused by name (ROADMAP.md item 12b).  A vision stack's
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


def make_train_step(cfg: ModelConfig, opt: AdamW, ranks: int = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``; ``params`` are leaves that require a gradient, updated in
    place, and ``loss`` is a 0-d tensor on the device (read it to
    synchronise).  ``ranks``: the data-parallel ranks of the default
    process group (``train(mesh=...)``), over which the gradients and the
    loss are averaged by all-reduce before the update."""
    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        loss = loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        if ranks is not None:
            loss = loss.clone()
            _all_mean_([*grads, loss], ranks)
        it = iter(grads)
        grad_tree = _like(params, it)
        params, opt_state = opt.update(grad_tree, opt_state, params)
        return params, opt_state, loss

    return train_step


def _all_mean_(tensors, ranks: int) -> None:
    """Each tensor replaced in place by its mean over the default group's
    ``ranks`` ranks (a sum by all-reduce, then / ranks: exact at 1)."""
    import torch.distributed as dist

    for t in tensors:
        dist.all_reduce(t)
        t.div_(ranks)


def _like(tree, it):
    if isinstance(tree, dict):
        return {k: _like(v, it) for k, v in tree.items()}
    return next(it)


def train(cfg: ModelConfig, tc: TrainConfig = TrainConfig(), mesh=None,
          log=print, *, params=None, device=None):
    """``tc.steps`` AdamW steps on ``training.data.batches``; returns
    (params, [(step, loss), ...] at every ``log_every``-th step and the
    last).  ``params``: a tree to start from (on ``device``), else
    ``init_params`` from ``tc.seed``.  ``mesh``: data-parallel over its
    ranks (module docstring)."""
    check_trainable(cfg)
    device = resolve_device(device)
    dp = DataParallel(cfg, tc, mesh) if mesh is not None else None
    opt = AdamW(lr=cosine_schedule(tc.peak_lr, tc.warmup, tc.steps),
                weight_decay=tc.weight_decay, grad_clip=tc.grad_clip)
    if params is None:
        params = init_params(cfg, torch.Generator(device=device).manual_seed(
            tc.seed), device)
    if dp is not None:
        params = dp.place(params)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt,
                              ranks=None if dp is None else dp.ranks)

    losses = []
    t0 = time.time()
    for i, b in enumerate(batches(cfg.vocab_size, tc.batch, tc.seq_len,
                                  tc.steps, tc.seed)):
        stub = STUB_INPUTS.get(cfg.frontend)
        if stub:
            b[stub] = stub_embeddings(cfg, tc, i)
        if dp is not None:
            b = dp.rows(b)
        batch = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        params, opt_state, loss = step_fn(params, opt_state, batch)
        if i % tc.log_every == 0 or i == tc.steps - 1:
            lv = float(loss)
            losses.append((i, lv))
            log(f"step {i:5d} loss {lv:.4f} "
                f"({(time.time() - t0) / max(i, 1):.2f}s/step)")
        if tc.ckpt_every and tc.ckpt_path and i and i % tc.ckpt_every == 0:
            ckpt.save(f"{tc.ckpt_path}/step_{i}.npz", params)
    if tc.ckpt_path:
        ckpt.save(f"{tc.ckpt_path}/final.npz", params)
    return params, losses


class DataParallel:
    """``train(mesh=...)``'s placement of parameters and batch rows over a
    ``DeviceMesh`` that spans the default process group; refuses what
    needs more than data parallelism."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, mesh):
        import torch.distributed as dist

        from repro_torch.models.sharding import batch_axes, mesh_axes

        axes = mesh_axes(mesh)
        if axes.shape.get("model", 1) > 1:
            raise NotImplementedError(
                f"train(mesh=...): a 'model' axis of {axes.shape['model']} "
                "needs tensor-parallel layers (collectives inside the "
                "layers), which the port does not have (ROADMAP.md item "
                "12b); use a model axis of 1")
        if cfg.fsdp:
            raise NotImplementedError(
                f"train(mesh=...): {cfg.name}: cfg.fsdp shards the weights "
                "over 'data' and needs them gathered inside the layers, "
                "which the port does not do (ROADMAP.md item 12b)")
        self.ranks = dist.get_world_size()
        if axes.size != self.ranks:
            raise ValueError(f"train(mesh=...): the mesh holds {axes.size} "
                             f"of the group's {self.ranks} ranks")
        if cfg.moe is not None and self.ranks > 1:
            raise NotImplementedError(
                f"train(mesh=...): {cfg.name} is an MoE stack: its expert "
                "capacity and load-balance loss are functions of the whole "
                "batch, so they would differ over "
                f"{self.ranks} data ranks (ROADMAP.md item 12b)")
        self.cfg, self.mesh, self.axes = cfg, mesh, axes
        self.entry = batch_axes(tc.batch, axes,
                                include_model=cfg.train_batch_over_model)
        self.coords = {n: mesh.get_local_rank(n) for n in axes.axis_names}

    def place(self, params):
        """Each leaf placed by its ``param_specs`` entry and replaced, in
        the tree, by its local tensor, one leaf at a time: a placement
        that copies (``Shard`` scatters into a new tensor) frees the old
        leaf at once, so the tree is never held twice."""
        from torch.distributed.tensor import distribute_tensor

        from repro_torch.models.sharding import param_specs, placements

        def put(tree, specs):
            for k, v in tree.items():
                if isinstance(v, dict):
                    put(v, specs[k])
                else:
                    tree[k] = distribute_tensor(
                        v.detach(), self.mesh,
                        placements(specs[k], self.axes)).to_local()
                    del v

        put(params, param_specs(params, self.cfg, self.axes))
        return params

    def rows(self, batch):
        """This rank's block of every leaf's rows (numpy)."""
        from repro_torch.models.sharding import shard_index

        index, count = shard_index(self.entry, self.axes, self.coords)
        out = {}
        for k, v in batch.items():
            n = v.shape[0] // count
            out[k] = v[index * n:(index + 1) * n]
        return out
