"""Training loop: AdamW steps over a decoder stack on the card.

Port of ``repro/training/trainer.py``.  A step is the loss
(``models.loss_fn``: the forward with remat, attention through the flash
kernel's autograd Function, chunked cross-entropy), its gradient by
``torch.autograd.grad`` (the flash backward kernel inside) and the AdamW
update in place.  The weights are drawn by ``weights.init_params`` from
``TrainConfig.seed`` on the device (``cuda`` unless the caller asks for
the CPU), or handed in (``params=``: the tests bridge the reference's).
A ``mesh`` is refused: sharding is ROADMAP.md Queue A item 12.  Mamba-2
stacks train through the SSD scan's backward kernel.  A vision stack's
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


def make_train_step(cfg: ModelConfig, opt: AdamW):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``; ``params`` are leaves that require a gradient, updated in
    place, and ``loss`` is a 0-d tensor on the device (read it to
    synchronise)."""
    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        loss = loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        grad_tree = _like(params, it)
        params, opt_state = opt.update(grad_tree, opt_state, params)
        return params, opt_state, loss.detach()

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
    ``init_params`` from ``tc.seed``."""
    if mesh is not None:
        raise NotImplementedError("train: a device mesh (sharded training) "
                                  "is not ported (ROADMAP.md Queue A item "
                                  "12)")
    check_trainable(cfg)
    device = resolve_device(device)
    opt = AdamW(lr=cosine_schedule(tc.peak_lr, tc.warmup, tc.steps),
                weight_decay=tc.weight_decay, grad_clip=tc.grad_clip)
    if params is None:
        params = init_params(cfg, torch.Generator(device=device).manual_seed(
            tc.seed), device)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt)

    losses = []
    t0 = time.time()
    for i, b in enumerate(batches(cfg.vocab_size, tc.batch, tc.seq_len,
                                  tc.steps, tc.seed)):
        stub = STUB_INPUTS.get(cfg.frontend)
        if stub:
            b[stub] = stub_embeddings(cfg, tc, i)
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
