"""Meta-tensor stand-ins and the sharded step functions of the dry-run.

Port of ``repro/launch/specs.py``.  ``input_specs(cfg, shape)`` returns
stand-ins for every model input: ``meta`` tensors with the reference's
shapes and dtypes (tokens int32; frames or patch embeddings, the stubbed
modality frontends, in the config's dtype), which allocate nothing.
``param_structs`` is the parameter tree on ``meta``: ``init_params``
itself, whose draws on ``meta`` consume no random bits (so a host
generator stands in for the device generator a meta device lacks).

``build_step(cfg, shape, mesh)`` returns ``(fn, args, in_placements,
donate_argnums)`` as the reference returns its ``in_shardings``: DTensor
placements per argument leaf (``models.sharding.placements``; ``None``
for the optimizer's host step counter), with the reference's choices:
ZeRO-1 moment specs (``fsdp=True``) for training, the training batch
spread over ``"model"`` too (``train_batch_over_model``), the cache
specs for decode.  ``out_specs`` gives the step's output specs: the
updated parameters and moments under the moments' ZeRO-1 specs (each
device updates its slice; the reference's compiled step places them so),
the loss replicated; the logits' rows over the batch's axes and vocab
over ``model``, and the cache specs.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig, ShapeConfig
from repro_torch.models import (batch_specs, cache_specs, init_cache,
                                long_context_variant, param_specs, prefill)
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import decode_step
from repro_torch.models.sharding import P, batch_axes, mesh_axes, placements
from repro_torch.training.optim import AdamW, tree_leaves
from repro_torch.training.trainer import make_train_step
from repro_torch.weights import init_params

META = torch.device("meta")


def shape_cfg(name: str) -> ShapeConfig:
    return INPUT_SHAPES[name]


def config_for(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """long_500k runs the sliding-window variant of full-attention archs
    (DESIGN.md §4)."""
    if shape.name == "long_500k":
        return long_context_variant(cfg)
    return cfg


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """(batch tree of meta tensors, None) for the shape's mode.

    train:   {tokens, labels [, frames | patch_embeds]}
    prefill: {tokens [, frames | patch_embeds]}
    decode:  tokens (B,) int32 (the cache comes from
             ``decode_cache_structs``)
    """
    B, S = shape.global_batch, shape.seq_len
    dt = dtype_of(cfg)
    d = cfg.d_model
    nf = cfg.n_frontend_tokens

    def tok(shape_):
        return torch.empty(shape_, dtype=torch.int32, device=META)

    def emb():
        return torch.empty((B, nf, d), dtype=dt, device=META)

    if shape.mode == "decode":
        return tok((B,)), None
    batch = {}
    n_text = S
    if cfg.is_encoder_decoder:
        batch["frames"] = emb()
    elif cfg.frontend == "vision_stub":
        batch["patch_embeds"] = emb()
        n_text = S - nf
    batch["tokens"] = tok((B, n_text))
    if shape.mode == "train":
        batch["labels"] = tok((B, n_text))
    return batch, None


def param_structs(cfg: ModelConfig):
    """The parameter tree of ``cfg`` on ``meta`` (``init_params``'s tree:
    same leaves, shapes and dtypes; nothing allocated)."""
    return init_params(cfg, torch.Generator(), META)


def decode_cache_structs(cfg: ModelConfig, shape: ShapeConfig):
    enc_len = cfg.n_frontend_tokens if cfg.is_encoder_decoder else 0
    return init_cache(cfg, shape.global_batch, shape.seq_len,
                      pos=shape.seq_len - 1, device=META, enc_len=enc_len)


def tree_placements(specs, mesh):
    """The DTensor placements of a tree (dicts, tuples) of specs; ``None``
    (the optimizer's host step counter) stays ``None``."""
    if isinstance(specs, P):
        return placements(specs, mesh)
    if isinstance(specs, dict):
        return {k: tree_placements(v, mesh) for k, v in specs.items()}
    if isinstance(specs, tuple):
        return tuple(tree_placements(s, mesh) for s in specs)
    return None


def _step_specs(cfg, mesh, params):
    """(param specs, the moments' ZeRO-1 specs)."""
    return (param_specs(params, cfg, mesh),
            param_specs(params, dataclasses.replace(cfg, fsdp=True), mesh))


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(fn, example args (meta tensors), in_placements, donate_argnums)."""
    cfg = config_for(cfg, shape)
    params = param_structs(cfg)
    pspecs, zspecs = _step_specs(cfg, mesh, params)
    B = shape.global_batch

    if shape.mode == "train":
        opt = AdamW(lr=1e-4, weight_decay=0.01, grad_clip=1.0)
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        opt_state = opt.init(params)
        # ZeRO-1: the f32 Adam moments always shard over the data axis;
        # the step counter is a host int
        ospecs = {"mu": zspecs, "nu": zspecs, "step": None}
        batch, _ = input_specs(cfg, shape)
        # training spreads the batch over every mesh axis (ZeRO-style);
        # channel-parallel recurrent stacks (RG-LRU) keep it over data
        bspecs = batch_specs(batch, mesh, B,
                             include_model=cfg.train_batch_over_model)
        train_step = make_train_step(cfg, opt)
        # donate params/opt_state: updated in place on the device
        return (train_step, (params, opt_state, batch),
                tree_placements((pspecs, ospecs, bspecs), mesh), (0, 1))

    if shape.mode == "prefill":
        batch, _ = input_specs(cfg, shape)
        bspecs = batch_specs(batch, mesh, B)

        def prefill_step(params, batch):
            return prefill(params, batch, cfg, max_len=shape.seq_len)

        return (prefill_step, (params, batch),
                tree_placements((pspecs, bspecs), mesh), ())

    tokens, _ = input_specs(cfg, shape)
    cache = decode_cache_structs(cfg, shape)
    cspecs = cache_specs(cache, cfg, mesh, B)
    tspec = batch_specs({"tokens": tokens}, mesh, B)["tokens"]

    def serve_step(params, tokens, cache):
        return decode_step(params, tokens, cache, cfg)

    # donate the KV cache: decode updates it in place
    return (serve_step, (params, tokens, cache),
            tree_placements((pspecs, tspec, cspecs), mesh), (2,))


def out_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, outputs):
    """Spec tree of the step's ``outputs`` (as ``build_step``'s fn returns
    them)."""
    cfg = config_for(cfg, shape)
    if shape.mode == "train":
        params = outputs[0]
        _, zspecs = _step_specs(cfg, mesh, params)
        return (zspecs, {"mu": zspecs, "nu": zspecs, "step": None}, P())
    logits, cache = outputs
    axes = mesh_axes(mesh)
    msize = axes.shape["model"] if "model" in axes.axis_names else 1
    vocab = "model" if logits.shape[-1] % msize == 0 else None
    return (P(batch_axes(shape.global_batch, mesh), vocab),
            cache_specs(cache, cfg, mesh, shape.global_batch))
