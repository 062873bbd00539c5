"""Model parameters for the port: fresh draws and the bridge from numpy.

The parameter tree keeps the reference layout (``repro/models/model.py``):
``embed.{table,head}``, ``final_norm.scale`` and
``stages.stage_0.{ln1,attn.{wq,wk,wv,wo},ln2,ffn.{w_in,w_gate,w_out}}``
with a leading layer axis on every stage leaf.

- ``init_params`` draws a model on the device with the reference's
  distributions (truncated-normal fan-in dense weights, normal x 0.02
  embeddings, unit norms).  Random bits differ from JAX's, so it is for
  runs that need a model of the right shape, not for comparisons.
- ``params_from_numpy`` carries any numpy tree (e.g. the reference's
  parameters or MoPE experts after ``jax.tree.map(np.asarray, ...)``)
  into torch with values and dtypes unchanged; the parity tests use it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.models.attention import gqa_init
from repro_torch.models.layers import dense_init, dtype_of, embed_init


def resolve_device(device) -> torch.device:
    """The entry points' device rule: ``cuda`` unless the caller names
    another device, and never a quiet move to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 is not a numpy dtype torch knows: carry the
        # bits as uint16 and reinterpret them
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_numpy(tree, device):
    """Nested dicts of numpy arrays -> the same tree of torch tensors on
    ``device``, bit for bit."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _to_tensor(np.asarray(tree), device)


def init_params(cfg: ModelConfig, generator: torch.Generator = None,
                device=None):
    """A freshly drawn dense-attention decoder on ``device`` (``cuda`` by
    default), from ``generator`` (seed 0 on the device when omitted).
    Layers are drawn one at a time into the stacked leaves, so the f32
    temporaries stay one layer large."""
    device = resolve_device(device)
    if set(cfg.layer_kinds()) != {ATTN} or cfg.moe is not None \
            or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: only dense-attention stacks are ported "
            "(ROADMAP.md Queue A item 6)")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dt = dtype_of(cfg)
    d, L, hd = cfg.d_model, cfg.n_layers, cfg.resolved_head_dim()

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    embed = {"table": embed_init((cfg.vocab_size, d), dt, generator, device)}
    if not cfg.tie_embeddings:
        embed["head"] = dense_init((d, cfg.vocab_size), dt, generator, device)
    ffn_shapes = {"w_in": (d, cfg.d_ff), "w_out": (cfg.d_ff, d)}
    if cfg.act == "silu":
        ffn_shapes["w_gate"] = (d, cfg.d_ff)
    attn, ffn = None, None
    for i in range(L):
        a = gqa_init(d, cfg.n_heads, cfg.n_kv_heads, hd, dt, generator,
                     device)
        f = {k: dense_init(s, dt, generator, device)
             for k, s in ffn_shapes.items()}
        if attn is None:
            attn = {k: torch.empty((L, *v.shape), dtype=dt, device=device)
                    for k, v in a.items()}
            ffn = {k: torch.empty((L, *v.shape), dtype=dt, device=device)
                   for k, v in f.items()}
        for k, v in a.items():
            attn[k][i] = v
        for k, v in f.items():
            ffn[k][i] = v
    stage = {"ln1": {"scale": ones(L, d)}, "attn": attn,
             "ln2": {"scale": ones(L, d)}, "ffn": ffn}
    return {"embed": embed, "final_norm": {"scale": ones(d)},
            "stages": {"stage_0": stage}}
