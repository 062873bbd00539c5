"""Model parameters for the port: fresh draws and the bridge from numpy.

The parameter tree keeps the reference layout (``repro/models/model.py``):
``embed.{table,head}``, ``final_norm.scale`` and
``stages.stage_0.{ln1,attn.{wq,wk,wv,wo},ln2,ffn.{w_in,w_gate,w_out}}``
for attention (full or sliding-window) with a dense FFN,
``ffn.{router,w_gate,w_in,w_out[,shared.{w_in,w_gate,w_out}]}`` on MoE
layers (a stack with dense first layers has one stage per run),
``attn.{wq_a,q_norm,wq_b,wkv_a,kv_norm,wkv_b,wo}`` for MLA,
``stages.stage_0.{ln1,attn.{in_proj,conv_w,conv_b,A_log,dt_bias,D,norm,
out_proj}}`` for Mamba-2, ``attn.{w_branch_x,w_branch_gate,conv_w,conv_b,
w_gate_a,w_gate_i,lam,w_out}`` with ``ln2`` and ``ffn`` for RG-LRU
layers, with a leading layer axis on every stage leaf.  An
encoder-decoder (Whisper) adds ``ln_cross`` and ``cross.{wq,wk,wv,wo}``
to every decoder layer and the encoder ``enc.{stages.stage_0,
final_norm}``, whose layers are attention layers with a dense FFN.

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

from repro_torch.configs.base import ATTN, ATTN_MLA, MAMBA2, RGLRU, ModelConfig
from repro_torch.models.attention import cross_init, gqa_init, mla_init
from repro_torch.models.layers import dense_init, dtype_of, embed_init
from repro_torch.models.model import check_ported, model_stages
from repro_torch.models.moe import moe_init
from repro_torch.models.rglru import rglru_init
from repro_torch.models.ssm import mamba2_init


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
    """A freshly drawn decoder on ``device`` (``cuda`` by default), from
    ``generator`` (seed 0 on the device when omitted): attention stages
    (``ATTN``, ``ATTN_LOCAL``, ``ATTN_MLA``) with dense or MoE FFNs,
    RG-LRU (``RGLRU``) stages with dense FFNs, Mamba-2 (``MAMBA2``)
    stages, and an encoder-decoder's cross-attention and encoder.  Layers
    are drawn one at a time into the stacked leaves, so the f32
    temporaries stay one layer large."""
    device = resolve_device(device)
    check_ported(cfg)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dt = dtype_of(cfg)
    d, hd = cfg.d_model, cfg.resolved_head_dim()

    embed = {"table": embed_init((cfg.vocab_size, d), dt, generator, device)}
    if not cfg.tie_embeddings:
        embed["head"] = dense_init((d, cfg.vocab_size), dt, generator, device)
    ffn_shapes = {"w_in": (d, cfg.d_ff), "w_out": (cfg.d_ff, d)}
    if cfg.act == "silu":
        ffn_shapes["w_gate"] = (d, cfg.d_ff)

    def draw(kind, moe_flag, cross):
        """One layer of ``kind``: {"ln1", "attn"[, "ln_cross", "cross"][,
        "ln2", "ffn"]}."""
        ones = torch.ones((d,), dtype=dt, device=device)
        layer = {"ln1": {"scale": ones}}
        if kind == MAMBA2:
            layer["attn"] = mamba2_init(cfg, dt, generator, device)
        elif kind == ATTN_MLA:
            layer["attn"] = mla_init(cfg, dt, generator, device)
        elif kind == RGLRU:
            layer["attn"] = rglru_init(cfg, dt, generator, device)
        else:
            layer["attn"] = gqa_init(d, cfg.n_heads, cfg.n_kv_heads, hd, dt,
                                     generator, device)
        if cross:
            layer["ln_cross"] = {"scale": ones.clone()}
            layer["cross"] = cross_init(d, cfg.n_heads, hd, dt, generator,
                                        device)
        if kind != MAMBA2:
            layer["ln2"] = {"scale": ones.clone()}
            layer["ffn"] = moe_init(cfg, dt, generator, device) if moe_flag \
                else {k: dense_init(s, dt, generator, device)
                      for k, s in ffn_shapes.items()}
        return layer

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i] = v

    def alloc(layer, count):
        return {k: alloc(v, count) if isinstance(v, dict) else
                torch.empty((count, *v.shape), dtype=v.dtype, device=device)
                for k, v in layer.items()}

    def stage_of(kind, moe_flag, count, cross=False):
        stage = None
        for i in range(count):
            layer = draw(kind, moe_flag, cross)
            if stage is None:
                stage = alloc(layer, count)
            put(stage, layer, i)
        return stage

    def final_norm():
        return {"scale": torch.ones((d,), dtype=dt, device=device)}

    params = {"embed": embed, "final_norm": final_norm(), "stages": {
        f"stage_{si}": stage_of(kind, moe_flag, count,
                                cross=cfg.is_encoder_decoder)
        for si, (kind, moe_flag, count) in enumerate(model_stages(cfg))}}
    if cfg.is_encoder_decoder:
        params["enc"] = {"stages": {"stage_0": stage_of(
            ATTN, False, cfg.n_encoder_layers)}, "final_norm": final_norm()}
    return params
