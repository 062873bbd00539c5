#!/usr/bin/env python3
"""How far rounding alone moves a full-width stack's logits on one card:
the floor under run Z's comparison of a (1, 2) mesh with one process.

For each stack (and depth), one process's prefill forward of 4 prompts
(run Z's: 512 positions) (weights from seed 0, bf16) against:

- the same call again (``repeat``: the card's determinism);
- the same stack in f32 from the same seed, its attention through the
  plain version (``attn_impl="naive"``: the f32 flash tiles stop at head
  dim 128) (``bf16_vs_f32``, and the greedy agreement of the last
  tokens);
- on Mamba-2 stacks, each reduction that ``ServePlan`` splits over a
  model axis of 2, changed alone in one process: ``in_proj`` as two
  column blocks (``in_proj_blocks``), the gated norm's sum of squares as
  two halves added in f32 (``norm_halves``), ``out_proj`` as two f32
  partial products added and rounded once (``out_proj_f32_halves``), or
  each rounded to bf16 before the sum (``out_proj_bf16_halves``), and
  all three of the mesh's (``mesh_order``);
- on stacks of GQA attention with a dense MLP (and an encoder-decoder's
  cross-attention), the row-parallel products that ``ServePlan`` splits
  over a model axis of 2 (``wo`` over the heads, the MLP's ``w_out`` over
  its hidden dim), each as two partial products rounded to bf16 and
  added in bf16 (``row_parallel_bf16_halves``) or added in f32 and
  rounded once (``row_parallel_f32_halves``).

The prompts, and a vision stack's patches or an encoder-decoder's frames,
are run Z's (``chip_smoke.serve_mesh_inputs``).  Each value is the
largest |difference| over the largest |logit| of the first call's last
tokens; each ``greedy_*`` is the share of the prompt's token positions
(all of them, not only the last) whose argmax equals the first call's.
One JSON line per stack and depth:

    python3 scripts/rounding_sensitivity.py mamba2-2.7b:64,32 \\
        minicpm3-4b recurrentgemma-2b internvl2-76b:8
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
VARIANTS = ("in_proj_blocks", "norm_halves", "out_proj_f32_halves",
            "out_proj_bf16_halves", "mesh_order")
ROW_PARALLEL = ("row_parallel_bf16_halves", "row_parallel_f32_halves")


def _row_parallel(variant):
    """(``attention._out_project``, ``layers.mlp``) in one process with
    their contraction split in two as a model axis of 2 splits it: each
    half's product rounded to bf16 and the two added in bf16, or both in
    f32 and the sum rounded once (module docstring)."""
    import torch.nn.functional as F

    from repro_torch.models.layers import matmul_f32

    f32 = variant == "row_parallel_f32_halves"

    def halves(a, w):
        n = a.shape[-1] // 2
        lo, hi = a[..., :n], a[..., n:]
        if f32:
            return (matmul_f32(lo, w[:n]) + matmul_f32(hi, w[n:])).to(
                a.dtype)
        return lo @ w[:n] + hi @ w[n:]

    def out_project(out, wo):
        B, S, H, k = out.shape
        return halves(out.reshape(B, S, H * k), wo.reshape(H * k, -1))

    def mlp_halves(params, x, act, tp=None):
        h = x @ params["w_in"]               # layers.mlp's hidden
        if act == "silu":
            h = F.silu(x @ params["w_gate"]) * h
        else:
            h = F.gelu(h, approximate="tanh")
        return halves(h, params["w_out"])

    return out_project, mlp_halves


def _mamba2_prefill(variant):
    """``ssm.mamba2_prefill`` in one process with ``variant``'s reductions
    split in two as a model axis of 2 splits them (module docstring)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import ssm
    from repro_torch.models.layers import matmul_f32, rmsnorm

    blocks = variant in ("in_proj_blocks", "mesh_order")
    halves = variant in ("norm_halves", "mesh_order")
    f32 = variant in ("out_proj_f32_halves", "mesh_order")

    def prefill(params, x, cfg, initial=None, tp=None):
        s = cfg.ssm
        Bsz, S, _ = x.shape
        w = params["in_proj"]
        n = w.shape[1] // 2
        proj = torch.cat([x @ w[:, :n], x @ w[:, n:]], -1) if blocks \
            else x @ w
        z, xbc, dt_raw = ssm._split_proj(cfg, proj)
        xbc_conv = F.silu(ssm.causal_conv(xbc, params["conv_w"],
                                          params["conv_b"]))
        xh, Bm, Cm, dt, la = ssm._gates(params, cfg, xbc_conv, dt_raw,
                                        (Bsz, S))
        x_in = (xh * dt[..., None].to(xh.dtype)).contiguous()
        y, state = ssm.ssd_chunked(x_in, la.contiguous(), Bm.contiguous(),
                                   Cm.contiguous(), s.chunk_size, None)
        y = (y + (params["D"][:, None] * xh.float()).to(y.dtype)).reshape(
            Bsz, S, -1)
        g = y * F.silu(z)
        h = g.shape[-1] // 2
        if halves:
            gf = g.float()
            var = (gf[..., :h].square().sum(-1, keepdim=True)
                   + gf[..., h:].square().sum(-1, keepdim=True)) \
                / gf.shape[-1]
            g = (gf * torch.rsqrt(var + cfg.norm_eps)
                 * params["norm"]["scale"].float()).to(g.dtype)
        else:
            g = rmsnorm(params["norm"], g, cfg.norm_eps)
        wo = params["out_proj"]
        lo, hi = g[..., :h].contiguous(), g[..., h:].contiguous()
        if f32:
            out = (matmul_f32(lo, wo[:h]) + matmul_f32(hi, wo[h:])).to(
                g.dtype)
        elif variant == "out_proj_bf16_halves":
            out = lo @ wo[:h] + hi @ wo[h:]
        else:
            out = g @ wo
        return out, {"conv_state": ssm._conv_tail(xbc, s.conv_width),
                     "ssm_state": state}

    return prefill


def measure(arch, n_layers):
    import torch

    from chip_smoke import serve_batch, serve_mesh_inputs
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ATTN, ATTN_LOCAL, MAMBA2
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import model as tm
    from repro_torch.models import ssm
    from repro_torch.models.layers import unembed
    from repro_torch.weights import init_params

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    prompts, stub, max_len = serve_mesh_inputs(None, cfg)
    batch = serve_batch(torch, prompts, stub)

    @torch.no_grad()
    def run(c, params):
        """(the last tokens' logits in f32, every token position's
        argmax)."""
        hidden, _, _, n_prefix = tm.forward_hidden(params, batch, c,
                                                   mode="prefill")
        hidden = hidden[:, n_prefix:]
        top = torch.cat([unembed(params["embed"], h).argmax(-1)
                         for h in hidden.split(64, dim=1)], dim=1)
        return unembed(params["embed"], hidden[:, -1]).float(), top

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), "cuda")
    base, base_top = run(cfg, params)
    top = float(base.abs().max())
    out = {"phase": "rounding_sensitivity", "model": cfg.name,
           "n_layers": cfg.n_layers, "prompts": prompts.shape[0],
           "prompt_len": prompts.shape[1], "max_len": max_len,
           "stub": {k: list(v.shape) for k, v in stub.items()}}

    def record(name, got):
        logits, argmax = got
        out[name] = float((logits - base).abs().max()) / top
        out[f"greedy_{name}"] = float((argmax == base_top).float().mean())

    record("repeat", run(cfg, params))
    if MAMBA2 in cfg.layer_kinds():
        plain = ssm.mamba2_prefill
        try:
            for variant in VARIANTS:
                ssm.mamba2_prefill = _mamba2_prefill(variant)
                record(variant, run(cfg, params))
        finally:
            ssm.mamba2_prefill = plain
    if {ATTN, ATTN_LOCAL} & set(cfg.layer_kinds()) and cfg.moe is None:
        plain = attn_mod._out_project, tm.mlp
        try:
            for variant in ROW_PARALLEL:
                attn_mod._out_project, tm.mlp = _row_parallel(variant)
                record(variant, run(cfg, params))
        finally:
            attn_mod._out_project, tm.mlp = plain
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32", attn_impl="naive")
    params = init_params(cfg32, torch.Generator(device="cuda").manual_seed(
        SEED), "cuda")
    record("bf16_vs_f32", run(cfg32, params))
    del params
    torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    import subprocess

    import torch
    if not torch.cuda.is_available():
        print("rounding_sensitivity: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"], capture_output=True,
        text=True, check=True).stdout.strip(), flush=True)
    for spec in argv or ["mamba2-2.7b"]:
        arch, _, depths = spec.partition(":")
        for depth in (depths.split(",") if depths else [None]):
            print(json.dumps(measure(arch, depth and int(depth))),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
