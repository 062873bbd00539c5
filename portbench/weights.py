"""Random weights from the seed, made on the device in the served dtype.

The tree has the program's parameter layout (``repro_torch/weights.py``):
``embed.{table,head}``, ``final_norm.scale`` and one ``stages.stage_<i>``
per run of layers of one structure, every leaf with a leading layer axis:
``ln1.scale``, ``attn.{wq,wk,wv}`` (L, d, heads, hd), ``attn.wo`` (L, H,
hd, d), ``ln2.scale`` and ``ffn.{w_in,w_out[,w_gate]}`` for a dense FFN, or
``ffn.{router,w_gate,w_in,w_out,shared.{w_in,w_gate,w_out}}`` for a MoE
FFN.  Each leaf is one ``normal_`` call on a ``torch.Generator`` on the
device: dense weights N(0, 1 / fan_in), embeddings N(0, 0.02**2), norm
scales 1 + N(0, 0.1**2).  The program and the reference are handed these
same tensors.
"""
from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def stages(model: dict):
    """[(moe, count)]: runs of layers with the same FFN kind (the first
    ``first_k_dense`` layers of a MoE stack are dense)."""
    n = model["n_layers"]
    k = model["moe"]["first_k_dense"] if model.get("moe") else n
    runs = [(False, k)] if k else []
    if n > k:
        runs.append((True, n - k))
    return runs


def make_params(model: dict, seed: int, device) -> dict:
    """The whole tree for the configuration's ``model`` block."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    dt = DTYPES[model.get("dtype", "bfloat16")]
    d, H, Hkv = model["d_model"], model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or d // H
    V = model["vocab_size"]

    def normal(shape, std, mean=0.0):
        t = torch.empty(shape, dtype=dt, device=device)
        return t.normal_(mean, std, generator=gen)

    def dense(shape, fan_in):
        return normal(shape, fan_in ** -0.5)

    params = {"embed": {"table": normal((V, d), 0.02),
                        "head": dense((d, V), d)},
              "final_norm": {"scale": normal((d,), 0.1, 1.0)},
              "stages": {}}
    for si, (moe, L) in enumerate(stages(model)):
        st = {"ln1": {"scale": normal((L, d), 0.1, 1.0)},
              "ln2": {"scale": normal((L, d), 0.1, 1.0)},
              "attn": {"wq": dense((L, d, H, hd), d),
                       "wk": dense((L, d, Hkv, hd), d),
                       "wv": dense((L, d, Hkv, hd), d),
                       "wo": dense((L, H, hd, d), H * hd)}}
        if moe:
            m = model["moe"]
            E, f, fs = m["n_experts"], m["d_ff_expert"], m["d_ff_shared"]
            ffn = {"router": dense((L, d, E), d),
                   "w_gate": dense((L, E, d, f), d),
                   "w_in": dense((L, E, d, f), d),
                   "w_out": dense((L, E, f, d), f)}
            if m["n_shared_experts"]:
                ffn["shared"] = {"w_gate": dense((L, d, fs), d),
                                 "w_in": dense((L, d, fs), d),
                                 "w_out": dense((L, fs, d), fs)}
        else:
            dff = model["d_ff"]
            ffn = {"w_in": dense((L, d, dff), d),
                   "w_out": dense((L, dff, d), dff)}
            if model.get("act", "silu") == "silu":
                ffn["w_gate"] = dense((L, d, dff), d)
        st["ffn"] = ffn
        params["stages"][f"stage_{si}"] = st
    return params
