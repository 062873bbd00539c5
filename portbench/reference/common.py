"""Pieces shared by the plain references: float32 linear maps (or their
fp8 control), RMSNorm, rotary embeddings, causal GQA attention.

Plain ``torch`` operations only, in float32 with TF32 off; nothing of the
program is imported.  ``Linear`` is where the control differs: with
``fp8=True`` both operands of every weight product are rounded to
float8 e4m3 (per row of the activations, per output column of the weight,
each scaled to the format's largest value 448) before an f32 product.
"""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """f32 products without TF32, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def fp8_round(x, dim):
    """``x`` (f32) rounded to float8 e4m3 with one scale per slice along
    ``dim`` (its absolute maximum maps to 448), returned in f32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Linear:
    """``x @ w`` for x (..., K) and a weight w (K, N) given in any dtype."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def weight(self, w):
        w = w.float()
        return fp8_round(w, dim=-2) if self.fp8 else w

    def __call__(self, x, w):
        """``w`` already passed through ``weight``."""
        if self.fp8:
            x = fp8_round(x, dim=-1)
        return x @ w


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x, positions, theta):
    """Split-halves rotary embedding; x (T, H, D), positions (T,)."""
    D = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                         device=x.device) / D)
    ang = positions.float()[:, None] * freqs               # (T, D/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, block=512):
    """q (T, H, D), k and v (T, Hkv, D): each query attends keys at or
    before its position, over query blocks of ``block`` rows."""
    T, H, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    qg = q.reshape(T, Hkv, G, D)
    out = torch.empty_like(q)
    for s in range(0, T, block):
        e = min(T, s + block)
        sc = torch.einsum("qkgd,tkd->kgqt", qg[s:e], k[:e]) * D ** -0.5
        mask = torch.arange(e, device=q.device)[None, :] \
            > torch.arange(s, e, device=q.device)[:, None]
        sc = sc.masked_fill(mask, float("-inf"))
        w = torch.softmax(sc, dim=-1)
        out[s:e] = torch.einsum("kgqt,tkd->qkgd", w, v[:e]).reshape(
            e - s, H, D)
    return out


def attention_block(lp, x, positions, model, lin):
    """One GQA self-attention sublayer on one sequence x (T, d), the
    residual not added.  ``lp`` holds the layer's weights already passed
    through ``lin.weight``."""
    T, d = x.shape
    H, Hkv = model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or d // H
    q = lin(x, lp["wq"]).reshape(T, H, hd)
    k = lin(x, lp["wk"]).reshape(T, Hkv, hd)
    v = lin(x, lp["wv"]).reshape(T, Hkv, hd)
    q = rope(q, positions, model["rope_theta"])
    k = rope(k, positions, model["rope_theta"])
    o = causal_attention(q, k, v).reshape(T, H * hd)
    return lin(o, lp["wo"])


def attn_weights(stage, i, lin):
    """Layer ``i``'s attention weights as 2-D f32 matrices."""
    a = stage["attn"]
    d = a["wq"].shape[1]
    return {"wq": lin.weight(a["wq"][i].reshape(d, -1)),
            "wk": lin.weight(a["wk"][i].reshape(d, -1)),
            "wv": lin.weight(a["wv"][i].reshape(d, -1)),
            "wo": lin.weight(a["wo"][i].reshape(-1, d))}


def run_stack(params, model, seqs, wants, layer_ffn, lin, device):
    """The decoder over every sequence, one layer at a time: each
    layer's weights are cast to f32 (or to the control's fp8) only while
    it runs.  ``seqs``: 1-D int64 token tensors; ``wants``: the positions
    whose logits are returned (f32, (len(want), V) each).  ``layer_ffn(
    stage, i, moe, h, lin)`` is the family's FFN over the rows ``h`` of
    every sequence together."""
    from portbench.weights import stages
    eps = model["norm_eps"]
    table = params["embed"]["table"]
    xs = [table[s.to(device)].float() for s in seqs]
    pos = [torch.arange(len(s), device=device) for s in seqs]
    for si, (moe, L) in enumerate(stages(model)):
        stage = params["stages"][f"stage_{si}"]
        for i in range(L):
            lp = attn_weights(stage, i, lin)
            ln1, ln2 = stage["ln1"]["scale"][i], stage["ln2"]["scale"][i]
            xs = [x + attention_block(lp, rmsnorm(x, ln1, eps), p, model,
                                      lin) for x, p in zip(xs, pos)]
            del lp
            h = torch.cat([rmsnorm(x, ln2, eps) for x in xs])
            f = layer_ffn(stage, i, moe, h, lin)
            del h
            xs = list(x + y for x, y in
                      zip(xs, torch.split(f, [len(x) for x in xs])))
            del f
    head = lin.weight(params["embed"]["head"])
    fn = params["final_norm"]["scale"]
    out = [lin(rmsnorm(x[w.to(device)], fn, eps), head)
           for x, w in zip(xs, wants)]
    return out
