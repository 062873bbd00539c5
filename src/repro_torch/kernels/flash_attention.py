"""Blockwise attention: whole-prompt prefill's hot spot, and the
cross-attention of an encoder-decoder's prefill.

Port of ``repro/kernels/flash_attention.py``.  One kernel, written by
hand in CUDA C++ for Hopper (``csrc/flash_attention.cu``), replaces
``flash_attention_pallas``; beside it is a plain PyTorch version of the
same function.  The kernel has two variants, chosen by dtype (both always
built): ``mma`` for bf16, on the tensor cores with cp.async-fed K/V tiles
(``csrc/attention_tile.cuh``), head dims up to 256, and ``fma`` for f32,
on the f32 FMA units (TF32 would miss the f32 tolerance of 1e-5), head
dims up to 128: its f32 tiles of 64 rows by 128 columns are sized for
them, and f32 at 256 is on no serving path.

Inputs, as in the reference (self-attention prefill: Sq == Skv; Whisper's
cross-attention: Sq prompt rows over Skv encoder frames):
    q   (B, Sq, Hq, D)    f32 or bf16
    k   (B, Skv, Hkv, D)  q's dtype; query head h reads kv head h // G
    v   (B, Skv, Hkv, Dv) q's dtype
Returns (B, Sq, Hq, Dv) in q's dtype.

The contract of the TPU kernel: scores are ``(q . k) * D**-0.5`` in f32;
masked scores are *set* to NEG_INF = -1e30 (finite); the mask is
``kpos < Skv``, plus ``kpos <= qpos`` when causal, plus
``kpos > qpos - window`` when windowed, aligned top-left (qpos and kpos
count from 0); the online softmax keeps (m, l, acc) in f32 and the
output is ``acc / max(l, 1e-30)``, rounded once to q's dtype.  A row
that no key is visible to (a window that ends past the last key: Sq >=
Skv + window) has no defined output: the TPU kernel's depends on its
padding, so both versions refuse such calls.

Training differentiates it (``FlashAttentionFunction``, the port of
the reference's ``jax.custom_vjp`` ``_flash_core``): the forward also
writes each row's log-sum-exp ``lse = m + log(max(l, 1e-30))`` (f32,
(B, Sq, Hq); the reference's ``_flash_fwd_impl``), and the backward is a
second hand-written kernel (``csrc/flash_attention_bwd.cu``, the port of
the jnp ``_flash_core_bwd``): delta = rowsum(dO * O), then dK/dV per
64-key tile over the G query heads of its kv head, then dQ per 64-row
query tile, each recomputing P = exp(s - lse) under the forward's mask;
no atomics.  Two variants, chosen by dtype: ``mma`` for bf16, on the
tensor cores (bf16 tiles fed by cp.async, ``mma.sync`` products, P and
dS as hi + lo bf16 terms), head dims up to 256; ``fma`` for f32, on the
f32 FMA units, head dims up to 128.  Its plain version,
``flash_attention_bwd_plain``, walks the reference's block pairs.
``O`` in delta is the output in q's dtype (the reference keeps
its f32 output for it: the same in f32, one bf16 rounding apart in bf16).

The backward has an accumulate mode (``accumulate=(dq, dk, dv)``, f32
buffers shaped as q, k, v): the gradients are added into them in f32 in
place of being rounded to the inputs' type, so the ring's steps
(``models.ring_attention``) sum their partials in f32 and round once.

A wrapper runs the plain version only when its tensors lie on the CPU
(the tests).  On CUDA tensors it launches the kernel or raises; there is
no fallback.  ``LAUNCHES`` counts kernel launches, in all and per variant
(``flash_attention:mma``; a backward call, its three kernels, once as
``flash_attention_bwd`` and once by variant,
``flash_attention_bwd:mma``, and once more as ``flash_attention_bwd:acc``
in the accumulate mode), so a run can show that the prefill and training
paths went through the kernels, and on which units.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# largest head dims each variant's tiles hold
MAX_HEAD_DIM = {torch.bfloat16: 256, torch.float32: 128}

VARIANTS = {torch.bfloat16: "mma", torch.float32: "fma"}
# the backward's largest head dims: bf16 tensor-core tiles up to 256, the
# f32 FMA kernels' 4 x 8 tiles per thread up to 128
MAX_BWD_HEAD_DIM = {torch.bfloat16: 256, torch.float32: 128}
BWD_VARIANTS = {torch.bfloat16: "mma", torch.float32: "fma"}
LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention:mma": 0,
                            "flash_attention:fma": 0,
                            "flash_attention_bwd": 0,
                            "flash_attention_bwd:mma": 0,
                            "flash_attention_bwd:fma": 0,
                            "flash_attention_bwd:acc": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _validate(q, k, v, window, block_q, block_kv):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash attention: q, k, v must be (B, S, H, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    Bk, Skv, Hkv, Dk = k.shape
    Bv, Sv, Hv, _ = v.shape
    if (Bk, Dk) != (B, D) or (Bv, Sv, Hv) != (Bk, Skv, Hkv):
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree "
                         "(q and k share B and D; k and v share B, their "
                         "length and their heads)")
    if Hkv == 0 or Hq % Hkv != 0:
        raise ValueError(f"flash attention: Hq={Hq} query heads do not "
                         f"group evenly over Hkv={Hkv} kv heads")
    if window < 0 or block_q <= 0 or block_kv <= 0:
        raise ValueError(f"flash attention: window={window}, block_q="
                         f"{block_q}, block_kv={block_kv}")
    if window and Sq >= Skv + window:
        raise ValueError(f"flash attention: window={window} leaves query "
                         f"rows {Skv + window - 1}..{Sq - 1} of Sq={Sq} no "
                         f"visible key among Skv={Skv}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash attention: tensors on mixed devices "
                         f"{sorted({str(t.device) for t in (q, k, v)})}")


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------
def flash_attention_plain(q, k, v, *, causal=True, window=0, block_q=128,
                          block_kv=128, return_lse=False):
    """The kernel's function, walked over kv blocks of ``block_kv`` with
    the (m, l, acc) online softmax in f32 over every query row at once
    (``block_q`` does not change the result: rows are independent).
    Fully masked blocks run, as in the TPU kernel.  ``return_lse``: also
    each row's f32 log-sum-exp (B, Sq, Hq)."""
    _validate(q, k, v, window, block_q, block_kv)
    B, Sq, Hq, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = Hq // Hkv
    bkv = min(block_kv, Skv)
    qf = q.float().permute(0, 2, 1, 3)                      # (B, Hq, Sq, D)
    kf = k.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, Hq, Sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, Hq, Sq, 1), device=q.device)
    acc = torch.zeros((B, Hq, Sq, Dv), device=q.device)
    for j0 in range(0, Skv, bkv):
        kpos = torch.arange(j0, j0 + bkv, device=q.device)[None, :]
        kb = kf[:, :, j0:j0 + bkv]
        vb = vf[:, :, j0:j0 + bkv]
        s = (qf @ kb.transpose(-1, -2)) * D ** -0.5         # (B, Hq, Sq, b)
        mask = kpos < Skv
        if causal:
            mask = mask & (kpos <= qpos)
        if window:
            mask = mask & (kpos > qpos - window)
        mask = mask[:, :kb.shape[2]]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p @ vb
        m = m_new
    l = l.clamp_min(1e-30)
    out = (acc / l).permute(0, 2, 1, 3).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l))[..., 0].permute(0, 2, 1)
    return out


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        lib.flash_attention_fwd.argtypes = [_P] * 5 + [_I] * 10 \
            + [ctypes.c_float, _P]
        lib.flash_attention_fwd.restype = _I
        lib.flash_attention_mma_smem_bytes.argtypes = [_I, _I]
        lib.flash_attention_mma_smem_bytes.restype = ctypes.c_size_t
    return lib


def _check_cuda(q, k, v):
    """Refuse anything the CUDA kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash attention: {name} must start on a "
                             "16-byte boundary (vector loads, cp.async)")
        if t.dtype not in _DTYPE_CODE:
            raise ValueError(f"flash attention: {name} dtype {t.dtype} not "
                             "in (float32, bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention: q {q.dtype}, k {k.dtype}, v "
                         f"{v.dtype} must share one dtype")
    B, Sq, Hq, D = q.shape
    Skv, Dv = k.shape[1], v.shape[-1]
    step = 8 if q.dtype == torch.bfloat16 else 4      # one 16-byte vector
    top = MAX_HEAD_DIM[q.dtype]
    for name, d in (("D", D), ("Dv", Dv)):
        if d % step or not step <= d <= top:
            raise ValueError(f"flash attention: head dim {name}={d} must be "
                             f"a multiple of {step} in [{step}, {top}] for "
                             f"{q.dtype} (the {VARIANTS[q.dtype]} kernel's "
                             "tiles)")
    if B < 1 or Sq < 1 or Skv < 1:
        raise ValueError(f"flash attention: empty launch (B={B}, Sq={Sq}, "
                         f"Skv={Skv})")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"flash attention: grid of B={B}, Hq={Hq} above "
                         "65535")


def _flash_cuda(q, k, v, causal, window, return_lse=False):
    _check_cuda(q, k, v)
    B, Sq, Hq, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Sq, Hq), dtype=torch.float32,
                      device=q.device) if return_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, Sq, Skv, Hq, Hkv, D, Dv, int(causal), int(window),
            _DTYPE_CODE[q.dtype], D ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd ({VARIANTS[q.dtype]}): "
                           f"CUDA error {rc} "
                           f"({torch.cuda.get_device_name(q.device)})")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES[f"flash_attention:{VARIANTS[q.dtype]}"] += 1
    return (out, lse) if return_lse else out


# ---------------------------------------------------------------------------
# public wrapper
# ---------------------------------------------------------------------------
def flash_attention_kernel(q, k, v, *, causal=True, window=0, block_q=128,
                           block_kv=128, return_lse=False):
    """Blockwise attention (Sq and Skv may differ).  CPU tensors run ``flash_attention_plain``;
    CUDA tensors the kernel (``mma`` for bf16, ``fma`` for f32), whose own
    tiles are 64 x 64 (block sizes only reorder f32 sums, so
    ``block_q``/``block_kv`` steer the plain version alone).
    ``return_lse``: (out, lse), lse f32 (B, Sq, Hq)."""
    _validate(q, k, v, window, block_q, block_kv)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     block_q=block_q, block_kv=block_kv,
                                     return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for {q.device}")
    return _flash_cuda(q, k, v, causal, window, return_lse)


# ---------------------------------------------------------------------------
# the backward: plain version
# ---------------------------------------------------------------------------
def block_pairs(n_q, n_kv, block_q, block_kv, causal, window):
    """The reference's ``_block_pairs``: (i, j) block pairs that hold an
    unmasked entry, on positions (q block i spans [i bq, (i+1) bq))."""
    pairs = []
    for i in range(n_q):
        q_lo, q_hi = i * block_q, (i + 1) * block_q - 1
        for j in range(n_kv):
            kv_lo, kv_hi = j * block_kv, (j + 1) * block_kv - 1
            if causal and kv_lo > q_hi:
                continue
            if window and kv_hi <= q_lo - window:
                continue
            pairs.append((i, j))
    return pairs


def _validate_bwd(q, k, v, out, lse, dout):
    B, Sq, Hq, _ = q.shape
    Dv = v.shape[-1]
    if tuple(out.shape) != (B, Sq, Hq, Dv) or out.shape != dout.shape:
        raise ValueError(f"flash attention backward: out {tuple(out.shape)} "
                         f"and dout {tuple(dout.shape)} must be "
                         f"{(B, Sq, Hq, Dv)}")
    if tuple(lse.shape) != (B, Sq, Hq) or lse.dtype != torch.float32:
        raise ValueError(f"flash attention backward: lse must be f32 "
                         f"{(B, Sq, Hq)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if {t.device for t in (out, lse, dout)} != {q.device}:
        raise ValueError("flash attention backward: tensors on mixed "
                         "devices")


def _validate_accumulate(q, k, v, accumulate):
    """The accumulate mode's buffers: three f32 tensors shaped as q, k, v
    on their device, contiguous."""
    if len(accumulate) != 3:
        raise ValueError("flash attention backward: accumulate takes "
                         "(dq, dk, dv)")
    for name, t, like in zip(("dq", "dk", "dv"), accumulate, (q, k, v)):
        if t.dtype != torch.float32 or t.shape != like.shape or \
                t.device != like.device or not t.is_contiguous():
            raise ValueError(f"flash attention backward: accumulate's "
                             f"{name} must be contiguous f32 "
                             f"{tuple(like.shape)} on {like.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal=True,
                              window=0, block_q=128, block_kv=128,
                              accumulate=None):
    """(dq, dk, dv) of ``flash_attention_plain`` at ``dout``, as the
    reference's ``_flash_core_bwd``: the static block pairs in order,
    P = exp(s - lse) under the mask, dS = P (dP - delta) scale, sums in
    f32, each gradient rounded once to its input's dtype; with
    ``accumulate`` (f32 dq, dk, dv buffers) the f32 gradients are added
    into them instead, and they are returned."""
    _validate(q, k, v, window, block_q, block_kv)
    _validate_bwd(q, k, v, out, lse, dout)
    if accumulate is not None:
        _validate_accumulate(q, k, v, accumulate)
    B, Sq, Hq, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = Hq // Hkv
    bq, bkv = min(block_q, Sq), min(block_kv, Skv)
    scale = D ** -0.5
    qf = q.float().reshape(B, Sq, Hkv, G, D)
    dof = dout.float().reshape(B, Sq, Hkv, G, Dv)
    kf, vf = k.float(), v.float()
    delta = (dof * out.float().reshape(B, Sq, Hkv, G, Dv)).sum(-1)
    lse_g = lse.reshape(B, Sq, Hkv, G)
    dq = torch.zeros((B, Sq, Hkv, G, D), device=q.device)
    dk = torch.zeros((B, Skv, Hkv, D), device=q.device)
    dv = torch.zeros((B, Skv, Hkv, Dv), device=q.device)
    pos = torch.arange(max(Sq, Skv), device=q.device)
    n_q, n_kv = -(-Sq // bq), -(-Skv // bkv)
    for i, j in block_pairs(n_q, n_kv, bq, bkv, causal, window):
        qs = slice(i * bq, min((i + 1) * bq, Sq))
        ks = slice(j * bkv, min((j + 1) * bkv, Skv))
        qpos, kpos = pos[qs][:, None], pos[ks][None, :]
        mask = kpos < Skv
        if causal:
            mask = mask & (kpos <= qpos)
        if window:
            mask = mask & (kpos > qpos - window)
        mask = mask[None, :, None, None, :]
        qb, dob, kb, vb = qf[:, qs], dof[:, qs], kf[:, ks], vf[:, ks]
        s = torch.einsum("bskgd,btkd->bskgt", qb, kb) * scale
        p = torch.where(mask, torch.exp(s - lse_g[:, qs, ..., None]),
                        torch.zeros((), device=q.device))
        dv[:, ks] += torch.einsum("bskgt,bskgd->btkd", p, dob)
        dp = torch.einsum("bskgd,btkd->bskgt", dob, vb)
        ds = p * (dp - delta[:, qs, ..., None]) * scale
        dq[:, qs] += torch.einsum("bskgt,btkd->bskgd", ds, kb)
        dk[:, ks] += torch.einsum("bskgt,bskgd->btkd", ds, qb)
    dq = dq.reshape(B, Sq, Hq, D)
    if accumulate is not None:
        for acc, g in zip(accumulate, (dq, dk, dv)):
            acc += g
        return tuple(accumulate)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the backward: CUDA kernels (csrc/flash_attention_bwd.cu)
# ---------------------------------------------------------------------------
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    if lib.flash_attention_bwd.argtypes is None:
        lib.flash_attention_bwd.argtypes = [_P] * 10 + [_I] * 11 \
            + [ctypes.c_float, _P]
        lib.flash_attention_bwd.restype = _I
        lib.flash_attention_bwd_smem_bytes.argtypes = [_I] * 4
        lib.flash_attention_bwd_smem_bytes.restype = ctypes.c_size_t
    return lib


def _flash_bwd_cuda(q, k, v, out, lse, dout, causal, window, accumulate):
    D, Dv = q.shape[-1], v.shape[-1]
    top = MAX_BWD_HEAD_DIM.get(q.dtype)
    if top is not None and max(D, Dv) > top:
        raise ValueError(f"flash attention backward: head dims D={D}, "
                         f"Dv={Dv} above {top} for {q.dtype} (the "
                         f"{BWD_VARIANTS[q.dtype]} backward kernel's tiles)")
    _check_cuda(q, k, v)
    for name, t in (("out", out), ("dout", dout), ("lse", lse)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash attention backward: {name} must be "
                             "contiguous and start on a 16-byte boundary")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"flash attention backward: out {out.dtype} and "
                         f"dout {dout.dtype} must be q's {q.dtype}")
    B, Sq, Hq, _ = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if accumulate is None:
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    else:
        dq, dk, dv = accumulate
        if any(t.data_ptr() % 16 for t in accumulate):
            raise ValueError("flash attention backward: accumulate's "
                             "buffers must start on a 16-byte boundary")
    delta = torch.empty((B, Sq, Hq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _bwd_lib().flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Sq, Skv, Hq, Hkv, D, Dv, int(causal), int(window),
            int(accumulate is not None), _DTYPE_CODE[q.dtype], D ** -0.5,
            stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd ({BWD_VARIANTS[q.dtype]}): "
                           f"CUDA error {rc} "
                           f"({torch.cuda.get_device_name(q.device)})")
    LAUNCHES["flash_attention_bwd"] += 1
    LAUNCHES[f"flash_attention_bwd:{BWD_VARIANTS[q.dtype]}"] += 1
    if accumulate is not None:
        LAUNCHES["flash_attention_bwd:acc"] += 1
    return dq, dk, dv


def flash_attention_bwd_kernel(q, k, v, out, lse, dout, *, causal=True,
                               window=0, block_q=128, block_kv=128,
                               accumulate=None):
    """(dq, dk, dv).  CPU tensors run ``flash_attention_bwd_plain``; CUDA
    tensors the three backward kernels (``mma`` for bf16, head dims up to
    256; ``fma`` for f32, up to 128; ``block_q``/``block_kv`` steer the
    plain version alone).  ``accumulate``: f32 (dq, dk, dv) buffers shaped
    as q, k, v, into which the f32 gradients are added (and which are
    returned) in place of gradients rounded to the inputs' type."""
    _validate(q, k, v, window, block_q, block_kv)
    _validate_bwd(q, k, v, out, lse, dout)
    if accumulate is not None:
        _validate_accumulate(q, k, v, accumulate)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal, window=window,
                                         block_q=block_q, block_kv=block_kv,
                                         accumulate=accumulate)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention backward: no kernel for "
                         f"{q.device}")
    return _flash_bwd_cuda(q, k, v, out, lse, dout, causal, window,
                           accumulate)


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its gradient: the forward saves (q, k, v, out,
    lse), the backward recomputes the probabilities from lse.  CPU tensors
    run the plain versions both ways; CUDA tensors launch the kernels or
    raise."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, block_q, block_kv):
        out, lse = flash_attention_kernel(
            q, k, v, causal=causal, window=window, block_q=block_q,
            block_kv=block_kv, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, block_q, block_kv)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, block_q, block_kv = ctx.args
        dq, dk, dv = flash_attention_bwd_kernel(
            q, k, v, out, lse, dout.contiguous(), causal=causal,
            window=window, block_q=block_q, block_kv=block_kv)
        return dq, dk, dv, None, None, None, None


def flash_attention_train(q, k, v, *, causal=True, window=0, block_q=128,
                          block_kv=128):
    """``flash_attention_kernel`` with a gradient (``FlashAttentionFunction``)."""
    return FlashAttentionFunction.apply(q, k, v, causal, window, block_q,
                                        block_kv)
