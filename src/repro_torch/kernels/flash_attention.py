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

A wrapper runs the plain version only when its tensors lie on the CPU
(the tests).  On CUDA tensors it launches the kernel or raises; there is
no fallback.  ``LAUNCHES`` counts kernel launches, in all and per variant
(``flash_attention:mma``), so a run can show that the prefill path went
through the kernel.
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
LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention:mma": 0,
                            "flash_attention:fma": 0}


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
                          block_kv=128):
    """The kernel's function, walked over kv blocks of ``block_kv`` with
    the (m, l, acc) online softmax in f32 over every query row at once
    (``block_q`` does not change the result: rows are independent).
    Fully masked blocks run, as in the TPU kernel."""
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
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        lib.flash_attention_fwd.argtypes = [_P] * 4 + [_I] * 10 \
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


def _flash_cuda(q, k, v, causal, window):
    _check_cuda(q, k, v)
    B, Sq, Hq, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, Hq, Hkv, D, Dv, int(causal), int(window),
            _DTYPE_CODE[q.dtype], D ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd ({VARIANTS[q.dtype]}): "
                           f"CUDA error {rc} "
                           f"({torch.cuda.get_device_name(q.device)})")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES[f"flash_attention:{VARIANTS[q.dtype]}"] += 1
    return out


# ---------------------------------------------------------------------------
# public wrapper
# ---------------------------------------------------------------------------
def flash_attention_kernel(q, k, v, *, causal=True, window=0, block_q=128,
                           block_kv=128):
    """Blockwise attention (Sq and Skv may differ).  CPU tensors run ``flash_attention_plain``;
    CUDA tensors the kernel (``mma`` for bf16, ``fma`` for f32), whose own
    tiles are 64 x 64 (block sizes only reorder f32 sums, so
    ``block_q``/``block_kv`` steer the plain version alone)."""
    _validate(q, k, v, window, block_q, block_kv)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     block_q=block_q, block_kv=block_kv)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for {q.device}")
    return _flash_cuda(q, k, v, causal, window)
