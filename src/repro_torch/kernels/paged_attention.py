"""Paged decode attention: the serving engine's hot spot (DESIGN.md §16).

Port of ``repro/kernels/paged_attention.py``.  Two kernels, each written
by hand in CUDA C++ for Hopper (``csrc/paged_attention.cu``), each with a
plain PyTorch version of the same function beside it:

- ``paged_attention_kernel`` (serial; replaces ``paged_attention_pallas``)
  chains every page of a row through one online-softmax state;
- ``paged_attention_splitk_kernel`` (flash decoding; replaces
  ``paged_attention_splitk_pallas``) gives each split of
  ``pages_per_split`` pages private (acc, m, l) partials and combines
  them with ``m = max_s m_s`` and ``exp(m_s - m)``.

Each comes in two variants, chosen by dtype (both always built):

- ``mma``: bf16 queries over bf16 or int8 pools, head dims up to 256.
  Consecutive rows that share a table row (the rows of one prefill
  chunk) form one M tile on the tensor cores
  (``csrc/attention_tile.cuh``), so each page is loaded once
  per tile, not once per row; a tile of one (row, query head) pair (a
  decode row of an MHA stack) takes a one-row FMA step over the same
  cp.async-landed pages instead.  The tiles are formed on the device by a
  plan kernel, with no host sync: plan, tensor-core walk, one-row walk
  (MHA stacks only: G = 1) and (split-K) combine are at most four
  launches where the ``fma`` variant has two (serial: three where it has
  one).  The serial kernel is the same walk over one split that spans the
  table, so both compute every score alike and their ``m`` agree bit for
  bit;
- ``fma``: f32 queries or f32 pools, on the f32 FMA units, so f32 holds
  1e-5.

Inputs, as in the reference:
    q            (B, Hq, D)        one token per query row (f32 or bf16)
    k_pool/v_pool(P, page, Hkv, D) paged KV pools (f32, bf16 or int8)
    block_tables (T, W)            int32 pool-page ids per table row
    ctx_lens     (B,)              int32 valid context length per row
    row_map      (B,) or None      int32 table row per query row
    k/v_scale    (P, page, Hkv)    bf16 dequant scales (int8 pools)

Rows with ``ctx_lens == 0`` return exact zeros: NEG_INF is finite, the
probabilities are multiplied by the mask, and ``l`` is clamped at 1e-30.

A wrapper runs the plain version only when its tensors lie on the CPU
(the tests).  On CUDA tensors it launches the kernel or raises; there is
no fallback.  ``LAUNCHES`` counts kernel launches per wrapper, per
wrapper and variant (``paged_attention_splitk:mma``) and per wrapper and
pool dtype (``paged_attention_splitk/int8``), so a run can show that the
serving path went through the kernels, and over which pools.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
# rows per block in the plain versions, bounding their gathered copies
_PLAIN_ROW_BLOCK = 16
# a block gets 48 KiB of shared memory without opting in
_MAX_SMEM = 48 * 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the widest head the tensor-core tiles take (csrc/attention_tile.cuh)
MMA_MAX_HEAD_DIM = 256

VARIANTS = ("mma", "fma")
POOLS = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}
# launches per wrapper, per wrapper and variant ("paged_attention:mma")
# and per wrapper and pool dtype ("paged_attention/int8")
LAUNCHES: Dict[str, int] = {
    f"{name}{tag}": 0 for name in ("paged_attention", "paged_attention_splitk")
    for tag in ("",) + tuple(f":{v}" for v in VARIANTS)
    + tuple(f"/{p}" for p in POOLS.values())}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# shared validation
# ---------------------------------------------------------------------------
def _validate(q, k_pool, block_tables, row_map, k_scale, v_scale):
    B, Hq, _ = q.shape
    Hkv = k_pool.shape[2]
    if Hq % Hkv != 0:
        raise ValueError(
            f"paged attention: Hq={Hq} query heads do not group evenly "
            f"over Hkv={Hkv} kv heads")
    if block_tables.ndim != 2 or block_tables.shape[1] == 0:
        raise ValueError(
            f"paged attention: block_tables must be (rows, n_pages>=1), "
            f"got {tuple(block_tables.shape)}")
    if row_map is None and block_tables.shape[0] != B:
        raise ValueError(
            f"paged attention: {B} query rows but {block_tables.shape[0]} "
            f"block-table rows; pass row_map for ragged launches")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged attention: k_scale and v_scale must be "
                         "passed together (int8 pools) or not at all")
    others = [t for t in (k_pool, block_tables, row_map, k_scale, v_scale)
              if t is not None]
    if any(t.device != q.device for t in others):
        devices = {str(t.device) for t in [q] + others}
        raise ValueError(f"paged attention: tensors on mixed devices "
                         f"{sorted(devices)}")


def _row_map(row_map, B, device):
    if row_map is None:
        return torch.arange(B, dtype=torch.int32, device=device)
    return row_map


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------
def _plain_partials(q, k_pool, v_pool, block_tables, ctx_lens, row_map,
                    k_scale, v_scale, pages_per_split):
    """Per-split online-softmax partials, as the split-K kernel flushes
    them: acc (B, Hkv, S, G, Dv), m and l (B, Hkv, S, G), all f32.  The
    table is padded with page 0 to a multiple of ``pages_per_split``
    (ctx masks the padding).  Scores are elementwise products summed over
    D, so a score's bits do not depend on how many pages are gathered."""
    B, Hq, D = q.shape
    page, Hkv = k_pool.shape[1], k_pool.shape[2]
    Dv = v_pool.shape[-1]
    G = Hq // Hkv
    W = block_tables.shape[1]
    S = -(-W // pages_per_split)
    n = pages_per_split * page                     # tokens per split
    tables = block_tables
    if S * pages_per_split != W:
        tables = torch.nn.functional.pad(tables, (0, S * pages_per_split - W))
    pos = torch.arange(S * n, device=q.device).reshape(S, n)
    accs, ms, ls = [], [], []
    for b0 in range(0, B, _PLAIN_ROW_BLOCK):
        rows = slice(b0, min(b0 + _PLAIN_ROW_BLOCK, B))
        pages = tables[row_map[rows].long()].long()        # (b, S*pps)
        k = k_pool[pages].float()                          # (b, S*pps, page, Hkv, D)
        v = v_pool[pages].float()
        if k_scale is not None:                            # int8 dequant
            k = k * k_scale[pages].float()[..., None]
            v = v * v_scale[pages].float()[..., None]
        nb = k.shape[0]
        k = k.reshape(nb, S, n, Hkv, D).permute(0, 3, 1, 2, 4)    # (b,Hkv,S,n,D)
        v = v.reshape(nb, S, n, Hkv, Dv).permute(0, 3, 1, 2, 4)
        qg = q[rows].float().reshape(nb, Hkv, 1, G, 1, D)
        s = (qg * k[:, :, :, None]).sum(-1) * D ** -0.5    # (b,Hkv,S,G,n)
        mask = (pos[None] < ctx_lens[rows].long()[:, None, None])  # (b,S,n)
        mask = mask[:, None, :, None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m = s.amax(-1)                                     # (b,Hkv,S,G)
        p = torch.exp(s - m[..., None]) * mask
        accs.append(torch.einsum("bksgn,bksnd->bksgd", p, v))
        ms.append(m)
        ls.append(p.sum(-1))
    return torch.cat(accs), torch.cat(ms), torch.cat(ls)


def paged_attention_plain(q, k_pool, v_pool, block_tables, ctx_lens, *,
                          row_map=None, k_scale=None, v_scale=None,
                          return_stats=False):
    """Plain version of the serial kernel: one split spanning the table.
    Returns (B, Hq, Dv) in q's dtype; with ``return_stats`` also (m, l),
    each (B, Hq) f32."""
    _validate(q, k_pool, block_tables, row_map, k_scale, v_scale)
    B, Hq, _ = q.shape
    row_map = _row_map(row_map, B, q.device)
    acc, m, l = _plain_partials(q, k_pool, v_pool, block_tables, ctx_lens,
                                row_map, k_scale, v_scale,
                                block_tables.shape[1])
    acc, m, l = acc[:, :, 0], m[:, :, 0], l[:, :, 0]
    out = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype).reshape(B, Hq, -1)
    if return_stats:
        return out, m.reshape(B, Hq), l.reshape(B, Hq)
    return out


def paged_attention_splitk_plain(q, k_pool, v_pool, block_tables, ctx_lens,
                                 *, pages_per_split=4, row_map=None,
                                 k_scale=None, v_scale=None,
                                 return_stats=False):
    """Plain version of the split-K kernel and its combine."""
    if pages_per_split <= 0:
        raise ValueError(f"pages_per_split must be >= 1, got "
                         f"{pages_per_split}")
    _validate(q, k_pool, block_tables, row_map, k_scale, v_scale)
    B, Hq, _ = q.shape
    row_map = _row_map(row_map, B, q.device)
    acc_p, m_p, l_p = _plain_partials(q, k_pool, v_pool, block_tables,
                                      ctx_lens, row_map, k_scale, v_scale,
                                      pages_per_split)
    # combine: m = max_s m_s (exact); partials rescale by exp(m_s - m).
    # Splits fully beyond ctx carry (m=NEG_INF, l=0, acc=0) and vanish.
    m = m_p.amax(2, keepdim=True)
    alpha = torch.exp(m_p - m)
    l = (l_p * alpha).sum(2)
    acc = (acc_p * alpha[..., None]).sum(2)
    out = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype).reshape(B, Hq, -1)
    if return_stats:
        return out, m[:, :, 0].reshape(B, Hq), l.reshape(B, Hq)
    return out


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/paged_attention.cu)
# ---------------------------------------------------------------------------
_P = ctypes.c_void_p
_I = ctypes.c_int
_SERIAL_ARGS = [_P] * 8 + [_P, _P, _P] + [_I] * 9 + [ctypes.c_float] \
    + [_I] * 3 + [_P]
_SPLITK_ARGS = [_P] * 8 + [_I, _I, _P, _P, _P, _P, _P, _P] + [_I] * 9 \
    + [ctypes.c_float] + [_I] * 3 + [_P]
_MMA_ARGS = [_P] * 9 + [_I] * 3 + [_P] * 6 + [_I] * 9 + [ctypes.c_float, _I,
                                                        _P]


def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    if lib.paged_attention_serial.argtypes is None:
        lib.paged_attention_serial.argtypes = _SERIAL_ARGS
        lib.paged_attention_serial.restype = _I
        lib.paged_attention_splitk.argtypes = _SPLITK_ARGS
        lib.paged_attention_splitk.restype = _I
        lib.paged_attention_smem_bytes.argtypes = [_I] * 5
        lib.paged_attention_smem_bytes.restype = ctypes.c_size_t
        lib.paged_attention_mma.argtypes = _MMA_ARGS
        lib.paged_attention_mma.restype = _I
        lib.paged_attention_mma_smem_bytes.argtypes = [_I] * 4
        lib.paged_attention_mma_smem_bytes.restype = ctypes.c_size_t
    return lib


def variant(q, k_pool) -> str:
    """The kernel variant a CUDA launch takes: ``mma`` (tensor cores) for
    bf16 queries over bf16 or int8 pools, else ``fma``."""
    if q.dtype == torch.bfloat16 and k_pool.dtype in (torch.bfloat16,
                                                      torch.int8):
        return "mma"
    return "fma"


def _check_cuda(q, k_pool, v_pool, block_tables, ctx_lens, row_map, k_scale,
                v_scale):
    """Refuse anything the CUDA kernels do not take."""
    named = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
             "block_tables": block_tables, "ctx_lens": ctx_lens,
             "row_map": row_map, "k_scale": k_scale, "v_scale": v_scale}
    for name, t in named.items():
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"paged attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged attention: {name} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged attention: q dtype {q.dtype} not in "
                         "(float32, bfloat16)")
    if k_pool.dtype not in _DTYPE_CODE or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"paged attention: pools {k_pool.dtype}/"
                         f"{v_pool.dtype}; need one of float32, bfloat16, "
                         "int8 for both")
    for name in ("block_tables", "ctx_lens", "row_map"):
        if named[name].dtype != torch.int32:
            raise ValueError(f"paged attention: {name} must be int32")
    B, Hq, D = q.shape
    P, page, Hkv, Dk = k_pool.shape
    if v_pool.ndim != 4 or Dk != D or v_pool.shape[0] != P \
            or v_pool.shape[1] != page or v_pool.shape[2] != Hkv:
        raise ValueError(f"paged attention: q {tuple(q.shape)}, k_pool "
                         f"{tuple(k_pool.shape)}, v_pool "
                         f"{tuple(v_pool.shape)} do not agree")
    if ctx_lens.shape != (B,) or row_map.shape != (B,):
        raise ValueError("paged attention: ctx_lens and row_map must be (B,)")
    if B < 1 or P < 1 or block_tables.shape[0] < 1:
        raise ValueError(f"paged attention: empty launch (B={B}, pool "
                         f"pages={P}, table rows={block_tables.shape[0]})")
    if k_scale is not None:
        for name in ("k_scale", "v_scale"):
            t = named[name]
            if t.dtype != torch.bfloat16 or t.shape != (P, page, Hkv):
                raise ValueError(f"paged attention: {name} must be bf16 "
                                 f"{(P, page, Hkv)}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
    if Hkv > 65535 or Hq > 65535:
        raise ValueError("paged attention: more than 65535 heads")
    Dv = v_pool.shape[3]
    if variant(q, k_pool) == "mma":
        step = 16 if k_pool.dtype == torch.int8 else 8
        for name, d in (("D", D), ("Dv", Dv)):
            if d % step or not step <= d <= MMA_MAX_HEAD_DIM:
                raise ValueError(f"paged attention: head dim {name}={d} "
                                 f"must be a multiple of {step} in "
                                 f"[{step}, {MMA_MAX_HEAD_DIM}] for "
                                 f"{k_pool.dtype} pools")
        if k_pool.dtype == torch.int8 and k_scale is None:
            raise ValueError("paged attention: int8 pools need k_scale and "
                             "v_scale")
        if Hq // Hkv > 64 or page > 64:
            raise ValueError(f"paged attention: G={Hq // Hkv} query heads "
                             f"per kv head and page={page} must be <= 64")
        for name in ("k_pool", "v_pool"):
            if named[name].data_ptr() % 16:
                raise ValueError(f"paged attention: {name} must start on "
                                 "a 16-byte boundary (cp.async)")
        if q.data_ptr() % 4:
            raise ValueError("paged attention: q must start on a 4-byte "
                             "boundary")
        return
    smem = _lib().paged_attention_smem_bytes(Hq, Hkv, D, Dv, page)
    if smem > _MAX_SMEM:
        raise ValueError(f"paged attention: shapes need {smem} B of shared "
                         f"memory per block, above {_MAX_SMEM}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _common_args(q, k_pool, v_pool, block_tables, ctx_lens, row_map,
                 k_scale, v_scale):
    return [_ptr(t) for t in (q, k_pool, v_pool, k_scale, v_scale,
                              block_tables, row_map, ctx_lens)]


def _shape_args(q, k_pool, v_pool, block_tables, k_scale):
    B, Hq, D = q.shape
    return [B, Hq, k_pool.shape[2], D, v_pool.shape[-1], k_pool.shape[1],
            block_tables.shape[0], block_tables.shape[1], k_pool.shape[0],
            D ** -0.5,
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype],
            int(k_scale is not None)]


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} "
                           f"({torch.cuda.get_device_name()})")


def _mma(q, k_pool, v_pool, block_tables, ctx_lens, row_map, k_scale,
         v_scale, pages_per_split, n_splits, direct, out, m, l):
    """Launch the plan, the walks and (split-K) the combine.  Their
    scratch, the plan's int32 workspace and (split-K) the f32 partials
    acc (B, Hkv, S, G, Dv), m and l (B, Hkv, S, G), is one allocation."""
    B, Hq, _ = q.shape
    n_ws = -(-(3 * B + 2 * B * n_splits + 3) // 4) * 4   # partials 16-byte aligned
    n_ml = 0 if direct else B * Hq * n_splits
    n_acc = n_ml * v_pool.shape[3]
    scratch = torch.empty(n_ws + n_acc + 2 * n_ml, dtype=torch.int32,
                          device=q.device)
    ws = scratch.data_ptr()
    parts = [None] * 3 if direct else [ws + 4 * n_ws, ws + 4 * (n_ws + n_acc),
                                       ws + 4 * (n_ws + n_acc + n_ml)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        return _lib().paged_attention_mma(
            *_common_args(q, k_pool, v_pool, block_tables, ctx_lens, row_map,
                          k_scale, v_scale),
            ws, pages_per_split, n_splits, int(direct), *parts,
            out.data_ptr(), _ptr(m), _ptr(l),
            *_shape_args(q, k_pool, v_pool, block_tables, k_scale)[:10],
            _DTYPE_CODE[k_pool.dtype], stream)


def _count(name: str, var: str, pools: torch.dtype):
    LAUNCHES[name] += 1
    LAUNCHES[f"{name}:{var}"] += 1
    LAUNCHES[f"{name}/{POOLS[pools]}"] += 1


def _serial_cuda(q, k_pool, v_pool, block_tables, ctx_lens, row_map,
                 k_scale, v_scale, return_stats):
    _check_cuda(q, k_pool, v_pool, block_tables, ctx_lens, row_map, k_scale,
                v_scale)
    B, Hq, _ = q.shape
    out = torch.empty((B, Hq, v_pool.shape[-1]), dtype=q.dtype,
                      device=q.device)
    m = l = None
    if return_stats:
        m = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
        l = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
    var = variant(q, k_pool)
    if var == "mma":
        rc = _mma(q, k_pool, v_pool, block_tables, ctx_lens, row_map,
                  k_scale, v_scale, block_tables.shape[1], 1, True, out, m, l)
    else:
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _lib().paged_attention_serial(
                *_common_args(q, k_pool, v_pool, block_tables, ctx_lens,
                              row_map, k_scale, v_scale),
                out.data_ptr(), _ptr(m), _ptr(l),
                *_shape_args(q, k_pool, v_pool, block_tables, k_scale),
                stream)
    _raise_on(rc, f"paged_attention_serial ({var})")
    _count("paged_attention", var, k_pool.dtype)
    return (out, m, l) if return_stats else out


def _splitk_cuda(q, k_pool, v_pool, block_tables, ctx_lens, row_map,
                 k_scale, v_scale, pages_per_split, return_stats):
    _check_cuda(q, k_pool, v_pool, block_tables, ctx_lens, row_map, k_scale,
                v_scale)
    B, Hq, _ = q.shape
    Hkv, Dv = k_pool.shape[2], v_pool.shape[-1]
    G = Hq // Hkv
    n_splits = -(-block_tables.shape[1] // pages_per_split)
    if n_splits > 65535:
        raise ValueError(f"paged attention: {n_splits} splits > 65535")
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty((B, Hq, Dv), dtype=q.dtype, device=q.device)
    m = l = None
    if return_stats:
        m = torch.empty((B, Hq), **f32)
        l = torch.empty((B, Hq), **f32)
    var = variant(q, k_pool)
    if var == "mma":
        rc = _mma(q, k_pool, v_pool, block_tables, ctx_lens, row_map,
                  k_scale, v_scale, pages_per_split, n_splits, False, out, m,
                  l)
    else:
        acc_p = torch.empty((B, Hkv, n_splits, G, Dv), **f32)
        m_p = torch.empty((B, Hkv, n_splits, G), **f32)
        l_p = torch.empty((B, Hkv, n_splits, G), **f32)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _lib().paged_attention_splitk(
                *_common_args(q, k_pool, v_pool, block_tables, ctx_lens,
                              row_map, k_scale, v_scale),
                pages_per_split, n_splits, acc_p.data_ptr(), m_p.data_ptr(),
                l_p.data_ptr(), out.data_ptr(), _ptr(m), _ptr(l),
                *_shape_args(q, k_pool, v_pool, block_tables, k_scale),
                stream)
    _raise_on(rc, f"paged_attention_splitk ({var})")
    _count("paged_attention_splitk", var, k_pool.dtype)
    return (out, m, l) if return_stats else out


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------
def paged_attention_kernel(q, k_pool, v_pool, block_tables, ctx_lens, *,
                           row_map: Optional[torch.Tensor] = None,
                           k_scale=None, v_scale=None, return_stats=False):
    """Serial paged attention.  Returns (B, Hq, Dv) in q's dtype; with
    ``return_stats`` also the softmax statistics (m, l), each (B, Hq) f32
    (m is bitwise comparable with the split-K combine's: max is exact).
    CPU tensors run ``paged_attention_plain``; CUDA tensors the kernel."""
    _validate(q, k_pool, block_tables, row_map, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, k_pool, v_pool, block_tables, ctx_lens, row_map=row_map,
            k_scale=k_scale, v_scale=v_scale, return_stats=return_stats)
    if q.device.type != "cuda":
        raise ValueError(f"paged attention: no kernel for {q.device}")
    return _serial_cuda(q, k_pool, v_pool, block_tables, ctx_lens,
                        _row_map(row_map, q.shape[0], q.device), k_scale,
                        v_scale, return_stats)


def paged_attention_splitk_kernel(q, k_pool, v_pool, block_tables, ctx_lens,
                                  *, pages_per_split=4,
                                  row_map: Optional[torch.Tensor] = None,
                                  k_scale=None, v_scale=None,
                                  return_stats=False):
    """Flash-decoding split-K paged attention (DESIGN.md §16): identical
    math to the serial kernel up to summation order, m bitwise equal.
    CPU tensors run ``paged_attention_splitk_plain``; CUDA tensors the
    kernel and its combine."""
    if pages_per_split <= 0:
        raise ValueError(f"pages_per_split must be >= 1, got "
                         f"{pages_per_split}")
    _validate(q, k_pool, block_tables, row_map, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_attention_splitk_plain(
            q, k_pool, v_pool, block_tables, ctx_lens,
            pages_per_split=pages_per_split, row_map=row_map,
            k_scale=k_scale, v_scale=v_scale, return_stats=return_stats)
    if q.device.type != "cuda":
        raise ValueError(f"paged attention: no kernel for {q.device}")
    return _splitk_cuda(q, k_pool, v_pool, block_tables, ctx_lens,
                        _row_map(row_map, q.shape[0], q.device), k_scale,
                        v_scale, pages_per_split, return_stats)
