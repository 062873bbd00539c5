#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

The quickest proof that the port builds and serves on an NVIDIA H100:

1. device and build: the card's name and power limit (nvidia-smi), and
   the CUDA kernels built from ``src/repro_torch/csrc`` with nvcc (one
   nvcc per source, all started together), with ptxas' registers and
   the dynamic shared memory of the tensor-core tiles, and the SSD
   kernel's registers, shared memory and blocks per SM;
2. kernels against their plain PyTorch versions on the card, at the
   serving path's shapes:
   - paged attention, serial and split-K, bf16 and int8 pools (Hq = Hkv
     = 32, D = 128, page 16): decode batches of 8 and 64 rows at table
     widths 32 and 256, and ragged mixed launches (a prefill chunk over
     one table row, 8 decode rows, padding rows with ctx 0); each case
     once more with f32 queries and f32 pools at a tight tolerance;
   - flash attention (B = 1, Hq = 32, D = 128): S = 128, 1024 and 1000
     causal in bf16 and f32 (Hkv = 32), one windowed case (window 256),
     one GQA case (Hkv = 8), and Mixtral-8x7B's prefill shape (S = 6144,
     Hkv = 8, window 4096) in bf16;
   - the SSD scan at Mamba-2-2.7B's shape (H = 80, P = 64, G = 1, N =
     128, chunk 128): S = 128, 1024 and 1000 with bf16 and f32 x, S = 4096
     with bf16 x (2560 blocks, 32 chunks chained per head), and S = 1000
     bf16 from an initial state.
   Each case prints one JSON line with errors and times (kernel, plain
   version, a library yardstick where one exists, the bound);
3. the engine at full width, a dozen requests from three clients under
   the Equinox scheduler with a MoPE predictor trained by the port:
     A  Llama-2-7B as registered (32 layers, d_model 4096, bf16; random
        weights from a seed), paged, fp pools, max_len 512 (table width
        >= 32: the split-K kernel),
     B  A with int8 KV pages,
     C  A with max_len 64, prompt + output < 64 (the serial kernel),
     D  A's weights and requests on the slots backend with whole-prompt
        prefill, max_len 1280 (the flash kernel, one launch per layer and
        prompt); its first-token logits against run A's,
     E  Mamba-2-2.7B as registered (64 layers, d_model 2560, bf16; random
        weights from a seed) on the slots backend, whose default for it
        is whole-prompt prefill (the SSD-scan kernel, one launch per layer
        and prompt), max_len 1280; plus prefill + one decode step against
        prefill of the longer prompt;
     F  DeepSeek-MoE-16B as registered (28 layers, d_model 2048, the first
        layer dense, then 64 routed experts top-6 and 2 shared, bf16;
        random weights from a seed) on the slots backend with
        whole-prompt prefill (the flash kernel), max_len 1280, capacity
        dispatch; its first-token logits against a plain forward of the
        port, prefill + one decode step against the longer prefill (on
        the dense MoE path: dispatch capacity follows the row count);
     G  Mixtral-8x7B at full width, depth cut 32 -> 16 layers (the whole
        model, 93.4 GB in bf16, exceeds the card), 8 experts top-2,
        window 4096, slots with whole-prompt prefill, max_len 6400; two
        of the 12 prompts are 4500-6000 tokens long, so flash masks by
        the window and their ring slot caches wrap; the same two checks
        at prompts past the window;
   plus a check of run A's first-token logits against a dense forward,
   and ``torch.profiler`` windows (device busy share, kernel launches and
   device time by kernel per iteration): decode-heavy windows of the
   configurations of runs A, D, E and F, and prefill-heavy windows of A
   (iterations that carry 512-row chunks), D, E and G (the first
   iteration: the whole prompts of the requests it admits);
   runs A, B, D, E, F and G must go through the tensor-core (``mma``)
   variants of their kernels and launch no ``fma`` variant, and no
   kernel a run does not expect;
4. a ``kernels`` JSON line (launches per variant beside the totals), the
   nvidia-smi line, and last the result line ``{"ok": true, "device":
   {...}}``.

Any failed check exits non-zero; no phase catches an error and goes on.
Without a CUDA device it exits 2 before printing any result.  TF32 is
switched off for matmuls and cuDNN, so f32 products are full f32.

    python3 chip_smoke.py
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import importlib
import json
import pathlib
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # f32 outside the tensor cores
# kernel vs plain version on the same inputs, elementwise
# |kernel - plain| <= atol + rtol * |plain|.  Both compute in f32 and
# round once to the output type, so bf16 outputs may differ by one bf16
# step (at most 2**-7 of the value); f32 outputs by summation order only.
BF16_TOL = (2 ** -7, 1e-5)         # (rtol, atol): bf16 q, bf16 or int8 pools
F32_TOL = (1e-5, 1e-5)             # f32 q, f32 pools
# the SSD scan: the gate of tests/test_kernels.py::test_ssd_kernel
SSD_BF16_TOL = (2 ** -7, 1e-4)
SSD_F32_TOL = (0.0, 5e-4)
# int8 pools vs the bf16 pools they were quantized from: the noise bound
# of tests/test_paged_kernels.py (0.15 x std of the fp output), held by
# the RMS of the difference; its max is reported (it grows with the
# number of elements, while the std does not)
INT8_NOISE_REL_STD = 0.15
DENSE_REL_TOL = 5e-2               # served vs dense-forward first-token logits
MAX_LEN_SLOTS = 1280               # runs D-F: prompts <= 1024, outputs <= 128
# run G: Mixtral-8x7B's depth cut to 16 of its 32 layers (23.5 B of 46.7 B
# parameters, 47 of 93.4 GB in bf16: the whole model exceeds the card's
# 80 GB); fewer layers make the host's share of an iteration larger
MIXTRAL_LAYERS = 16
MAX_LEN_LONG = 6400                # run G: prompts <= 6000, outputs <= 128
LONG_PROMPTS = (4500, 6001)        # run G: two prompts past the 4096 window


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)

    # 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    regs = {name: sorted({line.split("Used")[1].split(",")[0].strip()
                          for line in _build.build_log(name).splitlines()
                          if "Used" in line and "registers" in line})
            for name in built}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": built, "ptxas_registers": regs,
          "tile_smem_bytes": tile_smem_bytes(),
          "ssd_scan:mma": importlib.import_module(
              "repro_torch.kernels.ssd_scan").mma_attrs()})

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    kernel_rows = kernel_phase(torch, flush)
    kernel_rows.update(flash_phase(torch, flush))
    kernel_rows.update(ssd_phase(torch, flush))
    engine_phase(torch, kernel_rows)

    print(smi, flush=True)
    emit({"kernels": list(kernel_rows.values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def tile_smem_bytes():
    """Dynamic shared memory of one block of each tensor-core kernel at
    the serving head dim (128), from the libraries' own size functions."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    pa = importlib.import_module("repro_torch.kernels.paged_attention")
    out = {"flash_attention:mma": fa._lib().flash_attention_mma_smem_bytes(
        128, 128)}
    for quant, pools in ((0, "bf16"), (1, "int8")):
        for thin, walk in ((0, "tensor-core walk"), (1, "one-row walk")):
            out[f"paged_attention:mma/{pools}/{walk}"] = \
                pa._lib().paged_attention_mma_smem_bytes(128, 128, quant, thin)
    return out


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------
def time_ms(torch, fn, reps, flush):
    """Median of CUDA-event times of ``reps`` calls, each after the L2
    cache (50 MB) was overwritten, as a layer's pools are cold."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def library_attention(torch, q, k_pool, v_pool, tables, ctx, row_map,
                      k_scale, v_scale):
    """Yardstick only: gather each row's pages, dequantize int8 pages,
    then one ``scaled_dot_product_attention`` with the ctx mask."""
    F = torch.nn.functional
    B, Hq, D = q.shape
    pages = tables[row_map.long()].long()                 # (B, W)
    T = pages.shape[1] * k_pool.shape[1]

    def gather(pool, scale):
        x = pool[pages]
        if scale is not None:
            x = x.to(q.dtype) * scale[pages].to(q.dtype)[..., None]
        return x.reshape(B, T, pool.shape[2], -1).transpose(1, 2)

    k, v = gather(k_pool, k_scale), gather(v_pool, v_scale)
    mask = (torch.arange(T, device=q.device)[None] < ctx[:, None])
    return F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask[:, None, None],
        enable_gqa=k.shape[1] != Hq)[:, :, 0]


def bound(torch, q, k_pool, v_pool, tables, ctx, row_map, k_scale):
    """(ms, bound_by): the larger of the bytes this call must move (each
    needed K/V slot once: rows sharing a table row share its prefix; q,
    out, tables, ctx, row_map) over HBM bandwidth and its multiply-adds
    over the peak rate for q's type."""
    need = torch.zeros(tables.shape[0], dtype=torch.long, device=q.device)
    need.scatter_reduce_(0, row_map.long(), ctx.long(), "amax")
    n_tok = int(need.sum())
    Hkv, D, Dv = k_pool.shape[2], k_pool.shape[3], v_pool.shape[3]
    per_tok = Hkv * (D + Dv) * k_pool.element_size()
    if k_scale is not None:
        per_tok += 2 * Hkv * k_scale.element_size()
    io = (q.numel() * q.element_size() * (1 + Dv / D) + tables.numel() * 4
          + ctx.numel() * 4 + row_map.numel() * 4)
    t_bytes = (n_tok * per_tok + io) / HBM_BYTES_PER_S * 1e3
    flops = int(ctx.long().sum()) * q.shape[1] * 2 * (D + Dv)
    peak = {torch.bfloat16: 989e12, torch.float32: 67e12}[q.dtype]
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tol_ratio(out, plain, tol):
    """(max abs error, max of |out - plain| / (atol + rtol |plain|)):
    the second is at most 1 when every element is within tolerance."""
    rtol, atol = tol
    o, p = out.float(), plain.float()
    d = (o - p).abs()
    return d.max().item(), (d / (atol + rtol * p.abs())).max().item()


def kernel_cases():
    """(name, ctx list, row_map list, table rows, width) at the serving
    path's shapes."""
    rng = np.random.default_rng(SEED)
    cases = []
    for w in (32, 256):
        for b in (8, 64):
            ctx = rng.integers(1, 16 * w + 1, b)
            ctx[0] = 16 * w                           # one full table
            cases.append((f"decode{b}_w{w}", ctx.tolist(), list(range(b)),
                          b, w))
    for w, chunk, n_pad in ((32, 512, 1024), (4, 48, 64)):
        # one prefill chunk from position 0 over table row 0, 8 decode rows
        # on rows 1..8, padding rows with ctx 0 on the spare row 9
        dec = rng.integers(1, 16 * w + 1, 8).tolist()
        ctx = list(range(1, chunk + 1)) + dec + [0] * (n_pad - chunk - 8)
        rmap = [0] * chunk + list(range(1, 9)) + [9] * (n_pad - chunk - 8)
        cases.append((f"mixed{chunk}+8_w{w}", ctx, rmap, 16, w))
    return cases


def kernel_phase(torch, flush):
    from repro_torch.kernels.paged_attention import (
        paged_attention_kernel, paged_attention_plain,
        paged_attention_splitk_kernel, paged_attention_splitk_plain)
    from repro_torch.models.attention import quantize_kv

    dev = torch.device("cuda")
    H, D, page, pps = 32, 128, 16, 4
    rows = {"paged_attention": {"name": "paged_attention", "route": "cuda",
                                "source": "src/repro_torch/csrc/paged_attention.cu",
                                "replaces": "src/repro/kernels/paged_attention.py:242",
                                "max_abs_err": 0.0},
            "paged_attention_splitk": {
                "name": "paged_attention_splitk", "route": "cuda",
                "source": "src/repro_torch/csrc/paged_attention.cu",
                "replaces": "src/repro/kernels/paged_attention.py:312",
                "max_abs_err": 0.0}}
    # the cases that carry each kernel's times into the kernels line: the
    # shapes runs A (split-K, width 32) and C (serial, width 4) launch
    main_case = {"paged_attention": ("mixed48+8_w4", "bf16"),
                 "paged_attention_splitk": ("mixed512+8_w32", "bf16")}
    for ci, (name, ctx_l, rmap_l, n_tab, W) in enumerate(kernel_cases()):
        g = torch.Generator(device=dev).manual_seed(SEED + ci)
        B = len(ctx_l)
        n_pool = n_tab * W + 1
        q32 = torch.randn(B, H, D, generator=g, device=dev)
        kp32 = torch.randn(n_pool, page, H, D, generator=g, device=dev)
        vp32 = torch.randn(n_pool, page, H, D, generator=g, device=dev)
        q, kp, vp = (t.to(torch.bfloat16) for t in (q32, kp32, vp32))
        perm = torch.randperm(n_pool, generator=torch.Generator().manual_seed(ci))
        tables = perm[:n_tab * W].reshape(n_tab, W).to(torch.int32).to(dev)
        ctx = torch.tensor(ctx_l, dtype=torch.int32, device=dev)
        rmap = torch.tensor(rmap_l, dtype=torch.int32, device=dev)
        zero = ctx == 0
        valid = ~zero
        for pools in ("bf16", "int8", "f32"):
            tol = F32_TOL if pools == "f32" else BF16_TOL
            if pools == "int8":
                kq, ks = quantize_kv(kp)
                vq, vs = quantize_kv(vp)
                args, scales = (q, kq, vq, tables, ctx), (ks, vs)
            elif pools == "f32":
                args, scales = (q32, kp32, vp32, tables, ctx), (None, None)
            else:
                args, scales = (q, kp, vp, tables, ctx), (None, None)
            kw = dict(row_map=rmap, k_scale=scales[0], v_scale=scales[1])
            o_s, m_s, l_s = paged_attention_kernel(*args, return_stats=True,
                                                   **kw)
            o_k, m_k, l_k = paged_attention_splitk_kernel(
                *args, pages_per_split=pps, return_stats=True, **kw)
            torch.cuda.synchronize()
            p_s = paged_attention_plain(*args, **kw)
            p_k = paged_attention_splitk_plain(*args, pages_per_split=pps,
                                               **kw)
            err_s, ratio_s = tol_ratio(o_s, p_s, tol)
            err_k, ratio_k = tol_ratio(o_k, p_k, tol)
            line = {"phase": "kernels", "case": name, "pools": pools,
                    "rows": B, "width": W, "rtol": tol[0], "atol": tol[1],
                    "serial_err": err_s, "splitk_err": err_k,
                    "serial_tol_ratio": ratio_s, "splitk_tol_ratio": ratio_k,
                    "ctx0_rows": int(zero.sum()),
                    "ctx0_exact_zero": bool((o_s[zero] == 0).all()
                                            and (o_k[zero] == 0).all()),
                    "m_bitwise": bool(torch.equal(m_s, m_k)),
                    "finite": bool(torch.isfinite(o_s.float()).all()
                                   and torch.isfinite(o_k.float()).all())}
            check(ratio_s <= 1 and ratio_k <= 1,
                  f"{name}/{pools}: kernel vs plain outside tolerance "
                  f"{tol}: max abs error {err_s}, {err_k}; ratio to the "
                  f"tolerance {ratio_s}, {ratio_k}")
            check(line["ctx0_exact_zero"], f"{name}/{pools}: ctx=0 rows "
                  "are not exact zeros")
            check(line["m_bitwise"], f"{name}/{pools}: split-K m differs "
                  "from serial m")
            check(line["finite"], f"{name}/{pools}: non-finite output")
            if pools == "f32":           # checked, not timed
                emit(line)
                for kname, err in (("paged_attention", err_s),
                                   ("paged_attention_splitk", err_k)):
                    rows[kname]["max_abs_err_f32"] = max(
                        rows[kname].get("max_abs_err_f32", 0.0), err)
                continue
            if pools == "int8":
                ref_fp = paged_attention_plain(q, kp, vp, tables, ctx,
                                               row_map=rmap).float()[valid]
                std = ref_fp.std().item()
                for kname, o in (("serial", o_s), ("splitk", o_k)):
                    d = o.float()[valid] - ref_fp
                    rms = d.square().mean().sqrt().item() / std
                    line[f"{kname}_int8_noise_rms_rel_std"] = rms
                    line[f"{kname}_int8_noise_max_rel_std"] = \
                        d.abs().max().item() / std
                    check(rms < INT8_NOISE_REL_STD,
                          f"{name}/int8: {kname} quantization noise {rms} "
                          f"(RMS over the fp output's std) above "
                          f"{INT8_NOISE_REL_STD}")
            line["serial_ms"] = time_ms(
                torch, lambda: paged_attention_kernel(*args, **kw), 20, flush)
            line["splitk_ms"] = time_ms(
                torch, lambda: paged_attention_splitk_kernel(
                    *args, pages_per_split=pps, **kw), 20, flush)
            line["plain_ms"] = time_ms(
                torch, lambda: paged_attention_plain(*args, **kw), 3, flush)
            line["splitk_plain_ms"] = time_ms(
                torch, lambda: paged_attention_splitk_plain(
                    *args, pages_per_split=pps, **kw), 3, flush)
            line["library_ms"] = time_ms(
                torch, lambda: library_attention(torch, *args, rmap, *scales),
                5, flush)
            line["bound_ms"], line["bound_by"] = bound(
                torch, q, args[1], args[2], tables, ctx, rmap, scales[0])
            emit(line)
            for kname, err, ms, plain in (
                    ("paged_attention", err_s, "serial_ms", "plain_ms"),
                    ("paged_attention_splitk", err_k, "splitk_ms",
                     "splitk_plain_ms")):
                row = rows[kname]
                row["max_abs_err"] = max(row["max_abs_err"], err)
                if main_case[kname] == (name, pools):
                    fn = paged_attention_kernel if kname == "paged_attention" \
                        else paged_attention_splitk_kernel
                    row["ms_by_kernel"] = device_ms_by_kernel(
                        torch, lambda: fn(*args, **kw), flush)
                    row.update(ms=line[ms], plain_ms=line[plain],
                               bound_ms=line["bound_ms"],
                               bound_by=line["bound_by"],
                               library_ms=line["library_ms"],
                               shape=f"{name}/{pools}")
    return rows


def device_ms_by_kernel(torch, fn, flush, reps=5,
                        names=("paged_attention", "paged_plan")):
    """Device ms per call of each kernel that ``fn`` launches whose name
    holds one of ``names`` (the plan, the walks and the combine of a paged
    call), from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = defaultdict(float)
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us and any(n in e.key for n in names):
            out[e.key[:80]] += us / 1e3 / reps
    return dict(out)


def kernel_modules():
    """The three kernel modules (by module: the package exports functions
    of the same names)."""
    return [importlib.import_module(f"repro_torch.kernels.{m}")
            for m in ("paged_attention", "flash_attention", "ssd_scan")]


def launch_counts():
    counts = {}
    for mod in kernel_modules():
        counts.update(mod.LAUNCHES)
    return counts


def reset_launch_counts():
    for mod in kernel_modules():
        mod.reset_launch_counts()


def flash_bound(S, Hq, Hkv, D, causal, window, dtype):
    """(ms, bound_by): q, k, v read and out written once over HBM
    bandwidth, against the multiply-adds of the (q, k) pairs the mask
    keeps (QK^T and PV, 2 operations each) over the peak for the type."""
    elem = {"bfloat16": 2, "float32": 4}[dtype]
    n_bytes = S * (2 * Hq + 2 * Hkv) * D * elem
    pairs = 0
    for qpos in range(S):
        lo = max(0, qpos - window + 1) if window else 0
        hi = qpos + 1 if causal else S
        pairs += hi - lo
    flops = 2 * pairs * 2 * D * Hq
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_phase(torch, flush):
    """The flash-attention kernel against its plain version at the
    whole-prompt prefill shapes of Llama-2-7B (B = 1, 32 heads, D = 128)
    and Mixtral-8x7B (8 kv heads, window 4096, a 6144-token prompt);
    library yardstick: ``scaled_dot_product_attention`` (a windowed case
    passes its mask as a boolean tensor), timed here only.  The kernels
    line carries S1024 causal bf16; it and the Mixtral case add the
    profiler's device time (``ms_by_kernel``)."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    F = torch.nn.functional
    dev = torch.device("cuda")
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:93",
           "max_abs_err": 0.0}
    cases = [(f"S{S}_causal", S, 32, True, 0, dt)
             for S in (128, 1024, 1000) for dt in ("bfloat16", "float32")]
    cases += [("S1024_window256", 1024, 32, True, 256, "bfloat16"),
              ("S1024_gqa8", 1024, 8, True, 0, "bfloat16"),
              ("S6144_window4096_gqa8", 6144, 8, True, 4096, "bfloat16")]
    for ci, (name, S, Hkv, causal, window, dt) in enumerate(cases):
        g = torch.Generator(device=dev).manual_seed(SEED + 100 + ci)
        dtype = getattr(torch, dt)
        q = torch.randn(1, S, 32, 128, generator=g, device=dev).to(dtype)
        k = torch.randn(1, S, Hkv, 128, generator=g, device=dev).to(dtype)
        v = torch.randn(1, S, Hkv, 128, generator=g, device=dev).to(dtype)
        tol = BF16_TOL if dt == "bfloat16" else F32_TOL
        out = fa.flash_attention_kernel(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        plain = fa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
        err, ratio = tol_ratio(out, plain, tol)
        check(ratio <= 1, f"flash {name}/{dt}: kernel vs plain outside "
              f"tolerance {tol}: max abs error {err}, ratio {ratio}")
        check(bool(torch.isfinite(out.float()).all()),
              f"flash {name}/{dt}: non-finite output")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None
        if window:
            pos = torch.arange(S, device=dev)
            mask = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None]
                                                   - window)

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                enable_gqa=Hkv != 32)

        line = {"phase": "kernels", "kernel": "flash_attention",
                "case": name, "dtype": dt, "S": S, "Hq": 32, "Hkv": Hkv,
                "D": 128, "window": window, "rtol": tol[0], "atol": tol[1],
                "max_abs_err": err, "tol_ratio": ratio,
                "ms": time_ms(torch, lambda: fa.flash_attention_kernel(
                    q, k, v, causal=causal, window=window), 20, flush),
                "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
                    q, k, v, causal=causal, window=window), 3, flush),
                "library_ms": time_ms(torch, library, 10, flush)}
        line["bound_ms"], line["bound_by"] = flash_bound(
            S, 32, Hkv, 128, causal, window, dt)
        if name in ("S1024_causal", "S6144_window4096_gqa8") \
                and dt == "bfloat16":
            line["ms_by_kernel"] = device_ms_by_kernel(
                torch, lambda: fa.flash_attention_kernel(
                    q, k, v, causal=causal, window=window), flush,
                names=("flash_attention",))
        emit(line)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if (name, dt) == ("S1024_causal", "bfloat16"):
            row.update(ms=line["ms"], ms_by_kernel=line["ms_by_kernel"],
                       plain_ms=line["plain_ms"],
                       bound_ms=line["bound_ms"], bound_by=line["bound_by"],
                       library_ms=line["library_ms"],
                       shape=f"{name}/{dt}")
    return {"flash_attention": row}


def ssd_bound(S, H, P, N, chunk, dtype):
    """(ms, bound_by): x, la, B, C read and y and the f32 final state
    written once over HBM bandwidth, against the multiply-adds each
    chunk of this length needs (C B^T and its product with x over the
    causal pairs, C state^T and the state update), 2 operations each,
    over the peak for x's type."""
    elem = {"bfloat16": 2, "float32": 4}[dtype]
    n_bytes = S * (2 * H * P + 2 * N) * elem + S * H * 4 + H * P * N * 4
    macs = 0
    for t0 in range(0, S, chunk):
        q = min(chunk, S - t0)
        pairs = q * (q + 1) // 2
        macs += H * (pairs * (N + P) + 2 * q * P * N)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * macs / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssd_phase(torch, flush):
    """The SSD-scan kernel against its plain version at Mamba-2-2.7B's
    whole-prompt prefill shape; no single PyTorch call computes it."""
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    dev = torch.device("cuda")
    H, P, N, chunk = 80, 64, 128, 128
    row = {"name": "ssd_scan", "route": "cuda",
           "source": "src/repro_torch/csrc/ssd_scan.cu",
           "replaces": "src/repro/kernels/ssd_scan.py:85",
           "max_abs_err": 0.0, "library_ms": None}
    # decays as the model makes them: la = -dt * A, dt log-uniform on
    # [1e-3, 1e-1] (softplus of the dt_bias draw), A = 1 .. H; x at unit
    # scale and B, C at 0.3 (the scores C.B then have unit scale at N =
    # 128, as in tests/test_torch_kernels_cuda.py: at unit-scale B and C
    # they reach 11, and f32 cancellation alone moves outputs near zero
    # past the 1e-4 absolute tolerance on either side)
    cases = [(f"S{S}", ci, S, dt, False) for ci, S in enumerate((128, 1024, 1000))
             for dt in ("bfloat16", "float32")]
    cases += [("S4096", 3, 4096, "bfloat16", False),
              ("S1000_init", 4, 1000, "bfloat16", True)]
    for name, ci, S, dt, with_init in cases:
        g = torch.Generator(device=dev).manual_seed(SEED + 200 + ci)
        dtype = getattr(torch, dt)
        x = torch.randn(1, S, H, P, generator=g, device=dev).to(dtype)
        step = torch.exp(torch.rand(1, S, H, generator=g, device=dev)
                         * np.log(100.0) + np.log(1e-3))
        la = -step * torch.arange(1, H + 1, device=dev)
        Bm = (0.3 * torch.randn(1, S, 1, N, generator=g,
                                device=dev)).to(dtype)
        Cm = (0.3 * torch.randn(1, S, 1, N, generator=g,
                                device=dev)).to(dtype)
        init = torch.randn(1, H, P, N, generator=g, device=dev) \
            if with_init else None
        tol = SSD_BF16_TOL if dt == "bfloat16" else SSD_F32_TOL

        def kernel():
            return ss.ssd_scan_kernel(x, la, Bm, Cm, chunk=chunk,
                                      initial_state=init)

        y, st = kernel()
        torch.cuda.synchronize()
        py, pst = ss.ssd_scan_plain(x, la, Bm, Cm, chunk=chunk,
                                    initial_state=init)
        err, ratio = tol_ratio(y, py, tol)
        st_err, st_ratio = tol_ratio(st, pst, SSD_F32_TOL)
        check(ratio <= 1 and st_ratio <= 1,
              f"ssd {name}/{dt}: kernel vs plain outside tolerance {tol}: "
              f"y error {err} (ratio {ratio}), state error {st_err} "
              f"(ratio {st_ratio})")
        check(bool(torch.isfinite(y.float()).all()
                   and torch.isfinite(st).all()),
              f"ssd {name}/{dt}: non-finite output")
        line = {"phase": "kernels", "kernel": "ssd_scan", "case": name,
                "dtype": dt, "variant": ss.VARIANTS[dtype], "S": S, "H": H,
                "P": P, "G": 1, "N": N, "chunk": chunk,
                "initial_state": with_init, "rtol": tol[0], "atol": tol[1],
                "max_abs_err": err, "tol_ratio": ratio,
                "state_max_abs_err": st_err, "state_tol_ratio": st_ratio,
                "ms": time_ms(torch, kernel, 20, flush),
                "ms_by_kernel": device_ms_by_kernel(
                    torch, kernel, flush, names=("ssd_scan",)),
                "plain_ms": time_ms(torch, lambda: ss.ssd_scan_plain(
                    x, la, Bm, Cm, chunk=chunk, initial_state=init), 3,
                    flush),
                "library_ms": None,
                "grid_blocks": ss.grid_blocks(x, chunk),
                "sms": torch.cuda.get_device_properties(
                    dev).multi_processor_count}
        line["bound_ms"], line["bound_by"] = ssd_bound(S, H, P, N, chunk, dt)
        emit(line)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if (name, dt) == ("S1024", "bfloat16"):
            row.update(ms=line["ms"], ms_by_kernel=line["ms_by_kernel"],
                       plain_ms=line["plain_ms"], bound_ms=line["bound_ms"],
                       bound_by=line["bound_by"], shape=f"{name}/{dt}")
    return {"ssd_scan": row}


# ---------------------------------------------------------------------------
# 3. the engine at full width
# ---------------------------------------------------------------------------
def token_spy():
    """An observer of every produced token, per request, in production
    order, and of the host clock at the end of every iteration."""
    from repro_torch.serving.telemetry import Observer

    class TokenSpy(Observer):
        def __init__(self):
            self.tokens = defaultdict(list)
            self.stamps = []

        def on_iteration(self, now, *, t_iter, util, fresh, running,
                         produced, first):
            self.stamps.append(time.perf_counter())
            for r in produced:
                self.tokens[r.rid].append(int(r._next_token))

    return TokenSpy()


def reduced_of(cfg):
    """The cut of a run's configuration from the registered one, or None."""
    from repro_torch.configs import get_config

    full = get_config(cfg.name)
    if full.n_layers == cfg.n_layers:
        return None
    return {"n_layers": [full.n_layers, cfg.n_layers],
            "n_params": [full.n_params(), cfg.n_params()],
            "why": "the whole model exceeds the card's memory; fewer layers "
                   "make the host's share of an iteration larger"}


def setup(torch, arch, n_layers=None):
    """(cfg, weights drawn on the card from SEED, cost model, MoPE);
    ``n_layers`` cuts the depth."""
    from repro_torch.configs import get_config
    from repro_torch.predictor import MoPE
    from repro_torch.serving.costmodel import H100_SXM, CostModel
    from repro_torch.weights import init_params
    from repro_torch.workloads import corpus

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), "cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    cm = CostModel(cfg, H100_SXM)
    t0 = time.perf_counter()
    mope = MoPE(cm, corpus(4000, seed=SEED), epochs=20, seed=SEED)
    line = {"phase": "engine_setup", "model": cfg.name,
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "dtype": cfg.dtype, "n_params": cfg.n_params(),
            "weight_gib": n_bytes / 2 ** 30, "init_s": t_init,
            "mope_train_s": time.perf_counter() - t0}
    if reduced_of(cfg):
        line["reduced"] = reduced_of(cfg)
    emit(line)
    return cfg, params, cm, mope


def requests(short, long_prompts=0):
    """The 12 requests of every run (``short``: run C's, which fit
    max_len 64), from SEED; ``long_prompts``: that many of the first
    arrivals get prompts of LONG_PROMPTS tokens instead (run G)."""
    from repro_torch.core import Request
    from repro_torch.workloads.traces import sample_prompt

    rng = np.random.default_rng(SEED + short)
    out = []
    for i in range(12):
        kw = sample_prompt(rng)[0]
        if short:
            plen = int(rng.integers(16, 40))
            olen = int(rng.integers(8, 64 - plen))
        else:
            plen = int(rng.integers(64, 1025))
            olen = int(rng.integers(16, 129))
        out.append(Request(rid=i, client=f"client{i % 3}",
                           arrival=0.02 * i, prompt_len=plen,
                           output_len=olen, keywords=kw))
    rng = np.random.default_rng(SEED + 2)
    for r in out[:long_prompts]:
        r.prompt_len = int(rng.integers(*LONG_PROMPTS))
    return out


def serve(torch, run, model, max_len, short, expect, long_prompts=0,
          **engine_kw):
    """One run on a fresh engine; ``expect`` maps each kernel to
    whether the run must launch it (or an exact count).  Returns the
    tokens, the first-token logits, the launch counts and the engine
    line."""
    from repro_torch.core import jain, make_scheduler
    from repro_torch.serving.engine import ServingEngine

    cfg, params, cm, mope = model
    spy = token_spy()
    sched = make_scheduler("equinox", predictor=copy.deepcopy(mope))
    eng = ServingEngine(cfg, sched, params=params, max_len=max_len,
                        cost_model=cm, seed=SEED, observer=spy,
                        keep_first_logits=True, device="cuda",
                        **engine_kw)
    finite = []
    sample = eng._sample
    prefills = [0]
    whole = eng._prefill_whole

    def checked_sample(row):             # every decode row's logits
        finite.append(bool(np.isfinite(row).all()))
        return sample(row)

    def counted_prefill(req):            # every whole-prompt prefill
        prefills[0] += 1
        return whole(req)

    eng._sample = checked_sample
    eng._prefill_whole = counted_prefill
    reqs = requests(short, long_prompts)
    if eng.backend == "slots":
        # slot caches do not wrap for full attention: a write past
        # max_len would be dropped
        check(all(r.prompt_len + r.output_len + 1 <= max_len
                  for r in reqs), f"run {run}: a request outgrows "
              f"max_len {max_len}")
    torch.cuda.reset_peak_memory_stats()
    start_gib = torch.cuda.memory_allocated() / 2 ** 30
    reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    check(len(done) == len(reqs), f"run {run}: {len(done)}/{len(reqs)} "
          "finished")
    for r in done:
        check(r.generated == r.output_len, f"run {run}: rid {r.rid} "
              f"generated {r.generated} of {r.output_len}")
        check(np.isfinite(r._first_row).all(), f"run {run}: rid {r.rid} "
              "first-token logits not finite")
        check(len(spy.tokens[r.rid]) >= r.output_len,
              f"run {run}: rid {r.rid} token log short")
    check(all(finite), f"run {run}: non-finite decode logits")
    for name, want in expect.items():
        got = launches[name]
        if want == "per_layer_prefill":
            want_n = cfg.n_layers * prefills[0]
            check(prefills[0] > 0 and got == want_n,
                  f"run {run}: {name} launched {got} times, not "
                  f"{cfg.n_layers} layers x {prefills[0]} prefills")
        else:
            check(got > 0 if want else got == 0,
                  f"run {run}: {name} launched {got} times")
    # whole iterations on the host clock (admission, planning, the
    # model step, sampling, bookkeeping); the step span of iter_log
    # is the model step and its copy back alone
    it = np.diff([t0] + spy.stamps)
    step = np.array([s for s, _, _ in eng.iter_log])
    # the model steps that ran prompt tokens (run A: 512-row chunks and
    # decode rows in one launch; run D: whole prompts)
    pre = np.array([(s, n) for s, n, _ in eng.iter_log if n > 0])
    prompt_tokens = sum(r.prompt_len for r in done)
    output_tokens = sum(r.generated for r in done)
    ttft = np.array([r.ttft() for r in done])
    line = {"phase": "engine", "run": run, "model": cfg.name,
            "backend": eng.backend, "chunked": eng.chunked,
            "max_len": max_len, "kv_quant": eng.kv_quant,
            "requests": len(done), "prefill_calls_whole": prefills[0],
            "prompt_tokens": prompt_tokens, "output_tokens": output_tokens,
            "iterations": eng.iterations, "wall_s": wall,
            "iter_ms_mean": wall / eng.iterations * 1e3,
            "iter_ms_median": float(np.median(it) * 1e3),
            "iter_ms_p90": float(np.percentile(it, 90) * 1e3),
            "prefill_tok_per_s_wall": prompt_tokens / wall,
            "output_tok_per_s_wall": output_tokens / wall,
            "model_step_ms_median": float(np.median(step) * 1e3),
            "model_step_ms_p90": float(np.percentile(step, 90) * 1e3),
            "prefill_steps": len(pre),
            "prefill_step_ms_median": float(np.median(pre[:, 0]) * 1e3),
            "prefill_step_ms_max": float(pre[:, 0].max() * 1e3),
            "prefill_rows_per_step_mean": float(pre[:, 1].mean()),
            "ttft_model_s_p50": float(np.percentile(ttft, 50)),
            "ttft_model_s_p90": float(np.percentile(ttft, 90)),
            "service": {k: round(v, 1) for k, v in sched.service.items()},
            "jain": jain(list(sched.service.values())),
            "preemptions": eng.n_preemptions, "launches": launches,
            "start_mem_gib": start_gib,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if reduced_of(cfg):
        line["reduced"] = reduced_of(cfg)
    emit(line)
    tokens = {r.rid: spy.tokens[r.rid] for r in done}
    firsts = {r.rid: (r.prompt_tokens, r._first_row) for r in done}
    # the hooks above tie the engine into a cycle: free its pools and
    # caches now, not at some later collection inside the next run
    del eng, checked_sample, counted_prefill
    gc.collect()
    torch.cuda.empty_cache()
    return tokens, firsts, launches, line


def engine_phase(torch, kernel_rows):
    from repro_torch.core import make_scheduler
    from repro_torch.serving.engine import ServingEngine


    # every kernel and variant must stay unlaunched unless a run expects
    # it: runs A, B, C (bf16 queries over bf16 or int8 pages), D (bf16
    # prefill) and E (bf16 SSD scan) go through the tensor-core ("mma")
    # variants
    paged = {name: False for name in launch_counts()}
    splitk_mma = {"paged_attention_splitk": True,
                  "paged_attention_splitk:mma": True}
    llama = setup(torch, "llama2-7b")
    tok_a, first_a, la, _ = serve(torch, "A", llama, 512, False,
                                  dict(paged, **splitk_mma), backend="paged")
    tok_b, _, lb, _ = serve(torch, "B", llama, 512, False,
                            dict(paged, **splitk_mma), backend="paged",
                            kv_quant=True)
    _, _, lc, _ = serve(torch, "C", llama, 64, True,
                        dict(paged, paged_attention=True,
                             **{"paged_attention:mma": True}),
                        backend="paged")
    # reported, not asserted: int8 pages may flip a near-tie argmax
    agree = np.mean([tok_a[rid] == tok_b[rid] for rid in tok_a])
    emit({"phase": "engine", "greedy_agreement_fp_vs_int8": float(agree)})
    _, first_d, ld, _ = serve(
        torch, "D", llama, MAX_LEN_SLOTS, False,
        dict(paged, flash_attention="per_layer_prefill",
             **{"flash_attention:mma": "per_layer_prefill"}),
        backend="slots", chunked=False)
    first_token_check(first_d, first_a)
    dense_check(torch, llama[1], llama[0], first_a)

    def profiled(run, model, max_len, window="decode", long_prompts=0,
                 **engine_kw):
        cfg, params, cm, mope = model
        return profile_window(torch, run, ServingEngine(
            cfg, make_scheduler("equinox", predictor=copy.deepcopy(mope)),
            params=params, max_len=max_len, cost_model=cm, seed=SEED,
            device="cuda", **engine_kw), requests(False, long_prompts),
            window)

    profiled("A", llama, 512, backend="paged")
    profiled("A", llama, 512, "prefill", backend="paged")
    profiled("D", llama, MAX_LEN_SLOTS, backend="slots", chunked=False)
    profiled("D", llama, MAX_LEN_SLOTS, "prefill", backend="slots",
             chunked=False)
    del llama
    torch.cuda.empty_cache()

    mamba = setup(torch, "mamba2-2.7b")
    _, _, le, _ = serve(torch, "E", mamba, MAX_LEN_SLOTS, False,
                        dict(paged, ssd_scan="per_layer_prefill",
                             **{"ssd_scan:mma": "per_layer_prefill"}),
                        backend="slots")
    decode_consistency(torch, mamba[1], mamba[0])
    profiled("E", mamba, MAX_LEN_SLOTS, backend="slots")
    profiled("E", mamba, MAX_LEN_SLOTS, "prefill", backend="slots")
    del mamba
    gc.collect()
    torch.cuda.empty_cache()

    # the MoE stacks: whole-prompt prefill through the flash kernel, and
    # nothing else of the port (decode runs the slots step in torch)
    flash_only = dict(paged, flash_attention="per_layer_prefill",
                      **{"flash_attention:mma": "per_layer_prefill"})
    deepseek = setup(torch, "deepseek-moe-16b")
    _, first_f, lf, _ = serve(torch, "F", deepseek, MAX_LEN_SLOTS, False,
                              flash_only, backend="slots", chunked=False)
    # one prompt at a time: the plain forward's dispatch sees the same
    # rows as the served prefill, so the same assignments drop
    dense_check(torch, deepseek[1], deepseek[0], first_f)
    # prefill and decode put different row counts through the dispatch,
    # which then drops different assignments: compare on the dense path
    decode_consistency(torch, deepseek[1], dataclasses.replace(
        deepseek[0], moe_impl="dense"))
    profiled("F", deepseek, MAX_LEN_SLOTS, backend="slots", chunked=False)
    del deepseek
    gc.collect()
    torch.cuda.empty_cache()

    mixtral = setup(torch, "mixtral-8x7b", n_layers=MIXTRAL_LAYERS)
    window = mixtral[0].window
    _, first_g, lg, _ = serve(torch, "G", mixtral, MAX_LEN_LONG, False,
                              flash_only, long_prompts=2, backend="slots")
    long = sorted(rid for rid, (toks, _) in first_g.items()
                  if len(toks) > window)
    check(len(long) == 2, f"run G: {len(long)} prompts past the window "
          f"{window}, not 2")
    dense_check(torch, mixtral[1], mixtral[0], first_g, rids=long[:1])
    decode_consistency(torch, mixtral[1], dataclasses.replace(
        mixtral[0], moe_impl="dense"), n=window + 104)
    line = profiled("G", mixtral, MAX_LEN_LONG, "prefill", long_prompts=2,
                    backend="slots")
    check(line["longest_prompt_prefilled"] > window, "run G: the prefill "
          "window carried no prompt past the attention window")
    del mixtral
    gc.collect()
    torch.cuda.empty_cache()
    main_runs = {"paged_attention": (la, lb, lc),
                 "paged_attention_splitk": (la, lb, lc),
                 "flash_attention": (ld, lf, lg), "ssd_scan": (le,)}
    for name, runs in main_runs.items():
        row = kernel_rows[name]
        row["launches"] = sum(r[name] for r in runs)
        variants = {k.split(":")[1]: sum(r[k] for r in runs)
                    for k in runs[0] if k.startswith(f"{name}:")}
        if variants:
            row["launches_by_variant"] = variants


def first_token_check(firsts, ref):
    """Run D's first-token logits (whole-prompt prefill through the flash
    kernel) against run A's (chunked paged prefill through the paged
    kernels) for the same prompts and weights: equal argmax, max
    difference within DENSE_REL_TOL of the largest logit."""
    worst, n_equal = 0.0, 0
    for rid, (toks, row) in firsts.items():
        ref_toks, ref_row = ref[rid]
        check(np.array_equal(toks, ref_toks), f"rid {rid}: prompts differ "
              "between runs A and D")
        rel = float(np.abs(row - ref_row).max() / np.abs(ref_row).max())
        worst = max(worst, rel)
        n_equal += int(np.argmax(row)) == int(np.argmax(ref_row))
    emit({"phase": "first_token_check", "runs": "D vs A",
          "requests": len(firsts), "argmax_equal": n_equal,
          "max_rel_err": worst})
    check(n_equal == len(firsts), f"run D: first-token argmax differs from "
          f"run A's on {len(firsts) - n_equal} of {len(firsts)} requests")
    check(worst < DENSE_REL_TOL, f"run D: first-token logits differ from "
          f"run A's by {worst} (relative)")


def decode_consistency(torch, params, cfg, n=300):
    """prefill of n tokens against prefill of the first n - 1 followed by
    one decode step, as tests/test_decode_consistency.py does on the CPU:
    holds the SSD-scan kernel's final state (and the conv tail) against
    the ``ssd_step`` recurrence (run E), the flash kernel's prefill
    against decode over the slot cache (runs F and G; past the window,
    G's ring cache wraps)."""
    from repro_torch.models.model import decode_step, prefill

    toks = torch.from_numpy(np.random.default_rng(SEED + 7).integers(
        0, cfg.vocab_size, (1, n))).to("cuda")
    full, _ = prefill(params, {"tokens": toks}, cfg, n + 4)
    _, cache = prefill(params, {"tokens": toks[:, :-1]}, cfg, n + 4)
    step, _ = decode_step(params, toks[:, -1], cache, cfg)
    full, step = full.float()[0].cpu().numpy(), step.float()[0].cpu().numpy()
    rel = float(np.abs(step - full).max() / np.abs(full).max())
    same = int(np.argmax(step)) == int(np.argmax(full))
    emit({"phase": "decode_consistency", "model": cfg.name, "prompt_len": n,
          "moe_impl": cfg.moe_impl if cfg.moe else None,
          "max_rel_err": rel, "argmax_equal": same,
          "finite": bool(np.isfinite(step).all() and np.isfinite(full).all())})
    check(np.isfinite(step).all() and np.isfinite(full).all(),
          "decode consistency: non-finite logits")
    check(rel < DENSE_REL_TOL and same, f"decode consistency: prefill + one "
          f"decode step differs from the longer prefill by {rel} "
          f"(relative), argmax equal: {same}")


def profile_window(torch, run, eng, reqs, window="decode"):
    """Where an iteration's time goes (the configuration of ``run``): all
    requests arrive at once.

    ``decode``: 14 iterations run the prompts in, then 10 iterations are
    timed on the host clock and 10 more under ``torch.profiler`` for
    device time by kernel.  ``prefill``: iterations that carry prompt
    tokens, profiled, their host time read under the profiler: run A's
    iterations 2-4 (the first runs unprofiled; the two requests admitted
    first have 1726 prompt tokens, so these carry 512, 512 and 190 prompt
    rows beside the decode rows); the first iteration of runs D and E, the
    whole prompts of the requests it admits (later iterations decode until
    a request finishes).  Device busy share = device time per iteration / wall time
    per iteration."""
    from torch.profiler import ProfilerActivity, profile

    warm, steps = {"decode": (14, 10), "prefill": (1, 3) if run == "A"
                   else (0, 1)}[window]
    for r in reqs:
        r.arrival = 0.0
        eng.submit(r)
    for _ in range(warm):
        eng.step()
    torch.cuda.synchronize()
    rows = 0
    if window == "decode":
        t0 = time.perf_counter()
        for _ in range(steps):
            rows += len(eng.running)
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    n_log = len(eng.iter_log)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            if window == "prefill":
                rows += len(eng.running)
            eng.step()
        torch.cuda.synchronize()
        if window == "prefill":
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    logged = eng.iter_log[n_log:]
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    device_ms = sum(dev_us(e) for e in events) / 1e3 / steps
    top = sorted(events, key=dev_us, reverse=True)[:8]
    ours = defaultdict(lambda: [0.0, 0.0])        # the port's own kernels
    for e in events:
        if any(n in e.key for n in ("paged_attention", "paged_plan",
                                    "flash_attention", "ssd_scan")):
            name = e.key[:80]
            ours[name][0] += dev_us(e) / 1e3 / steps
            ours[name][1] += e.count / steps
    line = {"phase": "profile", "run": run, "window": window,
            "iterations": steps, "rows_per_iteration": rows / steps,
            "wall_ms_per_iteration": wall_ms,
            "device_ms_per_iteration": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "kernel_launches_per_iteration":
                sum(e.count for e in events) / steps,
            "port_kernels_ms_per_iteration": {
                k: v[0] for k, v in sorted(ours.items())},
            "port_kernel_launches_per_iteration": {
                k: v[1] for k, v in sorted(ours.items())},
            "top_device_kernels": [
                {"name": e.key[:80],
                 "ms_per_iteration": dev_us(e) / 1e3 / steps,
                 "calls_per_iteration": e.count / steps} for e in top]}
    if reduced_of(eng.cfg):
        line["reduced"] = reduced_of(eng.cfg)
    if window == "prefill":
        line["longest_prompt_prefilled"] = max(
            r.prompt_len for r in eng.running + eng.finished
            if r.prefill_done >= r.prompt_len)
        line["prompt_rows_per_iteration"] = [n for _, n, _ in logged]
        line["model_step_ms_profiled"] = [s * 1e3 for s, _, _ in logged]
        check(sum(n for _, n, _ in logged) > 0,
              f"run {run}: the prefill window ran no prompt tokens")
    emit(line)
    return line


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def plain_attention(torch, q, k, v, window, heads=8):
    """Causal (and windowed) attention of one prompt, scores in f32,
    ``heads`` query heads at a time.  q (S, Hq, D), k/v (S, Hkv, D)."""
    S, H, hd = q.shape
    G = H // k.shape[1]
    k, v = (t.repeat_interleave(G, dim=1).float() for t in (k, v))
    pos = torch.arange(S, device=q.device)
    keep = pos[None] <= pos[:, None]
    if window:
        keep &= pos[None] > pos[:, None] - window
    out = torch.empty((S, H, hd), device=q.device)
    for h in range(0, H, heads):
        s = torch.einsum("shd,thd->hst", q[:, h:h + heads].float(),
                         k[:, h:h + heads]) * hd ** -0.5
        p = torch.softmax(s.masked_fill(~keep, -1e30), -1)
        out[:, h:h + heads] = torch.einsum("hst,thd->shd", p,
                                           v[:, h:h + heads])
    return out.to(q.dtype)


def dense_check(torch, params, cfg, firsts, n=3, rids=None):
    """The served first-token logits of ``n`` requests (or of ``rids``)
    against a plain forward of the same weights, one prompt at a time:
    attention without pools or kernels, the port's MLP and MoE FFN."""
    from repro_torch.models.layers import apply_rope, embed, rmsnorm, unembed
    from repro_torch.models.model import (ffn_forward, layer_params,
                                          model_stages, window_for)

    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
    worst = 0.0
    with torch.no_grad():
        for rid in rids or sorted(firsts)[:n]:
            toks, served = firsts[rid]
            S = len(toks)
            x = embed(params["embed"], torch.as_tensor(toks, device="cuda"))
            pos = torch.arange(S, device="cuda")
            for si, (kind, moe_flag, count) in enumerate(model_stages(cfg)):
                st = params["stages"][f"stage_{si}"]
                window = window_for(cfg, kind)
                for i in range(count):
                    h = rmsnorm({"scale": st["ln1"]["scale"][i]}, x,
                                cfg.norm_eps)
                    q, k, v = (h @ st["attn"][w][i].reshape(cfg.d_model, -1)
                               for w in ("wq", "wk", "wv"))
                    q = apply_rope(q.reshape(S, H, hd), pos, cfg.rope_theta)
                    k = apply_rope(k.reshape(S, Hkv, hd), pos,
                                   cfg.rope_theta)
                    o = plain_attention(torch, q, k, v.reshape(S, Hkv, hd),
                                        window)
                    x = x + o.reshape(S, -1) @ st["attn"]["wo"][i].reshape(
                        H * hd, -1)
                    h2 = rmsnorm({"scale": st["ln2"]["scale"][i]}, x,
                                 cfg.norm_eps)
                    x = x + ffn_forward(layer_params(st["ffn"], i), h2, cfg,
                                        moe_flag)
            ref = unembed(params["embed"], rmsnorm(
                params["final_norm"], x[-1:], cfg.norm_eps)).float()[0]
            ref = ref.cpu().numpy()
            rel = float(np.abs(served - ref).max() / np.abs(ref).max())
            worst = max(worst, rel)
            emit({"phase": "dense_check", "model": cfg.name, "rid": rid,
                  "prompt_len": S, "max_rel_err": rel,
                  "argmax_equal": int(np.argmax(served)) == int(np.argmax(ref))})
    check(worst < DENSE_REL_TOL, f"{cfg.name}: served first-token logits "
          f"differ from the plain forward by {worst} (relative)")


if __name__ == "__main__":
    sys.exit(main())
