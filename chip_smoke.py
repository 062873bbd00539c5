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
     one table row, 8 decode rows, padding rows with ctx 0); at
     StarCoder2-7B's shape (Hq 36 over Hkv 4: G = 9) a decode batch of 8
     rows and the 512-row mixed launch at width 32; each case once more
     with f32 queries and f32 pools at a tight tolerance;
   - flash attention (B = 1, Hq = 32, D = 128): S = 128, 1024 and 1000
     causal in bf16 and f32 (Hkv = 32), one windowed case (window 256),
     one GQA case (Hkv = 8), Mixtral-8x7B's prefill shape (S = 6144,
     Hkv = 8, window 4096) in bf16, and Granite-3-2B's (S = 1024, Hkv =
     8, D = 64) in bf16 and f32;
   - the SSD scan at Mamba-2-2.7B's shape (H = 80, P = 64, G = 1, N =
     128, chunk 128): S = 128, 1024 and 1000 with bf16 and f32 x, S = 4096
     with bf16 x (2560 blocks, 32 chunks chained per head), and S = 1000
     bf16 from an initial state.
   Each case prints one JSON line with errors and times (kernel, plain
   version, a library yardstick where one exists, the bound); and the
   slots backend's decode attention at run D's shape through the paged
   kernels over the slot caches, against its f32 plain version, its
   extra device memory asserted below one f32 copy of the caches;
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
     H  StarCoder2-7B as registered (32 layers, d_model 4608, 36 query
        heads over 4 kv heads of 128, d_ff 18 432, GELU, vocab 49 152,
        bf16; random weights from a seed), paged like run A: G = 9 takes
        the split-K tensor-core walk for decode rows, never the one-row
        walk (asserted on its decode window); its first tokens against
        a plain forward,
     I  H's weights on multi-turn conversations that share system
        prompts, served cold and with the prefix cache: hits asserted,
        warm first-token logits against cold ones,
     J  a two-replica ``Cluster`` of paged Llama-2-7B engines over one
        weight set, Equinox schedulers sharing their fairness state,
        ``least_kv`` routing, a flight recorder per replica: the counter
        replay of the replicas' events equals the live counters, and the
        windowed Jain of the merged trace is printed;
   runs D, F and G decode over their slot caches through the split-K
   paged kernels (once per layer and decode step, asserted), and their
   decode steps take less extra memory than an f32 copy of one layer's
   caches;
   plus a check of run A's first-token logits against a dense forward,
   and ``torch.profiler`` windows (device busy share, kernel launches and
   device time by kernel per iteration): decode-heavy windows of the
   configurations of runs A, D, E, F, G and H, and prefill-heavy windows
   of A
   (iterations that carry 512-row chunks), D, E and G (the first
   iteration: the whole prompts of the requests it admits);
   runs A, B and D-J must go through the tensor-core (``mma``) variants
   of their kernels and launch no ``fma`` variant, and no kernel a run
   does not expect;
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
    slot_attention_phase(torch, flush)
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
    """(name, ctx list, row_map list, table rows, width, Hq, Hkv) at the
    serving path's shapes: Llama-2-7B's (MHA, 32 heads) and StarCoder2-7B's
    (36 query heads over 4 kv heads: G = 9, so a decode row is one tile of
    9 (row, head) pairs and a chunk's tiles hold 7 rows, 63 pairs)."""
    rng = np.random.default_rng(SEED)
    cases = []
    for w in (32, 256):
        for b in (8, 64):
            ctx = rng.integers(1, 16 * w + 1, b)
            ctx[0] = 16 * w                           # one full table
            cases.append((f"decode{b}_w{w}", ctx.tolist(), list(range(b)),
                          b, w, 32, 32))
    for w, chunk, n_pad in ((32, 512, 1024), (4, 48, 64)):
        cases.append(mixed_case(rng, w, chunk, n_pad, 32, 32))
    rng = np.random.default_rng(SEED + 16)
    ctx = rng.integers(1, 16 * 32 + 1, 8)
    ctx[0] = 16 * 32
    cases.append(("gqa9_decode8_w32", ctx.tolist(), list(range(8)), 8, 32,
                  36, 4))
    cases.append(mixed_case(rng, 32, 512, 1024, 36, 4, prefix="gqa9_"))
    return cases


def mixed_case(rng, w, chunk, n_pad, Hq, Hkv, prefix=""):
    """One prefill chunk from position 0 over table row 0, 8 decode rows
    on rows 1..8, padding rows with ctx 0 on the spare row 9."""
    dec = rng.integers(1, 16 * w + 1, 8).tolist()
    ctx = list(range(1, chunk + 1)) + dec + [0] * (n_pad - chunk - 8)
    rmap = [0] * chunk + list(range(1, 9)) + [9] * (n_pad - chunk - 8)
    return (f"{prefix}mixed{chunk}+8_w{w}", ctx, rmap, 16, w, Hq, Hkv)


def kernel_phase(torch, flush):
    from repro_torch.kernels.paged_attention import (
        paged_attention_kernel, paged_attention_plain,
        paged_attention_splitk_kernel, paged_attention_splitk_plain)
    from repro_torch.models.attention import quantize_kv

    dev = torch.device("cuda")
    D, page, pps = 128, 16, 4
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
    for ci, (name, ctx_l, rmap_l, n_tab, W, Hq, Hkv) in enumerate(
            kernel_cases()):
        g = torch.Generator(device=dev).manual_seed(SEED + ci)
        B = len(ctx_l)
        n_pool = n_tab * W + 1
        q32 = torch.randn(B, Hq, D, generator=g, device=dev)
        kp32 = torch.randn(n_pool, page, Hkv, D, generator=g, device=dev)
        vp32 = torch.randn(n_pool, page, Hkv, D, generator=g, device=dev)
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
                    "rows": B, "width": W, "Hq": Hq, "Hkv": Hkv,
                    "rtol": tol[0], "atol": tol[1],
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
    whole-prompt prefill shapes of Llama-2-7B (B = 1, 32 heads, D = 128),
    Mixtral-8x7B (8 kv heads, window 4096, a 6144-token prompt) and
    Granite-3-2B (8 kv heads of 64);
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
    cases = [(f"S{S}_causal", S, 32, 128, True, 0, dt)
             for S in (128, 1024, 1000) for dt in ("bfloat16", "float32")]
    cases += [("S1024_window256", 1024, 32, 128, True, 256, "bfloat16"),
              ("S1024_gqa8", 1024, 8, 128, True, 0, "bfloat16"),
              ("S6144_window4096_gqa8", 6144, 8, 128, True, 4096,
               "bfloat16")]
    # Granite-3-2B's prefill shape: 32 query heads over 8 kv heads of 64
    cases += [("S1024_gqa8_d64", 1024, 8, 64, True, 0, dt)
              for dt in ("bfloat16", "float32")]
    for ci, (name, S, Hkv, D, causal, window, dt) in enumerate(cases):
        g = torch.Generator(device=dev).manual_seed(SEED + 100 + ci)
        dtype = getattr(torch, dt)
        q = torch.randn(1, S, 32, D, generator=g, device=dev).to(dtype)
        k = torch.randn(1, S, Hkv, D, generator=g, device=dev).to(dtype)
        v = torch.randn(1, S, Hkv, D, generator=g, device=dev).to(dtype)
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
                "D": D, "window": window, "rtol": tol[0], "atol": tol[1],
                "max_abs_err": err, "tol_ratio": ratio,
                "ms": time_ms(torch, lambda: fa.flash_attention_kernel(
                    q, k, v, causal=causal, window=window), 20, flush),
                "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
                    q, k, v, causal=causal, window=window), 3, flush),
                "library_ms": time_ms(torch, library, 10, flush)}
        line["bound_ms"], line["bound_by"] = flash_bound(
            S, 32, Hkv, D, causal, window, dt)
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


def slot_attention_phase(torch, flush):
    """The slots backend's decode attention (``models.attention.
    decode_attention``) at run D's decode shape (8 slots of 1280 tokens,
    32 heads of 128, bf16 caches): the paged kernels over a view of the
    caches as pages, held against its plain version (f32 products, the
    softmax weights rounded to bf16 as the reference rounds them) within
    that rounding's bound, 2**-7 relative + 2**-9 max|v| (the kernels keep
    the weights in f32; tests/test_torch_slot_attention.py); its extra
    peak memory must stay below one f32 copy of the two caches, which the
    plain version makes.  Library yardstick: ``scaled_dot_product_attention``
    with the validity mask."""
    from repro_torch.models.attention import (decode_attention,
                                              decode_attention_plain)

    dev = torch.device("cuda")
    B, S, H, D = 8, MAX_LEN_SLOTS, 32, 128
    g = torch.Generator(device=dev).manual_seed(SEED + 300)
    q = torch.randn(B, 1, H, D, generator=g, device=dev).bfloat16()
    k = torch.randn(B, S, H, D, generator=g, device=dev).bfloat16()
    v = torch.randn(B, S, H, D, generator=g, device=dev).bfloat16()
    pos = torch.randint(0, S, (B,), generator=g, device=dev)
    ctx = (pos + 1).clamp(max=S)
    valid = torch.arange(S, device=dev)[None] < ctx[:, None]
    f32_copy = 2 * k.numel() * 4

    def with_peak(fn):
        """fn's result and the device memory it took beyond the inputs."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    got, extra = with_peak(lambda: decode_attention(q, k, v, ctx))
    plain, plain_extra = with_peak(
        lambda: decode_attention_plain(q, k, v, valid))
    tol = (2 ** -7, 2 ** -9 * v.float().abs().max().item())
    err, ratio = tol_ratio(got, plain, tol)
    check(ratio <= 1, f"slot decode attention vs plain outside the weight-"
          f"rounding bound {tol}: max abs error {err}, ratio {ratio}")
    check(bool(torch.isfinite(got.float()).all()),
          "slot decode attention: non-finite output")
    check(extra < f32_copy, f"slot decode attention took {extra} B of "
          f"extra device memory, not below one f32 copy of the caches "
          f"({f32_copy} B)")
    F = torch.nn.functional

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=valid[:, None, None])

    n_tok = int(ctx.sum())
    line = {"phase": "slot_attention", "case": "decode8_S1280_mha",
            "shape": [B, S, H, D], "dtype": "bfloat16",
            "rtol": tol[0], "atol": tol[1], "max_abs_err": err,
            "tol_ratio": ratio, "extra_peak_bytes": extra,
            "plain_extra_peak_bytes": plain_extra,
            "f32_copy_bytes": f32_copy,
            "ms": time_ms(torch, lambda: decode_attention(q, k, v, ctx), 20,
                          flush),
            "plain_ms": time_ms(torch, lambda: decode_attention_plain(
                q, k, v, valid), 5, flush),
            "library_ms": time_ms(torch, library, 10, flush),
            "bound_ms": (n_tok * H * D * 2 * 2 + 2 * q.numel() * 2)
            / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    emit(line)


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
          reqs=None, **engine_kw):
    """One run on a fresh engine; ``expect`` maps each kernel to
    whether the run must launch it, or to an exact count: once per layer
    and whole-prompt prefill (``per_layer_prefill``) or per layer and
    slots decode step (``per_layer_decode``).  ``reqs``: the run's
    requests, else ``requests(short, long_prompts)``.  Returns the
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
    prefills, decodes = [0], [0]
    whole, slots_decode = eng._prefill_whole, eng._decode_slots

    def checked_sample(row):             # every decode row's logits
        finite.append(bool(np.isfinite(row).all()))
        return sample(row)

    def counted_prefill(req):            # every whole-prompt prefill
        prefills[0] += 1
        return whole(req)

    def counted_decode(tokens):          # every slots decode step
        decodes[0] += 1
        return slots_decode(tokens)

    eng._sample = checked_sample
    eng._prefill_whole = counted_prefill
    eng._decode_slots = counted_decode
    reqs = requests(short, long_prompts) if reqs is None else reqs
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
        if want in ("per_layer_prefill", "per_layer_decode"):
            n = prefills[0] if want == "per_layer_prefill" else decodes[0]
            check(n > 0 and got == cfg.n_layers * n,
                  f"run {run}: {name} launched {got} times, not "
                  f"{cfg.n_layers} layers x {n} ({want})")
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
            "slots_decode_steps": decodes[0],
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
    if eng.core.prefix_cache is not None:
        st = eng.core.prefix_cache.stats
        line["prefix_cache"] = {"lookups": st.lookups, "hits": st.hits,
                                "hit_tokens": st.hit_tokens,
                                "hit_rate": st.hit_rate()}
    if reduced_of(cfg):
        line["reduced"] = reduced_of(cfg)
    emit(line)
    tokens = {r.rid: spy.tokens[r.rid] for r in done}
    firsts = {r.rid: (r.prompt_tokens, r._first_row) for r in done}
    # the hooks above tie the engine into a cycle: free its pools and
    # caches now, not at some later collection inside the next run
    del eng, checked_sample, counted_prefill, counted_decode
    gc.collect()
    torch.cuda.empty_cache()
    return tokens, firsts, launches, line


def engine_phase(torch, kernel_rows):
    from repro_torch.core import make_scheduler
    from repro_torch.serving.engine import ServingEngine


    # every kernel and variant must stay unlaunched unless a run expects
    # it: runs A, B, C, H, I, J (bf16 queries over bf16 or int8 pages),
    # D, F, G (bf16 prefill; slots decode over the caches viewed as
    # pages) and E (bf16 SSD scan) go through the tensor-core ("mma")
    # variants
    paged = {name: False for name in launch_counts()}
    splitk_mma = {"paged_attention_splitk": True,
                  "paged_attention_splitk:mma": True}
    # whole-prompt prefill through flash, decode over the slot caches
    # through split-K paged attention: each once per layer and call
    slots_attn = dict(
        paged, flash_attention="per_layer_prefill",
        paged_attention_splitk="per_layer_decode",
        **{"flash_attention:mma": "per_layer_prefill",
           "paged_attention_splitk:mma": "per_layer_decode"})
    runs = {}                         # run -> its launch counts
    llama = setup(torch, "llama2-7b")
    tok_a, first_a, runs["A"], _ = serve(torch, "A", llama, 512, False,
                                         dict(paged, **splitk_mma),
                                         backend="paged")
    tok_b, _, runs["B"], _ = serve(torch, "B", llama, 512, False,
                                   dict(paged, **splitk_mma),
                                   backend="paged", kv_quant=True)
    _, _, runs["C"], _ = serve(torch, "C", llama, 64, True,
                               dict(paged, paged_attention=True,
                                    **{"paged_attention:mma": True}),
                               backend="paged")
    # reported, not asserted: int8 pages may flip a near-tie argmax
    agree = np.mean([tok_a[rid] == tok_b[rid] for rid in tok_a])
    emit({"phase": "engine", "greedy_agreement_fp_vs_int8": float(agree)})
    _, first_d, runs["D"], _ = serve(torch, "D", llama, MAX_LEN_SLOTS,
                                     False, slots_attn, backend="slots",
                                     chunked=False)
    first_token_check(first_d, first_a)
    dense_check(torch, llama[1], llama[0], first_a)
    runs["J"] = cluster_run(torch, llama, dict(paged, **splitk_mma))

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
    no_casts("D", profiled("D", llama, MAX_LEN_SLOTS, backend="slots",
                           chunked=False))
    profiled("D", llama, MAX_LEN_SLOTS, "prefill", backend="slots",
             chunked=False)
    del llama
    torch.cuda.empty_cache()

    mamba = setup(torch, "mamba2-2.7b")
    _, _, runs["E"], _ = serve(torch, "E", mamba, MAX_LEN_SLOTS, False,
                               dict(paged, ssd_scan="per_layer_prefill",
                                    **{"ssd_scan:mma": "per_layer_prefill"}),
                               backend="slots")
    decode_consistency(torch, mamba[1], mamba[0])
    profiled("E", mamba, MAX_LEN_SLOTS, backend="slots")
    profiled("E", mamba, MAX_LEN_SLOTS, "prefill", backend="slots")
    del mamba
    gc.collect()
    torch.cuda.empty_cache()

    # the MoE stacks: whole-prompt prefill through the flash kernel,
    # decode through the paged kernels over the slot caches
    deepseek = setup(torch, "deepseek-moe-16b")
    _, first_f, runs["F"], _ = serve(torch, "F", deepseek, MAX_LEN_SLOTS,
                                     False, slots_attn, backend="slots",
                                     chunked=False)
    # one prompt at a time: the plain forward's dispatch sees the same
    # rows as the served prefill, so the same assignments drop
    dense_check(torch, deepseek[1], deepseek[0], first_f)
    # prefill and decode put different row counts through the dispatch,
    # which then drops different assignments: compare on the dense path
    decode_consistency(torch, deepseek[1], dataclasses.replace(
        deepseek[0], moe_impl="dense"))
    no_casts("F", profiled("F", deepseek, MAX_LEN_SLOTS, backend="slots",
                           chunked=False))
    del deepseek
    gc.collect()
    torch.cuda.empty_cache()

    mixtral = setup(torch, "mixtral-8x7b", n_layers=MIXTRAL_LAYERS)
    window = mixtral[0].window
    _, first_g, runs["G"], _ = serve(torch, "G", mixtral, MAX_LEN_LONG,
                                     False, slots_attn, long_prompts=2,
                                     backend="slots")
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
    no_casts("G", profiled("G", mixtral, MAX_LEN_LONG, long_prompts=2,
                           backend="slots"))
    del mixtral
    gc.collect()
    torch.cuda.empty_cache()

    # StarCoder2-7B: G = 9 through the paged kernels at full width
    starcoder = setup(torch, "starcoder2-7b")
    _, first_h, runs["H"], _ = serve(torch, "H", starcoder, 512, False,
                                     dict(paged, **splitk_mma),
                                     backend="paged")
    dense_check(torch, starcoder[1], starcoder[0], first_h)
    line = profiled("H", starcoder, 512, backend="paged")
    walks = " ".join(line["port_kernels_ms_per_iteration"])
    check("paged_attention_mma_kernel<128, false, false>" in walks
          and "paged_attention_mma_kernel<128, false, true>" not in walks,
          f"run H: decode rows of a G = 9 stack must take the tensor-core "
          f"walk and never the one-row walk; kernels: {walks}")
    runs["I (cold)"], runs["I (warm)"] = prefix_cache_run(
        torch, starcoder, dict(paged, **splitk_mma))
    del starcoder
    gc.collect()
    torch.cuda.empty_cache()

    emit({"phase": "engine", "launches_by_run": runs})
    for name, row in kernel_rows.items():
        row["launches"] = sum(r[name] for r in runs.values())
        variants = {k.split(":")[1]: sum(r[k] for r in runs.values())
                    for k in runs["A"] if k.startswith(f"{name}:")}
        if variants:
            row["launches_by_variant"] = variants


def no_casts(run, line):
    """A slots decode window reads its caches in their dtype: the paged
    kernels run in it, and a decode step's extra device memory stays
    below an f32 copy of one layer's slot caches (the f32 casts that
    the plain products made, layer after layer)."""
    ours = " ".join(line["port_kernels_ms_per_iteration"])
    check("paged_attention_mma_kernel" in ours, f"run {run}: the decode "
          f"window launched no paged kernel: {ours}")
    check(line["decode_step_extra_peak_bytes"]
          < line["layer_cache_f32_copy_bytes"], f"run {run}: a decode step "
          f"took {line['decode_step_extra_peak_bytes']} B beyond its "
          f"caches, not below an f32 copy of one layer's "
          f"({line['layer_cache_f32_copy_bytes']} B)")


def prefix_cache_run(torch, model, expect):
    """Run I: multi-turn conversations sharing system prompts (the
    port's ``multiturn_sharegpt_like``: 3 clients, 2 conversations of 2-4
    turns each, a pool of 2 system prompts of 64 tokens; prompts held to
    448 tokens so they fit max_len 512, outputs cut to 32 tokens so the
    run stays short), served cold and with the prefix cache on model's
    weights.  Warm first-token logits against cold ones: asserted within
    DENSE_REL_TOL of the largest logit (a warm prompt prefills only its
    uncached suffix, in other chunks beside other rows, so its products
    may take other cuBLAS algorithms); bitwise equality and greedy-token
    agreement are reported.  Returns the two runs' launch counts."""
    from repro_torch.workloads import multiturn_sharegpt_like

    def trace():
        reqs = multiturn_sharegpt_like(
            n_clients=3, n_conversations=2, turns=(2, 5), system_pool=2,
            system_len=64, think_time=2.0, max_prompt=448, seed=SEED)
        for r in reqs:
            r.output_len = min(r.output_len, 32)
        return reqs

    out = {}
    for cache in (False, True):
        tokens, firsts, launches, line = serve(
            torch, "I", model, 512, False, expect, reqs=trace(),
            backend="paged", prefix_cache=cache)
        out[cache] = tokens, firsts, launches, line
    st = out[True][3]["prefix_cache"]
    check(st["hits"] > 0 and st["hit_tokens"] > 0,
          f"run I: no prefix-cache hits: {st}")
    worst, bitwise, argmax = 0.0, 0, 0
    (cold_tok, cold_first), (warm_tok, warm_first) = (
        out[c][:2] for c in (False, True))
    for rid, (toks, cold) in cold_first.items():
        warm = warm_first[rid][1]
        rel = float(np.abs(warm - cold).max() / np.abs(cold).max())
        worst = max(worst, rel)
        bitwise += int(np.array_equal(warm, cold))
        argmax += int(np.argmax(warm) == np.argmax(cold))
    agree = np.mean([warm_tok[rid] == cold_tok[rid] for rid in cold_tok])
    emit({"phase": "prefix_cache_check", "run": "I", "requests":
          len(cold_first), "hits": st["hits"],
          "hit_tokens": st["hit_tokens"], "hit_rate": st["hit_rate"],
          "warm_vs_cold_max_rel_err": worst, "first_rows_bitwise_equal":
          bitwise, "first_argmax_equal": argmax,
          "greedy_token_agreement": float(agree)})
    check(worst < DENSE_REL_TOL, f"run I: warm first-token logits differ "
          f"from cold ones by {worst} (relative)")
    return out[False][2], out[True][2]


def cluster_run(torch, model, expect):
    """Run J: a two-replica ``Cluster`` of paged engines on the one card,
    both over one weight set, Equinox schedulers sharing their fairness
    state (``share_fairness_state``), routing ``least_kv``, a
    ``FlightRecorder`` on each replica.  The replicas' events, merged in
    the order the cluster fired them (one more recorder that every
    replica feeds), replay to the live counters exactly
    (``replay_cluster``); the per-replica traces, merged on the modeled
    clock (``merge_traces``), feed ``windowed_fairness``.  Returns the
    run's launch counts."""
    from repro_torch.core import make_scheduler
    from repro_torch.serving.cluster import Cluster
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.telemetry import (FlightRecorder,
                                               MultiObserver, merge_traces,
                                               scheduler_counters,
                                               windowed_fairness)

    cfg, params, cm, mope = model
    recs = [FlightRecorder(sample_every=4) for _ in range(2)]
    order = FlightRecorder()
    engines = [ServingEngine(
        cfg, make_scheduler("equinox", predictor=copy.deepcopy(mope)),
        params=params, max_len=512, cost_model=cm, seed=SEED + i,
        observer=MultiObserver(recs[i], order), device="cuda",
        backend="paged") for i in range(2)]
    cluster = Cluster(engines, policy="least_kv")
    reqs = requests(False)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = cluster.run(reqs, max_time=1e9)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    summary = res.summary()
    check(summary["finished"] == len(reqs), f"run J: {summary['finished']}"
          f"/{len(reqs)} finished")
    check(all(n > 0 for n in summary["per_replica"]),
          f"run J: a replica served nothing: {summary['per_replica']}")
    check(engines[0].sched.ufc is engines[1].sched.ufc,
          "run J: the replicas do not share their fairness state")
    for name, want in expect.items():
        check(launches[name] > 0 if want else launches[name] == 0,
              f"run J: {name} launched {launches[name]} times")
    live = scheduler_counters(engines[0].sched)
    replayed = replay_cluster(order.trace(), [r.trace()["meta"]
                                              for r in recs],
                              cluster.routed_to)
    check(replayed == live, "run J: the replay of the merged trace "
          "differs from the live counters")
    wf = windowed_fairness(merge_traces([r.trace() for r in recs]))
    jains = wf["rolling_jain"]
    emit({"phase": "cluster", "run": "J", "model": cfg.name, "replicas": 2,
          "policy": "least_kv", "requests": len(reqs),
          "finished_per_replica": summary["per_replica"],
          "routed_per_replica": [sum(1 for i in res.routed_to.values()
                                     if i == k) for k in range(2)],
          "replay_equals_live": True, "counters": sorted(live),
          "events": len(order.trace()["events"]),
          "windowed_jain_min": wf["min_jain"],
          "windowed_jain_median": float(np.median(jains)) if jains
          else None, "windows": wf["n_windows"],
          "max_discrepancy": wf["max_discrepancy"],
          "jain": summary["jain"], "p50_ttft_model_s": summary["p50_ttft"],
          "wall_s": wall, "launches": launches,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    del engines, cluster, res
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def replay_cluster(trace, metas, routed_to):
    """``replay_counters`` for replicas that share their fairness state:
    one scheduler per replica rebuilt from its trace's metadata (each keeps
    its own queues and, for Equinox, its own latency average, as live),
    the shared tables re-bound as the live cluster binds them, and every
    event of ``trace`` (the cluster's firing order) driven into the
    scheduler of the replica its request was routed to, as
    ``replay_counters`` drives one.  The reference defines replay for one
    replica; with shared tables the replicas' interleaving is part of the
    result, so the timestamp merge of ``merge_traces`` cannot replay."""
    from repro_torch.core.request import Request
    from repro_torch.serving import telemetry
    from repro_torch.serving.cluster import share_fairness_state

    scheds = [telemetry._scheduler_from_meta(m) for m in metas]
    share_fairness_state(scheds)
    stubs = {}
    for ev in trace["events"]:
        et, t = ev["type"], ev["t"]
        if et == "iteration":
            for rid in ev.get("produced", ()):
                stubs[rid].generated += 1
                scheds[routed_to[rid]].on_token(stubs[rid], t, 1)
            continue
        if et not in ("arrival", "admit", "preempt", "requeue", "complete"):
            continue
        sched = scheds[routed_to[ev["rid"]]]
        if et == "arrival":
            r = Request(rid=ev["rid"], client=ev["client"],
                        arrival=ev["arrival"], prompt_len=ev["prompt_len"],
                        output_len=0, weight=ev["weight"],
                        user=ev.get("user"), app=ev.get("app"),
                        interaction_id=ev.get("interaction_id"),
                        turn_index=ev.get("turn_index", 0))
            stubs[r.rid] = r
            sched.on_arrival(r, t)
            continue
        r = stubs[ev["rid"]]
        if et == "admit":
            try:
                sched.queues[r.account].remove(r)
            except ValueError:
                pass                      # as replay_counters: never twice
            r.cached_prefix = ev["cached_prefix"]
            r.pred_output_len = ev["pred_output_len"]
            r.pred_latency = ev["pred_latency"]
            r.pred_tps = ev["pred_tps"]
            r.pred_util = ev["pred_util"]
            sched.on_admit(r, t)
        elif et == "preempt":
            sched.on_preempt(r, t)
            r.generated = 0
            r.cached_prefix = 0
            sched.requeue_head(r)
        elif et == "requeue":
            sched.on_requeue(r, t)
        else:
            r.generated = ev["generated"]
            r.output_len = ev["output_len"]
            r.cached_prefix = ev["cached_prefix"]
            sched.on_complete(r, t, latency=ev["latency"], tps=ev["tps"],
                              util=ev["util"])
    return telemetry.scheduler_counters(scheds[0])


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
    if window == "decode" and eng.backend == "slots":
        # one more decode step over every slot, alone: the device memory
        # it takes beyond what is allocated (an f32 copy of a layer's
        # slot caches, had the attention made one)
        f32_copy = max((sum(t[0].numel() * 4 for name, t in st.items()
                            if name in ("k", "v"))
                        for st in eng.cache["stages"].values()), default=0)
        if f32_copy:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            eng._decode_slots(np.zeros(eng.max_slots, np.int64))
            torch.cuda.synchronize()
            line["decode_step_extra_peak_bytes"] = \
                torch.cuda.max_memory_allocated() - base
            line["layer_cache_f32_copy_bytes"] = f32_copy
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
