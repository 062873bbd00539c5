#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

The quickest proof that the port builds and serves on an NVIDIA H100:

1. device and build: the card's name and power limit (nvidia-smi), and
   the CUDA kernels built from ``src/repro_torch/csrc`` with nvcc;
2. kernels against their plain PyTorch versions on the card, serial and
   split-K, bf16 and int8 pools, at the serving path's shapes (Hq = Hkv
   = 32, D = 128, page 16): decode batches of 8 and 64 rows at table
   widths 32 and 256, and ragged mixed launches (a prefill chunk over
   one table row, 8 decode rows, padding rows with ctx 0).  Each case
   runs once more with f32 queries and f32 pools at a tight tolerance.
   Each case prints one JSON line with errors, the ctx-0 and bitwise-m
   checks, the int8 quantization noise, and times (kernel, plain
   version, a library yardstick, the bound);
3. the engine at full width: Llama-2-7B as registered (32 layers,
   d_model 4096, bf16; random weights from a seed), the Equinox
   scheduler with a MoPE predictor trained by the port, a dozen
   requests from three clients, served three times:
     A  fp pools, max_len 512 (table width >= 32: the split-K kernel),
     B  A with int8 KV pages,
     C  fp pools, max_len 64, prompt + output < 64 (the serial kernel);
   plus a check of served first-token logits against a dense forward,
   and a ``torch.profiler`` window of run A's configuration (device
   busy share, kernel launches and device time by kernel per iteration);
4. a ``kernels`` JSON line, the nvidia-smi line, and last the result line
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero; no phase catches an error and goes on.
Without a CUDA device it exits 2 before printing any result.  TF32 is
switched off for matmuls and cuDNN, so f32 products are full f32.

    python3 chip_smoke.py
"""
from __future__ import annotations

import copy
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
# kernel vs plain version on the same inputs, elementwise
# |kernel - plain| <= atol + rtol * |plain|.  Both compute in f32 and
# round once to the output type, so bf16 outputs may differ by one bf16
# step (at most 2**-7 of the value); f32 outputs by summation order only.
BF16_TOL = (2 ** -7, 1e-5)         # (rtol, atol): bf16 q, bf16 or int8 pools
F32_TOL = (1e-5, 1e-5)             # f32 q, f32 pools
# int8 pools vs the bf16 pools they were quantized from: the noise bound
# of tests/test_paged_kernels.py (0.15 x std of the fp output), held by
# the RMS of the difference; its max is reported (it grows with the
# number of elements, while the std does not)
INT8_NOISE_REL_STD = 0.15
DENSE_REL_TOL = 5e-2               # served vs dense-forward first-token logits


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
    regs = sorted({line.split("Used")[1].split(",")[0].strip()
                   for line in _build.build_log("paged_attention").splitlines()
                   if "Used" in line and "registers" in line})
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": built, "ptxas_registers": regs})

    kernel_rows = kernel_phase(torch)
    engine_phase(torch, kernel_rows)

    print(smi, flush=True)
    emit({"kernels": list(kernel_rows.values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


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


def kernel_phase(torch):
    from repro_torch.kernels.paged_attention import (
        paged_attention_kernel, paged_attention_plain,
        paged_attention_splitk_kernel, paged_attention_splitk_plain)
    from repro_torch.models.attention import quantize_kv

    dev = torch.device("cuda")
    H, D, page, pps = 32, 128, 16, 4
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
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
                    row.update(ms=line[ms], plain_ms=line[plain],
                               bound_ms=line["bound_ms"],
                               bound_by=line["bound_by"],
                               library_ms=line["library_ms"],
                               shape=f"{name}/{pools}")
    return rows


# ---------------------------------------------------------------------------
# 3. the engine at full width
# ---------------------------------------------------------------------------
def engine_phase(torch, kernel_rows):
    from repro_torch.configs import get_config
    from repro_torch.core import Request, jain, make_scheduler
    from repro_torch.kernels.paged_attention import (LAUNCHES,
                                                     reset_launch_counts)
    from repro_torch.predictor import MoPE
    from repro_torch.serving.costmodel import H100_SXM, CostModel
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.telemetry import Observer
    from repro_torch.weights import init_params
    from repro_torch.workloads import corpus
    from repro_torch.workloads.traces import sample_prompt

    class TokenSpy(Observer):
        """Every produced token, per request, in production order, and
        the host clock at the end of every iteration."""

        def __init__(self):
            self.tokens = defaultdict(list)
            self.stamps = []

        def on_iteration(self, now, *, t_iter, util, fresh, running,
                         produced, first):
            self.stamps.append(time.perf_counter())
            for r in produced:
                self.tokens[r.rid].append(int(r._next_token))

    cfg = get_config("llama2-7b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                         "cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    cm = CostModel(cfg, H100_SXM)
    t0 = time.perf_counter()
    mope = MoPE(cm, corpus(4000, seed=SEED), epochs=20, seed=SEED)
    emit({"phase": "engine_setup", "model": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype,
          "weight_gib": n_bytes / 2 ** 30, "init_s": t_init,
          "mope_train_s": time.perf_counter() - t0})

    def requests(short):
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
        return out

    def serve(run, max_len, kv_quant, short, expect):
        spy = TokenSpy()
        sched = make_scheduler("equinox", predictor=copy.deepcopy(mope))
        eng = ServingEngine(cfg, sched, params=params, max_len=max_len,
                            kv_quant=kv_quant, cost_model=cm, seed=SEED,
                            observer=spy, keep_first_logits=True,
                            device="cuda")
        finite = []
        sample = eng._sample

        def checked_sample(row):             # every decode row's logits
            finite.append(bool(np.isfinite(row).all()))
            return sample(row)

        eng._sample = checked_sample
        reqs = requests(short)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
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
            check(got > 0 if want else got == 0,
                  f"run {run}: {name} launched {got} times")
        # whole iterations on the host clock (admission, planning, the
        # model step, sampling, bookkeeping); the step span of iter_log
        # is the model step and its copy back alone
        it = np.diff([t0] + spy.stamps)
        step = np.array([s for s, _, _ in eng.iter_log])
        prompt_tokens = sum(r.prompt_len for r in done)
        output_tokens = sum(r.generated for r in done)
        ttft = np.array([r.ttft() for r in done])
        emit({"phase": "engine", "run": run, "max_len": max_len,
              "kv_quant": kv_quant, "requests": len(done),
              "prompt_tokens": prompt_tokens, "output_tokens": output_tokens,
              "iterations": eng.iterations, "wall_s": wall,
              "iter_ms_mean": wall / eng.iterations * 1e3,
              "iter_ms_median": float(np.median(it) * 1e3),
              "iter_ms_p90": float(np.percentile(it, 90) * 1e3),
              "prefill_tok_per_s_wall": prompt_tokens / wall,
              "output_tok_per_s_wall": output_tokens / wall,
              "model_step_ms_median": float(np.median(step) * 1e3),
              "model_step_ms_p90": float(np.percentile(step, 90) * 1e3),
              "ttft_model_s_p50": float(np.percentile(ttft, 50)),
              "ttft_model_s_p90": float(np.percentile(ttft, 90)),
              "service": {k: round(v, 1) for k, v in sched.service.items()},
              "jain": jain(list(sched.service.values())),
              "preemptions": eng.n_preemptions, "launches": launches,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
        tokens = {r.rid: spy.tokens[r.rid] for r in done}
        firsts = {r.rid: (r.prompt_tokens, r._first_row) for r in done}
        del eng
        torch.cuda.empty_cache()
        return tokens, firsts, launches

    tok_a, first_a, la = serve("A", 512, False, False,
                               {"paged_attention_splitk": True,
                                "paged_attention": False})
    tok_b, _, lb = serve("B", 512, True, False,
                         {"paged_attention_splitk": True,
                          "paged_attention": False})
    _, _, lc = serve("C", 64, False, True,
                     {"paged_attention": True,
                      "paged_attention_splitk": False})
    # reported, not asserted: int8 pages may flip a near-tie argmax
    agree = np.mean([tok_a[rid] == tok_b[rid] for rid in tok_a])
    emit({"phase": "engine", "greedy_agreement_fp_vs_int8": float(agree)})
    dense_check(torch, params, cfg, first_a)
    profile_window(torch, ServingEngine(
        cfg, make_scheduler("equinox", predictor=copy.deepcopy(mope)),
        params=params, max_len=512, cost_model=cm, seed=SEED,
        device="cuda"), requests(False))
    for name in kernel_rows:
        kernel_rows[name]["launches"] = la[name] + lb[name] + lc[name]


def profile_window(torch, eng, reqs, warm=14, steps=10):
    """Where an iteration's time goes (config of run A): all requests
    arrive at once, ``warm`` iterations run the prompts in, then
    ``steps`` iterations are timed on the host clock and ``steps`` more
    under ``torch.profiler`` for device time by kernel.  Device busy
    share = device time per iteration / wall time per iteration."""
    from torch.profiler import ProfilerActivity, profile

    for r in reqs:
        r.arrival = 0.0
        eng.submit(r)
    for _ in range(warm):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = 0
    for _ in range(steps):
        rows += len(eng.running)
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    device_ms = sum(dev_us(e) for e in events) / 1e3 / steps
    top = sorted(events, key=dev_us, reverse=True)[:8]
    emit({"phase": "profile", "iterations": steps,
          "rows_per_iteration": rows / steps,
          "wall_ms_per_iteration": wall_ms,
          "device_ms_per_iteration": device_ms,
          "device_busy_share": device_ms / wall_ms,
          "kernel_launches_per_iteration":
              sum(e.count for e in events) / steps,
          "top_device_kernels": [
              {"name": e.key[:80], "ms_per_iteration": dev_us(e) / 1e3 / steps,
               "calls_per_iteration": e.count / steps} for e in top]})


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def dense_check(torch, params, cfg, firsts, n=3):
    """The served first-token logits of ``n`` requests against a plain
    dense causal forward of the same weights (no pools, no kernels)."""
    from repro_torch.models.layers import apply_rope, embed, mlp, rmsnorm, unembed

    st = params["stages"]["stage_0"]
    H, hd = cfg.n_heads, cfg.resolved_head_dim()
    worst = 0.0
    with torch.no_grad():
        for rid in sorted(firsts)[:n]:
            toks, served = firsts[rid]
            S = len(toks)
            x = embed(params["embed"], torch.as_tensor(toks, device="cuda"))
            pos = torch.arange(S, device="cuda")
            causal = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
            for i in range(cfg.n_layers):
                h = rmsnorm({"scale": st["ln1"]["scale"][i]}, x, cfg.norm_eps)
                q, k, v = (h @ st["attn"][w][i].reshape(cfg.d_model, -1)
                           for w in ("wq", "wk", "wv"))
                q = apply_rope(q.reshape(S, H, hd), pos, cfg.rope_theta)
                k = apply_rope(k.reshape(S, H, hd), pos, cfg.rope_theta)
                s = torch.einsum("shd,thd->hst", q.float(), k.float()) \
                    * hd ** -0.5
                p = torch.softmax(s.masked_fill(~causal, -1e30), -1)
                o = torch.einsum("hst,thd->shd", p,
                                 v.reshape(S, H, hd).float()).to(x.dtype)
                x = x + o.reshape(S, -1) @ st["attn"]["wo"][i].reshape(
                    H * hd, -1)
                h2 = rmsnorm({"scale": st["ln2"]["scale"][i]}, x, cfg.norm_eps)
                x = x + mlp({w: t[i] for w, t in st["ffn"].items()}, h2,
                            cfg.act)
            ref = unembed(params["embed"], rmsnorm(
                params["final_norm"], x[-1:], cfg.norm_eps)).float()[0]
            ref = ref.cpu().numpy()
            rel = float(np.abs(served - ref).max() / np.abs(ref).max())
            worst = max(worst, rel)
            emit({"phase": "dense_check", "rid": rid, "prompt_len": S,
                  "max_rel_err": rel,
                  "argmax_equal": int(np.argmax(served)) == int(np.argmax(ref))})
    check(worst < DENSE_REL_TOL, f"served first-token logits differ from "
          f"the dense forward by {worst} (relative)")


if __name__ == "__main__":
    sys.exit(main())
