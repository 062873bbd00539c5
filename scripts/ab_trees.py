#!/usr/bin/env python3
"""Interleaved comparison of two trees of the PyTorch port on one card.

    python3 scripts/ab_trees.py --base DIR [--pairs 3] [--runs A,C,D,E]

DIR holds another tree of the repository, unpacked (``git archive
<commit> | tar -x -C DIR``, inside a directory that .gitignore lists);
the change is the tree this script lies in.  One process per (tree,
repetition) runs, in the order base, change, change, base, base,
change, ..., so that drift of the shared host's clock falls on both
trees alike.  Each process imports ``repro_torch`` from its tree (the
helpers of this tree's ``chip_smoke.py`` drive it), builds that tree's
kernels and measures:

- kernel ms as ``chip_smoke.py`` times them (median of CUDA-event times,
  each call after an L2 flush; where the wrapper's host work outlasts
  the flush, it counts too): flash S1024 causal, split-K
  mixed512+8_w32 and decode8_w32 (run A's launches), serial
  mixed48+8_w4 (run C's), the SSD scan at S1024 (Mamba-2-2.7B's heads,
  run E's launches) and its backward at run U's shape (B 4, S 2048, 80
  heads, chunk 128: chip_smoke's ``U_B4_S2048`` inputs, fed the
  forward's chunk states), bf16; for the SSD kernels also their device
  ms from the profiler, the backward's by kernel;
- each wrapper's host µs per call: 50 calls enqueued behind a device
  sleep that outlasts them, so that no call waits for the card;
- the runs of ``chip_smoke.py`` named by ``--runs`` (A, C, D: full-width
  Llama-2-7B; E: full-width Mamba-2-2.7B; random weights from seed 0) on
  fresh engines: iterations, iteration and model-step times on the host
  clock, tokens per second, memory;
- run A's decode profile window and run E's prefill window (its first
  iteration, whole prompts): host ms, device ms, kernel launches and the
  SSD scan's device ms per iteration.

Each process's output goes to ``chiprun_out/ab/``; its result is one
JSON line.  The last line holds the medians over repetitions per tree.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import copy
import importlib
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
OUT = ROOT / "chiprun_out" / "ab"
SLEEP_CYCLES = 100_000_000         # ~50 ms at the H100's 1.98 GHz boost clock
HOST_CALLS = 50
# run A's launches (a 512-row chunk beside decode rows; decode rows alone)
# and run C's
PAGED_CASES = {"mixed512+8_w32": "splitk", "decode8_w32": "splitk",
               "mixed48+8_w4": "serial"}


def host_us(torch, fn):
    """Host µs per call of ``fn``, none of them waiting for the card."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / HOST_CALLS * 1e6


def kernel_calls(torch, cs):
    """{case: call} at the shapes of chip_smoke's kernel lines."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    pa = importlib.import_module("repro_torch.kernels.paged_attention")
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(
            torch.bfloat16)

    q, k, v = (randn(1, 1024, 32, 128) for _ in range(3))
    calls = {"flash_S1024_causal": lambda: fa.flash_attention_kernel(
        q, k, v, causal=True)}
    # the SSD scan at chip_smoke's S1024 inputs (80 heads, P 64, N 128)
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    x = randn(1, 1024, 80, 64)
    step = torch.exp(torch.rand(1, 1024, 80, generator=g, device="cuda")
                     * math.log(100.0) + math.log(1e-3))
    la = -step * torch.arange(1, 81, device="cuda")
    Bm, Cm = (0.3 * randn(1, 1024, 1, 128) for _ in range(2))
    calls["ssd_S1024_bf16"] = lambda: ss.ssd_scan_kernel(x, la, Bm, Cm,
                                                         chunk=128)
    # the SSD backward at run U's shape, on chip_smoke's inputs
    ux, ula, uB, uC, udy, _, _ = cs.ssd_bwd_inputs(torch, 0)
    _, _, ucs = ss.ssd_scan_kernel(ux, ula, uB, uC, chunk=128,
                                   return_chunk_states=True)
    calls["ssd_bwd_U_B4_S2048_bf16"] = lambda: ss.ssd_scan_bwd_kernel(
        ux, ula, uB, uC, udy, None, chunk=128, chunk_states=ucs)
    for name, ctx_l, rmap_l, n_tab, W, *_ in cs.kernel_cases():
        if name not in PAGED_CASES:
            continue
        n_pool = n_tab * W + 1
        pq, kp, vp = randn(len(ctx_l), 32, 128), randn(
            n_pool, 16, 32, 128), randn(n_pool, 16, 32, 128)
        tables = torch.randperm(n_pool, generator=torch.Generator()
                                .manual_seed(cs.SEED))[:n_tab * W]
        tables = tables.reshape(n_tab, W).to(torch.int32).cuda()
        ctx = torch.tensor(ctx_l, dtype=torch.int32, device="cuda")
        rmap = torch.tensor(rmap_l, dtype=torch.int32, device="cuda")
        args = (pq, kp, vp, tables, ctx)
        if PAGED_CASES[name] == "splitk":
            calls[f"splitk_{name}"] = (
                lambda a=args, r=rmap: pa.paged_attention_splitk_kernel(
                    *a, pages_per_split=4, row_map=r))
        else:
            calls[f"serial_{name}"] = (
                lambda a=args, r=rmap: pa.paged_attention_kernel(
                    *a, row_map=r))
    return calls


def one(tree: pathlib.Path, tag: str, runs) -> dict:
    """Every measurement of one process, on the tree at ``tree``."""
    import torch
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import make_scheduler
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    res = {"tree": tag, "build_s": time.perf_counter() - t0, "kernels": {}}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for name, fn in kernel_calls(torch, cs).items():
        res["kernels"][name] = {"ms": cs.time_ms(torch, fn, 20, flush),
                                "host_us": host_us(torch, fn)}
        if name.startswith("ssd"):
            by = cs.device_ms_by_kernel(torch, fn, flush,
                                        names=("ssd_scan", "ssd_bwd"))
            res["kernels"][name]["device_ms"] = sum(by.values())
            if name.startswith("ssd_bwd"):
                res["kernels"][name]["device_ms_by_kernel"] = {
                    k.replace("(anonymous namespace)::", "").split("(")[0]
                    [:48]: v for k, v in by.items()}
    del flush
    keys = ("iterations", "wall_s", "iter_ms_median", "iter_ms_p90",
            "model_step_ms_median", "prefill_step_ms_median",
            "prefill_step_ms_max", "prefill_tok_per_s_wall",
            "output_tok_per_s_wall", "start_mem_gib", "peak_mem_gib")
    window_keys = ("wall_ms_per_iteration", "device_ms_per_iteration",
                   "kernel_launches_per_iteration")

    def engine(model, max_len, **kw):
        cfg, params, cm, mope = model
        return ServingEngine(
            cfg, make_scheduler("equinox", predictor=copy.deepcopy(mope)),
            params=params, max_len=max_len, cost_model=cm, seed=cs.SEED,
            device="cuda", **kw)

    llama_runs = {"A": (512, False, dict(backend="paged")),
                  "C": (64, True, dict(backend="paged")),
                  "D": (cs.MAX_LEN_SLOTS, False, dict(backend="slots",
                                                        chunked=False))}
    if any(r in runs for r in llama_runs):
        llama = cs.setup(torch, "llama2-7b")
        for run, (max_len, short, kw) in llama_runs.items():
            if run in runs:
                *_, line = cs.serve(torch, run, llama, max_len, short, {},
                                    **kw)
                res[run] = {k: line[k] for k in keys}
        if "A" in runs:
            line = cs.profile_window(torch, "A", engine(
                llama, 512, backend="paged"), cs.requests(False))
            res["A_decode_window"] = {k: line[k] for k in window_keys}
        del llama
        torch.cuda.empty_cache()
    if "E" in runs:
        mamba = cs.setup(torch, "mamba2-2.7b")
        *_, line = cs.serve(torch, "E", mamba, cs.MAX_LEN_SLOTS, False, {},
                            backend="slots")
        res["E"] = {k: line[k] for k in keys}
        line = cs.profile_window(torch, "E", engine(
            mamba, cs.MAX_LEN_SLOTS, backend="slots"), cs.requests(False),
            "prefill")
        res["E_prefill_window"] = {k: line[k] for k in window_keys}
        res["E_prefill_window"]["ssd_ms_per_iteration"] = sum(
            v for k, v in line["port_kernels_ms_per_iteration"].items()
            if "ssd_scan" in k)
        res["E_prefill_window"]["model_step_ms_profiled"] = \
            line["model_step_ms_profiled"][0]
    return res


def summary(results):
    """Medians over repetitions, per tree, of every number."""
    def walk(dicts):
        if isinstance(dicts[0], dict):
            return {k: walk([d[k] for d in dicts]) for k in dicts[0]}
        return statistics.median(dicts)

    out = {}
    for tag in ("base", "change"):
        mine = [{k: v for k, v in r.items() if k != "tree"}
                for r in results if r["tree"] == tag]
        out[tag] = walk(mine)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", type=pathlib.Path)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--runs", default="A,C,D,E",
                    help="engine runs to measure, of A, C, D, E")
    ap.add_argument("--one", type=pathlib.Path, help=argparse.SUPPRESS)
    ap.add_argument("--tag", help=argparse.SUPPRESS)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ab_trees: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    runs = set(a.runs.split(",")) - {""}
    if not runs <= {"A", "C", "D", "E"}:
        print(f"ab_trees: unknown runs {sorted(runs)}", file=sys.stderr)
        return 2
    if a.one is not None:
        print(json.dumps(one(a.one.resolve(), a.tag, runs)), flush=True)
        return 0
    if a.base is None or not (a.base / "src" / "repro_torch").is_dir():
        print("ab_trees: --base must name an unpacked tree of the repo",
              file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    trees = {"base": a.base.resolve(), "change": ROOT}
    results = []
    for i in range(a.pairs):
        for tag in ("base", "change") if i % 2 == 0 else ("change", "base"):
            p = subprocess.run([sys.executable, __file__, "--one",
                                str(trees[tag]), "--tag", tag,
                                "--runs", a.runs],
                               capture_output=True, text=True)
            log = OUT / f"{len(results):02d}_{tag}.log"
            log.write_text(p.stdout + p.stderr)
            if p.returncode != 0:
                print(f"ab_trees: the {tag} process failed (exit "
                      f"{p.returncode}); see {log}", file=sys.stderr)
                print(p.stderr[-3000:], file=sys.stderr)
                return 1
            res = json.loads(p.stdout.strip().splitlines()[-1])
            results.append(res)
            print(json.dumps(res), flush=True)
    print(json.dumps({"medians": summary(results)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
