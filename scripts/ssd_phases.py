#!/usr/bin/env python3
"""Where a block of the tensor-core SSD scan spends its time, on one card.

    python3 scripts/ssd_phases.py

Builds a copy of ``src/repro_torch/csrc/ssd_scan.cu`` whose ``mma`` kernel
stamps the SM clock at the ends of its phases (ticket; copies issued;
copies landed and la_cum; intra-chunk term; U; wait for the previous
chunk; hand-off until published; S_{c-1} staged; inter-chunk term and y),
and runs it through the port's wrapper at Mamba-2-2.7B's shape (H = 80,
P = 64, N = 128, chunk 128, bf16) for S = 128, 1024 and 4096.  Prints one
JSON line per S: the median cycles of each phase over the launch's blocks,
the blocks' median time, the launch's span, blocks per SM, and the median
wait and start time per chunk index.  The stamps cost a few percent; the
kernel the port runs carries none.  Needs one CUDA card and nvcc; the
copy is built under ``build/ssd_phases/``.
"""
from __future__ import annotations

import ctypes
import importlib
import json
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
PHASES = ("ticket", "copies_issued", "loaded", "intra", "U", "wait",
          "handoff", "staged", "inter_and_y")
# (anchor in the source, stamp inserted after it; slot k holds the clock at
# the end of PHASES[k - 2], slots 0 and 1 the start and length in ns)
STAMPS = [
    ("  if (threadIdx.x == 0) item_s = atomicAdd(ch.ticket, 1u) - ch.ticket_base;\n"
     "  __syncthreads();\n", 2),
    ("  attn_tile::cp_async_commit();\n", 3),
    ("  attn_tile::cp_async_wait<0>();\n  __syncthreads();\n", 4),
    ("    }\n  }\n\n  // (d) U = (x o w)^T B", 5),
    ("  // (e) the hand-off\n", 6),
    ("  __syncthreads();                         // the flag is seen; B_s is free\n", 7),
    ("    st_release(ch.flags + bh, ch.seq_base + c + 1);\n  }\n", 8),
    ("  __syncthreads();\n\n  // (f) y += exp(la_cum)", 9),
]
MAX_BLOCKS = 1 << 14


def instrumented(src: str) -> str:
    """The source with the stamps; every anchor must occur once."""
    def once(s, anchor):
        if s.count(anchor) != 1:
            raise RuntimeError(f"ssd_phases: anchor not found once: {anchor!r}")
        return s.index(anchor) + len(anchor)

    kernel = "template <int STEP>\n__global__ void __launch_bounds__(kThreads, 2)\nssd_scan_mma_kernel("
    at = once(src, kernel) - len(kernel)
    src = src[:at] + (
        f"__device__ long long g_stamps[{MAX_BLOCKS}][12];\n"
        "__device__ __forceinline__ long long ns_now() {\n"
        "  long long t;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
        "  return t;\n}\n") + src[at:]
    first = STAMPS[0][0]
    at = once(src, first) - len(first)
    src = src[:at] + "  const long long T0 = clock64(), G0 = ns_now();\n" + src[at:]
    for anchor, slot in STAMPS:
        if anchor.startswith("    }\n  }\n\n  // (d)") or anchor.startswith(
                "  __syncthreads();\n\n  // (f)"):
            # stamp before the comment that opens the next phase
            head = anchor[:anchor.index("  //")]
            at = once(src, anchor) - (len(anchor) - len(head))
        else:
            at = once(src, anchor)
        src = src[:at] + (f"  if (threadIdx.x == 0) g_stamps[item_s % {MAX_BLOCKS}]"
                          f"[{slot}] = clock64() - T0;\n") + src[at:]
    end = src.index("int configure() {")
    at = src.rindex("}\n", 0, end)          # the kernel's closing brace
    src = src[:at] + (
        "  __syncthreads();\n  if (threadIdx.x == 0) {\n"
        f"    long long* g = g_stamps[item_s % {MAX_BLOCKS}];\n"
        "    g[10] = clock64() - T0;\n    g[0] = G0;\n    g[1] = ns_now() - G0;\n"
        "    g[11] = c;\n  }\n") + src[at:]
    return src.replace('}  // extern "C"', (
        "int ssd_phase_stamps(long long* out, int n) {\n"
        "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
        "      out, ssd_mma::g_stamps, static_cast<size_t>(n) * 12 * sizeof(long long)));\n"
        "}\n\n"
        '}  // extern "C"'))


def build(_build) -> ctypes.CDLL:
    out = ROOT / "build" / "ssd_phases"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "ssd_scan_stamped.cu"
    cu.write_text(instrumented((_build.CSRC / "ssd_scan.cu").read_text()))
    lib_path = out / "libssd_scan_stamped.so"
    p = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                        str(_build.CSRC), "-o", str(lib_path), str(cu)],
                       capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{p.stdout}{p.stderr}")
    return ctypes.CDLL(str(lib_path))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_phases: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")

    lib = build(_build)
    port = ss._lib()
    for fn in ("ssd_scan_fwd", "ssd_scan_mma_fwd", "ssd_scan_mma_attrs"):
        getattr(lib, fn).argtypes = getattr(port, fn).argtypes
        getattr(lib, fn).restype = getattr(port, fn).restype
    lib.ssd_phase_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    ss._lib = lambda: lib                    # the wrapper launches the copy
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    H, P, N, chunk = 80, 64, 128, 128
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for S in (128, 1024, 4096):
        # chip_smoke.py's inputs: decays as the model makes them
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(1, S, H, P, generator=g, device=dev).bfloat16()
        step = torch.exp(torch.rand(1, S, H, generator=g, device=dev)
                         * np.log(100.0) + np.log(1e-3))
        la = -step * torch.arange(1, H + 1, device=dev)
        Bm, Cm = ((0.3 * torch.randn(1, S, 1, N, generator=g, device=dev))
                  .bfloat16() for _ in range(2))
        for _ in range(3):
            ss.ssd_scan_kernel(x, la, Bm, Cm, chunk=chunk)
        flush.zero_()
        torch.cuda.synchronize()
        ss.ssd_scan_kernel(x, la, Bm, Cm, chunk=chunk)
        torch.cuda.synchronize()
        n = ss.grid_blocks(x, chunk)
        t = np.zeros((n, 12), dtype=np.int64)
        if lib.ssd_phase_stamps(t.ctypes.data, n) != 0:
            raise RuntimeError("ssd_phases: reading the stamps failed")
        ends = t[:, 2:11]
        spans = np.diff(np.concatenate([np.zeros((n, 1), np.int64), ends], 1))
        start = t[:, 0] - t[:, 0].min()
        chunks = t[:, 11]
        print(json.dumps({
            "S": S, "blocks": n, "attrs": ss.mma_attrs(),
            "launch_span_us": float((start + t[:, 1]).max() / 1e3),
            "block_us_median": float(np.median(t[:, 1]) / 1e3),
            "block_cycles_median": int(np.median(t[:, 10])),
            "phase_cycles_median": {k: int(np.median(spans[:, i]))
                                    for i, k in enumerate(PHASES)},
            "wait_cycles_median_by_chunk": [
                int(np.median(spans[chunks == c, PHASES.index("wait")]))
                for c in range(int(chunks.max()) + 1)],
            "start_us_median_by_chunk": [
                round(float(np.median(start[chunks == c]) / 1e3), 2)
                for c in range(int(chunks.max()) + 1)]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
