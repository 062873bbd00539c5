#!/usr/bin/env python3
"""Chosen phases of ``chip_smoke.py`` alone, on one card: a shorter call
while a new phase is brought up.

    python3 scripts/chip_phases.py bwd,ops,P,Q,R,S,T,O
    python3 scripts/chip_phases.py ssd_bwd,U,examples
    python3 scripts/chip_phases.py P,V,ring,dryrun
    python3 scripts/chip_phases.py P,W,X
    python3 scripts/chip_phases.py ring,Y
    python3 scripts/chip_phases.py Z
    python3 scripts/chip_phases.py Z3,Z5
    python3 scripts/chip_phases.py Z7,Z8

``bwd``: the flash backward kernel lines (``flash_bwd_phase``);
``ssd_bwd``: the SSD scan's backward kernel lines (``ssd_bwd_phase``);
``ops``:
``kernels.ops.paged_attention_splitk``'s line (``ops_splitk_phase``);
``P``: Granite-3-2B training (``train_run``); ``Q``-``T``: training
DeepSeek-MoE-16B (7 layers), MiniCPM3-4B, Whisper large-v3,
RecurrentGemma-2B and Mamba-2-2.7B (``U``; ``stack_train_run``); ``O``:
InternVL2-76B through the slots engine (``internvl_run``, without its
profile window); ``examples``: the port's engine examples
(``examples_phase``); ``V``: run P through ``train(mesh=...)``
(``mesh_train_run``, held to P's losses: needs ``P``); ``W``: run P
over a (1, 2) mesh of two rank processes on the card (``mesh_rank_run``:
needs ``P``); ``X``: DeepSeek-MoE-16B (4 layers) with fsdp over a (2, 1)
mesh of two rank processes, held to one process; ``Y``: RecurrentGemma-2B
(6 layers) over a (1, 2) mesh, its RG-LRU branch channel-parallel, held
to one process; ``Z``: serving over a (1, 2) mesh of two rank processes
(``serve_mesh_run``: Llama-2-7B, Mixtral-8x7B at 4 layers, Llama-2-7B
at 8 layers with int8 slot caches, MiniCPM3-4B, Mamba-2-2.7B,
RecurrentGemma-2B, Whisper large-v3's encoder-decoder over 1500 frames,
InternVL2-76B at 8 layers behind 256 patches), held to one process;
``Z1``-``Z8``: those runs of Z alone, in the order given; ``ring``: ring
attention forward and backward
(``ring_phase``); ``dryrun``: the dry-run CLI and the
``--production`` refusal (``dryrun_phase``).  Builds the
kernels first, prints chip_smoke's JSON lines and the seconds each phase
took, and last the ``kernels`` rows of the phases run with the launches
of the runs run.  Exits non-zero on any failed check, as chip_smoke does.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    which = argv[0].split(",") if argv else ["bwd", "P", "O"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"], capture_output=True,
        text=True, check=True).stdout.strip(), flush=True)
    cs.emit({"phase": "build", "libraries": _build.build_all()})
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rows, runs = {}, {}
    t0 = time.perf_counter()
    if "bwd" in which:
        rows.update(cs.flash_bwd_phase(torch, flush))
        cs.emit({"phase": "seconds", "bwd": time.perf_counter() - t0})
    if "ssd_bwd" in which:
        t0 = time.perf_counter()
        rows.update(cs.ssd_bwd_phase(torch, flush))
        cs.emit({"phase": "seconds", "ssd_bwd": time.perf_counter() - t0})
    if "ops" in which:
        t0 = time.perf_counter()
        cs.ops_splitk_phase(torch, flush)
        cs.emit({"phase": "seconds", "ops": time.perf_counter() - t0})
    if "P" in which:
        t0 = time.perf_counter()
        runs["P"] = cs.train_run(torch)
        cs.emit({"phase": "seconds", "P": time.perf_counter() - t0})
    for run in cs.TRAIN_RUNS:
        if run in which:
            t0 = time.perf_counter()
            runs[run] = cs.stack_train_run(torch, run)
            cs.emit({"phase": "seconds", run: time.perf_counter() - t0})
    if "V" in which:
        t0 = time.perf_counter()
        runs["V"] = cs.mesh_train_run(torch)
        cs.emit({"phase": "seconds", "V": time.perf_counter() - t0})
    for run in cs.MESH_RUNS:
        if run in which:
            t0 = time.perf_counter()
            runs[run] = cs.mesh_rank_run(torch, run)
            cs.emit({"phase": "seconds", run: time.perf_counter() - t0})
    zs = tuple(cs.SERVE_MESH_RUNS) if "Z" in which else tuple(
        w for w in which if w in cs.SERVE_MESH_RUNS)
    if zs:
        t0 = time.perf_counter()
        runs["Z"] = cs.serve_mesh_run(torch, zs)
        cs.emit({"phase": "seconds", "Z": time.perf_counter() - t0})
    if "ring" in which:
        t0 = time.perf_counter()
        runs["ring"], _, _ = cs.ring_phase(torch)
        cs.emit({"phase": "seconds", "ring": time.perf_counter() - t0})
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    if "dryrun" in which:
        t0 = time.perf_counter()
        cs.dryrun_phase(torch)
        cs.emit({"phase": "seconds", "dryrun": time.perf_counter() - t0})
    if "O" in which:
        t0 = time.perf_counter()
        paged = {name: False for name in cs.launch_counts()
                 if "/" not in name}
        slots_attn = dict(
            paged, flash_attention="per_layer_prefill",
            paged_attention_splitk="per_layer_decode",
            **{"flash_attention:mma": "per_layer_prefill",
               "paged_attention_splitk:mma": "per_layer_decode"})
        vlm = cs.setup(torch, "internvl2-76b", n_layers=cs.INTERNVL_LAYERS)
        runs["O"] = cs.internvl_run(torch, vlm, slots_attn)
        cs.emit({"phase": "seconds", "O": time.perf_counter() - t0})
    if "examples" in which:
        t0 = time.perf_counter()
        cs.examples_phase(torch)
        cs.emit({"phase": "seconds", "examples": time.perf_counter() - t0})
    for name, row in rows.items():
        row["launches"] = sum(r[name] for r in runs.values())
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
