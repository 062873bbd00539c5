"""The readings the limits of ``correct`` are set from: for each seed, one
run of the cell at its own load (a short window) in one process, the
program's widest served-token gap against the f32 reference, and the
controls' on the same sample.  Not run by the benchmark's own runs.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 20 [--fp8] [--kv-int8] [--out control.jsonl]

``--fp8``: the reference computed with every weight product in float8
e4m3 (per-row and per-column scales), in the program's place: at each
compared position the token it puts first, read in the f32 reference,
and those gaps judged by the run's own comparison (``harness.check``
with the configuration's limits; ``fp8_correct`` has to be false).
``--kv-int8``: the program itself with its int8 KV pages
(``kv_quant``), a second run on the same seed.  ``--route-bf16`` (a MoE
reference): in the control's place, the f32 reference with only its
router's input rounded to bf16.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
os.environ.setdefault("OMP_NUM_THREADS", "2")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fp8", action="store_true")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--route-bf16", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness
    torch.set_num_threads(2)
    runs = [("program", {})] + ([("kv_int8", {"kv_quant": True})]
                                if args.kv_int8 else [])
    variant = {"route_bf16": True} if args.route_bf16 else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        for what, engine in runs:
            t0 = time.perf_counter()
            result, info = harness.run_cell(
                args.workload, seed, args.seconds, False, t0,
                control=(args.fp8 or bool(variant)) and what == "program",
                engine=engine, variant=variant)
            line = {"cell": args.workload, "seed": seed, "run": what,
                    "checks": result["checks"],
                    "sampled": info["sampled_requests"],
                    "seconds": time.perf_counter() - t0}
            line["gaps"] = info.get("gap_stats")
            if "control_gap_stats" in info:
                what_ctrl = "route_bf16" if variant else "fp8"
                line[f"{what_ctrl}_gaps"] = info["control_gap_stats"]
                # the control through the run's own comparison: it has to
                # come out not correct
                line[f"{what_ctrl}_correct"] = info["control_correct"]
                line[f"{what_ctrl}_checks"] = info["control_checks"]
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
