"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the program (``src/repro_torch``)
and ``BENCHMARK.json``.  With ``--trace 0`` the last line of standard
output carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, the device's busy and profiled seconds and the
breakdown.  The numbers compared with the reference, each with its limit,
are the last lines of standard error and the result's last key.  Exits
non-zero, printing no result, without enough CUDA devices, without the
program, or when JAX or the JAX package was loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
os.environ.setdefault("OMP_NUM_THREADS", "2")
os.environ.setdefault("USE_FLAX", "0")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness

    cell = harness.load_cell(args.workload)[0]
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available; nothing was run", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is not in this checkout ({e})",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result, info = harness.run_cell(args.workload, args.seed, args.seconds,
                                    bool(args.trace), T_PROCESS)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps({"info": info}), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
