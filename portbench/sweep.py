"""Find a cell's knee once: the highest offered rate at which the backlog
does not grow over the window.  Not run by the benchmark's own runs.

    python3 portbench/sweep.py --workload <cell> --seed <n> --seconds <s> \
        --rates 2,3,4,5 [--out sweep.jsonl]

One process: the weights are made once, then for each rate a fresh engine
(scheduler, MoPE, pools) serves the cell's mix at that rate for the
mix's ramp and ``--seconds``.  Each rate's line: requests due and
completed in the window, output tokens per second, and the backlog
(requests submitted without a first token) at the window's start, middle
and end.
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


def backlog(logs, t):
    return sum(1 for lg in logs if lg.submitted is not None
               and lg.submitted <= t
               and (not lg.stamps or lg.stamps[0] > t))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness
    from portbench.traffic.generator import schedule
    from portbench.weights import make_params

    torch.set_num_threads(2)
    cell, _, config, mix = harness.load_cell(args.workload)
    cfg = harness.build_cfg(config)
    params = make_params(config["model"], args.seed, "cuda")
    harness.warm_up(config, cfg, params, "cuda")
    # the knee is of the offered rate alone: no initial backlog
    mix = dict(mix, drain_first_tokens=False, clients=[
        dict(g, backlog=0) for g in mix["clients"]])
    for rate in [float(r) for r in args.rates.split(",")]:
        eng = harness.build_engine(config, cfg, params, "cuda")
        arrivals = schedule(mix, args.seed, mix["ramp_s"] + args.seconds,
                            rate)
        (w0, w1), _, logs, iters, _, _, _, _ = harness.open_loop(
            eng, arrivals, mix, args.seconds, args.seed,
            config["model"]["vocab_size"], t_process=T_PROCESS)
        stamps = sum(1 for lg in logs for t in lg.stamps if w0 <= t <= w1)
        its = [it for it in iters if it.model_s is not None
               and w0 <= it.t0 and it.t1 <= w1]
        line = {"cell": args.workload, "rate_rps": rate,
                "due_in_window": sum(1 for lg in logs if w0 <= lg.due < w1),
                "finished_in_window": sum(
                    1 for lg in logs if lg.finished is not None
                    and w0 <= lg.finished <= w1),
                "output_tokens_per_s": stamps / (w1 - w0),
                "backlog": [backlog(logs, t)
                            for t in (w0, 0.5 * (w0 + w1), w1)],
                "iterations": len(its),
                "step_ms_mean": 1e3 * sum(it.model_s for it in its)
                / max(len(its), 1),
                "decode_rows_mean": sum(it.decode_rows for it in its)
                / max(len(its), 1),
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        harness.free_engine(eng)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
