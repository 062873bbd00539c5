"""Scenario runner on the PyTorch port: reproduce a paper figure from the
command line (the counterpart of ``fairness_comparison.py``).

Runs FCFS / VTC / Equinox on one of the paper's synthetic scenarios in
the port's copy of the discrete-event simulator (A100 cost model) and
prints the fairness table — the script behind Figs. 9/10/17/18.  No
tensor work runs on a device: the simulator is host code, and MoPE's
experts train and predict in PyTorch on the CPU, so the example takes no
``--device``.

    PYTHONPATH=src python examples/fairness_comparison_torch.py \
        --scenario stochastic --duration 60
"""
import argparse
import copy

from repro_torch.configs import get_config
from repro_torch.core import (HFObserver, SimConfig, Simulator,
                              make_scheduler, summarize)
from repro_torch.predictor import MoPE
from repro_torch.serving.costmodel import A100_80G, CostModel
from repro_torch.workloads import SCENARIOS, corpus

HEADER = (f"{'scheduler':<14} {'thr tok/s':>9} {'p50 ttft':>9} "
          f"{'util':>5} {'sdiff avg':>10} {'sdiff max':>10} {'jainHF':>7}")


def fairness_rows(cm, wl, simcfg, duration, predictor,
                  schedulers=("fcfs", "vtc", "equinox")):
    """One table row per scheduler over a copy of the workload ``wl``:
    Equinox predicts with ``predictor`` (a ``MoPE``), FCFS and VTC with
    none.  Each row: its numbers and ``line``, as printed."""
    rows = []
    for name in schedulers:
        sched = make_scheduler(name, predictor=predictor
                               if name == "equinox" else None)
        obs = HFObserver()
        sim = Simulator(cm, sched, simcfg, observer=obs)
        res = sim.run(copy.deepcopy(wl), max_time=duration)
        s = summarize(res, clients=["client1", "client2"])
        row = {"scheduler": name,
               "throughput_tok_s": s["throughput_tok_s"],
               "p50_ttft": s["p50_ttft"], "mean_util": s["mean_util"],
               "service_diff_avg": s["service_diff"]["avg"],
               "service_diff_max": s["service_diff"]["max"],
               "jain_hf": obs.jain_index()}
        row["line"] = (f"{name:<14} {row['throughput_tok_s']:>9.0f} "
                       f"{row['p50_ttft']:>8.2f}s {row['mean_util']:>5.2f} "
                       f"{row['service_diff_avg']:>10.0f} "
                       f"{row['service_diff_max']:>10.0f} "
                       f"{row['jain_hf']:>7.3f}")
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="stochastic",
                    choices=sorted(SCENARIOS))
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--kv-budget", type=int, default=16000)
    args = ap.parse_args(argv)

    cm = CostModel(get_config("llama2-7b"), A100_80G)
    wl = SCENARIOS[args.scenario](duration=args.duration)
    mope = MoPE(cm, corpus(6000, seed=0), epochs=15)
    simcfg = SimConfig(max_batch=args.max_batch,
                       kv_budget_tokens=args.kv_budget)

    print(f"scenario={args.scenario} duration={args.duration}s "
          f"requests={len(wl)}")
    print(HEADER)
    print("-" * len(HEADER))
    rows = fairness_rows(cm, wl, simcfg, args.duration, mope)
    for row in rows:
        print(row["line"])
    return {"scenario": args.scenario, "duration": args.duration,
            "requests": len(wl), "rows": rows}


if __name__ == "__main__":
    main()
