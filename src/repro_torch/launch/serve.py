"""Serving launcher: the Equinox stack end to end on a real model.

Port of ``repro/launch/serve.py``: the continuous-batching engine
(reduced model) under any scheduler against a synthetic or trace
workload, reporting the paper's metrics.  Runs on the card by default;
``--device cpu`` runs the kernels' plain versions on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
        --scheduler equinox --workload balanced --duration 5
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import SMOKE_FACTORIES, get_config
from repro_torch.core import jain, make_scheduler
from repro_torch.predictor import MoPE, Oracle, SingleProxy
from repro_torch.serving.costmodel import A100_80G, CostModel
from repro_torch.serving.engine import ServingEngine
from repro_torch.workloads import SCENARIOS, corpus, lmsys_like


def build_predictor(name, cm, seed=0):
    if name == "oracle":
        return Oracle(cm)
    train_corpus = corpus(8000, seed=seed)
    if name == "single":
        return SingleProxy(cm, train_corpus, epochs=20)
    return MoPE(cm, train_corpus, epochs=20)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--scheduler", default="equinox",
                    choices=["fcfs", "rpm", "vtc", "equinox"])
    ap.add_argument("--predictor", default="mope",
                    choices=["mope", "single", "oracle"])
    ap.add_argument("--workload", default="balanced")
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--max-slots", type=int, default=8)
    ap.add_argument("--scale-tokens", type=float, default=0.05,
                    help="scale workload token lengths for the reduced "
                    "model")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the engine runs on")
    args = ap.parse_args(argv)

    cfg = SMOKE_FACTORIES[args.arch]()
    cm = CostModel(get_config(args.arch), A100_80G)
    pred = (build_predictor(args.predictor, cm, args.seed)
            if args.scheduler in ("vtc", "equinox") else None)
    sched = make_scheduler(args.scheduler, predictor=pred)
    if args.workload in SCENARIOS:
        reqs = SCENARIOS[args.workload](duration=args.duration,
                                        seed=args.seed)
    else:
        reqs = lmsys_like(duration=args.duration, seed=args.seed)
    # shrink token counts so the reduced model serves quickly
    s = args.scale_tokens
    for r in reqs:
        r.prompt_len = max(4, int(r.prompt_len * s))
        r.output_len = max(2, int(r.output_len * s))

    eng = ServingEngine(cfg, sched, max_slots=args.max_slots,
                        max_len=512, cost_model=cm, backend="paged",
                        seed=args.seed, device=args.device)
    done = eng.run(reqs)
    ttfts = np.array([r.ttft() for r in done if r.ttft() is not None])
    lats = np.array([r.e2e_latency() for r in done])
    tput = sum(r.prompt_len + r.generated for r in done) / max(eng.t_model,
                                                               1e-9)
    print(f"scheduler={args.scheduler} predictor={args.predictor} "
          f"workload={args.workload} device={eng.device}")
    print(f"finished {len(done)}/{len(reqs)} requests, "
          f"{eng.iterations} engine iterations")
    print(f"modeled throughput: {tput:.0f} tok/s")
    if len(ttfts):
        print(f"TTFT p50/p90: {np.percentile(ttfts, 50):.3f}/"
              f"{np.percentile(ttfts, 90):.3f} s (modeled)")
        print(f"mean e2e latency: {lats.mean():.3f} s (modeled)")
    print(f"service per client: "
          f"{ {k: round(v, 1) for k, v in sched.service.items()} }")
    print(f"jain(service): {jain(list(sched.service.values())):.3f}")


if __name__ == "__main__":
    main()
