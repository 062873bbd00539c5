"""Quickstart on the PyTorch port: the Equinox stack in ~70 lines (the
counterpart of ``quickstart.py``).

Builds a reduced Llama-2 model, trains the MoPE predictor on a synthetic
LMSYS-like corpus, then serves a two-client workload through the
holistic-fairness scheduler on the port's engine.  The cost model is the
port's ``H100_SXM`` preset, whose efficiency fields are not calibrated on
the card, so the TTFTs it prints are modeled, not measured.

    PYTHONPATH=src python examples/quickstart_torch.py
(on the card by default; ``--device cpu`` runs the kernels' plain
versions.)
"""
import argparse

import numpy as np

from repro_torch.configs import SMOKE_FACTORIES, get_config
from repro_torch.core import Request, jain, make_scheduler
from repro_torch.predictor import MoPE
from repro_torch.serving.costmodel import H100_SXM, CostModel
from repro_torch.serving.engine import ServingEngine
from repro_torch.workloads import corpus


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. cost model for the target hardware (one H100 SXM, uncalibrated)
    cm = CostModel(get_config("llama2-7b"), H100_SXM)
    print(f"cost model: {H100_SXM.name} preset (uncalibrated: its "
          "efficiency fields repeat the A100 preset's guesses); the TTFTs "
          "below are modeled")

    # 2. train the Mixture-of-Prediction-Experts offline (paper §6)
    print("training MoPE (router + 3 regression experts)...")
    mope = MoPE(cm, corpus(4000, seed=0), n_experts=3, epochs=10)

    # 3. holistic-fairness scheduler (UFC + RFC -> argmin HF, paper §3-5)
    sched = make_scheduler("equinox", predictor=mope)

    # 4. the port's continuous-batching engine on a reduced model
    cfg = SMOKE_FACTORIES["llama2-7b"]()
    engine = ServingEngine(cfg, sched, max_slots=4, max_len=128,
                           cost_model=cm, device=args.device)

    # 5. two clients: one chatty/short, one story/long
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(12):
        short = i % 3 != 0
        reqs.append(Request(
            rid=i, client="alice" if short else "bob", arrival=0.05 * i,
            prompt_len=int(rng.integers(6, 20)),
            output_len=int(rng.integers(3, 8) * (1 if short else 4)),
            keywords=("qa",) if short else ("story",)))

    done = engine.run(reqs)
    print(f"served {len(done)} requests in {engine.iterations} iterations "
          f"on {engine.device}")
    for r in done[:4]:
        print(f"  req {r.rid} ({r.client}): pred_out="
              f"{r.pred_output_len:.0f} actual={r.generated} "
              f"ttft={r.ttft():.3f}s (modeled, uncalibrated H100 preset)")
    service = {k: round(v, 1) for k, v in sched.service.items()}
    hf = {k: round(float(v), 3) for k, v in sched.fairness_scores().items()}
    j = jain(list(sched.service.values()))
    print("per-client weighted service:", service)
    print("per-client HF:", hf)
    print(f"jain(service) = {j:.3f}")
    return {"requests": len(done), "iterations": engine.iterations,
            "service": service, "hf": hf, "jain": j}


if __name__ == "__main__":
    main()
