"""Every registered architecture behind the port's serving API (the
counterpart of ``serve_multiarch.py``).

Spins up the port's continuous-batching engine for each reduced
architecture (dense, SSM, hybrid, MLA, MoE, vision prefix) and serves
the same mini-workload: the Equinox scheduler and the engine are
architecture-agnostic while their *cost models* differ (the paper's core
observation).  The encoder-decoder is skipped with the reason the engine
gives: its requests carry no audio frames.

    PYTHONPATH=src python examples/serve_multiarch_torch.py
(on the card by default; ``--device cpu`` runs the kernels' plain
versions.)
"""
import argparse

import numpy as np

from repro_torch.configs import SMOKE_FACTORIES, get_config
from repro_torch.core import Request, make_scheduler
from repro_torch.serving.costmodel import kv_read_bytes
from repro_torch.serving.engine import ServingEngine


def mini_workload(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, client=f"client{i % 2}", arrival=0.01 * i,
                    prompt_len=int(rng.integers(8, 24)),
                    output_len=int(rng.integers(4, 10)),
                    keywords=("chat",)) for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print(f"{'arch':<22}{'family':<8}{'KV B/req@8k':>12}"
          f"{'served':>7}{'modeled t':>11}")
    served = {}
    for arch in sorted(SMOKE_FACTORIES):
        cfg = SMOKE_FACTORIES[arch]()
        full = get_config(arch)
        if cfg.is_encoder_decoder:
            try:
                ServingEngine(cfg, make_scheduler("fcfs"), max_slots=4,
                              max_len=64, device=args.device)
            except NotImplementedError as refusal:
                reason = str(refusal)
            else:
                raise AssertionError(f"{arch}: the engine took an "
                                     "encoder-decoder stack")
            print(f"{arch:<22}{full.arch_type:<8}{'—':>12}{'skip':>7}"
                  f"{'—':>11}   ({reason})")
            served[arch] = None
            continue
        kv8k = kv_read_bytes(full, 8192) / 2 ** 20
        eng = ServingEngine(cfg, make_scheduler("fcfs"), max_slots=4,
                            max_len=64, device=args.device)
        reqs = mini_workload()
        done = eng.run(reqs)
        ok = sum(r.generated == r.output_len for r in done)
        print(f"{arch:<22}{full.arch_type:<8}{kv8k:>10.1f}Mi"
              f"{ok:>5}/{len(reqs)}{eng.t_model:>10.3f}s")
        served[arch] = (ok, len(reqs))
    return served


if __name__ == "__main__":
    main()
