#!/usr/bin/env python3
"""Whether a decode profile window of ``chip_smoke.py`` depends on how
long the engine runs before it: the configurations of runs D (Llama-2-7B,
slots, whole-prompt prefill) and E (Mamba-2-2.7B), each window after the
prompts are in (``chip_smoke.prompts_in``, the smoke's rule: at most 14
iterations) and after 14 iterations whatever the prompts, in turns (rule,
14, 14, rule) in one process on one card.  Prints the card's name and
power limit, then ``chip_smoke.profile_window``'s line for each window
(``warmup_iterations``, host and device ms an iteration, busy share).

    python3 scripts/window_warmup.py
"""
from __future__ import annotations

import copy
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("window_warmup: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import make_scheduler
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"], capture_output=True,
        text=True, check=True).stdout.strip(), flush=True)
    _build.build_all()
    rule = cs.prompts_in
    for run, arch, kw in (("D", "llama2-7b", {"chunked": False}),
                          ("E", "mamba2-2.7b", {})):
        cfg, params, cm, mope = cs.setup(torch, arch)
        for fixed in (False, True, True, False):
            cs.prompts_in = (lambda eng: False) if fixed else rule
            try:
                cs.profile_window(torch, run, ServingEngine(
                    cfg, make_scheduler("equinox",
                                        predictor=copy.deepcopy(mope)),
                    params=params, max_len=cs.MAX_LEN_SLOTS, cost_model=cm,
                    seed=cs.SEED, device="cuda", backend="slots", **kw),
                    cs.requests(False))
            finally:
                cs.prompts_in = rule
        del params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
