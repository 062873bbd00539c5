"""Training launcher.

Port of ``repro/launch/train.py``: AdamW steps (``training.train``) on
the synthetic Markov corpus, on the card by default.  ``--smoke`` takes
the reduced config; without it the registered one at full width, where
it fits the card (the port trains every ``--arch``: dense GQA, MoE, MLA,
RG-LRU, Mamba-2 through the SSD scan's backward kernel, the vision prefix
and Whisper's encoder-decoder over stubbed frames).  ``--production``
(``--multi-pod``) trains on the reference's 16 x 16 (2 x 16 x 16) mesh
(``launch.mesh.make_production_mesh``, then ``train(mesh=...)``): it needs
a process group of 256 (512) ranks that a launcher such as ``torchrun``
started, and refuses any other world size, one card's included.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --steps 8 --batch 4 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \
        --steps 4 --batch 4 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm3-4b \
        --smoke --device cpu --steps 20 --batch 4 --seq 64
"""
from __future__ import annotations

import argparse

from repro_torch.configs import SMOKE_FACTORIES, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.training import TrainConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b",
                    choices=sorted(SMOKE_FACTORIES))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--production", action="store_true",
                    help="16x16 mesh (a process group of 256 ranks)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --production: 2x16x16 (512 ranks)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the model trains on")
    args = ap.parse_args(argv)

    cfg = (SMOKE_FACTORIES[args.arch]() if args.smoke
           else get_config(args.arch))
    mesh = None
    if args.production:
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device=args.device)
    tc = TrainConfig(batch=args.batch, seq_len=args.seq, steps=args.steps,
                     peak_lr=args.lr, ckpt_path=args.ckpt, seed=args.seed)
    _, losses = train(cfg, tc, mesh=mesh, device=args.device)
    print(f"final loss: {losses[-1][1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
