"""End-to-end training driver on the PyTorch port: a ~100M-parameter
Llama-family model for a few hundred steps on the synthetic Markov
corpus, with checkpointing (the counterpart of ``train_100m.py``).

    PYTHONPATH=src python examples/train_100m_torch.py --steps 300
(on the card by default; ``--device cpu`` runs the kernels' plain
versions; the defaults are sized for a quick run, pass --d-model 768
--layers 12 for the full ~100M).  The model is the reference example's
(f32) except that attention is ``flash``, so on the card it runs the
hand-written forward and backward kernels (the reference's example
trains through its naive attention).
"""
import argparse
import math

from repro_torch.configs.base import ModelConfig
from repro_torch.training import TrainConfig, train


def make_cfg(d_model: int, layers: int, vocab: int) -> ModelConfig:
    return ModelConfig(
        name=f"llama-{d_model}x{layers}",
        arch_type="dense",
        n_layers=layers,
        d_model=d_model,
        n_heads=max(d_model // 64, 2),
        n_kv_heads=max(d_model // 128, 1),
        d_ff=d_model * 4,
        vocab_size=vocab,
        dtype="float32",
        attn_impl="flash",
        remat=False,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default="build/train_100m_torch_ckpt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = make_cfg(args.d_model, args.layers, args.vocab)
    print(f"model: {cfg.name}  params≈{cfg.n_params() / 1e6:.1f}M")
    tc = TrainConfig(batch=args.batch, seq_len=args.seq, steps=args.steps,
                     peak_lr=args.lr, warmup=20, log_every=20,
                     ckpt_every=100, ckpt_path=args.ckpt)
    _, losses = train(cfg, tc, device=args.device)
    first, last = losses[0][1], losses[-1][1]
    print(f"loss {first:.3f} -> {last:.3f} "
          f"(uniform entropy {math.log(args.vocab):.3f}); "
          f"checkpoints in {args.ckpt}")
    return losses


if __name__ == "__main__":
    main()
