"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""
BF16_FLOPS = 989e12          # FLOP/s, bf16 and fp16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12    # B/s
