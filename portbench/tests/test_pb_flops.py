"""The operation and byte counts against counts worked by hand."""
import pytest

from _pb_tiny import REPO  # noqa: F401  (puts the checkout on the path)

from portbench import flops, peaks

DENSE = {"n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 2, "d_ff": 16, "vocab_size": 10, "act": "gelu"}
MOE = {"n_layers": 3, "d_model": 4, "n_heads": 2, "n_kv_heads": 2,
       "head_dim": 2, "d_ff": 6, "vocab_size": 5, "act": "silu",
       "moe": {"n_experts": 4, "top_k": 2, "n_shared_experts": 1,
               "d_ff_expert": 3, "d_ff_shared": 3, "first_k_dense": 1}}


def test_dense_step():
    # a layer: q 8x8, k and v 8x4 each, o 8x8 = 192; mlp 2 x 8 x 16 = 256
    assert flops.layer_params(DENSE, False) == 448
    assert flops.matmul_flops_per_token(DENSE) == 2 * 2 * 448
    # rows attending 1, 2 and 5 keys: 4 x H x hd x 8 keys x layers
    assert flops.attn_flops(DENSE, [1, 2, 5]) == 4 * 4 * 2 * 8 * 2
    # 3 rows, 2 of them read logits: head 2 x 8 x 10 a row
    assert flops.step_flops(DENSE, [1, 2, 5], 2) == \
        3 * 1792 + 512 + 2 * 160


def test_moe_step():
    # attention 4 x 4 (q) + 2 x 4 x 4 (k, v) + 4 x 4 (o) = 64
    # dense layer: swiglu 3 x 4 x 6 = 72; moe layer: router 4 x 4, two
    # experts 2 x 3 x 4 x 3, shared 3 x 4 x 3: 16 + 72 + 36
    assert flops.layer_params(MOE, False) == 64 + 72
    assert flops.layer_params(MOE, True) == 64 + 124
    assert flops.matmul_flops_per_token(MOE) == 2 * (136 + 2 * 188)


def test_paged_call_and_least_time():
    # two requests with 10 and 3 keys; 4 rows attending 10, 9, 3, 3
    nbytes, fl = flops.paged_call(DENSE, [10, 3], [10, 9, 3, 3])
    # K and V: 13 tokens x 2 heads x 2 dims x 2 tensors x 2 B = 208;
    # q and out: 2 x 4 rows x 4 heads x 2 dims x 2 B = 128
    assert nbytes == 208 + 128
    assert fl == 4 * 4 * 2 * 25
    assert flops.least_seconds(nbytes, fl) == pytest.approx(
        max(336 / peaks.HBM_BYTES_PER_S, 800 / peaks.BF16_FLOPS))
