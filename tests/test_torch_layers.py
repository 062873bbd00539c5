"""Model layers of the PyTorch port against ``repro.models`` on the same
numpy inputs: RMSNorm, the MLPs, RoPE, embeddings, int8 KV quantization
and the initialisers' distributions.  f32 tolerance 1e-5; int8 values
and bf16 scales must be exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jl
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl
from repro_torch.weights import params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)


def rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def tree(d):
    return params_from_numpy(d, "cpu")


def test_rmsnorm():
    x, s = rand(0, 3, 5, 128), rand(1, 128)
    want = jl.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x), 1e-6)
    got = tl.rmsnorm(tree({"scale": s}), torch.from_numpy(x), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rmsnorm_bf16_casts_back():
    x = rand(2, 4, 64)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jl.rmsnorm({"scale": jnp.ones(64, jnp.bfloat16)}, xb)
    got = tl.rmsnorm({"scale": torch.ones(64, dtype=torch.bfloat16)},
                     tree(np.asarray(xb)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp(act):
    p = {"w_in": rand(3, 128, 256, scale=0.09),
         "w_out": rand(4, 256, 128, scale=0.06)}
    if act == "silu":
        p["w_gate"] = rand(5, 128, 256, scale=0.09)
    x = rand(6, 7, 128)
    want = jl.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), act)
    got = tl.mlp(tree(p), torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_heads", [True, False])
def test_apply_rope(with_heads):
    shape = (6, 4, 32) if with_heads else (6, 32)
    x = rand(7, *shape)
    pos = np.asarray([0, 1, 15, 16, 63, 511], np.int32)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("tie", [True, False])
def test_embed_unembed(tie):
    p = {"table": rand(8, 512, 128, scale=0.02)}
    if not tie:
        p["head"] = rand(9, 128, 512, scale=0.09)
    toks = np.asarray([0, 5, 511, 5], np.int32)
    e_want = jl.embed(jax.tree.map(jnp.asarray, p), jnp.asarray(toks))
    e_got = tl.embed(tree(p), torch.from_numpy(toks))
    np.testing.assert_array_equal(e_got.numpy(), np.asarray(e_want))
    x = rand(10, 4, 128)
    u_want = jl.unembed(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    u_got = tl.unembed(tree(p), torch.from_numpy(x))
    np.testing.assert_allclose(u_got.numpy(), np.asarray(u_want), **TOL)


def test_quantize_kv_exact():
    x = rand(11, 9, 4, 32, scale=3.0)
    x[0, 0] = 0.0                           # all-zero row: the 1e-6 floor
    x[1, 1, :4] = [127.0, -127.0, 63.5, -0.5]   # round-half-even cases
    q_want, s_want = jattn.quantize_kv(jnp.asarray(x))
    q_got, s_got = tattn.quantize_kv(torch.from_numpy(x))
    assert q_got.dtype == torch.int8 and s_got.dtype == torch.bfloat16
    np.testing.assert_array_equal(q_got.numpy(), np.asarray(q_want))
    np.testing.assert_array_equal(s_got.view(torch.uint16).numpy(),
                                  np.asarray(s_want).view(np.uint16))
    for dt_j, dt_t in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        d_want = jattn.dequantize_kv(q_want, s_want, dt_j)
        d_got = tattn.dequantize_kv(q_got, s_got, dt_t)
        np.testing.assert_array_equal(d_got.float().numpy(),
                                      np.asarray(d_want, np.float32))


def test_initialiser_distributions():
    """dense_init (truncated normal at fan-in scale) and embed_init
    (normal x 0.02) draw from the reference's distributions."""
    g = torch.Generator().manual_seed(0)
    shape = (256, 512)
    t_dense = tl.dense_init(shape, torch.float32, g, "cpu").numpy()
    j_dense = np.asarray(jl.dense_init(jax.random.key(0), shape,
                                       jnp.float32))
    scale = 256 ** -0.5
    for a in (t_dense, j_dense):
        assert np.abs(a).max() <= 2 * scale * (1 + 1e-6)
    assert abs(t_dense.std() / j_dense.std() - 1) < 0.02
    assert abs(t_dense.mean()) < 0.01 * scale
    t_emb = tl.embed_init(shape, torch.float32, g, "cpu").numpy()
    j_emb = np.asarray(jl.embed_init(jax.random.key(1), shape, jnp.float32))
    assert abs(t_emb.std() / j_emb.std() - 1) < 0.02
    assert abs(t_emb.std() - 0.02) < 0.001
