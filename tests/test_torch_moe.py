"""The port's MoE FFN (``repro_torch.models.moe``) against
``repro.models.moe`` on seeded numpy inputs and bridged weights (CPU):
routing (expert indices exactly, ties in ``jax.lax.top_k``'s order),
the dense oracle, the capacity dispatch with and without drops, the
chunked dispatch, the full FFN with shared experts, and the load-balance
loss.  f32 outputs within 1e-5; bf16 within one bf16 step with SiLU
rounded as the reference rounds it (bit-equal at top-6, drops included),
and the bf16 FFN as it ships against the reference and an f32 witness."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_FACTORIES
from repro.models import moe as jm
from repro_torch.configs import SMOKE_FACTORIES as T_SMOKE
from repro_torch.models import moe as tmoe
from repro_torch.weights import params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_STEP = dict(rtol=2 ** -7, atol=1e-5)


def configs(arch, **moe_kw):
    jcfg, tcfg = SMOKE_FACTORIES[arch](), T_SMOKE[arch]()
    if moe_kw:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **moe_kw))
        tcfg = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, **moe_kw))
    return jcfg, tcfg


def weights(jcfg, dtype=jnp.float32, seed=0):
    jp = jm.moe_init(jax.random.key(seed), jcfg, dtype)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def inputs(n, d, seed=1, dtype=jnp.float32):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)
    jx = jnp.asarray(x, dtype)
    return jx, params_from_numpy(np.asarray(jx), "cpu")


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-moe-16b"])
def test_route_matches_reference(arch):
    jcfg, tcfg = configs(arch)
    jp, tp = weights(jcfg)
    jx, tx = inputs(64, jcfg.d_model)
    jw, je, jprobs = jm._route(jp, jx, jcfg.moe)
    tw, te, tprobs = tmoe._route(tp, tx, tcfg.moe)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs),
                               rtol=1e-6, atol=1e-6)
    close(tw, jw)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_route_breaks_ties_as_lax_top_k(dtype):
    """Small integers make every logit exact in either framework, so
    equal logits give exactly equal probabilities: the lower expert index
    must come first, as ``jax.lax.top_k`` puts it."""
    jcfg, tcfg = configs("mixtral-8x7b", n_experts=8, top_k=3)
    rng = np.random.default_rng(2)
    router = rng.integers(-2, 3, (jcfg.d_model, 8)).astype(np.float32)
    router[:, 5] = router[:, 1]            # duplicate columns: exact ties
    router[:, 6] = router[:, 2]            # between experts in every row
    router[:, 7] = router[:, 2]
    x = rng.integers(-1, 2, (48, jcfg.d_model)).astype(np.float32)
    x[:4] = 0.0                            # all eight experts tie
    jr, jx = jnp.asarray(router, dtype), jnp.asarray(x, dtype)
    tr, tx = (params_from_numpy(np.asarray(a), "cpu") for a in (jr, jx))
    _, je, jprobs = jm._route({"router": jr}, jx, jcfg.moe)
    tw, te, _ = tmoe._route({"router": tr}, tx, tcfg.moe)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(te[:4].numpy(), [[0, 1, 2]] * 4)
    probs = np.asarray(jprobs)
    ties = sum(len(np.unique(p)) < len(p) for p in probs)
    assert ties == len(probs)              # every row holds a tie
    assert tw.dtype == getattr(torch, jnp.dtype(dtype).name)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-moe-16b"])
def test_moe_dense_matches_reference(arch):
    jcfg, tcfg = configs(arch)
    jp, tp = weights(jcfg)
    jx, tx = inputs(40, jcfg.d_model, seed=3)
    jy, _ = jm.moe_dense(jp, jx.reshape(2, 20, -1), jcfg.moe)
    ty, aux = tmoe.moe_dense(tp, tx.reshape(2, 20, -1), tcfg.moe)
    assert aux is None
    close(ty, jy)


@pytest.mark.parametrize("capacity_factor,drops", [(2.0, False),
                                                   (1.0, True)])
def test_moe_dispatch_matches_reference(capacity_factor, drops):
    """capacity_factor E / top_k (2.0 here) gives every expert room for
    all n rows: nothing drops, and the dispatch equals the dense oracle.
    At 1.0 (the reference's ``test_dispatch_drops_overflow`` situation)
    assignments past an expert's capacity drop and contribute zero."""
    jcfg, tcfg = configs("mixtral-8x7b", capacity_factor=capacity_factor)
    jp, tp = weights(jcfg, seed=4)
    jx, tx = inputs(37, jcfg.d_model, seed=5)
    jy, _ = jm.moe_dispatch(jp, jx, jcfg.moe)
    ty, _ = tmoe.moe_dispatch(tp, tx, tcfg.moe)
    close(ty, jy)
    dense, _ = tmoe.moe_dense(tp, tx, tcfg.moe)
    dropped = (ty - dense).abs().amax(-1) > 1e-5
    assert bool(dropped.any()) == drops
    if drops:        # a row that lost an assignment still matches
        close(ty[dropped], np.asarray(jy)[dropped.numpy()])


def test_moe_dispatch_chunked_matches_reference():
    """A chunk of 16 rows over 50 (4 chunks, the last padded with zero
    rows): capacity per chunk, as the reference's scan."""
    jcfg, tcfg = configs("deepseek-moe-16b")
    jp, tp = weights(jcfg, seed=6)
    jx, tx = inputs(50, jcfg.d_model, seed=7)
    jy, jaux = jm.moe_dispatch_chunked(jp, jx, jcfg.moe, chunk=16)
    ty, taux = tmoe.moe_dispatch_chunked(tp, tx, tcfg.moe, chunk=16,
                                         want_aux=True)
    close(ty, jy)
    close(taux, jaux)
    whole, _ = tmoe.moe_dispatch(tp, tx, tcfg.moe)
    assert not torch.allclose(ty, whole, atol=1e-5)   # capacity per chunk


@pytest.mark.parametrize("impl", ["dense", "dispatch"])
def test_moe_ffn_with_shared_experts(impl):
    jcfg, tcfg = configs("deepseek-moe-16b")
    jcfg = dataclasses.replace(jcfg, moe_impl=impl)
    tcfg = dataclasses.replace(tcfg, moe_impl=impl)
    assert tcfg.moe.n_shared_experts
    jp, tp = weights(jcfg, seed=8)
    jx, tx = inputs(30, jcfg.d_model, seed=9)
    jy, jaux = jm.moe_ffn(jp, jx.reshape(3, 10, -1), jcfg)
    ty, taux = tmoe.moe_ffn(tp, tx.reshape(3, 10, -1), tcfg, want_aux=True)
    close(ty, jy)
    close(taux, jaux)
    assert tmoe.moe_ffn(tp, tx, tcfg)[1] is None      # serving: no aux
    routed, _ = tmoe.moe_ffn(tp, tx, dataclasses.replace(
        tcfg, moe=dataclasses.replace(tcfg.moe, n_shared_experts=0)))
    assert not torch.allclose(routed, ty.reshape(30, -1), atol=1e-3)


def test_load_balance_loss_matches_reference():
    rng = np.random.default_rng(10)
    logits = rng.standard_normal((3, 7, 8)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    experts = rng.integers(0, 8, (3, 7, 2)).astype(np.int32)
    want = jm.load_balance_loss(jnp.asarray(probs), jnp.asarray(experts), 8)
    counts = tmoe.routed_counts(torch.tensor(experts).long(), 8)
    assert counts.tolist() == np.bincount(experts.ravel(), None, 8).tolist()
    got = tmoe.load_balance_loss(torch.tensor(probs), counts, 21, 8)
    close(got, want)


def silu_rounded_per_op(g):
    """SiLU as the reference computes it in bf16: XLA rounds the result
    of each of its five operations (negate, exp, add, divide, multiply)
    to bf16, where ``F.silu`` rounds once."""
    return g * (1 / (1 + torch.exp(-g)))


@pytest.mark.parametrize("impl", ["dense", "dispatch"])
def test_moe_ffn_bf16_within_one_step(impl, monkeypatch):
    """bf16 routing equals the reference's exactly.  The FFN's output is
    held with the activation rounded as the reference rounds it (the one
    rounding the port does differently, by design: it rounds once), so
    what is compared is the routing, gather, products and combine in
    bf16."""
    monkeypatch.setattr(torch.nn.functional, "silu", silu_rounded_per_op)
    jcfg, tcfg = configs("mixtral-8x7b")
    jcfg = dataclasses.replace(jcfg, moe_impl=impl, dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, moe_impl=impl, dtype="bfloat16")
    jp, tp = weights(jcfg, jnp.bfloat16, seed=11)
    jx, tx = inputs(24, jcfg.d_model, seed=12, dtype=jnp.bfloat16)
    _, je, _ = jm._route(jp, jx, jcfg.moe)
    _, te, _ = tmoe._route(tp, tx, tcfg.moe)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    jy, _ = jm.moe_ffn(jp, jx, jcfg)
    ty, _ = tmoe.moe_ffn(tp, tx, tcfg)
    assert ty.dtype == torch.bfloat16
    close(ty, jy, BF16_STEP)


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
@pytest.mark.parametrize("impl", ["dense", "dispatch"])
def test_moe_ffn_bf16_as_shipped(impl, seed):
    """The bf16 FFN as it ships (``F.silu`` rounds once), against the
    reference and, as a second witness, against the reference's f32
    result on the same bf16 values.  Its difference from the reference
    is held to two bf16 steps of the output's scale (measured over these
    cases: 0.65-1.30), and its RMS error against the f32 result to 1.05
    times the reference's own (measured: 0.857-1.022): rounding once is
    about as accurate as rounding each operation."""
    jcfg, tcfg = configs("mixtral-8x7b")
    jcfg = dataclasses.replace(jcfg, moe_impl=impl, dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, moe_impl=impl, dtype="bfloat16")
    jp, tp = weights(jcfg, jnp.bfloat16, seed=seed)
    jx, tx = inputs(24, jcfg.d_model, seed=seed + 1, dtype=jnp.bfloat16)
    jy, _ = jm.moe_ffn(jp, jx, jcfg)
    ty, _ = tmoe.moe_ffn(tp, tx, tcfg)
    assert ty.dtype == torch.bfloat16
    want, got = np.asarray(jy, np.float32), ty.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * 2 ** -7 * np.abs(want).max())
    f32 = np.asarray(jm.moe_ffn(
        jax.tree.map(lambda a: a.astype(jnp.float32), jp),
        jx.astype(jnp.float32),
        dataclasses.replace(jcfg, dtype="float32"))[0])

    def rms(a):
        return float(np.sqrt(np.mean((a - f32) ** 2)))

    assert rms(got) <= 1.05 * rms(want)


@pytest.mark.parametrize("capacity_factor", [1.0, 3.0])
def test_moe_dispatch_bf16_top6_combine(capacity_factor, monkeypatch):
    """DeepSeek's top-6 routing in bf16, with drops (1.0) and without
    (3.0): each token's six contributions are summed in increasing expert
    order, the reference's order, so with SiLU rounded as the reference
    rounds it the outputs are bit-equal."""
    monkeypatch.setattr(torch.nn.functional, "silu", silu_rounded_per_op)
    jcfg, tcfg = configs("deepseek-moe-16b", n_experts=16, top_k=6,
                         capacity_factor=capacity_factor)
    jp, tp = weights(jcfg, jnp.bfloat16, seed=11)
    jx, tx = inputs(40, jcfg.d_model, seed=12, dtype=jnp.bfloat16)
    jy, _ = jm.moe_dispatch(jp, jx, jcfg.moe)
    ty, _ = tmoe.moe_dispatch(tp, tx, tcfg.moe)
    np.testing.assert_array_equal(ty.float().numpy(),
                                  np.asarray(jy, np.float32))
