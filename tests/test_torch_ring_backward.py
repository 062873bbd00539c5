"""The ring's gradient in the port (``repro_torch.models.ring_attention``:
``RingFlashAttentionFunction``, ``ring_attention_shards``' backward)
against the reference (f32, CPU, 1e-5: the reference ring test's bound),
at ``RING_CASES`` with the output's gradient ``ring_dout``:

- the in-process backward over 2, 4 and 8 shards against ``jax.grad`` of
  the reference's ``naive_attention`` and against ``torch.autograd`` of
  the port's ``ring_attention_plain`` (the reference's arithmetic);
- against ``jax.grad`` of the reference's own ``ring_attention_sharded``
  on 4 forced host devices (one subprocess for the three cases);
- n = 1 on a world-size-1 gloo host mesh: bit for bit one
  ``flash_attention_bwd_plain`` call (the ring's merge of one partial
  gives back its output and lse);
- the flash backward's accumulate mode: added into zeros, its f32
  gradients rounded once are the default output's, bit for bit;
- bf16 over 8 shards: within ``ring_bwd_tolerance`` of one backward call
  given the ring's output and log-sum-exp, and a planted fault (one
  step's dK/dV dropped; the diagonal step's lse in place of the merged L)
  outside it.

The four-rank ring's gradients (each rank's own chunk, bit for bit this
in-process backward) are checked in ``tests/test_torch_ring_attention.py``,
whose rank processes run the forward and the backward."""
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.models.attention import naive_attention
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.models import ring_attention as ra

from _torch_dist_ranks import RING_CASES, ring_dout, ring_inputs

TOL = 1e-5
IDS = [f"S{c[0]}_H{c[1]}_{c[2]}_{'causal' if c[3] else 'full'}"
       for c in RING_CASES]


def _grads(fn, arrays, dout):
    """(out, dq, dk, dv) of ``fn`` at torch copies of ``arrays``."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
    out = fn(q, k, v)
    return (out.detach(), *torch.autograd.grad(out, (q, k, v),
                                               torch.from_numpy(dout)))


def _naive_grads(arrays, dout, causal):
    def loss(q, k, v):
        return jnp.sum(naive_attention(q, k, v, causal=causal) * dout)
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays))]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("case", range(len(RING_CASES)), ids=IDS)
def test_ring_backward_matches_naive_and_plain(case, n):
    S, Hq, Hkv, causal = RING_CASES[case]
    arrays, dout = ring_inputs(S, Hq, Hkv), ring_dout(S, Hq, Hkv)
    _, *got = _grads(lambda q, k, v: ra.ring_attention_shards(
        q, k, v, n, causal=causal), arrays, dout)
    _, *plain = _grads(lambda q, k, v: ra.ring_attention_plain(
        q, k, v, n, causal=causal), arrays, dout)
    for name, g, want, p in zip("qkv", got, _naive_grads(arrays, dout,
                                                          causal), plain):
        assert float(np.abs(g.numpy() - want).max()) < TOL, name
        assert float((g - p).abs().max()) < TOL, name


_JAX_RING = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path[:0] = ["src", "tests"]
    import jax, jax.numpy as jnp, numpy as np
    from repro.models.ring_attention import ring_attention_sharded
    from _torch_dist_ranks import RING_CASES, ring_dout, ring_inputs
    mesh = jax.make_mesh((4,), ("data",))
    out = {}
    for i, (S, Hq, Hkv, causal) in enumerate(RING_CASES):
        q, k, v = (jnp.asarray(a) for a in ring_inputs(S, Hq, Hkv))
        do = jnp.asarray(ring_dout(S, Hq, Hkv))
        def loss(q, k, v):
            return jnp.sum(ring_attention_sharded(q, k, v, mesh,
                                                  causal=causal) * do)
        with jax.set_mesh(mesh):
            grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
        for name, g in zip("qkv", grads):
            out[f"d{name}{i}"] = np.asarray(g)
    np.savez(sys.argv[1], **out)
    print("OK")
""")


@pytest.fixture(scope="module")
def jax_ring_grads(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_ring") / "grads.npz"
    r = subprocess.run([sys.executable, "-c", _JAX_RING, str(path)],
                       capture_output=True, text=True, timeout=240, cwd=".")
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-2000:]
    return np.load(path)


@pytest.mark.parametrize("case", range(len(RING_CASES)), ids=IDS)
def test_ring_backward_matches_reference_ring(jax_ring_grads, case):
    """The in-process backward over 4 shards against ``jax.grad`` of the
    reference's ring on 4 host devices (its ``ppermute`` transposed)."""
    S, Hq, Hkv, causal = RING_CASES[case]
    _, *got = _grads(lambda q, k, v: ra.ring_attention_shards(
        q, k, v, 4, causal=causal), ring_inputs(S, Hq, Hkv),
        ring_dout(S, Hq, Hkv))
    for name, g in zip("qkv", got):
        err = float(np.abs(g.numpy() - jax_ring_grads[f"d{name}{case}"])
                    .max())
        assert err < TOL, (name, err)


@pytest.fixture
def host_mesh():
    from repro_torch.launch.mesh import make_host_mesh

    assert not dist.is_initialized()
    mesh = make_host_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("causal", [True, False])
def test_ring_backward_single_rank_is_one_call(host_mesh, causal):
    """n = 1 through the mesh: bit for bit one backward call over the
    whole sequence, given one forward call's output and lse."""
    arrays = ring_inputs(64, 4, 2)
    dout = ring_dout(64, 4, 2)
    out, *got = _grads(lambda q, k, v: ra.ring_attention_sharded(
        q, k, v, host_mesh, causal=causal), arrays, dout)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    o, lse = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    assert torch.equal(out, o)
    want = flash_attention_bwd_plain(q, k, v, o, lse, torch.from_numpy(dout),
                                     causal=causal)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_accumulate_mode_from_zeros_is_default(dtype):
    """The plain backward's accumulate mode, into zeros, then rounded once
    to the inputs' type: the default output bit for bit; a second call
    adds its gradients to the first's."""
    q, k, v = (torch.from_numpy(a).to(dtype) for a in ring_inputs(64, 4, 2))
    o, lse = flash_attention_plain(q, k, v, return_lse=True)
    dout = torch.from_numpy(ring_dout(64, 4, 2)).to(dtype)
    want = flash_attention_bwd_plain(q, k, v, o, lse, dout)
    acc = tuple(torch.zeros(t.shape) for t in (q, k, v))
    got = flash_attention_bwd_plain(q, k, v, o, lse, dout, accumulate=acc)
    assert all(g is a for g, a in zip(got, acc))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g.to(dtype), w)
    once = [g.clone() for g in got]
    flash_attention_bwd_plain(q, k, v, o, lse, dout, accumulate=acc)
    for g, w in zip(acc, once):
        assert torch.equal(g, w + w)
    with pytest.raises(ValueError, match="accumulate's dq"):
        flash_attention_bwd_plain(q, k, v, o, lse, dout,
                                  accumulate=(acc[0].half(),) + acc[1:])


def _bf16_case():
    rng = np.random.default_rng(3)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(
        (1, 256, h, 32)).astype(np.float32)).to(torch.bfloat16)
        for h in (8, 2, 2, 8))
    return q, k, v, dout


def _ring_bf16(q, k, v, dout, causal, n=8):
    """(out, L, dq, dk, dv) of the in-process bf16 ring."""
    out, big_l = ra.ring_attention_shards(q, k, v, n, causal=causal,
                                          return_lse=True)
    _, *grads = _grads_t(lambda a, b, c: ra.ring_attention_shards(
        a, b, c, n, causal=causal), (q, k, v), dout)
    return (out, big_l, *grads)


def _grads_t(fn, tensors, dout):
    q, k, v = (t.clone().requires_grad_() for t in tensors)
    out = fn(q, k, v)
    return (out.detach(), *torch.autograd.grad(out, (q, k, v), dout))


@pytest.mark.parametrize("causal", [True, False])
def test_ring_backward_bf16_within_tolerance(causal, monkeypatch):
    """bf16 over 8 shards against one backward call over the whole
    sequence given the ring's (out, L): within ``ring_bwd_tolerance``
    (each side rounds the same f32 terms once, summed in another order);
    one step's dK/dV dropped, or the diagonal step's lse used for L, falls
    outside it."""
    q, k, v, dout = _bf16_case()
    out, big_l, *got = _ring_bf16(q, k, v, dout, causal)
    want = flash_attention_bwd_plain(q, k, v, out, big_l, dout,
                                     causal=causal)
    for g, w in zip(got, want):
        tol = ra.ring_bwd_tolerance(w, torch.bfloat16)
        assert float((g.float() - w.float()).abs().max()) <= tol
    tol_k = ra.ring_bwd_tolerance(want[1], torch.bfloat16)

    step_bwd = ra.ring_step_bwd

    def drop_one(q_, k_t, v_t, o, lse, do, idx, src, acc, causal=True):
        if (idx, src) == (5, 2):          # a step every mask keeps
            acc = (acc[0], torch.zeros_like(acc[1]),
                   torch.zeros_like(acc[2]))
        return step_bwd(q_, k_t, v_t, o, lse, do, idx, src, acc,
                        causal=causal)

    monkeypatch.setattr(ra, "ring_step_bwd", drop_one)
    _, _, _, dk_bad, _ = _ring_bf16(q, k, v, dout, causal)
    assert float((dk_bad.float() - want[1].float()).abs().max()) > tol_k
    monkeypatch.setattr(ra, "ring_step_bwd", step_bwd)

    merge = ra.ring_merge

    def partial_lse(parts, dtype):
        o, _ = merge(parts, dtype)
        return o, parts[0][1]

    monkeypatch.setattr(ra, "ring_merge", partial_lse)
    _, _, _, dk_bad, _ = _ring_bf16(q, k, v, dout, causal)
    assert float((dk_bad.float() - want[1].float()).abs().max()) > tol_k
