"""Ring flash attention in the port (``repro_torch.models.ring_attention``)
against the reference's ``naive_attention`` (f32, CPU, 1e-5: the bound
the reference's own ring test holds itself to):

- n = 1 in this process: ``ring_attention_sharded`` on a world-size-1
  gloo host mesh;
- four gloo ranks (one process each, a ``FileStore``: no network) at the
  reference's three cases, (64, 4, 2, causal), (128, 8, 8, causal) and
  (64, 4, 4, full), head dim 16; every rank's ring equals
  ``ring_attention_shards`` over four shards in one process, bit for bit,
  and so does its gradient (at ``ring_dout``): each rank's dq, dk and dv
  of its own chunk, zeros elsewhere (``tests/test_torch_ring_backward.py``
  holds the in-process gradient to the reference's);
- the ring's steps and merge over 2, 4 and 8 shards in one process, and
  the ring's plain version (the reference's (m, l, acc) arithmetic);
- bf16: the ring over 8 shards within ``ring_tolerance`` of one flash call
  over the whole sequence and of the f32 plain ring (each step's output
  rounded once, as the kernel writes it)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.models.attention import naive_attention
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models.ring_attention import (ring_attention_plain,
                                               ring_attention_shards,
                                               ring_attention_sharded,
                                               ring_merge, ring_order,
                                               ring_step, ring_tolerance)

from _torch_dist_ranks import RING_CASES, ring_inputs, run_ranks

TOL = 1e-5


def _naive(q, k, v, causal):
    return np.asarray(naive_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                      causal=causal))


@pytest.fixture
def host_mesh():
    from repro_torch.launch.mesh import make_host_mesh

    assert not dist.is_initialized()
    mesh = make_host_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_ring_single_device_degenerate(host_mesh):
    """n = 1 ring == plain attention, and == one flash call bit for bit
    (one partial comes back as it went in)."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, 32, 4, 8)).astype(np.float32)
    k = rng.standard_normal((1, 32, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, 32, 2, 8)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = ring_attention_sharded(tq, tk, tv, host_mesh, causal=True)
    np.testing.assert_allclose(out.numpy(), _naive(q, k, v, True), atol=TOL)
    assert torch.equal(out, flash_attention_plain(tq, tk, tv, causal=True))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Rank 0's arrays, and each rank's gradients as ``rank<r>_<name>``."""
    out = run_ranks("ring", 4, tmp_path_factory.mktemp("ring"))
    saved = dict(np.load(out))
    for r in range(4):
        saved.update({f"rank{r}_{k}": v for k, v in
                      np.load(f"{out}.rank{r}.npz").items()})
    return saved


@pytest.mark.parametrize("case", range(len(RING_CASES)),
                         ids=[f"S{c[0]}_H{c[1]}_{c[2]}_"
                              f"{'causal' if c[3] else 'full'}"
                              for c in RING_CASES])
def test_ring_matches_naive_4ranks(four_ranks, case):
    S, Hq, Hkv, causal = RING_CASES[case]
    q, k, v = ring_inputs(S, Hq, Hkv)
    out = four_ranks[f"ring{case}"]
    err = float(np.abs(out - _naive(q, k, v, causal)).max())
    assert err < TOL, err
    assert np.array_equal(out, four_ranks[f"shards{case}"])


@pytest.mark.parametrize("case", range(len(RING_CASES)),
                         ids=[f"S{c[0]}_H{c[1]}_{c[2]}_"
                              f"{'causal' if c[3] else 'full'}"
                              for c in RING_CASES])
def test_ring_backward_4ranks_is_in_process(four_ranks, case):
    """Each rank's gradient of ``ring_attention_sharded`` reaches its own
    chunk of the global q, k, v only, and equals the in-process
    backward's there bit for bit."""
    S = RING_CASES[case][0]
    s = S // 4
    for r in range(4):
        for name in ("dq", "dk", "dv"):
            got = four_ranks[f"rank{r}_{name}{case}"]
            want = four_ranks[f"shards_{name}{case}"]
            assert np.array_equal(got[:, r * s:(r + 1) * s],
                                  want[:, r * s:(r + 1) * s]), (r, name)
            rest = np.delete(got, np.s_[r * s:(r + 1) * s], axis=1)
            assert not rest.any(), (r, name)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("case", range(len(RING_CASES)))
def test_ring_shards_in_process(case, n):
    S, Hq, Hkv, causal = RING_CASES[case]
    q, k, v = ring_inputs(S, Hq, Hkv)
    ref = _naive(q, k, v, causal)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = ring_attention_shards(tq, tk, tv, n, causal=causal)
    assert float(np.abs(out.numpy() - ref).max()) < TOL
    plain = ring_attention_plain(tq, tk, tv, n, causal=causal)
    assert float(np.abs(plain.numpy() - ref).max()) < TOL


def test_ring_steps_skip_later_shards():
    """Under causal a rank takes n - idx shards' partials in ring order
    (the diagonal first, causal; the earlier ones full); without it all
    n."""
    q, k, v = (torch.from_numpy(a) for a in ring_inputs(16, 2, 1))
    n = 4
    for idx in range(n):
        order = ring_order(idx, n)
        assert order[0] == idx
        parts = [ring_step(q[:, :4], k[:, :4], v[:, :4], idx, src)
                 for src in order]
        assert sum(p is not None for p in parts) == idx + 1
        full = [ring_step(q[:, :4], k[:, :4], v[:, :4], idx, src,
                          causal=False) for src in order]
        assert all(p is not None for p in full)
    o, lse = ring_step(q[:, :4], k[:, :4], v[:, :4], 0, 0)
    out, big_l = ring_merge([(o, lse)], q.dtype)
    assert torch.equal(out, o) and torch.equal(big_l, lse)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_bf16_within_tolerance(causal):
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 256, h, 32)).astype(np.float32)).to(torch.bfloat16)
        for h in (8, 2, 2))
    ring = ring_attention_shards(q, k, v, 8, causal=causal).float()
    single = flash_attention_plain(q, k, v, causal=causal).float()
    plain = ring_attention_plain(q, k, v, 8, causal=causal)
    tol = ring_tolerance(v, torch.bfloat16)
    assert float((ring - single).abs().max()) <= tol
    assert float((ring - plain).abs().max()) <= tol
    # the rounding of each step's partial shows: not the single call's bits
    assert not torch.equal(ring, single)
