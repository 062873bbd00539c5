"""The device half of the UFC/RFC/HF counters in the port
(``repro_torch.core.counters.*_torch``) against the reference's numpy
versions and its jnp ones (``*_jax``), on the same inputs drawn from a
numpy seed: the counter updates (repeated clients add up), the HF scores
and the argmin-HF pick (-1 with no active client), all in f32 within
1e-6 relative; and ``build_batch_torch`` against ``build_batch_jax``
(equal admissions, kv_used within 1e-6) with its constraints checked:
at most ``max_batch`` admitted, no client past its queue, kv_used within
the budget and equal to the admitted requests' costs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import counters as J
from repro_torch.core import counters as T

REL = 1e-6


@pytest.mark.parametrize("seed", range(4))
def test_counter_updates_match_numpy_and_jnp(seed):
    rng = np.random.default_rng(seed)
    C = 6
    ufc = rng.random(C).astype(np.float32) * 100
    rfc = rng.random(C).astype(np.float32) * 50
    t_in, t_out, wait, ptime = (float(x) for x in rng.random(4) * 500)
    omega, delta, cached = 1.5, 0.1, t_in / 3
    for idx in (2, np.array([1, 4, 1])):
        want = J.ufc_update_jax(jnp.asarray(ufc), jnp.asarray(idx), t_in,
                                t_out, wait, ptime, omega, delta, cached, 0.5)
        got = T.ufc_update_torch(torch.from_numpy(ufc), idx, t_in, t_out,
                                 wait, ptime, omega, delta, cached, 0.5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=REL)
        want = J.rfc_update_jax(jnp.asarray(rfc), jnp.asarray(idx), 55.0,
                                0.9, omega)
        got = T.rfc_update_torch(torch.from_numpy(rfc), idx, 55.0, 0.9, omega)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=REL)
    # a scalar index against the host formula
    inc = J.ufc_increment(t_in, t_out, wait, ptime, omega, delta, cached, 0.5)
    got = T.ufc_update_torch(torch.zeros(C), 3, t_in, t_out, wait, ptime,
                             omega, delta, cached, 0.5)
    assert float(got[3]) == pytest.approx(inc, rel=REL)
    assert float(got.sum()) == pytest.approx(inc, rel=REL)
    got = T.rfc_update_torch(torch.zeros(C), 0, 55.0, 0.9, 2.0)
    assert float(got[0]) == pytest.approx(J.rfc_increment(55.0, 0.9, 2.0),
                                          rel=REL)


@pytest.mark.parametrize("seed", range(4))
def test_hf_and_selection_match_numpy_and_jnp(seed):
    rng = np.random.default_rng(10 + seed)
    C = 7
    ufc = (rng.random(C) * 1e3).astype(np.float32)
    rfc = (rng.random(C) * 1e2).astype(np.float32)
    active = rng.random(C) < 0.5
    tu, tr, ta = (torch.from_numpy(a) for a in (ufc, rfc, active))
    np.testing.assert_allclose(T.hf_scores_torch(tu, tr).numpy(),
                               J.hf_scores(ufc, rfc), rtol=REL)
    np.testing.assert_allclose(
        T.hf_scores_torch(tu, tr, 0.4, 0.6).numpy(),
        np.asarray(J.hf_scores_jax(jnp.asarray(ufc), jnp.asarray(rfc),
                                   0.4, 0.6)), rtol=REL)
    for mask in (active, np.zeros(C, bool), np.ones(C, bool)):
        got = T.select_min_hf_torch(tu, tr, torch.from_numpy(mask))
        assert got.ndim == 0
        assert int(got) == J.select_min_hf(ufc, rfc, mask) == int(
            J.select_min_hf_jax(jnp.asarray(ufc), jnp.asarray(rfc),
                                jnp.asarray(mask)))
    # Figure 5 of the paper: HF picks the latency-underserved client
    assert int(T.select_min_hf_torch(
        torch.tensor([700.0, 1000.0]), torch.tensor([1000.0, 200.0]),
        torch.tensor([True, True]))) == 1


@pytest.mark.parametrize("seed,max_batch,budget", [
    (0, 8, 5000.0), (1, 4, 1e9), (2, 16, 900.0), (3, 8, 0.0), (4, 32, 3000.0),
])
def test_build_batch_matches_jnp_and_holds_its_constraints(seed, max_batch,
                                                           budget):
    rng = np.random.default_rng(20 + seed)
    C = 5
    ufc = (rng.random(C) * 100).astype(np.float32)
    rfc = (rng.random(C) * 10).astype(np.float32)
    counts = rng.integers(0, 6, C).astype(np.int32)
    costs = rng.integers(50, 600, C).astype(np.float32)
    want_adm, want_kv = J.build_batch_jax(
        jnp.asarray(ufc), jnp.asarray(rfc), jnp.asarray(counts),
        jnp.asarray(costs), budget, max_batch)
    adm, kv = T.build_batch_torch(
        torch.from_numpy(ufc), torch.from_numpy(rfc),
        torch.from_numpy(counts), torch.from_numpy(costs), budget, max_batch)
    assert adm.dtype == torch.int32 and kv.dtype == torch.float32
    np.testing.assert_array_equal(adm.numpy(), np.asarray(want_adm))
    assert float(kv) == pytest.approx(float(want_kv), rel=REL)
    assert int(adm.sum()) <= max_batch
    assert (adm.numpy() <= counts).all()
    assert float(kv) <= budget
    assert float(kv) == pytest.approx(float((adm.numpy() * costs).sum()),
                                      rel=REL)


def test_build_batch_with_no_active_client():
    z = torch.zeros(4)
    adm, kv = T.build_batch_torch(z, z, torch.zeros(4, dtype=torch.int32),
                                  torch.ones(4), 100.0, 8)
    assert adm.tolist() == [0, 0, 0, 0] and float(kv) == 0.0
