"""The port's shared-prefix radix KV cache (``repro_torch.serving.
prefix_cache``, a numpy copy; DESIGN.md §9) and the engine that uses it:

- the radix-tree and ``PagePool`` unit and property tests of
  ``tests/test_prefix_cache.py``, run on the port's copies;
- the port's engine with ``prefix_cache=True`` (CPU, bridged smoke
  weights): first-token logits of prompts that resume from adopted pages
  equal the cold run's bit for bit, and the JAX engine's to 1e-4; the
  hit counts are the reference's; admissions, chunk plans, cached
  prefixes, TTFT and e2e latency equal the reference engine's and the
  port's simulator's."""
import dataclasses

import jax
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

from repro.configs import SMOKE_FACTORIES as J_SMOKE
from repro.core import Request as JRequest
from repro.core import make_scheduler as j_make_scheduler
from repro.models import init_params
from repro.serving.costmodel import A100_80G as J_A100
from repro.serving.costmodel import CostModel as JCM
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.telemetry import Observer as JObserver
from repro_torch.configs import SMOKE_FACTORIES, get_config
from repro_torch.core import Request, SimConfig, Simulator, make_scheduler
from repro_torch.serving.costmodel import A100_80G, CostModel
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_cache import PagePool
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.telemetry import Observer
from repro_torch.weights import params_from_numpy
from repro_torch.workloads.vocab import prompt_token_ids

PS = 4   # small pages keep the unit tests readable


def mk_cache(n_pages=64, page_size=PS):
    pool = PagePool(n_pages, page_size)
    return pool, PrefixCache(pool)


def mk_req(rid, tokens, output_len=4, client="c", arrival=0.0, cls=Request):
    tokens = np.asarray(tokens, np.int32)
    return cls(rid=rid, client=client, arrival=arrival,
               prompt_len=len(tokens), output_len=output_len,
               keywords=("chat",), prompt_tokens=tokens)


def publish(cache, req, now=0.0):
    """Admission + prefill-complete in one step (unit-test shorthand)."""
    req.cached_prefix = cache.lookup(req, now)
    cache.attach(req, now)
    cache.insert(req, now)


# -- radix tree semantics ------------------------------------------------------
def test_match_is_page_aligned_and_capped():
    _, cache = mk_cache()
    toks = list(range(100, 110))                     # 10 tokens, 2 full pages
    publish(cache, mk_req(0, toks))
    # identical prompt: the match is capped below prompt_len so the last
    # token is always recomputed
    assert cache.lookup(mk_req(1, toks[:8]), 1.0) == PS
    assert cache.lookup(mk_req(2, toks + [1, 2, 3]), 1.0) == 2 * PS


def test_match_stops_at_divergence_inside_page():
    _, cache = mk_cache()
    publish(cache, mk_req(0, [1, 2, 3, 4, 5, 6, 7, 8, 9]))
    assert cache.lookup(mk_req(1, [1, 2, 3, 4, 5, 99, 7, 8, 9]), 1.0) == PS
    assert cache.lookup(mk_req(2, [99, 2, 3, 4, 5, 6, 7, 8, 9]), 1.0) == 0


def test_insert_splits_edge_at_page_boundary():
    _, cache = mk_cache()
    a = list(range(1, 13))                           # 3 full pages
    publish(cache, mk_req(0, a))
    b = a[:8] + [50, 51, 52, 53, 54]                 # shares 2 pages, forks
    rb = mk_req(1, b)
    publish(cache, rb, now=1.0)
    assert rb.cached_prefix == 2 * PS
    assert cache.match_len(np.asarray(a, np.int32)) == 3 * PS
    assert cache.match_len(np.asarray(b, np.int32)) == 3 * PS


def test_partial_trailing_page_never_shared():
    _, cache = mk_cache()
    publish(cache, mk_req(0, list(range(1, 11))))    # 10 toks: 2 pages + 2
    r = mk_req(1, list(range(1, 11)) + [99] * 6)
    assert cache.lookup(r, 1.0) == 2 * PS


def test_refcount_sharing_and_release():
    pool, cache = mk_cache(n_pages=8)
    a = mk_req(0, list(range(1, 9)))                 # 2 full pages
    publish(cache, a)
    pages_a = list(pool.owned[0])
    b = mk_req(1, list(range(1, 9)) + [70, 71, 72, 73])
    b.cached_prefix = cache.lookup(b, 1.0)
    cache.attach(b, 1.0)
    assert b.cached_prefix == 2 * PS
    assert pool.owned[1][:2] == pages_a[:2]          # physically shared
    assert pool.refcount[pages_a[0]] == 2
    cache.release(a)
    assert pool.refcount[pages_a[0]] == 1
    cache.release(b)
    assert pool.refcount[pages_a[0]] == 0            # warm in the tree
    assert pages_a[0] not in pool.free


def test_eviction_lru_and_refcount_protection():
    pool, cache = mk_cache(n_pages=8)
    a = mk_req(0, list(range(1, 9)))
    publish(cache, a, now=0.0)
    b = mk_req(1, list(range(20, 28)))               # younger
    publish(cache, b, now=1.0)
    cache.release(b)
    pool.alloc(2, 4 * PS)          # consumes the free list, no eviction yet
    assert cache.match_len(np.asarray(list(range(20, 28)), np.int32)) == 2 * PS
    pool.alloc(3, PS)              # evicts b's refcount-0 pages, never a's
    assert cache.match_len(np.asarray(list(range(1, 9)), np.int32)) == 2 * PS
    assert cache.match_len(np.asarray(list(range(20, 28)), np.int32)) == 0
    with pytest.raises(MemoryError):
        pool.alloc(4, 3 * PS)
    cache.release(a)
    pool.alloc(4, 2 * PS)
    assert cache.match_len(np.asarray(list(range(1, 9)), np.int32)) == 0


def test_partially_adopted_leaf_evicts_its_free_tail():
    pool, cache = mk_cache(n_pages=2)
    a = mk_req(0, list(range(1, 9)))
    publish(cache, a)
    cache.release(a)
    b = mk_req(1, list(range(1, 9)))                 # identical prompt
    b.cached_prefix = cache.lookup(b, 1.0)           # cap -> adopts page 0
    cache.attach(b, 1.0)
    assert b.cached_prefix == PS
    assert pool.can_alloc(PS)
    assert len(pool.alloc(2, PS)) == 1               # evicts page 1
    assert cache.match_len(np.asarray(list(range(1, 9)), np.int32)) == PS
    assert pool.refcount[pool.owned[1][0]] == 1


def test_match_len_probe_is_side_effect_free():
    _, cache = mk_cache()
    toks = list(range(1, 9))
    publish(cache, mk_req(0, toks, output_len=2), now=5.0)
    node = next(iter(cache.root.children.values()))
    stamp = node.last_access
    assert cache.match_len(np.asarray(toks, np.int32)) == 2 * PS
    assert node.last_access == stamp


# -- property tests ------------------------------------------------------------
@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(1, 7), min_size=1, max_size=40),
       st.lists(st.integers(1, 7), min_size=1, max_size=40))
def test_radix_match_bounded_by_common_prefix(xs, ys):
    _, cache = mk_cache(n_pages=32)
    publish(cache, mk_req(0, xs))
    m = cache.match_len(np.asarray(ys, np.int32))
    common = 0
    for a, b in zip(xs, ys):
        if a != b:
            break
        common += 1
    assert m % PS == 0 and m <= common
    assert m >= min(common // PS, len(xs) // PS) * PS


@settings(max_examples=25, deadline=None)
@given(st.lists(st.tuples(st.lists(st.integers(1, 5), min_size=4,
                                   max_size=24),
                          st.booleans()),
                min_size=1, max_size=10))
def test_eviction_never_reclaims_referenced_pages(ops):
    pool, cache = mk_cache(n_pages=16)
    live = {}
    for rid, (toks, do_release) in enumerate(ops):
        req = mk_req(rid, toks)
        try:
            publish(cache, req)
        except MemoryError:
            continue
        live[rid] = req
        if do_release and live:
            cache.release(live.pop(next(iter(live))))
        cache.evict(2)
        held = {p for r in live.values() for p in pool.owned.get(r.rid, [])}
        assert held.isdisjoint(pool.free)
        assert all(pool.refcount[p] >= 1 for p in held)


# -- PagePool hardening --------------------------------------------------------
def test_double_free_and_adopt_of_dead_page_raise():
    pool = PagePool(8, PS)
    pool.alloc(0, 8)
    pool.free_request(0)
    with pytest.raises(ValueError, match="double free"):
        pool.free_request(0)
    with pytest.raises(ValueError):
        pool.free_request(42)                        # never allocated
    with pytest.raises(ValueError):
        PagePool(8, PS).adopt(1, [3])                # never allocated


def test_exhaustion_with_and_without_reclaimer():
    pool = PagePool(4, PS)
    pool.alloc(0, 4 * PS)
    assert not pool.can_alloc(1)
    with pytest.raises(MemoryError):
        pool.alloc(1, PS)
    pool.reclaimer = lambda n: 0     # frees nothing: must not mask the error
    with pytest.raises(MemoryError):
        pool.alloc(1, PS)


def test_can_alloc_counts_evictable_cached_pages():
    pool, cache = mk_cache(n_pages=4)
    req = mk_req(0, list(range(1, 1 + 4 * PS)))      # fills the pool
    publish(cache, req)
    cache.release(req)
    assert len(pool.free) == 0
    assert pool.can_alloc(2 * PS)
    pool.alloc(1, 2 * PS)                            # triggers eviction


def test_block_table_and_used_pages():
    pool = PagePool(8, PS)
    pool.alloc(5, 3 * PS)
    bt = pool.block_table([5], width=6)
    assert bt.shape == (1, 6) and (bt[0, 3:] == 0).all()
    narrow = pool.block_table([5], width=2)
    assert narrow.shape == (1, 2) and list(narrow[0]) == pool.owned[5][:2]
    pool = PagePool(16, PS)
    pool.alloc(0, 3 * PS)
    pool.alloc(1, 2 * PS)
    pool.free_request(0)
    pool.alloc(2, 5 * PS)
    pool.extend(2, 5 * PS, 6 * PS)
    pool.free_request(1)
    assert pool.used_pages == 6
    owned = [p for pages in pool.owned.values() for p in pages]
    assert len(set(owned)) == len(owned) and set(owned).isdisjoint(pool.free)
    pool.free_request(2)
    assert pool.used_pages == 0


# -- the engine: warm against cold, port against reference --------------------
@pytest.fixture(scope="module")
def weights():
    params = init_params(jax.random.key(7), J_SMOKE["llama2-7b"]())
    return params, params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def warm_cold_requests(cls):
    sys_toks = prompt_token_ids(("system", "sys0"), 32, seed=10_000)

    def mk(rid, seed, plen, arrival):
        toks = np.concatenate([
            sys_toks, prompt_token_ids(("chat",), plen - 32, seed=seed)])
        return mk_req(rid, toks, output_len=4, arrival=arrival, cls=cls)

    return [mk(0, 1, 48, 0.0), mk(1, 2, 56, 0.5), mk(2, 3, 48, 1.0)]


@pytest.fixture(scope="module")
def warm_cold(weights):
    """The reference test's three requests sharing a 32-token system
    prompt, on the port's engine cold and warm and the JAX engine warm."""
    jp, tp = weights
    out = {}
    for side, cache in (("torch", False), ("torch", True), ("jax", True)):
        kw = dict(max_slots=4, max_len=96, backend="paged", chunked=True,
                  prefill_chunk_tokens=16, prefix_cache=cache,
                  keep_first_logits=True)
        if side == "torch":
            eng = ServingEngine(SMOKE_FACTORIES["llama2-7b"](),
                                make_scheduler("fcfs"), params=tp,
                                device="cpu", **kw)
            reqs = warm_cold_requests(Request)
        else:
            eng = JEngine(J_SMOKE["llama2-7b"](), j_make_scheduler("fcfs"),
                          params=jp, **kw)
            reqs = warm_cold_requests(JRequest)
        done = eng.run(reqs)
        out[side, cache] = ({r.rid: r for r in done},
                            eng.core.prefix_cache.stats if cache else None)
    return out


def test_cached_prefill_logits_equal_cold(warm_cold):
    """Prefill resuming from shared cached pages gives the same logits
    bits as a cold prefill: page sharing changes where KV lives, not what
    attention computes (the CPU's plain paged attention sums each score
    over D alike whatever rows share the launch)."""
    warm, _ = warm_cold["torch", True]
    cold, _ = warm_cold["torch", False]
    assert warm[1].cached_prefix == 32 and warm[2].cached_prefix == 32
    for rid in (0, 1, 2):
        np.testing.assert_array_equal(warm[rid]._first_row,
                                      cold[rid]._first_row)


def test_warm_rows_and_hits_match_reference(warm_cold):
    warm, stats = warm_cold["torch", True]
    j_warm, j_stats = warm_cold["jax", True]
    for rid in (0, 1, 2):
        assert warm[rid].cached_prefix == j_warm[rid].cached_prefix
        np.testing.assert_allclose(warm[rid]._first_row,
                                   j_warm[rid]._first_row, atol=1e-4,
                                   rtol=1e-4)
    assert stats.hits == j_stats.hits == 2
    assert stats.hit_tokens == j_stats.hit_tokens == 64
    assert 0 < stats.hit_rate() == j_stats.hit_rate() < 1


def spy_class(base):
    class Spy(base):
        def __init__(self):
            self.order, self.chunks = [], []

        def on_admit(self, r, now):
            self.order.append(r.rid)

        def on_prefill_chunk(self, r, c):
            self.chunks.append((r.rid, c))
    return Spy


def parity_trace(cls):
    sys_toks = prompt_token_ids(("system", "sys0"), 32, seed=10_000)
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(10):
        plen = int(rng.integers(40, 60))
        toks = np.concatenate([sys_toks,
                               prompt_token_ids(("chat",), plen - 32, seed=i)])
        reqs.append(cls(rid=i, client=f"client{i % 2}", arrival=0.2 * i,
                        prompt_len=plen, output_len=int(rng.integers(4, 10)),
                        keywords=("chat",), prompt_tokens=toks))
    return reqs


def test_parity_admissions_chunks_ttft_with_cache(weights):
    """tests/test_prefix_cache.py's parity trace with the cache on: the
    port's engine, the reference engine and the port's simulator make
    the same admissions, chunk plans and cached-prefix decisions, with
    the same TTFT and e2e latency."""
    jp, tp = weights
    kw = dict(max_slots=4, max_len=96, kv_budget_tokens=2000, chunked=True,
              prefill_chunk_tokens=16, backend="paged", prefix_cache=True)
    t_spy, j_spy, s_spy = (spy_class(Observer)(), spy_class(JObserver)(),
                           spy_class(Observer)())
    cm = CostModel(get_config("llama2-7b"), A100_80G)
    port = ServingEngine(SMOKE_FACTORIES["llama2-7b"](),
                         make_scheduler("fcfs"), params=tp, cost_model=cm,
                         observer=t_spy, device="cpu", **kw).run(
        parity_trace(Request))
    ref = JEngine(J_SMOKE["llama2-7b"](), j_make_scheduler("fcfs"),
                  params=jp, cost_model=JCM(get_config("llama2-7b"), J_A100),
                  observer=j_spy, **kw).run(parity_trace(JRequest))
    sim = Simulator(cm, make_scheduler("fcfs"),
                    SimConfig(max_batch=4, kv_budget_tokens=2000,
                              default_reserve=128, prefill_chunk=16,
                              prefix_cache=True, page_size=16),
                    observer=s_spy).run(parity_trace(Request)).requests
    assert len(port) == len(ref) == 10
    assert t_spy.order == j_spy.order == s_spy.order
    assert t_spy.chunks == j_spy.chunks == s_spy.chunks
    for other in (ref, sim):
        o = {r.rid: r for r in other}
        for r in port:
            assert r.cached_prefix == o[r.rid].cached_prefix
            assert r.ttft() == pytest.approx(o[r.rid].ttft(), abs=1e-9)
            assert r.e2e_latency() == pytest.approx(o[r.rid].e2e_latency(),
                                                    abs=1e-9)
    assert sum(r.cached_prefix for r in port) > 0


def test_sim_cache_cuts_ttft_at_equal_throughput():
    """The port's simulator: the cache cuts p50 TTFT on the multiturn
    trace at no throughput loss (tests/test_prefix_cache.py's claim)."""
    from repro_torch.workloads import multiturn_sharegpt_like

    cm = CostModel(get_config("llama2-7b"), A100_80G)
    trace = multiturn_sharegpt_like(n_clients=4, n_conversations=2, seed=0)
    stats = {}
    for cache in (False, True):
        res = Simulator(cm, make_scheduler("vtc"),
                        SimConfig(max_batch=16, kv_budget_tokens=60_000,
                                  prefix_cache=cache)).run(
            [dataclasses.replace(r) for r in trace])
        assert all(r.state == "finished" for r in res.requests)
        stats[cache] = (float(np.percentile(res.ttfts(), 50)),
                        res.throughput_tokens_per_s())
    assert stats[True][0] < 0.8 * stats[False][0]
    assert stats[True][1] >= 0.999 * stats[False][1]
