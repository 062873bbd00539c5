"""Model-based test of the port's radix KV cache, in lockstep with the
reference's.

The stateful harness of ``tests/test_prefix_cache_model.py``, with the
reference ``repro.serving.prefix_cache`` as the model: every random
``publish`` / ``adopt`` / ``probe`` / ``free`` / ``evict`` is applied to
a (PagePool, PrefixCache) pair of each package, and after every
operation the two must agree on what it returned (match lengths, cached
prefixes, evicted pages) and on every observable piece of state (block
tables, refcounts, free list, cached set, adopted pages, pinned pages,
hit statistics).  The port's pool is also checked for its invariants:
refcounts equal live block-table references, free and live pages
partition the pool, cached pages are never free.

Two loops feed the checker: a hypothesis stateful machine and a
seeded random walk; a seeded divergence shows that the checker trips."""
import numpy as np
import pytest
from _hypothesis_compat import (HAVE_HYPOTHESIS, RuleBasedStateMachine,
                                invariant, rule, run_state_machine_as_test,
                                st)

from repro.core import Request as JRequest
from repro.serving.kv_cache import PagePool as JPagePool
from repro.serving.prefix_cache import PrefixCache as JPrefixCache
from repro_torch.core import Request as TRequest
from repro_torch.serving.kv_cache import PagePool as TPagePool
from repro_torch.serving.prefix_cache import PrefixCache as TPrefixCache

PS = 4          # page size: small enough that splits and caps happen often
N_PAGES = 48    # small enough that eviction pressure is reachable


class Lockstep:
    """The reference's and the port's radix caches driven alike."""

    def __init__(self, n_pages=N_PAGES, page_size=PS):
        self.sides = []
        for pool_cls, cache_cls, req_cls in (
                (JPagePool, JPrefixCache, JRequest),
                (TPagePool, TPrefixCache, TRequest)):
            pool = pool_cls(n_pages, page_size)
            self.sides.append((pool, cache_cls(pool), req_cls))
        self.now = 0.0
        self.next_rid = 0
        self.live = []               # rids of requests holding pages
        self.published = []          # token lists, for conversation turns

    def _both(self, fn):
        """fn(pool, cache, req_cls) on both sides; their results must be
        equal (a raised MemoryError counts as a result)."""
        out = []
        for side in self.sides:
            try:
                out.append(("ok", fn(*side)))
            except MemoryError:
                out.append(("MemoryError", None))
        assert out[0] == out[1], out
        return out[1]

    def _admit(self, tokens, publish):
        rid = self.next_rid
        self.next_rid += 1
        self.now += 1.0
        now = self.now
        toks = np.asarray(tokens, np.int32)

        def go(pool, cache, req_cls):
            req = req_cls(rid=rid, client="c", arrival=0.0,
                          prompt_len=len(toks), output_len=2,
                          keywords=("chat",), prompt_tokens=toks)
            req.cached_prefix = cache.lookup(req, now)
            cache.attach(req, now)
            if publish:
                cache.insert(req, now)
            return req.cached_prefix, list(pool.owned.get(rid, []))

        status, _ = self._both(go)
        if status == "ok":
            self.live.append(rid)
            if publish:
                self.published.append(list(tokens))
        self.check()

    def publish(self, tokens):
        self._admit(tokens, True)

    def adopt(self, tokens):
        self._admit(tokens, False)

    def probe(self, tokens):
        toks = np.asarray(tokens, np.int32)
        self._both(lambda pool, cache, _: cache.match_len(toks))
        self.check()

    def free(self, idx):
        if not self.live:
            return
        rid = self.live.pop(idx % len(self.live))

        def go(pool, cache, _):
            if rid in pool.owned:
                pool.free_request(rid)
        self._both(go)
        self.check()

    def evict(self, n):
        self._both(lambda pool, cache, _: cache.evict(n))
        self.check()

    def state(self, pool, cache):
        s = cache.stats
        return {"owned": {r: list(p) for r, p in pool.owned.items()},
                "refcount": dict(pool.refcount), "free": list(pool.free),
                "cached": sorted(pool.cached),
                "adopted": {r: sorted(p) for r, p in pool.adopted.items()},
                "pinned": pool.pinned_unaccounted_pages(),
                "evictable": pool.evictable_pages(),
                "stats": (s.lookups, s.hits, s.hit_tokens),
                "matches": [cache.match_len(np.asarray(t, np.int32))
                            for t in self.published]}

    def check(self):
        (jp, jc, _), (tp, tc, _) = self.sides
        assert self.state(tp, tc) == self.state(jp, jc)
        # the port's pool: refcounts are live block-table references
        counts = {}
        for rid, pages in tp.owned.items():
            assert len(set(pages)) == len(pages), f"rid {rid} dup pages"
            for p in pages:
                counts[p] = counts.get(p, 0) + 1
        for p, rc in tp.refcount.items():
            assert rc == counts.get(p, 0), (p, rc, counts.get(p, 0))
        assert set(counts) <= set(tp.refcount)
        assert set(tp.free).isdisjoint(tp.refcount)
        assert len(tp.free) + len(tp.refcount) == tp.n_pages
        assert tp.cached <= set(tp.refcount)


TOKENS = st.lists(st.integers(1, 5), min_size=1, max_size=28)


class LockstepMachine(RuleBasedStateMachine):
    def __init__(self):
        super().__init__()
        self.m = Lockstep()

    @rule(toks=TOKENS)
    def publish(self, toks):
        self.m.publish(toks)

    @rule(toks=TOKENS)
    def adopt(self, toks):
        self.m.adopt(toks)

    @rule(toks=TOKENS)
    def probe(self, toks):
        self.m.probe(toks)

    @rule(idx=st.integers(0, 31))
    def free(self, idx):
        self.m.free(idx)

    @rule(n=st.integers(1, 8))
    def evict(self, n):
        self.m.evict(n)

    @invariant()
    def consistent(self):
        self.m.check()


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
def test_lockstep_stateful():
    from hypothesis import settings as hsettings
    run_state_machine_as_test(
        LockstepMachine,
        settings=hsettings(max_examples=30, stateful_step_count=30,
                           deadline=None))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lockstep_random_walk(seed):
    rng = np.random.default_rng(seed)
    m = Lockstep()
    # a small alphabet and extensions of published prompts (conversation
    # turns) make shared prefixes, edge splits and eviction likely
    for _ in range(250):
        op = rng.choice(["publish", "adopt", "probe", "free", "evict"],
                        p=[0.35, 0.15, 0.25, 0.15, 0.10])
        if op in ("publish", "adopt", "probe"):
            if m.published and rng.random() < 0.5:
                base = m.published[rng.integers(len(m.published))]
                toks = list(base[:int(rng.integers(1, len(base) + 1))])
                toks += [int(t) for t in
                         rng.integers(1, 6, size=int(rng.integers(0, 12)))]
            else:
                toks = [int(t) for t in
                        rng.integers(1, 6, size=int(rng.integers(1, 29)))]
            getattr(m, op)(toks)
        elif op == "free":
            m.free(int(rng.integers(0, 32)))
        else:
            m.evict(int(rng.integers(1, 9)))
    # the walk reached hits and eviction
    pool, cache, _ = m.sides[1]
    assert m.published and cache.stats.hits > 0
    assert cache.stats.lookups > cache.stats.hits


def test_lockstep_detects_seeded_divergence():
    """The checker trips when the port's state drifts from the
    reference's: one page moved from the port's free list."""
    m = Lockstep()
    m.publish(list(range(1, 13)))
    pool = m.sides[1][0]
    pool.free.insert(0, pool.free.pop())
    with pytest.raises(AssertionError):
        m.check()
