"""The paper's synthetic workload scenarios (§7.2 and Appendix A).

Every generator returns a list of ``Request`` sorted by arrival time.
Prompts are synthetic: each request carries a small keyword tuple (an
"intent" plus filler words) from which the predictor extracts features;
the ground-truth output length is scenario-controlled.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.request import Request, set_slo

_FILLER = ("please", "could", "explain", "about", "with", "using", "the",
           "details", "help", "me")


def _mk_requests(rng, client, rate, duration, in_len, out_len, *, start=0.0,
                 poisson=False, rid_offset=0, keywords=("chat",),
                 weight=1.0):
    """Deterministic (1/rate spacing) or Poisson arrivals for one client."""
    reqs = []
    t = start
    rid = rid_offset
    while t < start + duration:
        if poisson:
            t += rng.exponential(1.0 / rate)
        else:
            t += 1.0 / rate
        if t >= start + duration:
            break
        kw = keywords + tuple(rng.choice(_FILLER, size=2))
        out = int(max(1, rng.normal(out_len, out_len * 0.05))) \
            if poisson else out_len
        reqs.append(Request(rid=rid, client=client, arrival=t,
                            prompt_len=in_len, output_len=out,
                            keywords=kw, weight=weight))
        rid += 1
    return reqs


def balanced(duration=60.0, seed=0):
    """§7.2.1: client1 2 req/s (100 in / 400 out); client2 1 req/s
    (100 in / 900 out)."""
    rng = np.random.default_rng(seed)
    r1 = _mk_requests(rng, "client1", 2.0, duration, 100, 400,
                      keywords=("chat",))
    r2 = _mk_requests(rng, "client2", 1.0, duration, 100, 900,
                      rid_offset=10_000, keywords=("story",))
    return sorted(r1 + r2, key=lambda r: r.arrival)


def stochastic(duration=60.0, seed=0):
    """§7.2.2: Poisson arrivals; client1 16 req/s prefill-heavy (512/32);
    client2 3 req/s decode-heavy (32/512)."""
    rng = np.random.default_rng(seed)
    r1 = _mk_requests(rng, "client1", 16.0, duration, 512, 32, poisson=True,
                      keywords=("summarize",))
    r2 = _mk_requests(rng, "client2", 3.0, duration, 32, 512, poisson=True,
                      rid_offset=10_000, keywords=("story",))
    return sorted(r1 + r2, key=lambda r: r.arrival)


def overload(duration=60.0, seed=0):
    """Appendix A: constant extreme overload; client1 20 req/s (20/180);
    client2 2 req/s (200/1800)."""
    rng = np.random.default_rng(seed)
    r1 = _mk_requests(rng, "client1", 20.0, duration, 20, 180,
                      keywords=("qa",))
    r2 = _mk_requests(rng, "client2", 2.0, duration, 200, 1800,
                      rid_offset=100_000, keywords=("story",))
    return sorted(r1 + r2, key=lambda r: r.arrival)


def dynamic(duration=60.0, seed=0):
    """Appendix A: client1 constant 1 req/s (100/400); client2 steps from
    1 req/s to 4 req/s halfway."""
    rng = np.random.default_rng(seed)
    r1 = _mk_requests(rng, "client1", 1.0, duration, 100, 400,
                      keywords=("chat",))
    r2a = _mk_requests(rng, "client2", 1.0, duration / 2, 100, 400,
                       rid_offset=10_000, keywords=("chat",))
    r2b = _mk_requests(rng, "client2", 4.0, duration / 2, 100, 400,
                       start=duration / 2, rid_offset=20_000,
                       keywords=("chat",))
    return sorted(r1 + r2a + r2b, key=lambda r: r.arrival)


def zipf_scale(n_clients=10_000, n_requests=200_000, duration=4000.0,
               seed=0, alpha=1.05, burst=24, prompt_rng=(16, 64),
               out_rng=(48, 160)):
    """Provider-scale trace (DESIGN.md §15): ``n_requests`` short chat
    requests from ``n_clients`` accounts whose popularity follows a
    bounded Zipf law (rank-r client weight ∝ r^-alpha — the long tail a
    real multi-tenant endpoint sees), arriving in bursts of ``burst``
    *distinct* clients so the batch repeatedly settles into the steady
    all-decode state the macro-stepper exploits.

    Built entirely with vectorized numpy draws — constructing the
    ``Request`` objects is the only Python-rate loop — so generating a
    10⁴-client / 2·10⁵-request trace costs seconds, not minutes.
    Deterministic for a given seed (``benchmarks/sim_scale.py`` relies
    on this for the run-twice determinism pin)."""
    rng = np.random.default_rng(seed)
    n_bursts = -(-n_requests // burst)          # ceil
    burst_t = np.sort(rng.uniform(0.0, duration, size=n_bursts))
    # bounded Zipf over client ranks; per-burst weighted sampling
    # *without replacement* by the exponential-race (Gumbel top-k)
    # trick, vectorized across a chunk of bursts at a time
    w = np.arange(1, n_clients + 1, dtype=np.float64) ** -alpha
    prompts = rng.integers(prompt_rng[0], prompt_rng[1] + 1,
                           size=n_requests)
    outs = rng.integers(out_rng[0], out_rng[1] + 1, size=n_requests)
    jitter = rng.uniform(0.0, 1e-3, size=n_requests)
    clients = np.empty((n_bursts, burst), dtype=np.int64)
    chunk = max(1, (1 << 22) // n_clients)      # ~32 MB of keys at once
    for c0 in range(0, n_bursts, chunk):
        c1 = min(c0 + chunk, n_bursts)
        keys = rng.exponential(size=(c1 - c0, n_clients)) / w
        clients[c0:c1] = np.argpartition(keys, burst, axis=1)[:, :burst]
    reqs = []
    for b in range(n_bursts):
        lo = b * burst
        hi = min(lo + burst, n_requests)
        t0 = burst_t[b]
        for j, rid in enumerate(range(lo, hi)):
            reqs.append(Request(
                rid=rid, client=f"acct{clients[b, j]:05d}",
                arrival=float(t0 + jitter[rid]),
                prompt_len=int(prompts[rid]), output_len=int(outs[rid]),
                keywords=("chat",)))
    return sorted(reqs, key=lambda r: (r.arrival, r.rid))


SCENARIOS = {"balanced": balanced, "stochastic": stochastic,
             "overload": overload, "dynamic": dynamic}


# -- SLO-classed workloads (DESIGN.md §12) ------------------------------------
def tag_slo_classes(reqs, interactive_frac: float = 0.5):
    """Deterministically split a trace's clients into ``interactive``
    and ``batch`` SLO classes (class targets from
    ``repro_torch.core.request.SLO_CLASSES``), in place.

    Clients are sorted by name and interactive slots are spread evenly
    across that order (not a prefix slice — ``client0..clientN`` sorts
    lexicographically and a prefix would correlate class with the
    generator's client index).  Tagging is per-*client*: a client's
    whole stream shares one QoS contract, matching how serving tiers
    are sold.  Returns ``reqs`` for chaining."""
    if not 0.0 <= interactive_frac <= 1.0:
        raise ValueError(f"interactive_frac must be in [0, 1], got "
                         f"{interactive_frac}")
    clients = sorted({r.client for r in reqs})
    n_inter = int(round(len(clients) * interactive_frac))
    inter = {c for i, c in enumerate(clients)
             if ((i + 1) * n_inter) // len(clients)
             > (i * n_inter) // len(clients)}
    for r in reqs:
        set_slo(r, "interactive" if r.client in inter else "batch")
    return reqs


def diurnal(duration=90.0, seed=0, n_interactive=6, n_batch=2,
            base_rate=0.5, peak_mult=6.0, period=45.0,
            batch_rate=0.3, batch_in=7000, batch_out=64):
    """Bursty diurnal trace (DESIGN.md §12): ``n_interactive`` chat/QA
    clients whose arrival rate follows a day/night sinusoid — each
    client's rate swings from ``base_rate`` req/s in the trough to
    ``base_rate * peak_mult`` at the peak of every ``period``-second
    cycle (nonhomogeneous Poisson, sampled by thinning) — sharing the
    machine with ``n_batch`` batch-class clients submitting
    long-*input* summarization jobs (``batch_in`` prompt tokens,
    ``batch_out`` output tokens) at a constant ``batch_rate``.  The mix
    is built to expose the static prefill budget: chunking a
    ``batch_in``-token prompt at 512 tokens/iteration stretches ~14
    consecutive iterations past the interactive 40 ms TBT target —
    long enough to blanket a short chat decode end to end — while the
    SLO-auto budget shrinks chunks under interactive decodes and blasts
    cap-size chunks in the windows without them.  Requests arrive
    pre-tagged with their SLO class."""
    rng = np.random.default_rng(seed)
    reqs, rid = [], 0
    rate_max = base_rate * peak_mult
    for ci in range(n_interactive):
        t = 0.0
        while True:
            t += rng.exponential(1.0 / rate_max)
            if t >= duration:
                break
            phase = 0.5 * (1.0 - np.cos(2.0 * np.pi * t / period))
            rate = base_rate * (1.0 + (peak_mult - 1.0) * phase)
            if rng.random() * rate_max > rate:      # thinned out
                continue
            kw = ("qa",) + tuple(rng.choice(_FILLER, size=2))
            reqs.append(set_slo(Request(
                rid=rid, client=f"inter{ci}", arrival=float(t),
                prompt_len=int(rng.integers(24, 96)),
                output_len=int(rng.integers(24, 80)), keywords=kw),
                "interactive"))
            rid += 1
    for ci in range(n_batch):
        jobs = _mk_requests(rng, f"batch{ci}", batch_rate, duration,
                            batch_in, batch_out, poisson=True,
                            rid_offset=100_000 + 10_000 * ci,
                            keywords=("summarize",))
        for r in jobs:
            set_slo(r, "batch")
        reqs += jobs
    return sorted(reqs, key=lambda r: (r.arrival, r.rid))
