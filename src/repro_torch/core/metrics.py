"""Policy-independent fairness measurement.

The paper evaluates every scheduler on the *same* yardstick: Jain's
index over per-client Holistic Fairness values (§7.1), and the
max/avg/var of the accumulated weighted-service difference (Table 1).
``HFObserver`` tracks UFC/RFC from *observed* request metrics (not
predictions) for whatever policy is running, so FCFS / VTC / Equinox are
scored identically — this is how Fig. 13 can conclude that VTC's HF-based
fairness is no better than FCFS's.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core import counters as C
from repro_torch.core.request import Request
from repro_torch.serving.telemetry import Observer


class HFObserver(Observer):
    """Accumulates UFC/RFC per fairness account (``Request.account`` —
    the session name for flat traces, user@app for interactions,
    DESIGN.md §13) from actual post-execution metrics."""

    def __init__(self, params: C.HFParams = C.HFParams()):
        self.p = params
        self.ufc: Dict[str, float] = {}
        self.rfc: Dict[str, float] = {}

    def on_admit(self, req: Request, now: float):
        self.ufc.setdefault(req.account, 0.0)
        self.rfc.setdefault(req.account, 0.0)

    def on_complete(self, req: Request, now: float, *, latency: float,
                    tps: float, util: float):
        """``latency`` is GPU execution time (queue wait excluded)."""
        wait = max((req.admit_time or req.arrival) - req.arrival, 0.0)
        self.ufc[req.account] = self.ufc.get(req.account, 0.0) \
            + C.ufc_increment(req.prompt_len, req.generated, wait, latency,
                              req.weight, self.p.delta)
        self.rfc[req.account] = self.rfc.get(req.account, 0.0) \
            + C.rfc_increment(tps, util, req.weight)

    def hf(self) -> Dict[str, float]:
        clients = sorted(self.ufc)
        if not clients:
            return {}
        ufc = np.array([self.ufc[c] for c in clients])
        rfc = np.array([self.rfc[c] for c in clients])
        hf = C.hf_scores(ufc, rfc, self.p.alpha, self.p.beta)
        return dict(zip(clients, hf))

    def jain_index(self) -> float:
        return jain(list(self.hf().values()))


def jain(xs) -> float:
    """Jain's index over non-NaN scores.  Empty or all-zero input means
    no client got *differential* treatment — return the perfectly-fair
    1.0 rather than 0/0 (a fully-throttled run is uniformly bad, not
    unfair)."""
    xs = np.asarray([x for x in xs if np.isfinite(x)], float)
    if len(xs) == 0 or np.all(xs == 0):
        return 1.0
    return float(xs.sum() ** 2 / (len(xs) * np.sum(xs ** 2)))


def delivered_jain(requests) -> float:
    """Jain over *delivered* weighted tokens per fairness account
    (DESIGN.md §13).  Unlike ``SimResult.jain_index`` (which drops
    zero-score clients), every account that showed up is a population
    member: throttled or starved accounts contribute an explicit 0 —
    the starvation convention — so admission control cannot
    improve its Jain by rejecting whole accounts."""
    delivered: Dict[str, float] = {}
    for r in requests:
        delivered.setdefault(r.account, 0.0)
        if r.state == "finished":
            delivered[r.account] += (r.prompt_len
                                     + C.OUT_TOKEN_WEIGHT * r.generated)
    return jain(list(delivered.values()))


def service_difference_stats(result, c1: str, c2: str,
                             settle: float = 0.1) -> dict:
    """Max/avg/var of |service_1 - service_2| (Table 1), skipping the
    initial ``settle`` fraction while both clients ramp up.  Degenerate
    inputs (no samples at all, or a settle slice that consumes every
    sample — e.g. both clients fully throttled) report zeros instead of
    raising on an empty array."""
    ts, diff = result.service_difference(c1, c2)
    if len(diff) == 0:
        return {"max": 0.0, "avg": 0.0, "var": 0.0}
    k = int(len(diff) * settle)
    d = diff[k:]
    if len(d) == 0:
        d = diff[-1:]            # settle swallowed everything: last sample
    return {"max": float(d.max()), "avg": float(d.mean()),
            "var": float(d.var())}


def percentile_or_none(xs, q: float):
    """``np.percentile`` that is uniformly ``None`` on empty input —
    every percentile field in ``summarize`` uses this, so callers never
    have to guess which fields can be None (all of them, exactly when
    the underlying sample set is empty)."""
    xs = np.asarray(xs)
    return float(np.percentile(xs, q)) if len(xs) else None


def summarize(result, clients: List[str] = None) -> dict:
    ttfts = result.ttfts()
    lats = result.latencies()
    tbts = np.array([t for t in (r.tbt() for r in result.requests)
                     if t is not None])
    out = {
        "throughput_tok_s": result.throughput_tokens_per_s(),
        "mean_util": result.mean_util(),
        "p50_ttft": percentile_or_none(ttfts, 50),
        "p90_ttft": percentile_or_none(ttfts, 90),
        "p99_ttft": percentile_or_none(ttfts, 99),
        "p99_tbt": percentile_or_none(tbts, 99),
        "mean_latency": float(lats.mean()) if len(lats) else None,
        "finished": sum(r.state == "finished" for r in result.requests),
        "total": len(result.requests),
    }
    # admission-control metrics (DESIGN.md §13) — only results that
    # carry them (SimResult/ClusterResult post-§13); getattr-guarded so
    # older result shims keep working
    goodput = getattr(result, "goodput_tokens_per_s", None)
    if callable(goodput):
        out["goodput_tok_s"] = goodput()
    wasted = getattr(result, "wasted_tokens", None)
    if callable(wasted):
        out["wasted_tokens"] = wasted()
    out["n_throttled"] = sum(r.state == "throttled"
                             for r in result.requests)
    out["jain_delivered"] = delivered_jain(result.requests)
    if clients and len(clients) >= 2:
        out["service_diff"] = service_difference_stats(result, clients[0],
                                                       clients[1])
    return out
