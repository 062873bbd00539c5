"""Deterministic MoPE router (paper §6).

Training learns, from the corpus's true output lengths:
  1. regime boundaries — the 33rd/66th output-length percentiles (the
     paper lands on <53 / 53–210 / >210 for LMSYS);
  2. a keyword→regime vote table ("automatically identified keywords
     indicative of output length classes") via mean regime per keyword;
  3. prompt-length thresholds (per-regime mean length prior);
  4. a mixing weight between the keyword vote and the length prior,
     grid-searched to maximise training classification accuracy (the
     paper's "balancing different signals via a mixing weight").

Routing is a pure table lookup + threshold test: ~µs per prompt,
matching the paper's 0.02 ms router overhead budget.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Router:
    boundaries: np.ndarray              # (n_experts-1,) output-length cuts
    keyword_votes: dict                 # word -> (n_experts,) vote vector
    length_centroids: np.ndarray        # (n_experts,) mean log prompt len
    mix: float                          # keyword-vote weight
    n_experts: int

    def classify(self, keywords, prompt_len: int) -> int:
        scores = self._scores(keywords, prompt_len)
        return int(np.argmax(scores))

    def _scores(self, keywords, prompt_len: int) -> np.ndarray:
        kw = np.zeros(self.n_experts)
        hits = 0
        for w in keywords:
            v = self.keyword_votes.get(w)
            if v is not None:
                kw += v
                hits += 1
        if hits:
            kw /= hits
        # length prior: similarity to per-regime prompt-length centroid
        d = -np.abs(np.log1p(prompt_len) - self.length_centroids)
        d = np.exp(d)
        d /= d.sum()
        return self.mix * kw + (1 - self.mix) * d


def regime_of(length: float, boundaries: np.ndarray) -> int:
    return int(np.searchsorted(boundaries, length, side="right"))


def train_router(corpus, n_experts: int = 3, seed: int = 0) -> Router:
    """corpus: list of (keywords, prompt_len, output_len)."""
    outs = np.array([o for _, _, o in corpus], np.float64)
    qs = np.linspace(0, 100, n_experts + 1)[1:-1]
    boundaries = np.percentile(outs, qs)
    regimes = np.array([regime_of(o, boundaries) for o in outs])

    # keyword vote table: empirical regime distribution per keyword
    counts: dict = {}
    for (kw, _pl, _o), r in zip(corpus, regimes):
        for w in kw:
            counts.setdefault(w, np.zeros(n_experts))[r] += 1
    votes = {}
    for w, c in counts.items():
        tot = c.sum()
        if tot >= 5:                      # drop ultra-rare words
            votes[w] = c / tot

    # per-regime prompt-length centroid
    plens = np.array([p for _, p, _ in corpus], np.float64)
    cents = np.array([np.log1p(plens[regimes == r]).mean()
                      if (regimes == r).any() else 0.0
                      for r in range(n_experts)])

    # mixing-weight grid search on training accuracy
    best_mix, best_acc = 0.5, -1.0
    sub = np.random.default_rng(seed).permutation(len(corpus))[:4000]
    for mix in np.linspace(0.0, 1.0, 11):
        r = Router(boundaries, votes, cents, float(mix), n_experts)
        acc = np.mean([r.classify(corpus[i][0], corpus[i][1]) == regimes[i]
                       for i in sub])
        if acc > best_acc:
            best_acc, best_mix = acc, float(mix)
    return Router(boundaries, votes, cents, best_mix, n_experts)


def router_accuracy(router: Router, corpus) -> float:
    outs = np.array([o for _, _, o in corpus])
    regimes = np.array([regime_of(o, router.boundaries) for o in outs])
    pred = np.array([router.classify(kw, pl) for kw, pl, _ in corpus])
    return float(np.mean(pred == regimes))
