"""Synthetic token data pipeline for the training examples (a copy of
``repro/training/data.py``: pure numpy, so the batches are the
reference's bit for bit).

Generates a deterministic Markov "language" (Zipf unigram marginals +
state-dependent transitions) so a small model has real structure to
learn (loss drops well below uniform entropy) without any offline data.
"""
from __future__ import annotations

import numpy as np


class MarkovTokenStream:
    def __init__(self, vocab_size: int, seed: int = 0, n_states: int = 64,
                 zipf_a: float = 1.2):
        self.vocab = vocab_size
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        base = 1.0 / ranks ** zipf_a
        # per-state re-weighting: each state boosts a random token slice
        self.n_states = n_states
        self.state_boost = self.rng.integers(0, vocab_size,
                                             size=(n_states, 32))
        self.base = base / base.sum()

    def _probs(self, state: int) -> np.ndarray:
        p = self.base.copy()
        p[self.state_boost[state % self.n_states]] *= 30.0
        return p / p.sum()

    def sample(self, batch: int, seq_len: int, seed: int) -> np.ndarray:
        rng = np.random.default_rng(seed)
        out = np.empty((batch, seq_len + 1), np.int32)
        # vectorised: state = previous token mod n_states
        prev = rng.integers(0, self.vocab, batch)
        # precompute per-state cumulative distributions lazily
        cache = {}
        for t in range(seq_len + 1):
            states = prev % self.n_states
            nxt = np.empty(batch, np.int64)
            for s in np.unique(states):
                if s not in cache:
                    cache[s] = np.cumsum(self._probs(int(s)))
                idx = states == s
                u = rng.random(idx.sum())
                nxt[idx] = np.searchsorted(cache[s], u)
            out[:, t] = np.minimum(nxt, self.vocab - 1)
            prev = nxt
        return out


def batches(vocab_size: int, batch: int, seq_len: int, n_steps: int,
            seed: int = 0):
    """Yields {tokens, labels} numpy batches."""
    stream = MarkovTokenStream(vocab_size, seed)
    for step in range(n_steps):
        chunk = stream.sample(batch, seq_len, seed=seed * 100_003 + step)
        yield {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}
