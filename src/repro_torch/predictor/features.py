"""Prompt featurization for the router and the regression experts.

The paper's router "classifies prompts based on input length thresholds
and automatically identified keywords" via "feature embedding and
similarity lookups".  We featurize a prompt as:
    [log1p(prompt_len), prompt_len/1024, hashed keyword bag (K dims), 1]
The hash embedding is deterministic (stable across runs / processes).
"""
from __future__ import annotations

import numpy as np

# the shared trace vocabulary (DESIGN.md §9) supplies the hash, so the
# radix prefix cache's token ids and these features agree on keywords —
# bit-identical to the private md5 hash this module used to carry
from repro_torch.workloads.vocab import stable_hash as _stable_hash

N_HASH = 32
DIM = 2 + N_HASH + 1


def featurize(keywords, prompt_len: int) -> np.ndarray:
    f = np.zeros(DIM, np.float32)
    f[0] = np.log1p(prompt_len)
    f[1] = prompt_len / 1024.0
    for w in keywords:
        f[2 + _stable_hash(w) % N_HASH] += 1.0
    f[-1] = 1.0
    return f


def featurize_batch(items) -> np.ndarray:
    """items: iterable of (keywords, prompt_len)."""
    return np.stack([featurize(kw, pl) for kw, pl in items])
