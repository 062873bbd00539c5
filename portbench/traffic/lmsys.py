"""LMSYS-like chat lengths: a frozen copy of the program's intent model.

Copied from ``repro_torch/workloads/traces.py`` (``INTENTS``,
``INTENT_PROBS``, ``sample_prompt``, ``true_output_len``) so that a change
to the program cannot move the benchmark's traffic.  Output length is a
function of the intent keyword and the prompt length plus lognormal noise,
which is what MoPE learns from.
"""
from __future__ import annotations

import numpy as np

# intent -> (base output length, prompt-length exponent, noise sigma)
INTENTS = {
    "qa":        (26.0, 0.10, 0.45),
    "chat":      (100.0, 0.15, 0.55),
    "summarize": (60.0, 0.55, 0.40),
    "translate": (55.0, 0.90, 0.25),
    "code":      (360.0, 0.25, 0.60),
    "story":     (800.0, 0.10, 0.50),
}
INTENT_NAMES = tuple(INTENTS)
INTENT_PROBS = np.array([0.20, 0.28, 0.11, 0.07, 0.19, 0.15])

FILLER = ("the", "a", "of", "to", "in", "and", "for", "with", "on", "is",
          "how", "what", "why", "when", "best", "new", "my", "your")


def true_output_len(intent: str, prompt_len: int, rng, cap: int = 4096) -> int:
    base, gamma, sigma = INTENTS[intent]
    mean = base * (prompt_len / 128.0) ** gamma
    out = mean * rng.lognormal(0.0, sigma)
    return int(np.clip(out, 1, cap))


def sample_prompt(rng):
    """(keywords, prompt_len, intent)."""
    intent = str(rng.choice(INTENT_NAMES, p=INTENT_PROBS))
    prompt_len = int(np.clip(rng.lognormal(4.45, 0.95), 4, 3500))
    n_fill = int(rng.integers(2, 6))
    kw = (intent,) + tuple(str(w) for w in rng.choice(FILLER, size=n_fill))
    return kw, prompt_len, intent


def draw(n: int, rng, cap: int = 4096):
    """``n`` (keywords, prompt_len, output_len) triples."""
    out = []
    for _ in range(n):
        kw, plen, intent = sample_prompt(rng)
        out.append((kw, plen, true_output_len(intent, plen, rng, cap)))
    return out
