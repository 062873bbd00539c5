"""One deterministic keyword→token-id vocabulary for the whole repo.

The synthetic traces (``repro_torch.workloads.traces``) historically carried
keyword tuples but no token ids, so the predictor's hashed-keyword
features and the serving engine's prompt tokens lived in unrelated
spaces.  The shared-prefix radix KV cache (DESIGN.md §9) needs prompts
as *token-id sequences* whose prefixes are meaningful — so this module
is the single mapping both sides use:

- ``stable_hash`` is the md5-based hash the predictor's feature
  embedding has always used (``repro_torch.predictor.features`` imports it
  from here; values are bit-identical to the old private copy, so
  trained predictors and their tests are unaffected);
- ``token_id`` folds that hash into a small trace vocabulary sized to
  fit every smoke model config (vocab_size = 512);
- ``prompt_token_ids`` renders (keywords, prompt_len) into a
  deterministic token array: keyword tokens first — the radix tree and
  the router literally key on the same ids — then seeded filler.
"""
from __future__ import annotations

import hashlib

import numpy as np

# fits the smoke configs' embedding tables (every smoke vocab_size is 512)
TRACE_VOCAB = 512


def stable_hash(word: str) -> int:
    """Deterministic across runs/processes (unlike ``hash``)."""
    return int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")


def token_id(word: str) -> int:
    return stable_hash(word) % TRACE_VOCAB


def keyword_tokens(keywords) -> np.ndarray:
    return np.array([token_id(w) for w in keywords], np.int32)


def filler_tokens(n: int, seed: int) -> np.ndarray:
    """Seeded filler ids padding a prompt to length (reserving id 0 as a
    never-generated pad sentinel keeps accidental radix matches out)."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, TRACE_VOCAB, max(n, 0)).astype(np.int32)


def prompt_token_ids(keywords, prompt_len: int, seed: int = 0) -> np.ndarray:
    """Deterministic prompt: keyword ids then seeded filler, truncated or
    padded to exactly ``prompt_len`` tokens."""
    kw = keyword_tokens(keywords)[:prompt_len]
    fill = filler_tokens(prompt_len - len(kw), seed)
    return np.concatenate([kw, fill]).astype(np.int32)
