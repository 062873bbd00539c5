"""The one traffic generator: a mix file of parameters in, an arrival
schedule out.

A mix (``portbench/traffic/<name>.json``) lists groups of clients.  Each
group gives a client count, the keywords its requests carry (MoPE's
features) and a length model for prompts and outputs:

- ``{"dist": "lognormal", "median": m, "sigma": s, "min": a, "max": b}``:
  lognormal lengths clipped to [a, b];
- ``{"dist": "lmsys"}`` (prompt and output together): the frozen LMSYS-like
  intent model of ``lmsys.py``, whose keywords then come from the draw.

``rate_rps`` is the total offered rate, split over the clients by
``split``: ``"equal"`` (equal request rates), ``"equal_demand"`` (rates
inversely proportional to each client's mean weighted tokens, prompt + 4 x
output, so every client offers the same service demand) or ``{"zipf": a}``
(shares proportional to 1 / rank**a).  Arrivals are Poisson per client;
a group's ``backlog`` gives each of its clients that many more requests
due at time 0, the queue an overloaded deployment already holds.

The work does not depend on the seed, only its order does.  The mix's
``pool_seed`` fixes one trace: each client's arrivals (a shuffle of
stratified exponential gaps) and its requests' lengths (stratified
quantiles of the clipped lognormal, or a fixed draw of the LMSYS model),
each in an order drawn from ``pool_seed``.  The run's seed then shuffles
the lengths (prompt, output and keywords together) among each run of
``shuffle_block`` consecutive arrivals of one group (8 by default), so
every seed serves the same arrivals and the same load over any few
seconds, in another order of requests, and draws the prompts' token
ids.  The schedule covers ``horizon_s`` seconds.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
from typing import List, Tuple

import numpy as np

from portbench.traffic import lmsys

OUT_TOKEN_WEIGHT = 4.0          # the paper's §3.1 weight of an output token


@dataclasses.dataclass
class Arrival:
    rid: int
    client: str
    due: float                  # seconds after the schedule starts
    prompt_len: int
    output_len: int
    keywords: Tuple[str, ...]


def load_mix(path) -> dict:
    return json.loads(pathlib.Path(path).read_text())


def _lognormal_quantiles(spec, n):
    """Stratified quantiles (i + 0.5) / n of the clipped lognormal."""
    from statistics import NormalDist
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    x = spec["median"] * np.exp(spec["sigma"] * z)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def _exp_gaps(rate, n):
    """Stratified exponential quantiles, scaled to the mean 1 / rate."""
    u = (np.arange(n) + 0.5) / n
    g = -np.log1p(-u)
    return g / (g.mean() * rate)


def _shares(split, groups):
    clients = [(g, i) for g in groups for i in range(g["count"])]
    if split == "equal":
        w = np.ones(len(clients))
    elif split == "equal_demand":
        w = np.array([1.0 / mean_weighted_tokens(g) for g, _ in clients])
    elif isinstance(split, dict) and "zipf" in split:
        w = 1.0 / np.arange(1, len(clients) + 1) ** float(split["zipf"])
    else:
        raise ValueError(f"unknown split {split!r}")
    return clients, w / w.sum()


def mean_weighted_tokens(group) -> float:
    """Mean prompt + 4 x output tokens of a group's requests (the fixed
    multiset of ``pool_lengths`` at 4096 requests)."""
    p, o, _ = pool_lengths(group, 4096, pool_seed=0)
    return float(np.mean(p) + OUT_TOKEN_WEIGHT * np.mean(o))


def pool_lengths(group, n, pool_seed):
    """The fixed multiset of a client's ``n`` (prompts, outputs,
    keywords)."""
    if group.get("prompt", {}).get("dist") == "lmsys":
        rng = np.random.default_rng(pool_seed)
        tr = lmsys.draw(n, rng, cap=int(group["prompt"].get("output_cap",
                                                            4096)))
        return (np.array([t[1] for t in tr], np.int64),
                np.array([t[2] for t in tr], np.int64),
                [t[0] for t in tr])
    kw = tuple(group.get("keywords", ()))
    return (_lognormal_quantiles(group["prompt"], n),
            _lognormal_quantiles(group["output"], n), [kw] * n)


def schedule(mix: dict, seed: int, horizon_s: float,
             rate_rps: float = None) -> List[Arrival]:
    """The arrivals due in [0, horizon_s), sorted by due time; ``rid`` is
    the index.  ``rate_rps`` overrides the mix's rate (the knee sweep)."""
    rate = float(mix["rate_rps"] if rate_rps is None else rate_rps)
    pool_seed = int(mix.get("pool_seed", 0))
    rng = np.random.default_rng(pool_seed)
    clients, shares = _shares(mix["split"], mix["clients"])
    out, group_of = [], {}
    for ci, ((group, gi), share) in enumerate(zip(clients, shares)):
        r = rate * share
        k = int(group.get("backlog", 0))
        n = max(1, int(math.ceil(r * horizon_s)))
        due = np.concatenate([np.zeros(k), np.cumsum(
            rng.permutation(_exp_gaps(r, n)))])
        n += k
        prompts, outputs, kws = pool_lengths(group, n,
                                             pool_seed * 1_000 + ci)
        order_p = rng.permutation(n)
        # the LMSYS model's output follows its prompt: keep the pairs
        order_o = order_p if group["prompt"].get("dist") == "lmsys" \
            else rng.permutation(n)
        name = f"{group['name']}{gi}"
        group_of[name] = group["name"]
        for j in range(n):
            if due[j] >= horizon_s:
                break
            out.append(Arrival(-1, name, float(due[j]),
                               int(prompts[order_p[j]]),
                               int(outputs[order_o[j]]),
                               tuple(kws[order_p[j]])))
    out.sort(key=lambda a: (a.due, a.client))
    block = int(mix.get("shuffle_block", 8))
    mine = np.random.default_rng(seed)
    for g in dict.fromkeys(group_of.values()):
        idx = [i for i, a in enumerate(out) if group_of[a.client] == g]
        for b in range(0, len(idx), block):
            part = idx[b:b + block]
            sizes = [(out[i].prompt_len, out[i].output_len, out[i].keywords)
                     for i in part]
            for i, k in zip(part, mine.permutation(len(part))):
                (out[i].prompt_len, out[i].output_len,
                 out[i].keywords) = sizes[k]
    for i, a in enumerate(out):
        a.rid = i
    return out


def prompt_tokens(seed: int, rid: int, n: int, vocab: int) -> np.ndarray:
    """The prompt's token ids, drawn from the seed over the vocabulary."""
    return np.random.default_rng([seed, rid]).integers(
        0, vocab, n).astype(np.int32)
