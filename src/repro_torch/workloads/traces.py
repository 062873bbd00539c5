"""LMSYS-Chat-1M / ShareGPT-like synthetic traces.

The raw datasets are not available offline; these generators match the
statistics the paper relies on (DESIGN.md §8): lognormal output lengths
whose 33rd/66th percentiles sit near the paper's MoPE regime boundaries
(53 / 210 tokens), heavy-tailed prompt lengths and per-client Poisson
arrivals with heterogeneous rates.

Output length is a *learnable* function of the prompt (intent keyword +
prompt length + noise) so the MoPE router/experts have real structure to
capture — mirroring how output length correlates with prompt semantics
in the real traces.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.request import Request
from repro_torch.workloads.vocab import filler_tokens, prompt_token_ids

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
# LMSYS-ish intent mix (chat-dominated, long-form tail); tuned so the
# output-length 33rd/66th percentiles land near the paper's 53/210 cuts
INTENT_PROBS = np.array([0.20, 0.28, 0.11, 0.07, 0.19, 0.15])

_FILLER = ("the", "a", "of", "to", "in", "and", "for", "with", "on", "is",
           "how", "what", "why", "when", "best", "new", "my", "your")


def true_output_len(intent: str, prompt_len: int, rng) -> int:
    base, gamma, sigma = INTENTS[intent]
    mean = base * (prompt_len / 128.0) ** gamma
    out = mean * rng.lognormal(0.0, sigma)
    return int(np.clip(out, 1, 4096))


def sample_prompt(rng):
    """Returns (keywords, prompt_len)."""
    intent = str(rng.choice(INTENT_NAMES, p=INTENT_PROBS))
    prompt_len = int(np.clip(rng.lognormal(4.45, 0.95), 4, 3500))
    n_fill = int(rng.integers(2, 6))
    kw = (intent,) + tuple(rng.choice(_FILLER, size=n_fill))
    return kw, prompt_len, intent


def corpus(n: int, seed: int = 0):
    """(keywords, prompt_len, output_len) triples for predictor training."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        kw, plen, intent = sample_prompt(rng)
        out.append((kw, plen, true_output_len(intent, plen, rng)))
    return out


def lmsys_like(n_clients=27, duration=120.0, total_rate=8.0, seed=0):
    """27 heterogeneous clients (paper Appendix B uses 27 from the LMSYS
    trace), zipf-distributed request rates, Poisson arrivals."""
    rng = np.random.default_rng(seed)
    shares = 1.0 / np.arange(1, n_clients + 1) ** 0.8
    shares /= shares.sum()
    reqs = []
    rid = 0
    for ci in range(n_clients):
        rate = float(total_rate * shares[ci])
        t = rng.exponential(1.0 / rate)
        while t < duration:
            kw, plen, intent = sample_prompt(rng)
            reqs.append(Request(
                rid=rid, client=f"client{ci}", arrival=float(t),
                prompt_len=plen,
                output_len=true_output_len(intent, plen, rng),
                keywords=kw))
            rid += 1
            t += rng.exponential(1.0 / rate)
    return sorted(reqs, key=lambda r: r.arrival)


def multiturn_sharegpt_like(n_clients=8, n_conversations=3,
                            turns=(2, 7), system_pool=4, system_len=64,
                            turn_len=(8, 160), think_time=6.0,
                            max_prompt=3500, seed=0):
    """Multi-turn conversations with real token ids — the workload the
    shared-prefix radix KV cache (DESIGN.md §9) is built for.

    Per client: ``n_conversations`` sequential conversations, each opening
    with a system prompt drawn from a pool of ``system_pool`` prompts
    *shared across all clients* (deterministic token ids, so distinct
    clients' requests share page-aligned prefixes).  Turn *k*'s prompt is
    the concatenated history — system prompt, every earlier user turn and
    assistant reply, then the new user turn — so each turn's
    ``prompt_tokens`` strictly extends the previous turn's.  Assistant
    replies are seeded filler ids standing in for generated text; output
    lengths and per-turn keywords reuse the LMSYS-style intent model, so
    predictor structure is preserved.  Arrivals: turn k+1 follows turn k
    after an exponential think time (mean ``think_time`` seconds).
    """
    rng = np.random.default_rng(seed)
    # the system-prompt pool is keyed by index only — identical across
    # clients and runs, which is what makes cross-client sharing real
    sys_prompts = [prompt_token_ids(("system", f"sys{i}"), system_len,
                                    seed=10_000 + i)
                   for i in range(system_pool)]
    reqs, rid = [], 0
    for ci in range(n_clients):
        t = float(rng.exponential(think_time))
        for _conv in range(n_conversations):
            history = [sys_prompts[int(rng.integers(system_pool))]]
            hist_len = len(history[0])
            n_turns = int(rng.integers(turns[0], turns[1]))
            for _turn in range(n_turns):
                kw, plen, intent = sample_prompt(rng)
                user_len = int(np.clip(plen, turn_len[0], turn_len[1]))
                user = prompt_token_ids(kw, user_len,
                                        seed=int(rng.integers(1 << 31)))
                if hist_len + user_len > max_prompt:
                    break
                prompt = np.concatenate(history + [user])
                out_len = true_output_len(intent, len(prompt), rng)
                reqs.append(Request(
                    rid=rid, client=f"client{ci}", arrival=float(t),
                    prompt_len=len(prompt), output_len=out_len,
                    keywords=kw, prompt_tokens=prompt))
                rid += 1
                reply = filler_tokens(out_len,
                                      seed=int(rng.integers(1 << 31)))
                history += [user, reply]
                hist_len += user_len + out_len
                t += float(rng.exponential(think_time))
            t += float(rng.exponential(2.0 * think_time))   # between convs
    return sorted(reqs, key=lambda r: r.arrival)


def multiturn_interactions(n_users=4, n_apps=2, sessions_per_user=3,
                           turns=(2, 6), system_pool=4, system_len=64,
                           turn_len=(8, 160), think_time=2.0,
                           session_gap=6.0, max_prompt=3500, seed=0):
    """Closed-loop multi-turn trace: first-class ``Interaction`` objects
    (DESIGN.md §13) instead of a pre-stamped request stream.

    Each (user, app) pair opens ``sessions_per_user`` sessions; each
    session is one interaction whose turns extend the conversation
    history exactly like ``multiturn_sharegpt_like`` (shared system-
    prompt pool, real token ids, LMSYS-style intent/output model).  The
    crucial difference is arrival semantics: only turn 0 carries a
    generator-stamped arrival (session starts are spaced by exponential
    ``session_gap`` gaps per user); every later turn's arrival is
    *decided at serving time* — ``Interaction.next_request`` stamps it
    as the previous turn's completion plus an exponential think time
    (mean ``think_time``, pre-drawn here so the trace stays
    deterministic).  Apps are assigned round-robin over users, so
    several users share an app and the per-app admission window has
    real aggregation to do.

    ``sessions_per_user`` may be a sequence, cycled over users — e.g.
    ``(2, 8)`` makes every other user "chatty" (4× the sessions), the
    demand skew the per-user admission windows are meant to clip.

    Returns a list of ``Interaction``; feed via
    ``Simulator.run(interactions=...)`` (or the engine / cluster
    equivalents).
    """
    from repro_torch.core.request import Interaction
    rng = np.random.default_rng(seed)
    sys_prompts = [prompt_token_ids(("system", f"sys{i}"), system_len,
                                    seed=10_000 + i)
                   for i in range(system_pool)]
    if np.isscalar(sessions_per_user):
        n_sessions = [int(sessions_per_user)] * n_users
    else:
        n_sessions = [int(sessions_per_user[ui % len(sessions_per_user)])
                      for ui in range(n_users)]
    inters, rid, iid = [], 0, 0
    for ui in range(n_users):
        user, app = f"user{ui}", f"app{ui % n_apps}"
        t = float(rng.exponential(session_gap))
        for si in range(n_sessions[ui]):
            history = [sys_prompts[int(rng.integers(system_pool))]]
            hist_len = len(history[0])
            n_turns = int(rng.integers(turns[0], turns[1]))
            sess_turns, thinks = [], []
            for turn_i in range(n_turns):
                kw, plen, intent = sample_prompt(rng)
                user_len = int(np.clip(plen, turn_len[0], turn_len[1]))
                user_toks = prompt_token_ids(kw, user_len,
                                             seed=int(rng.integers(1 << 31)))
                if hist_len + user_len > max_prompt:
                    break
                prompt = np.concatenate(history + [user_toks])
                out_len = true_output_len(intent, len(prompt), rng)
                # arrival: the real stamp for turn 0; a provisional
                # open-loop one for later turns (overwritten at release
                # — kept so an interaction trace can also be run flat)
                sess_turns.append(Request(
                    rid=rid, client=f"u{ui}s{si}", arrival=float(t),
                    prompt_len=len(prompt), output_len=out_len,
                    keywords=kw, prompt_tokens=prompt))
                rid += 1
                thinks.append(0.0 if turn_i == 0
                              else float(rng.exponential(think_time)))
                reply = filler_tokens(out_len,
                                      seed=int(rng.integers(1 << 31)))
                history += [user_toks, reply]
                hist_len += user_len + out_len
            if sess_turns:
                inters.append(Interaction(
                    interaction_id=iid, turns=sess_turns,
                    think_times=thinks, user=user, app=app))
                iid += 1
            t += float(rng.exponential(session_gap))
    return inters


def sharegpt_like(n_clients=8, n_per_client=160, rate_per_client=3.5,
                  seed=0):
    """§7.3.2 setup: fixed per-client Poisson rate, fixed request count.
    ShareGPT skews longer than LMSYS — shift the prompt distribution up."""
    rng = np.random.default_rng(seed)
    reqs = []
    rid = 0
    for ci in range(n_clients):
        t = 0.0
        for _ in range(n_per_client):
            t += rng.exponential(1.0 / rate_per_client)
            kw, plen, intent = sample_prompt(rng)
            plen = int(np.clip(plen * 1.6, 4, 3500))
            reqs.append(Request(
                rid=rid, client=f"client{ci}", arrival=float(t),
                prompt_len=plen,
                output_len=true_output_len(intent, plen, rng),
                keywords=kw))
            rid += 1
    return sorted(reqs, key=lambda r: r.arrival)
