"""UFC / RFC / HF counter math (paper §3) — the primary contribution.

Implemented twice, as in the reference (``repro/core/counters.py``):
- numpy host versions driving the simulator and the serving engine's
  scheduler loop (copied);
- torch versions of the reference's jnp half (``*_torch``), vectorised
  over clients on whatever device the counters live on, with the same
  math; ``build_batch_torch`` runs the greedy batch assembly without a
  host sync per pass.  The tests pin them to the numpy and jnp versions.

Formulas (paper §3.1–3.3):
    UFC += ω_f · (T_in + 4·T_out) / (1 + δ·(WaitTime + PredictTime))
    RFC += ω_f · TPS · Util
    HF_f = α · norm(UFC_f) + β · norm(RFC_f),   α + β = 1
Scheduling = max-min: serve the client with the smallest HF.

Beyond-paper extension (DESIGN.md §9): with the shared-prefix radix KV
cache, ``T_in_cached`` of a request's input tokens were served from the
cache and cost the operator almost nothing — charging them like computed
tokens over-bills conversational clients, while charging them zero lets
a client farm free service from its own history.  ``ufc_increment``
therefore bills cached input tokens at a tunable discount weight
``omega_cached`` ∈ [0, 1] (1 = paper behavior, cache-blind):

    T_in_effective = (T_in − T_in_cached) + ω_cached · T_in_cached
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

OUT_TOKEN_WEIGHT = 4.0          # §3.1: output tokens 4× input tokens
DEFAULT_DELTA = 0.1             # §3.1: latency compensation factor
DEFAULT_ALPHA = 0.7             # §7.6: chosen operating point
DEFAULT_BETA = 0.3


# ---------------------------------------------------------------------------
# scalar / numpy (host) versions
# ---------------------------------------------------------------------------
def billable_input(t_in: float, t_in_cached: float = 0.0,
                   omega_cached: float = 1.0) -> float:
    """Effective input tokens after the cached-prefix discount
    (DESIGN.md §9); ``omega_cached=1`` reproduces the paper exactly."""
    return (t_in - t_in_cached) + omega_cached * t_in_cached


def ufc_increment(t_in: float, t_out: float, wait: float, predict_time: float,
                  omega: float = 1.0, delta: float = DEFAULT_DELTA,
                  t_in_cached: float = 0.0,
                  omega_cached: float = 1.0) -> float:
    service = (billable_input(t_in, t_in_cached, omega_cached)
               + OUT_TOKEN_WEIGHT * t_out)
    return omega * service / (1.0 + delta * (wait + predict_time))


def rfc_increment(tps: float, util: float, omega: float = 1.0) -> float:
    return omega * tps * util


def hf_scores(ufc: np.ndarray, rfc: np.ndarray, alpha: float = DEFAULT_ALPHA,
              beta: float = DEFAULT_BETA) -> np.ndarray:
    """Normalized weighted combination (§3.3)."""
    un = ufc / max(float(np.max(ufc)), 1e-9)
    rn = rfc / max(float(np.max(rfc)), 1e-9)
    return alpha * un + beta * rn


def select_min_hf(ufc, rfc, active_mask, alpha=DEFAULT_ALPHA,
                  beta=DEFAULT_BETA) -> int:
    """argmin HF over clients with queued work (-1 if none)."""
    if not np.any(active_mask):
        return -1
    hf = hf_scores(np.asarray(ufc, float), np.asarray(rfc, float),
                   alpha, beta)
    hf = np.where(active_mask, hf, np.inf)
    return int(np.argmin(hf))


# ---------------------------------------------------------------------------
# torch (device) versions: identical math
# ---------------------------------------------------------------------------
def ufc_update_torch(ufc, client_idx, t_in, t_out, wait, predict_time, omega,
                     delta=DEFAULT_DELTA, t_in_cached=0.0, omega_cached=1.0):
    """A new ``ufc`` with the increment of ``ufc_increment`` added at
    ``client_idx`` (an index or an index tensor; repeated clients add
    up, as ``.at[].add`` does); the other arguments are scalars or
    tensors broadcast to the indices."""
    service = ((t_in - t_in_cached) + omega_cached * t_in_cached
               + OUT_TOKEN_WEIGHT * t_out)
    inc = omega * service / (1.0 + delta * (wait + predict_time))
    return _add_at(ufc, client_idx, inc)


def rfc_update_torch(rfc, client_idx, tps, util, omega):
    return _add_at(rfc, client_idx, omega * tps * util)


def _add_at(x, idx, inc):
    idx = torch.as_tensor(idx, dtype=torch.long, device=x.device)
    inc = torch.as_tensor(inc, dtype=x.dtype, device=x.device)
    return x.index_put((idx.reshape(-1),),
                       inc.expand(idx.shape).reshape(-1), accumulate=True)


def hf_scores_torch(ufc, rfc, alpha=DEFAULT_ALPHA, beta=DEFAULT_BETA):
    un = ufc / torch.clamp(ufc.max(), min=1e-9)
    rn = rfc / torch.clamp(rfc.max(), min=1e-9)
    return alpha * un + beta * rn


def select_min_hf_torch(ufc, rfc, active_mask, alpha=DEFAULT_ALPHA,
                        beta=DEFAULT_BETA):
    """argmin HF over the active clients as a 0-d long tensor on the
    counters' device, -1 when none is active (no host sync)."""
    hf = torch.where(active_mask, hf_scores_torch(ufc, rfc, alpha, beta),
                     torch.inf)
    return torch.where(active_mask.any(), hf.argmin(),
                       torch.full((), -1, device=hf.device))


def build_batch_torch(ufc, rfc, active_counts, kv_costs, kv_budget,
                      max_batch, alpha=DEFAULT_ALPHA, beta=DEFAULT_BETA):
    """Device-resident greedy batch assembly (Algorithm 1 inner loop), the
    reference's ``build_batch_jax``: repeatedly admit from the argmin-HF
    client while the batch-size and memory constraints hold; a client
    whose head request does not fit is blocked for the round; each
    admission charges a nominal UFC of its KV cost so the pick rotates.
    Returns (admit_counts (C,) int32, kv_used f32 0-d).

    The reference's ``lax.while_loop`` becomes a fixed number of passes
    with masked updates: a pass that runs either admits one request (at
    most ``max_batch`` of them) or blocks one client (at most C), so
    ``max_batch + C`` passes reach the loop's end, and later passes
    change nothing.  No pass reads a value back to the host."""
    C = ufc.shape[0]
    dev = ufc.device
    admitted = torch.zeros(C, dtype=torch.int32, device=dev)
    kv_used = torch.zeros((), dtype=torch.float32, device=dev)
    counts = active_counts.clone()
    blocked = torch.zeros(C, dtype=torch.bool, device=dev)
    ufc_s = ufc.to(torch.float32).clone()
    costs = kv_costs.to(torch.float32)
    for _ in range(int(max_batch) + C):
        mask = (counts > 0) & ~blocked
        live = mask.any() & (admitted.sum() < max_batch)
        hf = hf_scores_torch(ufc_s, rfc, alpha, beta)
        c = torch.where(mask, hf, torch.inf).argmin()
        cost = costs[c]
        fits = kv_used + cost <= kv_budget
        admit = live & fits
        one = torch.nn.functional.one_hot(c, C).bool()
        admitted = admitted + (one & admit).int()
        counts = counts - (one & admit).to(counts.dtype)
        blocked = torch.where(one & live, ~fits, blocked)
        add = torch.where(admit, cost, torch.zeros((), device=dev))
        ufc_s = ufc_s + one * add
        kv_used = kv_used + add
    return admitted, kv_used


@dataclasses.dataclass
class HFParams:
    alpha: float = DEFAULT_ALPHA
    beta: float = DEFAULT_BETA
    delta: float = DEFAULT_DELTA
    out_weight: float = OUT_TOKEN_WEIGHT
    # Latency-compensation normalization (reproduction decision, see
    # DESIGN.md §8): "absolute" is the paper's literal formula — the
    # denominator uses raw seconds, which is only stable inside the
    # paper's tested load regime; "relative" divides (wait + predict)
    # by its running mean so the compensation tilt is scale-free and
    # bounded by ``tilt_cap`` regardless of how deep the overload is.
    wait_norm: str = "relative"
    tilt_cap: float = 2.0
    # UFC charging granularity: "upfront" charges the predicted service at
    # admission and reconciles at completion (Algorithm 1 literal);
    # "incremental" charges output tokens as they are produced (same
    # refresh-with-actuals loop at the finest granularity — keeps service
    # tracking VTC-tight while predictions still steer admission order,
    # RFC and the latency tilt).
    charging: str = "incremental"
    # Cached-token discount (DESIGN.md §9): weight applied to input tokens
    # served from the shared-prefix KV cache.  1.0 = cache-blind (paper);
    # 0.0 = cached tokens free.
    omega_cached: float = 1.0
    # Locality tilt (DESIGN.md §11): HF headroom a fully cached prefix
    # may override in ``Equinox.pop_next`` — the effective score is
    # HF_c − locality_bonus · (cached_prefix / prompt_len) of the head
    # request.  HF is normalized to ~[0, 1], so 0.05–0.2 is a mild-to-
    # strong preference; 0.0 (default) is the paper's exact argmin-HF.
    locality_bonus: float = 0.0
