"""UFC / RFC / HF counter math (paper §3) — the primary contribution.

The numpy host versions that drive the serving engine's scheduler loop.
The device-resident half (counter updates and argmin-HF selection fused
into the serving program) is not part of this package yet.

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
