"""Request lifecycle shared by the simulator, the serving engine and the
schedulers."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

# request states
WAITING = "waiting"
PREFILLING = "prefilling"
DECODING = "decoding"
FINISHED = "finished"
DROPPED = "dropped"
PREEMPTED = "preempted"     # evicted from the batch (recompute on re-admit)
THROTTLED = "throttled"     # rejected by overload admission control — never
#                             entered a scheduler queue (DESIGN.md §13)


# -- SLO classes (DESIGN.md §12) ----------------------------------------------
@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """Delivered-QoS targets of one service class: time-to-first-token
    and (mean) time-between-tokens, both in seconds on the modeled
    clock."""
    ttft: float
    tbt: float


# The two paper-style service classes (FairBatching, arXiv:2510.14392):
# ``interactive`` — a human is watching the stream, so the decode cadence
# must stay under the reading/typing threshold; ``batch`` — offline
# summarization/codegen traffic that only cares about completing.  The
# TBT numbers are set against the A100 roofline this repo models: a
# decode-only iteration of a moderate batch costs ~9-15 ms incl. the
# refresh overhead, a full 512-token prefill chunk pushes the mixed
# iteration past 50 ms — so 40 ms forces the budget solver to actually
# shrink chunks while staying feasible, and 500 ms never binds.
SLO_CLASSES = {
    "interactive": SLOTarget(ttft=1.5, tbt=0.040),
    "batch": SLOTarget(ttft=30.0, tbt=0.500),
}


def set_slo(req: "Request", slo_class: str, *, ttft: float = None,
            tbt: float = None) -> "Request":
    """Tag ``req`` with a service class and its TTFT/TBT targets (class
    defaults from ``SLO_CLASSES``, individually overridable).  Returns
    the request so workload generators can tag inline."""
    if slo_class not in SLO_CLASSES:
        raise ValueError(f"unknown SLO class {slo_class!r}; choose from "
                         f"{tuple(SLO_CLASSES)}")
    tgt = SLO_CLASSES[slo_class]
    req.slo_class = slo_class
    req.ttft_slo = float(ttft if ttft is not None else tgt.ttft)
    req.tbt_slo = float(tbt if tbt is not None else tgt.tbt)
    return req


@dataclasses.dataclass
class Request:
    rid: int
    client: str
    arrival: float                      # seconds since epoch of the run
    prompt_len: int
    output_len: int                     # ground-truth generation length
    keywords: tuple = ()                # synthetic prompt keywords (router feats)
    weight: float = 1.0                 # client priority ω_f
    # predictions (filled by the predictor before scheduling) --------------
    pred_output_len: Optional[float] = None
    pred_latency: Optional[float] = None
    pred_tps: Optional[float] = None
    pred_util: Optional[float] = None
    # lifecycle ------------------------------------------------------------
    state: str = WAITING
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    generated: int = 0
    prefill_done: int = 0               # chunked-prefill progress
    cached_prefix: int = 0              # prompt tokens served from the
    #                                     shared-prefix cache (DESIGN.md §9)
    # preemption (DESIGN.md §10) ------------------------------------------
    n_preempted: int = 0                # times evicted for recompute
    preempt_time: Optional[float] = None
    generated_peak: int = 0             # largest observed output across
    #                                     preempt/readmit cycles — floors
    #                                     the re-admission KV reservation
    prompt_tokens: Optional[np.ndarray] = None   # token ids (engine decode,
    #                                     radix prefix keys, affinity routing)
    # SLO class (DESIGN.md §12) -------------------------------------------
    slo_class: Optional[str] = None     # "interactive" / "batch" / None
    ttft_slo: Optional[float] = None    # s; None = no TTFT target
    tbt_slo: Optional[float] = None     # s; None = no TBT target (the
    #                                     budget solver ignores this req)
    # interaction membership (DESIGN.md §13) ------------------------------
    # ``client`` stays the *session* name; ``user``/``app`` identify the
    # fairness account the session bills to.  Both None = legacy flat
    # stream (account == client, bit-identical pre-§13 behavior).
    interaction_id: Optional[int] = None
    turn_index: int = 0                 # position within the interaction
    user: Optional[str] = None
    app: Optional[str] = None

    # -- derived -------------------------------------------------------------
    @property
    def account(self) -> str:
        """Fairness billing key (DESIGN.md §13): sessions of one
        (user, app) pair share a single account, so a chatty app cannot
        dodge counters by opening new sessions.  Falls back to the
        session name when no interaction identity is attached."""
        if self.user is None and self.app is None:
            return self.client
        return f"{self.user if self.user is not None else self.client}" \
               f"@{self.app if self.app is not None else '-'}"

    @property
    def total_tokens(self) -> int:
        return self.prompt_len + self.output_len

    def weighted_tokens(self, out_weight: float = 4.0,
                        predicted: bool = False) -> float:
        """VTC/Equinox service measure: in + w·out tokens."""
        out = (self.pred_output_len if predicted and
               self.pred_output_len is not None else self.output_len)
        return self.prompt_len + out_weight * out

    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival

    def e2e_latency(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival

    # -- SLO accounting (DESIGN.md §12) -----------------------------------
    def tbt(self, now: float = None) -> Optional[float]:
        """Mean time between output tokens over the decode phase (first
        token excluded — its cadence is TTFT's job).  ``now`` prices an
        in-flight request; finished requests use ``finish_time``.  None
        until at least two tokens exist."""
        if self.first_token_time is None or self.generated < 2:
            return None
        end = self.finish_time if self.finish_time is not None else now
        if end is None:
            return None
        return max(end - self.first_token_time, 0.0) / (self.generated - 1)

    def ttft_met(self) -> Optional[bool]:
        if self.ttft_slo is None or self.ttft() is None:
            return None
        return self.ttft() <= self.ttft_slo

    def tbt_met(self) -> Optional[bool]:
        if self.tbt_slo is None or self.tbt() is None:
            return None
        return self.tbt() <= self.tbt_slo

    def slo_violating(self, now: float) -> bool:
        """Is this *running* request currently missing its class targets?
        Prefill phase: the TTFT clock has already run past the target.
        Decode phase: the observed mean TBT exceeds the target.  Used by
        preemption's victim pool (DESIGN.md §12) — an SLO-violating
        batch request is the cheapest thing to evict."""
        if self.first_token_time is None:
            return (self.ttft_slo is not None
                    and now - self.arrival > self.ttft_slo)
        t = self.tbt(now)
        return (self.tbt_slo is not None and t is not None
                and t > self.tbt_slo)


# -- interactions (DESIGN.md §13) ---------------------------------------------
@dataclasses.dataclass
class Interaction:
    """A multi-turn conversation as a first-class scheduling object.

    ``turns`` are ordered requests of one session; turn k only enters
    the arrival stream once turn k−1 has *completed* plus the user's
    think time (the closed-loop release rule — unlike the open-loop
    ``multiturn_sharegpt_like`` trace, which pre-stamps every turn's
    arrival at generation time).  ``stage`` counts completed turns,
    ``released`` counts turns handed to the arrival stream; the frontends
    drive both via ``mark_stage_complete``/``next_request``.

    ``user``/``app`` are the fairness account the whole interaction
    bills to (stamped onto every turn in ``__post_init__``); ``client``
    on the turns stays the session name.
    """
    interaction_id: int
    turns: List["Request"]
    think_times: List[float] = None     # think_times[k] = user think time
    #                                     BEFORE turn k (index 0 unused —
    #                                     turn 0 keeps its stamped arrival)
    user: Optional[str] = None
    app: Optional[str] = None
    stage: int = 0                      # turns completed
    released: int = 0                   # turns handed to the arrival stream
    throttled: bool = False             # admission rejected this interaction

    def __post_init__(self):
        if not self.turns:
            raise ValueError("an Interaction needs at least one turn")
        if self.think_times is None:
            self.think_times = [0.0] * len(self.turns)
        if len(self.think_times) != len(self.turns):
            raise ValueError(
                f"think_times length {len(self.think_times)} != "
                f"{len(self.turns)} turns")
        for k, t in enumerate(self.turns):
            t.interaction_id = self.interaction_id
            t.turn_index = k
            t.user = self.user
            t.app = self.app

    @property
    def done(self) -> bool:
        return self.throttled or self.stage >= len(self.turns)

    def next_request(self, now: float = None) -> Optional["Request"]:
        """The next turn ready for the arrival stream, or None.  A turn
        is ready once every prior turn completed (``released <= stage``).
        With ``now`` given, the turn's arrival is re-stamped to
        ``now + think_time`` — the closed-loop rule; turn 0 keeps the
        arrival its generator stamped (the interaction's birth)."""
        if self.throttled or self.released >= len(self.turns):
            return None
        if self.released > self.stage:
            return None                  # previous turn still in flight
        req = self.turns[self.released]
        if now is not None and self.released > 0:
            req.arrival = now + self.think_times[self.released]
        self.released += 1
        return req

    def mark_stage_complete(self, now: float = None):
        """Turn ``stage`` finished — the next turn becomes releasable."""
        self.stage += 1

    def throttle(self):
        """Admission rejected this interaction: every unreleased turn is
        marked THROTTLED (they never enter a scheduler queue) so metrics
        can count the account's denied work as zero-service."""
        self.throttled = True
        for t in self.turns[self.released:]:
            t.state = THROTTLED
