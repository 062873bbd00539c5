"""Overload-aware admission control (DESIGN.md §13).

FairServe-style throttling layer in front of the scheduler queues:
per-user and per-app sliding rate windows that only *bite* when the
replica signals overload (KV pressure or queued prompt backlog).  Two
deliberate asymmetries:

- **Overload-gated**: off-peak, the windows observe but never reject —
  unlike a static RPM quota (the paper's §1 critique), spare capacity
  is always usable.  Only when the replica is saturated do the heaviest
  users/apps get clipped to their recent rate.
- **Throttle-before-inflight**: only turn-0 requests — *new*
  interactions — can be rejected.  An in-flight turn rides on sunk
  investment (its conversation's KV pages and radix prefix are
  resident); killing it converts all of that to waste, whereas a new
  interaction has cost nothing yet.  So under overload the window
  clips conversation *starts*, never conversation *progress*.

State lives in plain rebindable dicts so ``share_admission_state`` can
alias them across replicas (mirroring ``share_fairness_state`` for the
schedulers): spraying interaction starts across a cluster still lands
in one shared window per user/app.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional

from repro_torch.core.request import Request


@dataclasses.dataclass
class AdmissionConfig:
    """Knobs of the overload-aware throttle (DESIGN.md §13).

    ``window_s``      sliding-window length (seconds).
    ``user_rate``     max new interactions per user per window.
    ``app_rate``      max new interactions per app per window (an app
                      aggregates all its users — the per-tenant cap).
    ``kv_thresh``     overload when reserved KV fraction >= this.
    ``queue_thresh``  overload when queued prompt tokens >= this
                      fraction of the KV budget (prefill backlog the
                      replica cannot absorb soon).
    """
    window_s: float = 60.0
    user_rate: float = 30.0
    app_rate: float = 120.0
    kv_thresh: float = 0.85
    queue_thresh: float = 0.5

    def __post_init__(self):
        """User-input validation — ``ValueError``, never ``assert``
        (asserts vanish under ``python -O``)."""
        if self.window_s is None or self.window_s <= 0:
            raise ValueError(f"admission window_s must be > 0 seconds, "
                             f"got {self.window_s!r}")
        for knob in ("user_rate", "app_rate"):
            v = getattr(self, knob)
            if v is None or v <= 0:
                raise ValueError(f"admission {knob} must be > 0 "
                                 f"interactions/window, got {v!r}")
        for knob in ("kv_thresh", "queue_thresh"):
            v = getattr(self, knob)
            if v is None or not 0.0 < v <= 1.0:
                raise ValueError(f"admission {knob} must be in (0, 1], "
                                 f"got {v!r}")


class AdmissionController:
    """Sliding-window throttle; decisions via ``allow(req, now,
    overloaded)``.  Pure policy — the overload signal comes from the
    caller (``BatchCore.overloaded``), so the same controller instance
    serves the simulator, the engine, and every replica of a cluster."""

    def __init__(self, cfg: AdmissionConfig = None):
        self.cfg = cfg or AdmissionConfig()
        # rebindable containers (``share_admission_state``): timestamps
        # of *allowed* interaction starts per user / per app
        self.user_windows: Dict[str, collections.deque] = \
            collections.defaultdict(collections.deque)
        self.app_windows: Dict[str, collections.deque] = \
            collections.defaultdict(collections.deque)
        self.stats: Dict[str, int] = collections.defaultdict(int)

    def _roll(self, w: collections.deque, now: float):
        horizon = now - self.cfg.window_s
        while w and w[0] <= horizon:
            w.popleft()

    def allow(self, req: Request, now: float, overloaded: bool) -> bool:
        """Admission decision for a request entering the frontend.
        Non-first turns of a known interaction always pass
        (throttle-before-inflight); turn-0 requests charge both windows
        when allowed, and are rejected when the replica is overloaded
        AND either window is already at its rate limit."""
        if req.turn_index > 0 and req.interaction_id is not None:
            return True
        user = req.user if req.user is not None else req.client
        app = req.app if req.app is not None else "-"
        uw, aw = self.user_windows[user], self.app_windows[app]
        self._roll(uw, now)
        self._roll(aw, now)
        if overloaded and (len(uw) >= self.cfg.user_rate
                           or len(aw) >= self.cfg.app_rate):
            self.stats["n_throttled"] += 1
            return False
        uw.append(now)
        aw.append(now)
        self.stats["n_allowed"] += 1
        return True


def share_admission_state(ctrls):
    """Alias the sliding windows (and stats) of several controllers to
    the first one's containers — the admission analogue of
    ``cluster.share_fairness_state``: a user spraying interaction
    starts across replicas hits ONE window, not one per replica."""
    ctrls = list(ctrls)
    if len(ctrls) < 2:
        return ctrls
    head = ctrls[0]
    for c in ctrls[1:]:
        c.user_windows = head.user_windows
        c.app_windows = head.app_windows
        c.stats = head.stats
    return ctrls


def as_controller(admission) -> Optional[AdmissionController]:
    """Normalize the user-facing ``admission=`` knob: None (off), an
    ``AdmissionConfig`` (fresh controller), or a ready
    ``AdmissionController`` (shared across frontends/replicas)."""
    if admission is None:
        return None
    if isinstance(admission, AdmissionController):
        return admission
    if isinstance(admission, AdmissionConfig):
        return AdmissionController(admission)
    raise ValueError(f"admission must be None, AdmissionConfig or "
                     f"AdmissionController, got {type(admission).__name__}")
