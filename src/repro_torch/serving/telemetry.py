"""Serving-loop observers (DESIGN.md §14): the lifecycle event types,
the ``Observer`` base class and the ``MultiObserver`` fan-out.

``Observer`` is the formal base class for everything that watches the
serving loop.  Every hook is a no-op default; subclasses override the
ones they care about.  ``__init_subclass__`` validates override names at
class-definition time, so a typo'd hook (``on_premept``) raises instead
of silently never firing.  ``BatchCore`` and the engine guard every hook
behind ``if observer is not None``.  The flight recorder and its
exporters are not part of this package yet.
"""
from __future__ import annotations

# Request lifecycle event types (the DESIGN.md §14 schema table).
EVENT_TYPES = (
    "arrival",        # accepted into a scheduler queue
    "throttle",       # rejected by overload admission control
    "admit",          # entered the GPU batch (counters charged)
    "prefill_chunk",  # one chunk of prompt prefill planned/executed
    "first_token",    # prompt finished prefilling; first output token
    "preempt",        # evicted from the batch for recompute
    "requeue",        # popped but failed canSchedule; back to queue head
    "turn_release",   # finished turn released the interaction's next turn
    "complete",       # finished; actual latency/TPS/util fed back
    "iteration",      # per-step sample: batch, budget, KV, counters
)


class Observer:
    """Base class for serving-loop observers (DESIGN.md §14).

    Every hook is a no-op; ``BatchCore`` and the frontends call them
    unconditionally (behind a single ``is not None`` check), so a
    subclass only overrides what it needs.  Defining any ``on_*``
    attribute that is not a known hook raises ``TypeError`` at class
    definition time — the misspelled-override guard.
    """

    _HOOKS = frozenset((
        "on_arrival", "on_throttle", "on_admit", "on_requeue",
        "on_preempt", "on_prefill_budget", "on_prefill_chunk",
        "on_turn_release", "on_complete", "on_iteration",
    ))

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        bad = [n for n in vars(cls)
               if n.startswith("on_") and n not in Observer._HOOKS]
        if bad:
            raise TypeError(
                f"{cls.__name__} defines unknown observer hook(s) "
                f"{bad} — known hooks: {sorted(Observer._HOOKS)}. "
                f"A misspelled hook would never fire; fix the name.")

    # -- wiring (called by BatchCore / Cluster) ---------------------------
    def bind_core(self, core):
        """The ``BatchCore`` this observer watches was constructed."""

    def set_replica(self, idx: int):
        """Stamp the replica index (cluster wiring; default ignores it)."""

    # -- request lifecycle ------------------------------------------------
    def on_arrival(self, req, now: float):
        pass

    def on_throttle(self, req, now: float):
        pass

    def on_admit(self, req, now: float):
        pass

    def on_requeue(self, req, now: float):
        pass

    def on_preempt(self, req, now: float):
        pass

    def on_prefill_budget(self, budget: int):
        pass

    def on_prefill_chunk(self, req, chunk: int):
        pass

    def on_turn_release(self, req, now: float):
        pass

    def on_complete(self, req, now: float, *, latency: float, tps: float,
                    util: float):
        pass

    # -- per-iteration sample (frontends call after token production) -------
    def on_iteration(self, now: float, *, t_iter: float, util: float,
                     fresh: bool, running, produced, first):
        """One simulator/engine step executed.  ``running`` is the batch
        after preemption, ``produced`` the requests that emitted a token
        this step (in production order), ``first`` the rids whose token
        was their first."""


class MultiObserver(Observer):
    """Fan one hook stream out to several observers (e.g. the metrics
    ``HFObserver`` plus a ``FlightRecorder`` on the same run).

    Forwarding is precomputed per hook: only observers that *override*
    a hook are on its target list (as bound methods), so a hook nobody
    implements costs one empty-loop pass — the fan-out must not erode
    the recorder's <3% overhead gate on per-iteration hooks."""

    def __init__(self, *observers):
        self.observers = [o for o in observers if o is not None]
        for hook in ("bind_core", "set_replica", *sorted(self._HOOKS)):
            targets = [getattr(o, hook) for o in self.observers
                       if getattr(type(o), hook) is not getattr(Observer,
                                                                hook)]
            setattr(self, "_" + hook, targets)

    def bind_core(self, core):
        for f in self._bind_core:
            f(core)

    def set_replica(self, idx):
        for f in self._set_replica:
            f(idx)

    def on_arrival(self, req, now):
        for f in self._on_arrival:
            f(req, now)

    def on_throttle(self, req, now):
        for f in self._on_throttle:
            f(req, now)

    def on_admit(self, req, now):
        for f in self._on_admit:
            f(req, now)

    def on_requeue(self, req, now):
        for f in self._on_requeue:
            f(req, now)

    def on_preempt(self, req, now):
        for f in self._on_preempt:
            f(req, now)

    def on_prefill_budget(self, budget):
        for f in self._on_prefill_budget:
            f(budget)

    def on_prefill_chunk(self, req, chunk):
        for f in self._on_prefill_chunk:
            f(req, chunk)

    def on_turn_release(self, req, now):
        for f in self._on_turn_release:
            f(req, now)

    def on_complete(self, req, now, *, latency, tps, util):
        for f in self._on_complete:
            f(req, now, latency=latency, tps=tps, util=util)

    def on_iteration(self, now, *, t_iter, util, fresh, running, produced,
                     first):
        for f in self._on_iteration:
            f(now, t_iter=t_iter, util=util, fresh=fresh, running=running,
              produced=produced, first=first)
