"""Flight recorder: structured event tracing + replay audit (DESIGN.md §14).

Copy of ``repro/serving/telemetry.py`` (no JAX in it): a fix there must
be copied here by hand, so traces and replays stay identical.

Three layers, zero overhead when off (``BatchCore`` and the frontends
guard every hook behind ``if observer is not None``; no observer means
no calls, no allocations):

- ``Observer`` — the formal base class for everything that watches the
  serving loop.  Every hook is a no-op default; subclasses override the
  ones they care about.  ``__init_subclass__`` validates override names
  at class-definition time, so a typo'd hook (``on_premept``) raises
  instead of silently never firing — the failure mode the old
  ``hasattr(self.observer, "on_...")`` duck typing invited.
  ``MultiObserver`` composes several observers behind one hook fan-out.

- ``FlightRecorder`` — an ``Observer`` that records every request
  lifecycle event (``EVENT_TYPES``) with replica/account/interaction
  stamps, plus one ``iteration`` sample per engine/simulator step:
  batch composition, the solved prefill budget, KV occupancy/headroom,
  modeled iteration time, and per-account counter snapshots
  (service + VTC/DLPM counters or Equinox UFC/RFC).  Events carry the
  predictor's per-request output (and MoPE expert regime) at admission
  and the eventual actuals at completion, so prediction accuracy is
  auditable per expert after the fact.

- consumers — ``to_chrome_trace`` (Perfetto-loadable Chrome trace
  JSON: one process per replica, one track per account, counter tracks
  for KV/budget/fairness), ``windowed_fairness`` (rolling Jain and the
  bounded-discrepancy audit: max pairwise weighted-service difference
  over *every* window in which both accounts stay backlogged, per
  Sheng et al., arXiv:2401.00588), and ``replay_counters`` (offline
  re-derivation of the live scheduler's counters purely from the event
  log — the trace is a correctness oracle, not best-effort logging;
  ``tests/test_telemetry.py`` pins replayed == live across policies).

Replay is defined for single-replica traces: cluster runs interleave
per-replica hook streams whose relative order the merged trace does not
preserve (each replica steps on its own clock), so ``merge_traces``
exists for timeline export, not for replay.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

# Request lifecycle event types recorded by FlightRecorder.  Every name
# here must appear (backtick-quoted) in the DESIGN.md §14 schema table —
# scripts/check_docs.py fails CI otherwise.
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

    # -- per-iteration sample (frontends call after token production) -----
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


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------
class FlightRecorder(Observer):
    """Record the full event stream of one replica's serving loop.

    ``trace()`` returns the serializable trace dict consumed by
    ``to_chrome_trace`` / ``windowed_fairness`` / ``replay_counters``.
    One recorder per replica — ``Cluster`` stamps ``set_replica`` so
    ``merge_traces`` can interleave per-replica streams on the shared
    modeled clock.

    Recording cost is gated (< 3% over the metrics observer,
    ``benchmarks/telemetry_overhead.py``), so the hot path defers all
    shaping it can: per-iteration entries are appended as plain tuples
    (requeues as bare rids) and expanded to event dicts lazily on first
    access of ``events`` (export-time, outside the serving loop); the
    replica id is stamped once at ``trace()`` export; and the *table*
    snapshot in the iteration sample (counter dicts, active-account
    set, batch composition — the only part that must be deep-copied
    while the scheduler state is live) is taken every ``sample_every``
    iterations rather than every step.  Per-token state (``produced``,
    ``t_iter``, util, the solved prefill budget) is recorded every
    iteration — counter replay needs it; the subsampled tables only
    feed the timeline counter tracks and the windowed fairness audit,
    where every-K fidelity is plenty.  Pass ``sample_every=1`` for
    full-fidelity snapshots.
    """

    def __init__(self, sample_every: int = 16):
        # mixed log: event dicts (cold lifecycle hooks) and compact
        # tuples (hot hooks), expanded lazily by the ``events`` property
        self._log: List[object] = []
        self.replica = 0
        self.sample_every = max(int(sample_every), 1)
        self.meta: Dict[str, object] = {}
        self._core = None
        self._now = 0.0
        self._budget: Optional[int] = None
        self._iter = 0
        self._requeued: List[int] = []   # rids since the last iteration
        self._mat: Optional[List[dict]] = None
        self._mat_key = (-1, -1)

    @property
    def events(self) -> List[dict]:
        """The event log, materialized: hot-path tuple entries are
        expanded to full event dicts on first access (cached until more
        events are recorded).  A step's requeues are buffered as bare
        rids and expanded here, just before the step's iteration event —
        every requeue happens at the step timestamp, and ``on_requeue``
        is refund-only accounting (commutative with the step's token
        charges), so replay order is preserved where it matters."""
        key = (len(self._log), len(self._requeued))
        if self._mat_key == key:
            return self._mat
        out: List[dict] = []
        for e in self._log:
            if type(e) is not tuple:
                out.append(e)
                continue
            k = e[0]
            if k == "iteration":
                t = e[1]
                if e[7]:
                    for rid in e[7]:
                        out.append({"type": "requeue", "t": t, "rid": rid})
                ev = {"type": k, "t": t, "produced": e[2], "t_iter": e[3],
                      "util": e[4], "fresh": e[5], "budget": e[6]}
                if e[8] is not None:
                    ev.update(e[8])
                out.append(ev)
            elif k == "prefill_chunk":
                out.append({"type": k, "t": e[1], "rid": e[2],
                            "chunk": e[3], "prefill_done": e[4]})
            else:                        # first_token
                out.append({"type": k, "t": e[1], "rid": e[2]})
        for rid in self._requeued:       # requeues after the last step
            out.append({"type": "requeue", "t": self._now, "rid": rid})
        self._mat, self._mat_key = out, key
        return out

    # -- wiring -----------------------------------------------------------
    def bind_core(self, core):
        self._core = core
        self.meta = _scheduler_meta(core)

    def set_replica(self, idx: int):
        self.replica = idx

    def _ev(self, type_: str, t: float, **payload) -> dict:
        ev = {"type": type_, "t": t}
        ev.update(payload)
        self._log.append(ev)
        return ev

    # -- lifecycle hooks --------------------------------------------------
    def on_arrival(self, req, now):
        self._now = now
        self._ev("arrival", now, rid=req.rid, account=req.account,
                 client=req.client, user=req.user, app=req.app,
                 arrival=req.arrival, prompt_len=req.prompt_len,
                 weight=req.weight, interaction_id=req.interaction_id,
                 turn_index=req.turn_index)

    def on_throttle(self, req, now):
        self._now = now
        self._ev("throttle", now, rid=req.rid, account=req.account,
                 interaction_id=req.interaction_id)

    def on_admit(self, req, now):
        self._now = now
        self._ev("admit", now, rid=req.rid, account=req.account,
                 cached_prefix=req.cached_prefix,
                 pred_output_len=req.pred_output_len,
                 pred_latency=req.pred_latency, pred_tps=req.pred_tps,
                 pred_util=req.pred_util,
                 pred_regime=getattr(req, "_pred_regime", None))

    def on_requeue(self, req, now):
        # hottest hook (a saturated replica pops-and-requeues every
        # backlogged client every iteration): a bare rid append, no
        # account (``req.account`` builds a string; the exporter
        # resolves the track via the rid), no timestamp (requeues carry
        # the step time; the ``events`` property re-attaches it)
        self._now = now
        self._requeued.append(req.rid)

    def on_preempt(self, req, now):
        self._now = now
        self._ev("preempt", now, rid=req.rid, account=req.account,
                 n_preempted=req.n_preempted,
                 generated_peak=req.generated_peak)

    def on_prefill_budget(self, budget):
        self._budget = budget

    def on_prefill_chunk(self, req, chunk):
        self._log.append(("prefill_chunk", self._now, req.rid, chunk,
                          req.prefill_done))

    def on_turn_release(self, req, now):
        self._now = now
        self._ev("turn_release", now, rid=req.rid,
                 interaction_id=req.interaction_id,
                 turn_index=req.turn_index, arrival=req.arrival)

    def on_complete(self, req, now, *, latency, tps, util):
        self._now = now
        self._ev("complete", now, rid=req.rid, account=req.account,
                 latency=latency, tps=tps, util=util,
                 generated=req.generated, output_len=req.output_len,
                 cached_prefix=req.cached_prefix,
                 pred_output_len=req.pred_output_len,
                 pred_regime=getattr(req, "_pred_regime", None),
                 n_preempted=req.n_preempted)

    def on_iteration(self, now, *, t_iter, util, fresh, running, produced,
                     first):
        self._now = now
        log = self._log
        for rid in first:
            log.append(("first_token", now, rid))
        rq = self._requeued
        if rq:
            self._requeued = []
        core = self._core
        snap = None
        if core is not None and self._iter % self.sample_every == 0:
            sched = core.sched
            counters = {"service": dict(sched.service)}
            for name in ("counter", "ufc", "rfc"):
                tbl = getattr(sched, name, None)
                if isinstance(tbl, dict):
                    counters[name] = dict(tbl)
            snap = {"batch": [r.rid for r in running],
                    "n_prefilling": sum(r.state == "prefilling"
                                        for r in running),
                    "n_decoding": sum(r.state == "decoding"
                                      for r in running),
                    "kv_used": core.kv_used,
                    "kv_headroom": core.kv_headroom(),
                    "counters": counters,
                    "active": sorted(sched.active_clients())}
        self._iter += 1
        log.append(("iteration", now, [r.rid for r in produced],
                    t_iter, util, fresh, self._budget, rq or None, snap))

    # -- views ------------------------------------------------------------
    def samples(self, full: bool = False) -> List[dict]:
        """Iteration samples; ``full=True`` keeps only the every-K
        samples that carry the counter-table snapshot."""
        if full:
            return [e for e in self.events
                    if e["type"] == "iteration" and "counters" in e]
        return [e for e in self.events if e["type"] == "iteration"]

    def trace(self) -> dict:
        for e in self.events:            # stamp once at export, not in
            e["replica"] = self.replica  # the recording hot path
        return {"version": 1, "meta": dict(self.meta, replica=self.replica),
                "events": self.events}


def _scheduler_meta(core) -> dict:
    """Everything ``replay_counters`` needs to reconstruct the policy's
    accounting: the name plus the knobs that change what a request
    costs (never the knobs that only change *order*, like
    ``victim_policy`` or ``locality_bonus`` — replay consumes the
    recorded decisions, it does not re-make them)."""
    import dataclasses

    from repro_torch.core.schedulers import DLPM, RPM, VTC, Equinox
    sched = core.sched
    meta = {"policy": sched.name, "omega_cached": sched.omega_cached,
            "kv_budget": core.kv_budget, "has_predictor": False}
    if isinstance(sched, VTC):
        meta["out_weight"] = sched.w
        meta["has_predictor"] = sched.predictor is not None
    if isinstance(sched, DLPM):
        meta["quantum"] = sched.quantum
    if isinstance(sched, Equinox):
        meta["hf_params"] = dataclasses.asdict(sched.p)
        meta["has_predictor"] = True
    if isinstance(sched, RPM):
        meta["quota_per_min"] = sched.quota
    return meta


# ---------------------------------------------------------------------------
# trace (de)serialization + merging
# ---------------------------------------------------------------------------
def save_trace(trace: dict, path: str) -> str:
    with open(path, "w") as f:
        json.dump(trace, f, sort_keys=True)
    return path


def load_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def merge_traces(traces) -> dict:
    """Merge per-replica traces on the shared modeled clock (stable sort
    by timestamp, so same-time events keep their per-replica order).
    The result is for timeline export and windowed analysis only —
    counter replay needs a single replica's exact hook order."""
    traces = list(traces)
    events = [ev for tr in traces for ev in tr["events"]]
    events.sort(key=lambda e: e["t"])
    return {"version": 1,
            "meta": {"replicas": [tr["meta"] for tr in traces]},
            "events": events}


# ---------------------------------------------------------------------------
# consumer 1: Perfetto / Chrome trace event JSON
# ---------------------------------------------------------------------------
def _finite(x) -> bool:
    return isinstance(x, (int, float)) and x == x \
        and x not in (float("inf"), float("-inf"))


def to_chrome_trace(trace: dict) -> dict:
    """Chrome-trace-event JSON (``chrome://tracing`` / ui.perfetto.dev):
    one process per replica, one named thread track per account (request
    slices are async ``b``/``e`` pairs keyed by rid; lifecycle points
    are instant events), plus per-replica counter tracks for KV
    occupancy/headroom, the solved prefill budget, and per-account
    service.  Timestamps are modeled seconds scaled to microseconds."""
    out: List[dict] = []
    tids: Dict[tuple, int] = {}       # (replica, account) -> tid
    replicas = set()

    def tid_of(rep: int, account: str) -> int:
        key = (rep, account)
        if key not in tids:
            tids[key] = len([k for k in tids if k[0] == rep]) + 1
            out.append({"ph": "M", "name": "thread_name", "pid": rep,
                        "tid": tids[key], "ts": 0,
                        "args": {"name": account}})
        return tids[key]

    open_rids: Dict[int, tuple] = {}  # rid -> (pid, tid, name)
    for ev in trace["events"]:
        rep = ev.get("replica", 0)
        ts = int(ev["t"] * 1e6)
        et = ev["type"]
        if rep not in replicas:
            replicas.add(rep)
            out.append({"ph": "M", "name": "process_name", "pid": rep,
                        "tid": 0, "ts": 0,
                        "args": {"name": f"replica{rep}"}})
        if et == "admit":
            acct = ev["account"]
            tid = tid_of(rep, acct)
            name = f"r{ev['rid']}"
            open_rids[ev["rid"]] = (rep, tid, name)
            out.append({"ph": "b", "cat": "request", "id": str(ev["rid"]),
                        "name": name, "pid": rep, "tid": tid, "ts": ts,
                        "args": {k: ev[k] for k in
                                 ("account", "cached_prefix",
                                  "pred_output_len") if k in ev}})
        elif et == "complete":
            rep0, tid, name = open_rids.pop(
                ev["rid"], (rep, tid_of(rep, ev["account"]), f"r{ev['rid']}"))
            out.append({"ph": "e", "cat": "request", "id": str(ev["rid"]),
                        "name": name, "pid": rep0, "tid": tid, "ts": ts,
                        "args": {"generated": ev.get("generated"),
                                 "latency": ev.get("latency")}})
        elif et in ("arrival", "throttle", "first_token", "preempt",
                    "requeue", "turn_release"):
            acct = ev.get("account")
            if acct is None and ev["rid"] in open_rids:
                tid = open_rids[ev["rid"]][1]
            else:
                tid = tid_of(rep, acct) if acct is not None else 0
            out.append({"ph": "i", "s": "t", "name": et, "pid": rep,
                        "tid": tid, "ts": ts,
                        "args": {"rid": ev.get("rid")}})
        elif et == "iteration":
            if "kv_used" in ev:
                out.append({"ph": "C", "name": "kv", "pid": rep, "tid": 0,
                            "ts": ts, "args": {
                                "used": ev["kv_used"],
                                "headroom": ev["kv_headroom"]}})
            if ev.get("budget") is not None:
                out.append({"ph": "C", "name": "prefill_budget", "pid": rep,
                            "tid": 0, "ts": ts,
                            "args": {"budget": ev["budget"]}})
            service = ev.get("counters", {}).get("service")
            if service:
                vals = {a: v for a, v in service.items() if _finite(v)}
                if vals:
                    out.append({"ph": "C", "name": "service", "pid": rep,
                                "tid": 0, "ts": ts, "args": vals})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# consumer 2: windowed fairness (bounded-discrepancy audit)
# ---------------------------------------------------------------------------
def sample_scores(sample: dict) -> Dict[str, float]:
    """Per-account fairness scores of one iteration sample: HF where
    UFC/RFC were recorded (Equinox), the VTC/DLPM counter where that
    was, accumulated service otherwise — mirroring each policy's
    ``fairness_scores``."""
    import numpy as np

    from repro_torch.core import counters as C
    tabs = sample.get("counters", {})
    if "ufc" in tabs:
        accounts = sorted(tabs["ufc"])
        if not accounts:
            return {}
        ufc = np.array([tabs["ufc"][a] for a in accounts])
        rfc = np.array([tabs["rfc"].get(a, 0.0) for a in accounts])
        return dict(zip(accounts, C.hf_scores(ufc, rfc)))
    if "counter" in tabs:
        return dict(tabs["counter"])
    return dict(tabs.get("service", {}))


def windowed_fairness(trace: dict) -> dict:
    """The bounded-discrepancy audit (Sheng et al., arXiv:2401.00588,
    Theorem 2 as a *measured* property): for every pair of accounts and
    every time window in which both stay backlogged (queued or
    in-flight at every sample), the difference in weighted service
    accrued inside the window.  Over a maximal both-backlogged run the
    supremum over all sub-windows of |ΔS_a − ΔS_b| equals
    ``max(D) − min(D)`` of the prefix difference D = S_a − S_b, so the
    audit is O(samples) per pair instead of O(samples²).

    Returns ``max_discrepancy`` (tokens; the bound VTC/Equinox claim is
    O(max request size), FCFS's grows with the trace), the pair and
    window that achieved it, and the rolling per-sample Jain index over
    the policy's own fairness scores."""
    from repro_torch.core.metrics import jain

    # only the every-K snapshot samples carry the counter tables and the
    # active set (FlightRecorder.sample_every); the lean in-between
    # iteration events would read as empty activity, not as gaps
    samples = [e for e in trace["events"]
               if e["type"] == "iteration" and "counters" in e]
    result = {"max_discrepancy": 0.0, "worst_pair": None,
              "worst_window": None, "n_windows": 0,
              "rolling_jain": [], "min_jain": 1.0}
    if not samples:
        return result
    times = [s["t"] for s in samples]
    service = [s.get("counters", {}).get("service", {}) for s in samples]
    active = [set(s.get("active", ())) for s in samples]
    accounts = sorted({a for sv in service for a in sv})

    rj = [jain(list(sample_scores(s).values())) for s in samples]
    result["rolling_jain"] = rj
    result["min_jain"] = min(rj) if rj else 1.0

    for i, a in enumerate(accounts):
        for b in accounts[i + 1:]:
            k = 0
            while k < len(samples):
                if a not in active[k] or b not in active[k]:
                    k += 1
                    continue
                j = k
                while j < len(samples) and a in active[j] \
                        and b in active[j]:
                    j += 1
                run = range(k, j)
                if len(run) >= 2:
                    d = [service[m].get(a, 0.0) - service[m].get(b, 0.0)
                         for m in run]
                    lo, hi = min(d), max(d)
                    result["n_windows"] += 1
                    if hi - lo > result["max_discrepancy"]:
                        result["max_discrepancy"] = hi - lo
                        result["worst_pair"] = (a, b)
                        result["worst_window"] = (times[k], times[j - 1])
                k = j
    return result


def prediction_accuracy(trace: dict) -> Dict[object, dict]:
    """Per-expert (MoPE regime) output-length prediction accuracy from
    the event log: the ``admit`` event carries the prediction (and the
    routing regime) as made, the ``complete`` event the actual.  Keys
    are regimes (None for non-MoPE predictors); values report count and
    mean absolute/relative error."""
    preds: Dict[int, dict] = {}
    for ev in trace["events"]:
        if ev["type"] == "admit" and ev.get("pred_output_len") is not None:
            preds[ev["rid"]] = ev
    out: Dict[object, dict] = {}
    for ev in trace["events"]:
        if ev["type"] != "complete" or ev["rid"] not in preds:
            continue
        adm = preds[ev["rid"]]
        regime = adm.get("pred_regime")
        err = abs(ev["output_len"] - adm["pred_output_len"])
        rel = err / max(ev["output_len"], 1)
        agg = out.setdefault(regime, {"n": 0, "abs_err": 0.0,
                                      "rel_err": 0.0})
        agg["n"] += 1
        agg["abs_err"] += err
        agg["rel_err"] += rel
    for agg in out.values():
        agg["abs_err"] /= agg["n"]
        agg["rel_err"] /= agg["n"]
    return out


# ---------------------------------------------------------------------------
# consumer 3: offline counter replay (the correctness oracle)
# ---------------------------------------------------------------------------
class _StubPredictor:
    """Predictor stand-in for replay: the recorded events carry every
    prediction as made, so ``predict`` must keep them (a real predictor
    would re-run a model whose calibration state replay cannot see) and
    ``observe`` must not recalibrate anything."""

    def predict(self, req):
        return req

    def observe(self, req, *, latency, tps, util):
        pass


def scheduler_counters(sched) -> Dict[str, Dict[str, float]]:
    """The policy's accounting tables, uniformly keyed — what replay
    must reproduce exactly.  (``service`` is universal; ``counter`` is
    VTC/DLPM, ``ufc``/``rfc`` Equinox.)"""
    out = {"service": dict(sched.service)}
    for name in ("counter", "ufc", "rfc"):
        tbl = getattr(sched, name, None)
        if isinstance(tbl, dict):
            out[name] = dict(tbl)
    return out


def _scheduler_from_meta(meta: dict):
    from repro_torch.core.counters import HFParams
    from repro_torch.core.schedulers import make_scheduler
    name = meta["policy"]
    stub = _StubPredictor()
    kw = {}
    if name in ("vtc", "dlpm"):
        kw["predictor"] = stub if meta.get("has_predictor") else None
        kw["out_weight"] = meta["out_weight"]
        if name == "dlpm":
            kw["quantum"] = meta["quantum"]
    elif name == "equinox":
        kw["predictor"] = stub
        kw["params"] = HFParams(**meta["hf_params"])
    elif name == "rpm":
        kw["quota_per_min"] = meta["quota_per_min"]
    sched = make_scheduler(name, **kw)
    sched.omega_cached = meta.get("omega_cached", 1.0)
    return sched


def replay_counters(trace: dict) -> Dict[str, Dict[str, float]]:
    """Re-derive the live scheduler's counters purely from the event
    log: reconstruct the policy from the trace metadata, then drive its
    *actual* accounting hooks (``on_arrival``/``on_admit``/``on_token``/
    ``on_preempt``/``on_complete``) with per-rid request stubs updated
    from each event's payload, in recorded order.  Queue membership is
    mirrored (arrival appends, admit removes, preempt re-queues at the
    head; a ``requeue`` nets to zero live, so replay only fires the
    refund hook) because the VTC/Equinox no-gaming lift reads the
    active set at arrival time.

    Returns ``scheduler_counters`` of the replayed policy; equality
    with the live run's is the trace-completeness oracle
    (DESIGN.md §14)."""
    from repro_torch.core.request import Request

    sched = _scheduler_from_meta(trace["meta"])
    stubs: Dict[int, Request] = {}
    for ev in trace["events"]:
        et, t = ev["type"], ev["t"]
        if et == "arrival":
            r = Request(rid=ev["rid"], client=ev["client"],
                        arrival=ev["arrival"], prompt_len=ev["prompt_len"],
                        output_len=0, weight=ev["weight"],
                        user=ev.get("user"), app=ev.get("app"),
                        interaction_id=ev.get("interaction_id"),
                        turn_index=ev.get("turn_index", 0))
            stubs[r.rid] = r
            sched.on_arrival(r, t)
        elif et == "admit":
            r = stubs[ev["rid"]]
            try:
                sched.queues[r.account].remove(r)
            except ValueError:
                pass                      # defensive: never popped twice
            r.cached_prefix = ev["cached_prefix"]
            r.pred_output_len = ev["pred_output_len"]
            r.pred_latency = ev["pred_latency"]
            r.pred_tps = ev["pred_tps"]
            r.pred_util = ev["pred_util"]
            sched.on_admit(r, t)
        elif et == "iteration":
            for rid in ev.get("produced", ()):
                r = stubs[rid]
                r.generated += 1
                sched.on_token(r, t, 1)
        elif et == "preempt":
            r = stubs[ev["rid"]]
            sched.on_preempt(r, t)
            r.generated = 0
            r.cached_prefix = 0
            sched.requeue_head(r)
        elif et == "requeue":
            sched.on_requeue(stubs[ev["rid"]], t)
        elif et == "complete":
            r = stubs[ev["rid"]]
            r.generated = ev["generated"]
            r.output_len = ev["output_len"]
            r.cached_prefix = ev["cached_prefix"]
            sched.on_complete(r, t, latency=ev["latency"], tps=ev["tps"],
                              util=ev["util"])
        # throttle / first_token / prefill_chunk / turn_release carry no
        # counter semantics — they exist for the timeline consumers
    return scheduler_counters(sched)
