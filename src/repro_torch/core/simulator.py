"""Discrete-event continuous-batching serving simulator.

Copy of ``repro/core/simulator.py`` (numpy only): a fix there must be
copied here by hand, so the two simulators stay equal.

Reproduces the paper's evaluation figures deterministically on CPU: the
engine loop (admission → chunked prefill → batched decode → completion)
is literally shared with ``repro_torch.serving.engine`` — both drive the same
``repro_torch.serving.batch_core.BatchCore`` (DESIGN.md §6); iteration
*timing* comes from the analytic roofline cost model instead of wall
clock, so latency/throughput/utilization numbers reflect the target
accelerator rather than this container.

Serving mechanics modeled (all inside ``BatchCore``):
- continuous batching with per-iteration admission (work-conserving);
- chunked prefill (stall-free: running decodes never pause for a long
  prompt — Sarathi-style prefill budget per iteration);
- ``canSchedule`` (Algorithm 1): batch-size cap L_b + KV-memory budget M,
  with predicted-output KV reservation when a predictor is attached;
- adaptive batching: admission stops once the projected iteration time
  exceeds the target (keeps TTFT bounded under bursts);
- per-batch refresh overhead (host-bound gap — the Figure 2c mechanism).

The simulator also exposes the replica protocol (``submit`` / ``step`` /
``clock`` / ``has_work``) consumed by ``repro_torch.serving.cluster.Cluster``
(DESIGN.md §7), so multi-replica experiments reuse this exact loop.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List

import numpy as np

from repro_torch.core import counters as C
from repro_torch.core.request import DECODING, FINISHED, THROTTLED, Request
from repro_torch.core.schedulers import SchedulerBase
from repro_torch.serving.batch_core import BatchConfig, BatchCore
from repro_torch.serving.costmodel import CostModel


@dataclasses.dataclass
class SimConfig(BatchConfig):
    """BatchCore knobs + the simulator's own stopping horizon."""
    max_time: float = 1e9
    # shared-prefix radix KV cache (DESIGN.md §9): the simulator keeps a
    # host-side PagePool + radix tree over prompt token ids so cache-hit
    # admission decisions and TTFT match the engine's paged backend
    prefix_cache: bool = False
    page_size: int = 16
    # event-driven macro-stepping (DESIGN.md §15): when the batch is in
    # a provably scheduling-quiet steady decode (``BatchCore.
    # stable_horizon``), advance many iterations in one vectorized pass.
    # Off by default — the per-iteration loop is the reference; the
    # macro path is pinned bit-identical to it by
    # tests/test_macro_equivalence.py.
    macro_step: bool = False


@dataclasses.dataclass
class Timeline:
    """Per-iteration samples.  ``service`` is *delta-encoded* (DESIGN.md
    §15): each sample holds only the accounts whose accumulated service
    changed that iteration (admitted / produced / preempted), mapped to
    their post-iteration cumulative value.  Reconstruction is a forward
    fill from an implicit all-zero baseline (``account_series``), so
    memory is O(active clients) per sample instead of O(all clients) —
    the difference between 10² and 10⁵ accounts being traceable at all.
    Inside a bulk macro step the deltas additionally coalesce to the
    boundary sample (intermediate samples are empty dicts)."""
    t: List[float] = dataclasses.field(default_factory=list)
    util: List[float] = dataclasses.field(default_factory=list)
    batch: List[int] = dataclasses.field(default_factory=list)
    tokens: List[float] = dataclasses.field(default_factory=list)
    service: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    # per-iteration prefill token budget actually granted (DESIGN.md
    # §12; constant at ``prefill_chunk`` under slo_budget="static")
    budget: List[int] = dataclasses.field(default_factory=list)

    def accounts(self):
        """Sorted accounts that ever accumulated service."""
        seen = set()
        for d in self.service:
            seen.update(d)
        return sorted(seen)

    def account_series(self, account: str) -> np.ndarray:
        """Cumulative service of ``account`` at every sample (forward
        fill of the delta encoding; 0.0 before its first charge)."""
        out = np.empty(len(self.service))
        cur = 0.0
        for i, d in enumerate(self.service):
            v = d.get(account)
            if v is not None:
                cur = v
            out[i] = cur
        return out

    def final_service(self) -> Dict[str, float]:
        """Last-known cumulative service per account (all deltas folded)."""
        out: Dict[str, float] = {}
        for d in self.service:
            out.update(d)
        return out


@dataclasses.dataclass
class SimResult:
    requests: List[Request]
    timeline: Timeline
    scheduler: SchedulerBase
    sim_time: float
    # admission-control accounting (DESIGN.md §13)
    wasted_preempt: float = 0.0     # recompute waste from preemptions
    n_throttled: int = 0            # requests rejected by admission

    # -- metrics ---------------------------------------------------------------
    def by_client(self):
        out: Dict[str, List[Request]] = {}
        for r in self.requests:
            out.setdefault(r.client, []).append(r)
        return out

    def throughput_tokens_per_s(self) -> float:
        tot = sum(r.prompt_len + r.generated for r in self.requests
                  if r.state == FINISHED)
        return tot / max(self.sim_time, 1e-9)

    def service_rate_series(self, window: float = 2.0):
        """Per-client weighted-token service rate over time (the delta-
        encoded timeline is forward-filled per account)."""
        tl = self.timeline
        ts = np.array(tl.t)
        out = {}
        for c in tl.accounts():
            cum = tl.account_series(c)
            rate = np.gradient(cum, ts, edge_order=1) if len(ts) > 2 \
                else np.zeros_like(cum)
            out[c] = (ts, cum, rate)
        return out

    def service_difference(self, c1: str, c2: str):
        """|accumulated weighted service| gap over time (both-backlogged
        windows are where fairness is defined — matches VTC's metric)."""
        tl = self.timeline
        s1 = tl.account_series(c1)
        s2 = tl.account_series(c2)
        return np.array(tl.t), np.abs(s1 - s2)

    def ttfts(self, client=None):
        return np.array([r.ttft() for r in self.requests
                         if r.ttft() is not None
                         and (client is None or r.client == client)])

    def latencies(self, client=None):
        return np.array([r.e2e_latency() for r in self.requests
                         if r.e2e_latency() is not None
                         and (client is None or r.client == client)])

    def mean_util(self) -> float:
        tl = self.timeline
        if not tl.t:
            return 0.0
        ts = np.array(tl.t)
        dt = np.diff(ts, prepend=0.0)
        return float(np.sum(np.array(tl.util) * dt) / max(ts[-1], 1e-9))

    def jain_index(self) -> float:
        xs = np.array(list(self.scheduler.fairness_scores().values()))
        xs = xs[xs > 0]
        if len(xs) == 0:
            return 1.0
        return float(xs.sum() ** 2 / (len(xs) * np.sum(xs ** 2)))

    # -- goodput / waste (DESIGN.md §13) -----------------------------------
    def goodput_tokens_per_s(self) -> float:
        """*Delivered* weighted tokens per second: only requests that
        finished count — tokens computed for preempted-then-dropped or
        horizon-unfinished work are capacity, not goodput."""
        tot = sum(r.prompt_len + C.OUT_TOKEN_WEIGHT * r.generated
                  for r in self.requests if r.state == FINISHED)
        return tot / max(self.sim_time, 1e-9)

    def wasted_tokens(self) -> float:
        """Computed-but-undelivered tokens: recompute waste from
        preemptions (accumulated by ``BatchCore.preempt``) plus whatever
        unfinished requests computed by the horizon (their prefill and
        partial decode occupied the GPU yet delivered nothing)."""
        partial = sum(max(r.prefill_done - r.cached_prefix, 0) + r.generated
                      for r in self.requests if r.state != FINISHED)
        return self.wasted_preempt + partial


class Simulator:
    """One simulated replica.  ``run`` drives a whole trace; the
    ``submit``/``step`` pair is the per-iteration API the cluster layer
    uses to interleave several replicas on a global event loop."""

    def __init__(self, cost_model: CostModel, scheduler: SchedulerBase,
                 sim_cfg: SimConfig = SimConfig(), observer=None,
                 admission=None):
        self.cm = cost_model
        self.sched = scheduler
        self.observer = observer
        cache = None
        if getattr(sim_cfg, "prefix_cache", False):
            from repro_torch.serving.kv_cache import PagePool
            from repro_torch.serving.prefix_cache import PrefixCache
            budget = (sim_cfg.kv_budget_tokens
                      or cost_model.kv_budget_tokens())
            self.pool = PagePool(-(-budget // sim_cfg.page_size),
                                 sim_cfg.page_size)
            cache = PrefixCache(self.pool)
            if sim_cfg.kv_page_size == 1:
                # mirror the paged engine's page-rounded KV accounting
                # (DESIGN.md §10) so sim/engine admission + preemption
                # decisions stay identical with the cache on
                sim_cfg = dataclasses.replace(sim_cfg,
                                              kv_page_size=sim_cfg.page_size)
        self.cfg = sim_cfg
        self.core = BatchCore(scheduler, cost_model, sim_cfg,
                              observer=observer, prefix_cache=cache,
                              admission=admission)
        self.kv_budget = self.core.kv_budget
        self._reset()

    def _reset(self):
        self.t = 0.0
        self.core.reset()               # core owns its mutable state
        self.running = self.core.running   # alias: core owns the batch
        self.tl = Timeline()
        self.n_finished = 0

    @property
    def n_preemptions(self) -> int:
        """Preemption events on this replica (cluster metric)."""
        return self.core.n_preemptions

    # -- replica protocol (cluster layer) -----------------------------------
    @property
    def clock(self) -> float:
        return self.t

    def advance_to(self, t: float):
        self.t = max(self.t, t)

    def submit(self, req: Request):
        # overload-aware admission gate (DESIGN.md §13): a throttled
        # request never reaches a scheduler queue
        if not self.core.accept(req, self.t):
            return
        self.sched.on_arrival(req, self.t)

    def has_work(self) -> bool:
        return bool(self.running) or self.sched.has_waiting()

    def kv_load(self) -> float:
        return self.core.kv_load()

    def queued_prompt_tokens(self) -> int:
        return self.core.queued_prompt_tokens()

    def step(self) -> bool:
        """One continuous-batching iteration on this replica's clock.
        Returns False when idle (no running batch, nothing admissible).
        The iteration *body* — token production, first-token stamping,
        completion detection, observer firing, completion feedback — is
        ``BatchCore.execute_iteration`` (DESIGN.md §15, shared with the
        engine); this frontend supplies timing from the cost model and
        mirrors the physical KV allocation schedule."""
        t = self.t
        # admission (Algorithm 1 inner loop, shared BatchCore)
        admitted = self.core.admit(t, len(self.running))
        self.running.extend(admitted)
        if not self.running and not self.sched.has_waiting():
            return False

        # reservation reconciliation + fairness-aware preemption
        # (DESIGN.md §10) — before the iteration executes, so victims
        # neither prefill nor decode this step
        preempted = self.core.prepare_iteration(t, self.running)
        for r in preempted:
            self.running.remove(r)

        # one continuous-batching iteration
        plan = self.core.plan_prefill(self.running)
        decoding = [r for r in self.running if r.state == DECODING]
        if self.core.prefix_cache is not None:
            # mirror the engine's physical allocation schedule (pages per
            # prefill chunk, one decode row per iteration) on the host
            # pool: under pool pressure, *when* pages are allocated
            # decides *which* warm pages LRU eviction reclaims, and the
            # radix trees of the two frontends must evolve identically
            # (tests/test_parity_matrix.py pins this with the cache on)
            for r, _chunk in plan:
                self.pool.ensure(r.rid, r.prefill_done)
            for r in decoding:
                # this iteration's decode writes KV row prompt+generated-1
                # (generated counts the prefill-emitted first token), so
                # coverage through prompt+generated tokens is needed
                self.pool.ensure(r.rid, r.prompt_len + r.generated)
        ctxs = [r.prompt_len + r.generated for r in decoding]
        fresh = bool(admitted) or bool(preempted) or not self.running
        t_iter = self.core.iteration_time(plan, ctxs, fresh)
        t += t_iter
        self.t = t

        out = self.core.execute_iteration(
            t, plan, decoding, t_iter=t_iter, fresh=fresh,
            admitted=admitted, preempted=preempted,
            pre_complete=self.core.release_kv)
        self.n_finished += len(out.finished)

        # timeline sample (service delta-encoded; DESIGN.md §15)
        self.tl.t.append(t)
        self.tl.util.append(out.util)
        self.tl.batch.append(len(self.running) + len(out.finished))
        self.tl.tokens.append(out.iter_tokens)
        self.tl.service.append(out.service_delta)
        self.tl.budget.append(self.core.last_prefill_budget)
        return True

    def macro_or_step(self, stop_before: float = float("inf")) -> bool:
        """Advance one scheduling quantum: a vectorized macro step over
        the whole stable decode horizon when one exists (DESIGN.md §15),
        else one legacy iteration.  ``stop_before`` is the next
        clock-visible event (pending arrival or ``max_time``) the macro
        step must not run past."""
        k = self.core.stable_horizon()
        if k >= 2:                      # a 1-iteration macro is pure overhead
            tl = self.tl

            def cb(t, util, batch, tokens, delta, budget):
                tl.t.append(t)
                tl.util.append(util)
                tl.batch.append(batch)
                tl.tokens.append(tokens)
                tl.service.append(delta)
                tl.budget.append(budget)

            done, t_end, finished = self.core.execute_macro_step(
                self.t, k, stop_before=stop_before, timeline_cb=cb,
                pre_complete=self.core.release_kv)
            if done:
                self.t = t_end
                self.n_finished += len(finished)
                return True
        return self.step()

    def run(self, requests: List[Request] = None, max_time: float = None,
            interactions=None) -> SimResult:
        """Drive a trace to completion (or ``max_time``).

        ``requests`` — flat open-loop stream (pre-stamped arrivals, the
        historical path, bit-identical to the pre-§13 loop).
        ``interactions`` — first-class ``Interaction`` objects, released
        *closed-loop*: only each interaction's first turn enters the
        arrival stream up front; turn k+1 arrives when ``BatchCore.
        complete`` fires the turn-release hook at turn k's finish time
        plus think time.  Both kinds can be mixed in one run.
        """
        max_time = max_time or self.cfg.max_time
        self._reset()
        heap: List[tuple] = []        # (arrival, seq, req) — seq keeps the
        seq = 0                       # submission order of arrival ties
        #                               identical to the sorted-list loop
        all_reqs: List[Request] = []

        def push(req):
            nonlocal seq
            heapq.heappush(heap, (req.arrival, seq, req))
            all_reqs.append(req)
            seq += 1

        for r in sorted(requests or [], key=lambda r: r.arrival):
            push(r)
        for inter in interactions or []:
            self.core.register_interaction(inter)
            first = inter.next_request()      # keeps its stamped arrival
            if first is not None:
                push(first)
        self.core.on_turn_release = lambda nxt, now: push(nxt)

        while self.t < max_time:
            while heap and heap[0][0] <= self.t:
                self.submit(heapq.heappop(heap)[2])
            if not self.running and not self.sched.has_waiting():
                if not heap:
                    break             # drained: nothing running, queued,
                #                       due, or releasable (closed loop:
                #                       releases only happen inside step)
                self.t = heap[0][0]   # idle jump to the next arrival
                continue
            if self.cfg.macro_step:
                self.macro_or_step(min(heap[0][0], max_time) if heap
                                   else max_time)
            else:
                self.step()

        # result set: everything that entered the arrival stream, plus
        # the turns a throttled/unfinished interaction never released —
        # metrics must see the denied work (delivered-Jain zero-service
        # accounts, throttle counts), not just the admitted subset
        for inter in interactions or []:
            all_reqs.extend(inter.turns[inter.released:])
        all_reqs.sort(key=lambda r: (r.arrival, r.rid))
        return SimResult(requests=all_reqs, timeline=self.tl,
                         scheduler=self.sched, sim_time=self.t,
                         wasted_preempt=self.core.wasted_tokens,
                         n_throttled=sum(r.state == THROTTLED
                                         for r in all_reqs))
