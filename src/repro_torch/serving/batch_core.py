"""Shared continuous-batching core (paper Algorithm 1; DESIGN.md §6).

One implementation of the admission / ``canSchedule`` / KV-reservation /
completion-feedback loop, driven by two frontends:

- ``repro_torch.core.simulator.Simulator`` — discrete-event timing from the
  analytic roofline cost model (reproduces the paper's figures on CPU);
- ``repro_torch.serving.engine.ServingEngine`` — real JAX decode with a dual
  clock (wall time for measurement, modeled time for scheduler feedback).

Both frontends own their iteration *timing and token production*; the core
owns every scheduling decision so simulator and engine cannot drift:

- admission (Algorithm 1 inner loop): pop the scheduler's next request,
  check the batch-size cap L_b and the KV budget M with predicted-output
  reservation (``canSchedule``), optionally cap projected iteration time
  (adaptive batching), charge counters via ``scheduler.on_admit``;
- chunked-prefill budgeting (stall-free scheduling, Sarathi-style);
- shared-prefix reuse (DESIGN.md §9): when a ``PrefixCache`` is
  attached, admission looks up the longest cached page-aligned prefix of
  the prompt, adopts those pages (refcount +1) and starts
  ``prefill_done`` there, so ``plan_prefill`` only plans chunks for the
  uncached suffix and ``iteration_time`` prices only uncached tokens
  (each chunk's ``avg_ctx`` still spans the cached prefix — attention
  over cached pages is real work and stays charged);
- iteration timing from the cost model (incl. per-refresh host overhead);
- reservation reconciliation + fairness-aware preemption (DESIGN.md
  §10): the admission-time KV reservation is a *prediction*; every
  iteration ``prepare_iteration`` grows it to the request's actual
  footprint and, when the budget M would be exceeded, preempts the
  scheduler-selected victim by recompute — release its pages, refund its
  service charges, requeue it at the head of its client queue;
- completion: release the KV reservation and feed *actual* latency /
  TPS / utilization back to the scheduler and predictor (Algorithm 1
  line 20 — the recalibration half of the loop).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.request import (DECODING, FINISHED, PREEMPTED, PREFILLING,
                                THROTTLED, Request)
from repro_torch.core.schedulers import SchedulerBase
from repro_torch.serving.admission import as_controller
from repro_torch.serving.costmodel import CostModel
from repro_torch.serving.telemetry import Observer


@dataclasses.dataclass
class BatchConfig:
    """Knobs of the shared admission loop (defaults match the paper's
    simulator setup; the engine overrides ``default_reserve`` and, for
    architectures without incremental-prefill support, falls back to
    ``stall_free=False, adaptive_batching=False`` whole-prompt prefill)."""
    max_batch: int = 32               # L_b
    kv_budget_tokens: Optional[int] = None   # M (None -> from cost model)
    prefill_chunk: int = 512          # chunked-prefill budget per iteration
    stall_free: bool = True
    adaptive_batching: bool = True
    target_iter_time: float = 0.25    # s; adaptive-batching admission cap
    default_reserve: int = 256        # KV reservation w/o predictor
    # KV accounting granularity (DESIGN.md §10): reservations and actual
    # footprints are rounded up to this many tokens.  The paged engine
    # sets it to its page size so that "token budget respected" implies
    # "page pool never exhausts" (sums of page-rounded footprints divide
    # exactly into pages); 1 = exact token accounting (slots backend,
    # plain simulator).
    kv_page_size: int = 1
    # SLO-controllable batch formation (DESIGN.md §12): "static" keeps
    # the fixed ``prefill_chunk`` budget; "auto" solves, every iteration,
    # for the largest prefill token budget (still capped by
    # ``prefill_chunk``) that keeps the decode batch's modeled iteration
    # time under the strictest running TBT target, and fills it in the
    # scheduler's fairness order instead of admission order.
    slo_budget: str = "static"
    # int8 KV pages (DESIGN.md §16): halves KV bytes per token, so a
    # cost-model-derived budget (kv_budget_tokens=None) roughly doubles.
    # The engine quantizes into int8 pools and dequantizes in-kernel.
    kv_quant: bool = False

    def __post_init__(self):
        """User-input validation — ``ValueError``, never ``assert``
        (asserts vanish under ``python -O``).  A non-positive
        ``prefill_chunk`` used to be accepted silently: with
        ``stall_free=True`` it starved every prefill forever (the
        admission loop stays work-conserving, so the suite hung instead
        of failing), and with ``stall_free=False`` the ``1 << 30``
        whole-prompt fallback masked the typo completely.  Same story
        for ``kv_page_size``: ``BatchCore``'s defensive ``max(ps, 1)``
        hid a zero/negative page size that the paged pool could never
        honor."""
        if self.prefill_chunk is None or self.prefill_chunk <= 0:
            raise ValueError(f"prefill_chunk must be a positive token "
                             f"budget, got {self.prefill_chunk!r}")
        if self.kv_page_size is None or self.kv_page_size <= 0:
            raise ValueError(f"kv_page_size must be >= 1 token, got "
                             f"{self.kv_page_size!r}")
        if self.slo_budget not in ("static", "auto"):
            raise ValueError(f"slo_budget must be 'static' or 'auto', "
                             f"got {self.slo_budget!r}")


@dataclasses.dataclass
class IterationOutcome:
    """What one continuous-batching iteration produced (DESIGN.md §15) —
    the return contract of ``BatchCore.execute_iteration``, shared by
    the simulator and the engine so their token-production/completion
    loops are literally one piece of code.  Every field here must be
    documented in DESIGN.md §15 (``scripts/check_docs.py`` enforces
    it)."""
    produced: List[int]          # rids that emitted a token this iteration
    firsts: List[int]            # subset of ``produced``: first tokens
    finished: List[Request]      # requests completed this iteration
    t_iter: float                # modeled iteration duration (s)
    util: float                  # modeled utilization of the iteration
    iter_tokens: int             # prefill chunk tokens + decode tokens
    service_delta: Dict[str, float]   # post-iteration service of every
    #                                   account whose service changed


class BatchCore:
    """Admission + KV accounting + token production + completion
    feedback, frontend-agnostic.

    Frontends call, per iteration:
        ``admit(now, batch_len)``         -> newly admitted requests
        ``prepare_iteration(now, run)``   -> reconcile + preempted victims
        ``plan_prefill(running)``         -> [(req, chunk), ...] prefill plan
        ``iteration_time(plan, ...)``     -> modeled iteration duration
        ``execute_iteration(now, ...)``   -> token production, first-token
                                             stamping, completion detection,
                                             observer firing, completion
                                             feedback -> IterationOutcome
    and, on the event-driven fast path (DESIGN.md §15):
        ``stable_horizon()``              -> k decode-only iterations that
                                             are provably scheduling-quiet
        ``execute_macro_step(t0, k, ..)`` -> advance k iterations at once

    The core also *owns* the running batch (``self.running``) and every
    piece of mutable per-run state (``reset()``); frontends alias the
    list and drive it, so state like the prompt-token backlog
    (``queued_prompt_tokens``) has exactly one implementation.
    """

    def __init__(self, scheduler: SchedulerBase, cost_model: CostModel,
                 cfg: BatchConfig = None, observer=None, prefix_cache=None,
                 admission=None):
        self.sched = scheduler
        self.cm = cost_model
        self.cfg = cfg or BatchConfig()
        if observer is not None and not isinstance(observer, Observer):
            # formal hook protocol (DESIGN.md §14): duck-typed observers
            # made a typo'd hook name fail silently — the base class
            # validates override names at class-definition time
            raise TypeError(
                f"observer must be a repro_torch.serving.telemetry.Observer "
                f"(got {type(observer).__name__}); subclass it so hook "
                f"names are checked instead of hasattr-guessed")
        self.observer = observer
        self.prefix_cache = prefix_cache      # repro_torch.serving.prefix_cache
        #   (property: also threads the locality probe into the scheduler)
        self.kv_budget = (self.cfg.kv_budget_tokens
                          or cost_model.kv_budget_tokens(
                              kv_quant=self.cfg.kv_quant or None))
        self.kv_page = max(getattr(self.cfg, "kv_page_size", 1) or 1, 1)
        self.admission = as_controller(admission)
        # mutable per-run state: created once, zeroed by ``reset()`` so
        # construction and a frontend reset can never drift apart
        self.reserved: Dict[int, int] = {}
        self.running: List[Request] = []
        self.reset()
        if observer is not None:
            observer.bind_core(self)    # after budgets/config are final

    def reset(self):
        """Zero every piece of mutable per-run state this core owns —
        the one construction/reset path.  ``reserved`` and ``running``
        are cleared *in place* because frontends alias them
        (``ServingEngine.reserved``, both frontends' ``running``)."""
        self.kv_used = 0
        self.reserved.clear()
        self.running.clear()
        self.n_preemptions = 0          # preemption events on this replica
        self.blocked_client = None      # set by try_admit on canSchedule fail
        self.last_prefill_budget = None  # solved budget of the last
        #                                  plan_prefill (DESIGN.md §12)
        # interactions + overload-aware admission (DESIGN.md §13) -----------
        self.interactions: Dict[int, object] = {}   # id -> Interaction
        self.on_turn_release = None     # frontend hook: next turn -> arrivals
        self.throttled: List[Request] = []
        self.wasted_tokens = 0.0        # recompute waste from preemptions

    # -- locality probe threading (DESIGN.md §11) ----------------------------
    @property
    def prefix_cache(self):
        return self._prefix_cache

    @prefix_cache.setter
    def prefix_cache(self, cache):
        """Attaching a prefix cache (at construction, or late — the
        engine wires its pool-backed cache after ``BatchCore.__init__``)
        also hands the scheduler a side-effect-free locality probe, so
        DLPM's LPM ordering and Equinox's ``locality_bonus`` see the
        same radix tree admission adopts from."""
        self._prefix_cache = cache
        self.sched.locality_probe = (self.probe_cached_prefix
                                     if cache is not None else None)

    def probe_cached_prefix(self, req: Request) -> int:
        """Side-effect-free LPM score of a queued request: the
        page-aligned cached prefix admission would adopt *right now*,
        under the same cap rule as ``PrefixCache.lookup`` (the prompt's
        last token is always recomputed).  Must not touch LRU stamps —
        scoring every feasible candidate would otherwise distort
        eviction order toward whoever queues the most."""
        cache = self._prefix_cache
        toks = req.prompt_tokens
        if cache is None or toks is None or req.prompt_len <= 1:
            return 0
        m = cache.match_len(toks[:req.prompt_len])
        cap = (req.prompt_len - 1) // cache.page_size * cache.page_size
        return min(m, cap)

    def _round_kv(self, tokens: int) -> int:
        """Round a KV footprint up to the accounting granularity."""
        ps = self.kv_page
        return -(-tokens // ps) * ps if ps > 1 else tokens

    # -- canSchedule ---------------------------------------------------------
    def reserve_amount(self, req: Request) -> int:
        """KV tokens to reserve at admission: *uncached* prompt + predicted
        output.  Adopted prefix pages are already resident and refcounted
        (DESIGN.md §9) — charging the full prompt would double-count them
        and under-admit cache hits.  A preempted request's reservation is
        floored at its largest observed output (``generated_peak``), so a
        known misprediction is not repeated at re-admission."""
        pred = req.pred_output_len
        pred = int(pred if pred is not None else self.cfg.default_reserve)
        return self._round_kv((req.prompt_len - req.cached_prefix)
                              + max(pred, req.generated_peak))

    def kv_headroom(self) -> int:
        """Effective KV budget for the canSchedule / preemption checks:
        the configured budget minus pool capacity held by cache-pinned
        pages that live adopters reference but no reservation charges
        (the satellite-1 discount) — without this deduction the token
        accounting could over-commit the physical pool even while
        ``kv_used <= kv_budget`` (DESIGN.md §10)."""
        if self.prefix_cache is None:
            return self.kv_budget
        pool = self.prefix_cache.pool
        return self.kv_budget - (pool.page_size
                                 * pool.pinned_unaccounted_pages())

    def kv_load(self) -> float:
        """Fraction of the KV budget currently reserved (dispatcher signal)."""
        return self.kv_used / max(self.kv_budget, 1)

    def _requeue(self, req: Request, now: float):
        self.sched.requeue_head(req)
        self.sched.on_requeue(req, now)
        if self.observer is not None:
            self.observer.on_requeue(req, now)

    # -- overload-aware admission (DESIGN.md §13) ----------------------------
    def register_interaction(self, inter):
        """Make an interaction's turn chain visible to ``complete`` (the
        closed-loop release rule) and to ``accept``'s throttle-before-
        inflight test."""
        self.interactions[inter.interaction_id] = inter

    def queued_prompt_tokens(self) -> int:
        """Prompt-token backlog — the second overload signal (a saturated
        KV can drain; a deep prefill backlog means arrivals outpace
        completions).  One implementation for both consumers: the
        admission controller's ``overloaded()`` check and the replica
        routing protocol (``Cluster``'s least-kv / min-ttft scores) read
        the same number — scheduler queues plus the un-prefilled
        remainder of already-admitted PREFILLING requests, which is
        backlog the batch still has to chew through."""
        return sum(r.prompt_len
                   for c in self.sched._live_backlog()
                   for r in self.sched.queues[c]) \
            + sum(r.prompt_len - r.prefill_done for r in self.running
                  if r.state == PREFILLING)

    def overloaded(self) -> bool:
        """Is this replica under enough pressure that the admission
        windows should bite?  Off-peak the throttle must be invisible —
        that's what distinguishes it from a static RPM quota."""
        if self.admission is None:
            return False
        cfg = self.admission.cfg
        return (self.kv_load() >= cfg.kv_thresh
                or self.queued_prompt_tokens()
                >= cfg.queue_thresh * self.kv_budget)

    def accept(self, req: Request, now: float) -> bool:
        """Admission-control gate in front of ``scheduler.on_arrival`` —
        both frontends route every arrival through here.  Returns False
        when the request (necessarily a turn-0: in-flight turns always
        pass) was throttled; the whole interaction is then rejected and
        its unreleased turns are marked THROTTLED."""
        if self.admission is None \
                or self.admission.allow(req, now, self.overloaded()):
            if self.observer is not None:
                self.observer.on_arrival(req, now)
            return True
        req.state = THROTTLED
        self.throttled.append(req)
        inter = (self.interactions.get(req.interaction_id)
                 if req.interaction_id is not None else None)
        if inter is not None:
            inter.throttle()
        if self.observer is not None:
            self.observer.on_throttle(req, now)
        return False

    def try_admit(self, now: float, batch_len: int,
                  exclude=None) -> Optional[Request]:
        """One Algorithm-1 admission attempt.  Returns the admitted request
        or None (batch full / queue empty / canSchedule failed — in which
        case the popped request is put back at the head of its queue).
        After a None, ``blocked_client`` names the client whose head
        failed ``canSchedule`` (the frontend excludes it and keeps
        admitting other clients — one client's big head request, e.g. a
        preempted-and-regrown one, must not head-of-line-block everyone
        else) or is None when admission should stop for this iteration."""
        self.blocked_client = None
        if batch_len >= self.cfg.max_batch:
            return None
        req = self.sched.pop_next(now, exclude)
        if req is None:
            return None
        # shared-prefix lookup (DESIGN.md §9): page-aligned cached prefix
        # of the prompt.  Re-probed on every attempt — the tree may have
        # grown since a failed admission requeued this request.
        req.cached_prefix = (self.prefix_cache.lookup(req, now)
                             if self.prefix_cache is not None else 0)
        need = self.reserve_amount(req)
        if self.kv_used + need > self.kv_headroom() and batch_len > 0:
            # canSchedule failed -> requeue at head, skip this account
            self._requeue(req, now)
            self.blocked_client = req.account
            return None
        if self.cfg.adaptive_batching and batch_len > 0:
            proj = self.cm.prefill_time(
                min(req.prompt_len - req.cached_prefix,
                    self.cfg.prefill_chunk))
            if proj > self.cfg.target_iter_time:
                # iteration-time budget: stop admitting entirely
                self._requeue(req, now)
                return None
        self.kv_used += need
        self.reserved[req.rid] = need
        req.state = PREFILLING
        req.admit_time = now
        # a cached prefix is prefill work already done: chunks only cover
        # the uncached suffix (capped so the last prompt token — whose
        # logits seed the first output token — is always recomputed)
        req.prefill_done = req.cached_prefix
        if self.prefix_cache is not None:
            self.prefix_cache.attach(req, now)
        self.sched.on_admit(req, now)
        if self.observer is not None:
            self.observer.on_admit(req, now)
        return req

    def admit(self, now: float, batch_len: int, has_capacity=None,
              on_admitted=None) -> List[Request]:
        """Admission loop: admit while the batch cap, KV budget and
        adaptive-batching projection all hold, skipping (not stopping at)
        clients whose head request does not fit the remaining budget.
        The one implementation of the skip protocol — the engine passes
        ``has_capacity`` (free decode slot available?) and ``on_admitted``
        (bind the request to a slot) so its slot bookkeeping rides the
        same loop instead of duplicating it."""
        admitted: List[Request] = []
        blocked = set()
        while has_capacity is None or has_capacity():
            req = self.try_admit(now, batch_len + len(admitted),
                                 exclude=blocked)
            if req is not None:
                if on_admitted is not None:
                    on_admitted(req)
                admitted.append(req)
                continue
            if self.blocked_client is None:
                break
            blocked.add(self.blocked_client)
        return admitted

    # -- reservation reconciliation + preemption (DESIGN.md §10) -------------
    def footprint(self, req: Request) -> int:
        """Actual private KV tokens ``req`` needs through its *next*
        decode write: the uncached prompt plus the tokens generated so
        far (the next decode appends its KV at row ``prompt+generated``,
        so this count covers that write)."""
        return (req.prompt_len - req.cached_prefix) + req.generated

    def reconcile(self, req: Request) -> int:
        """Grow the reservation in place when decode has outrun the
        admission-time prediction (the over-commit bug this subsystem
        fixes: ``kv_used`` used to stay frozen at the reservation while
        the real footprint kept growing).  Returns the extension."""
        need = self._round_kv(self.footprint(req))
        held = self.reserved.get(req.rid, 0)
        if need <= held:
            return 0
        self.kv_used += need - held
        self.reserved[req.rid] = need
        return need - held

    def preempt(self, req: Request, now: float) -> Request:
        """Preempt by recompute: drop the reservation and the pages
        (refcounted — shared prefix pages survive in the cache, so
        re-prefill can re-adopt them cheaply), refund the service charges
        (``scheduler.on_preempt``), reset the request and requeue it at
        the *head* of its client queue."""
        self.kv_used -= self.reserved.pop(req.rid, 0)
        self.release_kv(req)
        # recompute waste (DESIGN.md §13): every token this admission
        # computed — the uncached prefill plus all generated output — is
        # discarded and will be re-computed after re-admission
        self.wasted_tokens += max(req.prefill_done - req.cached_prefix, 0) \
            + req.generated
        req.generated_peak = max(req.generated_peak, req.generated)
        req.state = PREEMPTED
        req.n_preempted += 1
        req.preempt_time = now
        req.generated = 0
        req.prefill_done = 0
        req.cached_prefix = 0
        self.n_preemptions += 1
        self.sched.on_preempt(req, now)
        self.sched.requeue_head(req)
        if self.observer is not None:
            self.observer.on_preempt(req, now)
        return req

    def prepare_iteration(self, now: float, running: List[Request]
                          ) -> List[Request]:
        """Called after admission, before the iteration executes: grow
        every DECODING request's reservation to its actual footprint and,
        while the budget is exceeded, preempt the scheduler-selected
        victim (never the last running request — it proceeds serially,
        exactly like an over-budget solo admission).  Returns the victims
        in preemption order; the frontend removes them from its batch and
        frees backend state."""
        for r in running:
            if r.state == DECODING:
                self.reconcile(r)
        preempted: List[Request] = []
        # kv_headroom is re-evaluated per victim: preempting an adopter
        # releases its adoptions, which can shrink the pinned deduction
        while self.kv_used > self.kv_headroom():
            cands = [r for r in running if r not in preempted]
            if len(cands) <= 1:
                break
            victim = self.sched.select_victim(
                self.slo_victim_pool(cands, now), now)
            if victim is None:
                break
            self.preempt(victim, now)
            preempted.append(victim)
        return preempted

    @staticmethod
    def slo_victim_pool(cands: List[Request], now: float) -> List[Request]:
        """Narrow preemption candidates by SLO class before the
        scheduler's fairness rule picks inside the pool (DESIGN.md §12,
        composing with §10's ``select_victim``): when interactive and
        batch traffic share the batch, batch-class requests absorb the
        over-commit first — and among those, the ones *already* missing
        their own targets lose the least delivered QoS.  Single-class
        batches (including every pre-SLO workload, where ``slo_class``
        is None everywhere) pass through unchanged, so the §10 policies
        are bit-identical without class information."""
        batch = [r for r in cands if r.slo_class != "interactive"]
        if not batch or len(batch) == len(cands):
            return cands
        violating = [r for r in batch if r.slo_violating(now)]
        return violating or batch

    # -- chunked prefill -----------------------------------------------------
    def strictest_tbt(self, running: List[Request]) -> Optional[float]:
        """Tightest TBT target among the *decoding* requests — the SLO
        the next mixed iteration must deliver under (DESIGN.md §12).
        PREFILLING requests impose nothing here: their clock is TTFT,
        which the budget serves, not constrains.  None when no running
        decode carries a target (the solver then falls back to the
        static cap)."""
        targets = [r.tbt_slo for r in running
                   if r.state == DECODING and r.tbt_slo is not None]
        return min(targets) if targets else None

    def _planned_step_time(self, order: List[Request], ctx_lens,
                           budget: int) -> float:
        """Modeled duration of the mixed iteration that ``plan_prefill``
        would produce with this budget: the same greedy fill over
        ``order`` (so the solve prices exactly the chunks the plan will
        take), plus the batch-refresh overhead — assumed worst-case
        *paid*, since granting budget means the batch is changing."""
        chunks, rem = [], budget
        for r in order:
            if rem <= 0:
                break
            c = min(r.prompt_len - r.prefill_done, rem)
            if c > 0:
                chunks.append((c, r.prefill_done + c / 2))
                rem -= c
        return self.cm.mixed_step_time(chunks, ctx_lens) \
            + self.cm.hw.batch_overhead

    def solve_prefill_budget(self, order: List[Request], ctx_lens,
                             tbt_target: float, cap: int) -> int:
        """Largest prefill token budget B ∈ [0, cap] whose planned mixed
        iteration stays within ``tbt_target`` — ``CostModel.
        mixed_step_time`` inverted over the chunk budget (DESIGN.md
        §12).  The step time is monotone non-decreasing in B (more chunk
        tokens never price cheaper), so a binary search over the integer
        budget is exact.  Returns 0 when even a decode-only iteration
        busts the target (the decode batch must shrink by completion
        before prefill resumes — never a livelock: decodes finish on
        their own and the budget reopens).

        Guarantees (property-tested in ``tests/test_slo_batching.py``):
        monotone non-increasing in decode batch size and in SLO
        strictness, never exceeds ``cap``, and any B > 0 satisfies
        the target under the cost model."""
        total = sum(r.prompt_len - r.prefill_done for r in order)
        hi = min(cap, total)
        if hi <= 0:
            return 0
        if self._planned_step_time(order, ctx_lens, hi) <= tbt_target:
            return hi
        if self._planned_step_time(order, ctx_lens, 0) > tbt_target:
            return 0
        lo = 0                         # feasible; hi infeasible
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if self._planned_step_time(order, ctx_lens, mid) <= tbt_target:
                lo = mid
            else:
                hi = mid
        return lo

    def plan_prefill(self, running: List[Request]):
        """Advance PREFILLING requests within this iteration's chunk budget
        (stall-free: running decodes never wait on a long prompt).

        ``slo_budget="static"`` (default): the historical fixed
        ``prefill_chunk`` budget, filled in ``running`` (admission)
        order — bit-identical to the pre-§12 planner.

        ``slo_budget="auto"`` (DESIGN.md §12): the budget is solved per
        iteration — the largest B ≤ ``prefill_chunk`` whose mixed
        iteration keeps the decode batch under its strictest running
        TBT target — and filled in the *scheduler's* fairness order
        (``SchedulerBase.prefill_order``: VTC/DLPM smallest counter,
        Equinox smallest HF), so when the budget cannot cover everyone
        the shortfall lands on the most-served client.

        Returns the per-request chunk plan ``[(req, chunk), ...]`` in
        fill order with every ``chunk > 0``, mutating ``prefill_done`` —
        this single method is what makes simulator and engine take
        identical chunking decisions (the engine executes the plan
        against the model, the simulator only times it).  The budget
        actually granted is recorded in ``last_prefill_budget`` and
        mirrored to the observer's ``on_prefill_budget`` hook."""
        cap = self.cfg.prefill_chunk if self.cfg.stall_free else 1 << 30
        prefilling = [r for r in running
                      if r.state == PREFILLING
                      and r.prompt_len - r.prefill_done > 0]
        budget = cap
        if self.cfg.slo_budget == "auto":
            order = self.sched.prefill_order(prefilling)
            tbt = self.strictest_tbt(running)
            if tbt is not None and order:
                ctxs = [r.prompt_len + r.generated for r in running
                        if r.state == DECODING]
                budget = self.solve_prefill_budget(order, ctxs, tbt, cap)
        else:
            order = prefilling
        self.last_prefill_budget = budget
        if self.observer is not None:
            self.observer.on_prefill_budget(budget)
        plan: List[tuple] = []
        for r in order:
            if budget <= 0:
                break
            chunk = min(r.prompt_len - r.prefill_done, budget)
            r.prefill_done += chunk
            budget -= chunk
            plan.append((r, chunk))
            if self.observer is not None:
                self.observer.on_prefill_chunk(r, chunk)
        return plan

    def prefix_match_len(self, tokens) -> int:
        """Longest cached prefix of ``tokens`` on this replica (tokens; 0
        without a prefix cache).  Side-effect free — the
        ``prefix_affinity`` routing probe must not distort LRU order."""
        if self.prefix_cache is None:
            return 0
        return self.prefix_cache.match_len(tokens)

    def note_prefill_complete(self, req: Request, now: float):
        """A request's prompt finished prefilling (its first token exists):
        publish the whole-page prompt prefix into the prefix cache so
        later requests — the next conversation turn, a sibling sharing
        the system prompt — can reuse it.  Called by both frontends at
        the same lifecycle point so their trees evolve identically."""
        if self.prefix_cache is not None:
            self.prefix_cache.insert(req, now)

    def release_kv(self, req: Request):
        """Drop the request's page references (refcounted: shared prefix
        pages survive in the cache; private pages return to the pool)."""
        if self.prefix_cache is not None:
            self.prefix_cache.release(req)

    # -- timing --------------------------------------------------------------
    def refresh_overhead(self, fresh_batch: bool) -> float:
        """Host-side batch-refresh cost, paid whenever the batch changed
        (the Figure 2c mechanism) — the single place this rule lives."""
        return self.cm.hw.batch_overhead if fresh_batch else 0.0

    def iteration_time(self, plan, ctx_lens, fresh_batch: bool) -> float:
        """Modeled duration of one iteration: fused chunked-prefill +
        batched-decode pass (one weight stream — ``mixed_step_time``) +
        host-side refresh overhead when the batch changed.  ``plan`` is
        the ``plan_prefill`` output; each chunk is priced with the mean
        context its tokens attend to, so a late chunk of a long prompt
        pays full-prefix attention."""
        chunks = [(c, (r.prefill_done - c) + c / 2) for r, c in plan]
        t = self.cm.mixed_step_time(chunks, ctx_lens)
        return max(t + self.refresh_overhead(fresh_batch), 1e-6)

    def iteration_util(self, t_iter: float, fresh_batch: bool,
                       n_running: int) -> float:
        """Modeled utilization of one iteration — refresh overhead is dead
        time, and small batches underutilize the chip.  Shared so the
        engine and the simulator feed identical Util values back to the
        scheduler (Equinox's RFC term)."""
        overhead = self.refresh_overhead(fresh_batch)
        return (1.0 - overhead / max(t_iter, 1e-9)) * min(
            n_running / max(self.cfg.max_batch * 0.25, 1), 1.0)

    # -- token production (the one iteration body; DESIGN.md §15) ------------
    def execute_iteration(self, now: float, plan, decoding, *,
                          t_iter: float, fresh: bool, firsts=None,
                          admitted=(), preempted=(),
                          on_first=None, on_decode=None,
                          pre_complete=None, post_complete=None
                          ) -> IterationOutcome:
        """The shared iteration body both frontends used to duplicate:
        token production (prefill-completion first tokens + one decode
        token per DECODING request), first-token stamping, completion
        detection, observer firing and the completion feedback loop.

        The frontend has already advanced its clock to ``now`` (timing is
        frontend-owned: cost model vs wall clock) and supplies:

        - ``plan``      — this iteration's ``plan_prefill`` output;
        - ``decoding``  — requests that were DECODING at iteration start;
        - ``firsts``    — production schedule.  None (simulator): scan
          ``self.running`` in order, interleaving first tokens with
          decode tokens exactly like the historical sim loop.  A list
          (engine): emit these first tokens first, then the decode
          tokens — the historical engine order;
        - ``on_first(req)`` / ``on_decode(req)`` — physical-KV hooks run
          before the request's bookkeeping (engine: install the prefilled
          cache / sample the next token);
        - ``pre_complete(req)`` / ``post_complete(req)`` — around
          ``complete`` for each finished request (sim: ``release_kv``;
          engine: free pool pages + vacate the slot).

        Mutates request lifecycle state and ``self.running`` (finished
        requests are removed); fires ``scheduler.on_token`` per produced
        token and ``observer.on_iteration`` *before* completions, so the
        replay oracle sees hook calls in the scheduler's order."""
        running = self.running
        sched = self.sched
        produced_reqs: List[Request] = []
        first_rids: List[int] = []
        done_now: List[Request] = []

        def emit_first(r: Request):
            if on_first is not None:
                on_first(r)
            r.state = DECODING
            r.generated = 1              # prefill emits the first token
            if r.first_token_time is None:
                # kept across preempt/recompute cycles: the first token
                # was already streamed at its original stamp
                r.first_token_time = now
            self.note_prefill_complete(r, now)
            sched.on_token(r, now, 1)
            produced_reqs.append(r)
            first_rids.append(r.rid)
            if r.generated >= r.output_len:
                r.state = FINISHED
                r.finish_time = now
                done_now.append(r)

        def emit_decode(r: Request):
            if on_decode is not None:
                on_decode(r)
            r.generated += 1
            sched.on_token(r, now, 1)
            produced_reqs.append(r)
            if r.generated >= r.output_len:
                r.state = FINISHED
                r.finish_time = now
                done_now.append(r)

        if firsts is None:
            # simulator order: one pass over the running batch, each
            # request produced where it sits
            for r in running:
                if r.state == PREFILLING and r.prefill_done >= r.prompt_len:
                    emit_first(r)
                elif r.state == DECODING:
                    emit_decode(r)
        else:
            # engine order: completed prefills first, then the decode
            # batch that was captured at iteration start
            for r in firsts:
                emit_first(r)
            for r in decoding:
                emit_decode(r)

        iter_tokens = sum(c for _, c in plan) + len(decoding)
        util = self.iteration_util(t_iter, fresh, len(running))
        if self.observer is not None:
            # per-iteration sample BEFORE the completion feedback, so the
            # replay oracle sees token charges and completion
            # reconciliation in the same order the scheduler did
            self.observer.on_iteration(now, t_iter=t_iter, util=util,
                                       fresh=fresh, running=running,
                                       produced=produced_reqs,
                                       first=first_rids)
        for r in done_now:
            running.remove(r)
            if pre_complete is not None:
                pre_complete(r)
            self.complete(r, now, util=util)
            if post_complete is not None:
                post_complete(r)
        accts = {r.account for r in produced_reqs}
        accts.update(r.account for r in admitted)
        accts.update(r.account for r in preempted)
        delta = {a: sched.service[a] for a in sorted(accts)}
        return IterationOutcome(produced=[r.rid for r in produced_reqs],
                                firsts=first_rids, finished=done_now,
                                t_iter=t_iter, util=util,
                                iter_tokens=iter_tokens,
                                service_delta=delta)

    # -- event-driven macro-stepping (DESIGN.md §15) -------------------------
    def stable_horizon(self) -> int:
        """Number of upcoming iterations that are provably *scheduling-
        quiet*: pure batched decode where no admission, preemption,
        prefill-budget or completion decision can change anything — so
        they may be advanced in one vectorized pass.  Exhaustive
        conditions (each one's violation is an event that ends a macro
        step; DESIGN.md §15):

        1. the batch is non-empty and every running request is DECODING
           (a PREFILLING request changes the chunk plan every iteration);
        2. no request is queued on any account (a queued head re-attempts
           admission — and fires requeue telemetry — every iteration);
        3. k stops at the earliest completion: ``min(output_len -
           generated)`` (completions feed the scheduler/predictor and can
           unblock admission);
        4. k stops before reservation growth would exceed the KV
           headroom, i.e. before ``prepare_iteration`` would preempt
           (closed-form page-rounded growth, ``_kv_stable_iters``);
        5. the *frontend* additionally stops before the next pending
           arrival / turn release / ``max_time`` (clock-dependent — the
           core cannot see the arrival heap), via ``stop_before``.

        Returns 0 when no quiet horizon exists (frontends fall back to the
        per-iteration path)."""
        running = self.running
        if not running or self.sched.has_waiting():
            return 0
        for r in running:
            if r.state != DECODING:
                return 0
        k = min(r.output_len - r.generated for r in running)
        if k <= 0:
            return 0
        return self._kv_stable_iters(running, k)

    def _kv_stable_iters(self, running, k: int) -> int:
        """Largest m <= k such that growing every reservation through
        iteration m-1 stays within the KV headroom (page-rounded, exact
        integer arithmetic — identical to m successive ``reconcile``
        passes).  Headroom is constant over a decode-only horizon: the
        pinned-page deduction only moves on admission / prefill
        completion / release, none of which occur inside a macro step."""
        headroom = self.kv_headroom()

        def used_at(i: int) -> int:
            u = self.kv_used
            for r in running:
                need = self._round_kv(self.footprint(r) + i)
                held = self.reserved.get(r.rid, 0)
                if need > held:
                    u += need - held
            return u

        if used_at(k - 1) <= headroom:
            return k
        if used_at(0) > headroom:
            return 0
        lo, hi = 0, k - 1          # used_at(lo) fits; used_at(hi) does not
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if used_at(mid) <= headroom:
                lo = mid
            else:
                hi = mid
        return lo + 1

    def execute_macro_step(self, t0: float, k: int, *,
                           stop_before: float = float("inf"),
                           timeline_cb=None, pre_complete=None,
                           post_complete=None):
        """Advance up to ``k`` steady-decode iterations (a
        ``stable_horizon`` prefix) in one pass.  Returns
        ``(n_done, t_end, finished)``.

        Per-iteration step times come from ``CostModel.
        decode_macro_times`` in closed form (bit-identical to the
        sequential cost-model calls — integer-exactness argument in its
        docstring); the clock itself stays a sequential float fold, so
        every timestamp matches the per-iteration loop exactly.
        Iteration i executes only while its *start* time is before
        ``stop_before`` (the legacy loop's arrival/horizon rule).

        Two inner paths, both bit-identical in every scheduler table,
        request timestamp and KV count:

        - **bulk** (no observer, no prefix cache, and the scheduler's
          ``macro_bulk_ok`` holds — same-account batch-mates share an
          identical per-token increment, so per-request folds commute
          with the per-iteration order): billing via
          ``SchedulerBase.on_tokens`` (the proven sequential-fold
          equivalent), reservation growth in closed form.  Timeline
          service deltas coalesce to the macro boundary (empty dicts in
          between — DESIGN.md §15).
        - **interleaved** (otherwise): per-iteration ``on_token`` /
          ``reconcile`` / pool ``ensure`` / observer firing in exactly
          the legacy order, so flight-recorder traces, snapshots and
          ``replay_counters`` pin bit-identical; still skips admission,
          victim selection, prefill planning and per-iteration cost-model
          sums."""
        running = self.running
        sched = self.sched
        obs = self.observer
        cache = self.prefix_cache
        n = len(running)
        times = self.cm.decode_macro_times(
            [r.prompt_len + r.generated for r in running], k)
        # with no PREFILLING request the planner grants the full cap and
        # plans no chunks, under both slo_budget modes
        budget = self.cfg.prefill_chunk if self.cfg.stall_free else 1 << 30
        bulk = (obs is None and cache is None
                and sched.macro_bulk_ok(running))
        t = t0
        done = 0
        if bulk:
            t_stamps: List[float] = []
            samples: List[tuple] = []
            for i in range(k):
                if t >= stop_before:
                    break
                t_iter = max(float(times[i]), 1e-6)
                t = t + t_iter
                t_stamps.append(t)
                done += 1
                if timeline_cb is not None:
                    samples.append((t, self.iteration_util(t_iter, False, n),
                                    t_iter))
            if not done:
                return 0, t0, []
            self.last_prefill_budget = budget
            for r in running:
                # closed-form reservation growth == `done` reconciles
                need = self._round_kv(self.footprint(r) + done - 1)
                held = self.reserved.get(r.rid, 0)
                if need > held:
                    self.kv_used += need - held
                    self.reserved[r.rid] = need
                sched.on_tokens(r, t_stamps)
                r.generated += done
            if timeline_cb is not None:
                final = {r.account: sched.service[r.account]
                         for r in sorted(running, key=lambda r: r.account)}
                for i, (ti, util, _t_iter) in enumerate(samples):
                    timeline_cb(ti, util, n, n,
                                final if i == done - 1 else {}, budget)
            util_last = self.iteration_util(max(float(times[done - 1]),
                                                1e-6), False, n)
        else:
            util_last = 0.0
            for i in range(k):
                if t >= stop_before:
                    break
                # prepare_iteration, minus victim selection: the horizon
                # proved no preemption can trigger
                for r in running:
                    self.reconcile(r)
                self.last_prefill_budget = budget
                if obs is not None:
                    obs.on_prefill_budget(budget)
                if cache is not None:
                    pool = cache.pool
                    for r in running:
                        # mirror the physical allocation schedule: one
                        # decode row per request per iteration (legacy
                        # order — eviction timing must match)
                        pool.ensure(r.rid, r.prompt_len + r.generated)
                t_iter = max(float(times[i]), 1e-6)
                t = t + t_iter
                done += 1
                done_now: List[Request] = []
                for r in running:
                    r.generated += 1
                    sched.on_token(r, t, 1)
                    if r.generated >= r.output_len:
                        r.state = FINISHED
                        r.finish_time = t
                        done_now.append(r)
                util_last = self.iteration_util(t_iter, False, n)
                if obs is not None:
                    obs.on_iteration(t, t_iter=t_iter, util=util_last,
                                     fresh=False, running=running,
                                     produced=list(running), first=[])
                if timeline_cb is not None:
                    delta = {a: sched.service[a] for a in
                             sorted({r.account for r in running})}
                    timeline_cb(t, util_last, len(running), n, delta,
                                budget)
                if done_now:
                    break               # horizon guarantees this is i==k-1
        finished = [r for r in running if r.generated >= r.output_len]
        for r in finished:
            r.state = FINISHED
            if r.finish_time is None:
                r.finish_time = t
            running.remove(r)
            if pre_complete is not None:
                pre_complete(r)
            self.complete(r, t, util=util_last)
            if post_complete is not None:
                post_complete(r)
        return done, t, finished

    # -- completion feedback -------------------------------------------------
    def complete(self, req: Request, now: float, util: float = None):
        """Close the loop (Algorithm 1 line 20): free the reservation and
        feed actual metrics to the scheduler (which recalibrates the
        predictor).  ``latency`` is GPU execution time — queue wait is
        excluded (§3.2: TPS is "tokens per second in GPU"), and so are
        cached-prefix prompt tokens, which the GPU never computed —
        counting them over-credited RFC for conversational clients.
        ``util`` defaults to the cost model's MFU over the request's
        window."""
        req.state = FINISHED
        if req.finish_time is None:
            req.finish_time = now
        self.kv_used -= self.reserved.pop(req.rid, 0)
        exec_lat = max(now - (req.admit_time if req.admit_time is not None
                              else now), 1e-9)
        computed = (req.prompt_len - req.cached_prefix) + req.generated
        tps = computed / exec_lat
        if util is None:
            util = self.cm.mfu(computed, exec_lat)
        self.sched.on_complete(req, now, latency=exec_lat, tps=tps,
                               util=util)
        if self.observer is not None:
            self.observer.on_complete(req, now, latency=exec_lat, tps=tps,
                                      util=util)
        # closed-loop turn release (DESIGN.md §13): a finished turn
        # unlocks the interaction's next one — its arrival becomes
        # now + think time, and the frontend's hook feeds it back into the
        # arrival stream (the whole point of first-class interactions:
        # turn k+1 *cannot* be scheduled before turn k finished)
        if req.interaction_id is not None:
            inter = self.interactions.get(req.interaction_id)
            if inter is not None:
                inter.mark_stage_complete(now)
                nxt = inter.next_request(now)
                if nxt is not None and self.on_turn_release is not None:
                    self.on_turn_release(nxt, now)
                    if self.observer is not None:
                        self.observer.on_turn_release(nxt, now)
        return exec_lat, tps, util
