"""Scheduling policies behind one protocol: FCFS, RPM, VTC, Equinox, DLPM.

Protocol (driven by the simulator and the serving engine):
    on_arrival(req, now)      request entered the queue
    pop_next(now)             next request to admit, or None  (work-conserving)
    on_admit(req, now)        request entered the GPU batch (counters update
                              here — Algorithm 1 ``updateCounter``)
    on_token(req, now, n)     n output tokens produced (incremental service)
    on_complete(req, now, *, latency, tps, util)
                              request finished; feeds actual metrics back
                              (Algorithm 1 line 20 closes the loop)
    on_preempt(req, now)      request evicted from the batch for recompute
                              (DESIGN.md §10): every service charge this
                              admission made is refunded, so re-admission
                              re-charges from scratch and a preempt/readmit
                              cycle bills exactly like an uninterrupted run
    select_victim(running, now)
                              fairness-aware preemption victim (FairBatching
                              [Lyu et al., 2025]: victim choice *is* a
                              fairness decision) — VTC picks the
                              largest-counter client's youngest request,
                              Equinox the highest-HF client's; the base
                              policy is plain LIFO (youngest request —
                              least recomputation lost)

Service accounting (for fairness metrics) is uniform across policies:
weighted tokens, input counted at admit, output counted as generated.

Billing key (DESIGN.md §13): every queue and counter is keyed by
``Request.account`` — the (user, app) fairness account — not the session
name.  Sessions of one account share a FIFO queue and accumulate into
one counter, so a chatty app cannot dodge VTC/DLPM/Equinox fairness by
opening new sessions.  Requests without interaction identity have
``account == client``, keeping every pre-§13 trace bit-identical.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core import counters as C
from repro_torch.core.request import Request


class SchedulerBase:
    name = "base"
    # Cached-token discount (DESIGN.md §9): input tokens served from the
    # shared-prefix KV cache are billed at this weight (1.0 = cache-blind).
    # Settable per policy via ``make_scheduler(..., omega_cached=...)``.
    omega_cached: float = 1.0
    # Preemption victim policy (DESIGN.md §10): "fair" lets VTC/Equinox
    # pick the worst-counter client's youngest request; "lifo" forces the
    # policy-blind youngest-request baseline everywhere.
    victim_policy: str = "fair"
    # Locality probe (DESIGN.md §11): a side-effect-free callable
    # ``req -> cached-prefix match length in tokens``, threaded in by
    # ``BatchCore`` when a prefix cache is attached.  None (no cache)
    # means every request scores 0 and locality-aware policies (DLPM,
    # Equinox+locality_bonus) degrade to their cache-blind order.
    locality_probe = None

    def __init__(self):
        self.queues: Dict[str, collections.deque] = collections.defaultdict(
            collections.deque)
        self.service: Dict[str, float] = collections.defaultdict(float)
        # set, not list: on_arrival runs once per request, and an O(n) list
        # scan here is O(n²) over an LMSYS-sized trace
        self.arrived_clients = set()
        # per-client in-batch request count (admitted, not yet completed
        # or preempted) — with the queues this defines the *active* client
        # set the VTC no-gaming lift is taken over.  Entries are removed
        # when they reach zero so ``active_clients`` stays O(active), not
        # O(every client that ever ran).
        self.inflight: Dict[str, int] = collections.defaultdict(int)
        # Backlog index (DESIGN.md §15): the clients that *may* have
        # queued work, plus each client's queues-dict insertion rank.
        # ``has_waiting``/``queued_clients``/``active_clients`` scan this
        # instead of every ever-arrived client's (mostly empty) deque —
        # the difference between O(backlog) and O(all clients) per
        # iteration on a 10⁴-account trace.  Stale entries (queue drained
        # since the last look) are pruned lazily; ``_queue_rank`` orders
        # ``queued_clients()`` exactly like the historical
        # ``queues.items()`` iteration, which the policies' min()
        # tie-breaks are pinned to.
        self._backlog: set = set()
        self._queue_rank: Dict[str, int] = {}

    def billable_input(self, req: Request) -> float:
        """Input tokens after the cached-prefix discount: a cache-hit
        prompt re-used ``req.cached_prefix`` tokens of resident KV, so
        those are billed at ``omega_cached`` instead of full price."""
        return C.billable_input(req.prompt_len, req.cached_prefix,
                                self.omega_cached)

    # -- queue plumbing ------------------------------------------------------
    def on_arrival(self, req: Request, now: float):
        acct = req.account
        if acct not in self.arrived_clients:
            self.arrived_clients.add(acct)
            self._on_new_client(acct)
        elif not self.client_active(acct):
            # the account was idle (nothing queued on any replica, nothing
            # in a batch) and is returning — re-apply the no-gaming lift
            # so idle time never banks credit (VTC [Sheng et al.,
            # OSDI'24]); an account actively backlogged on a peer replica
            # must NOT be lifted away from its earned priority
            self._on_client_return(acct)
        self.queues[acct].append(req)
        self._note_queued(acct)

    def _on_new_client(self, client: str):
        pass

    def _on_client_return(self, client: str):
        pass

    def _note_queued(self, client: str):
        if client not in self._queue_rank:
            self._queue_rank[client] = len(self._queue_rank)
        self._backlog.add(client)

    def requeue_head(self, req: Request):
        """Put a popped/preempted request back at the head of its
        account's queue.  The one sanctioned way to re-queue outside
        ``on_arrival``: it keeps the backlog index in sync, where a
        direct ``queues[...].appendleft`` would leave the client
        invisible to ``has_waiting``/``queued_clients`` if its backlog
        entry was pruned while the queue sat empty."""
        self.queues[req.account].appendleft(req)
        self._note_queued(req.account)

    def _live_backlog(self):
        """Backlogged clients with a nonempty queue (arbitrary order),
        pruning entries whose queue drained since the last look."""
        if not self._backlog:
            return []
        live = [c for c in self._backlog if self.queues.get(c)]
        if len(live) != len(self._backlog):
            self._backlog = set(live)
        return live

    def has_waiting(self) -> bool:
        return len(self._live_backlog()) > 0

    def queued_clients(self):
        # rank order == queues-dict insertion order: the policies'
        # min()/first-minimal tie-breaks are pinned to it
        return sorted(self._live_backlog(),
                      key=self._queue_rank.__getitem__)

    def active_clients(self):
        """Clients with queued or in-batch work — the set the VTC/Equinox
        returning-client lift is defined over.  Long-idle clients keep
        stale-low counters; including them would let a returning client
        catch up further than the no-gaming rule permits.  In a cluster,
        ``share_fairness_state`` sets ``peers`` so queued work on every
        replica counts (queues are per-replica, counters are global —
        the lift must see the whole cluster's active set)."""
        act = set()
        for s in getattr(self, "peers", None) or (self,):
            act.update(s._live_backlog())
        act.update(c for c, n in self.inflight.items() if n > 0)
        return act

    def client_active(self, client: str) -> bool:
        """Membership form of ``active_clients`` — O(replicas) per call,
        so the per-arrival idle-return check doesn't rebuild the whole
        set on an LMSYS-sized trace (an O(n²)-per-trace cost)."""
        if self.inflight.get(client, 0) > 0:
            return True
        for s in getattr(self, "peers", None) or (self,):
            if s.queues.get(client):
                return True
        return False

    def head_locality(self, client: str) -> int:
        """Cached-prefix match length (tokens) of ``client``'s head
        request — the LPM score of DLPM / D²LPM (DESIGN.md §11).  Probes
        via ``locality_probe`` (side-effect-free: ordering candidates
        must not distort the cache's LRU order); 0 without a cache."""
        q = self.queues.get(client)
        if not q or self.locality_probe is None:
            return 0
        return self.locality_probe(q[0])

    # -- service accounting ----------------------------------------------------
    def on_admit(self, req: Request, now: float):
        inc = req.weight * self.billable_input(req)
        self.service[req.account] += inc
        req._service_charged = inc
        self.inflight[req.account] += 1

    def on_token(self, req: Request, now: float, n: int = 1):
        inc = req.weight * C.OUT_TOKEN_WEIGHT * n
        self.service[req.account] += inc
        req._service_charged = getattr(req, "_service_charged", 0.0) + inc

    def on_tokens(self, req: Request, t_list):
        """Bulk billing for the macro-step fast path (DESIGN.md §15):
        bit-identical to ``for t in t_list: self.on_token(req, t, 1)``.

        The contract every override must keep: the per-token increment is
        hoisted (it does not depend on ``now``), but the accumulation
        stays a sequential float fold — ``acc + inc`` repeated
        ``len(t_list)`` times, NOT ``acc + inc * len(t_list)``, which
        differs in float.  Accumulations into *different* tables
        (service/counter/ufc) commute because they touch independent
        float chains; the property test in
        ``tests/test_macro_equivalence.py`` pins this for every policy."""
        inc = req.weight * C.OUT_TOKEN_WEIGHT * 1
        acc = self.service[req.account]
        charged = getattr(req, "_service_charged", 0.0)
        for _ in t_list:
            acc += inc
            charged += inc
        self.service[req.account] = acc
        req._service_charged = charged

    def _dec_inflight(self, client: str):
        # drop zero entries so the dict only ever holds active clients
        n = self.inflight.get(client, 0) - 1
        if n > 0:
            self.inflight[client] = n
        else:
            self.inflight.pop(client, None)

    def _macro_inc_key(self, req: Request):
        """Everything this policy's per-*token* billing increment
        depends on.  ``macro_bulk_ok`` compares it across same-account
        batch-mates; policies whose increment reads more request state
        must override (Equinox: the admission-time latency tilt)."""
        return req.weight

    def macro_bulk_ok(self, reqs) -> bool:
        """May the macro bulk path (DESIGN.md §15) bill these
        batch-mates with one ``on_tokens`` fold per request?  Charges
        to *different* accounts always commute (independent float
        chains).  Same-account charges commute only when the per-token
        increments are identical — the account's accumulator then sees
        the same count of identical additions under any interleaving,
        so per-request folds reproduce the per-iteration order
        bit-for-bit."""
        seen: Dict[str, object] = {}
        for r in reqs:
            key = self._macro_inc_key(r)
            if seen.setdefault(r.account, key) != key:
                return False
        return True

    def on_complete(self, req: Request, now: float, *, latency: float,
                    tps: float, util: float):
        self._dec_inflight(req.account)

    def on_preempt(self, req: Request, now: float):
        """Refund semantics (DESIGN.md §10): preemption-by-recompute
        discards the victim's work, so every service charge made since
        its admission is returned — re-admission re-charges from scratch
        and preempted service is never double-billed."""
        self.service[req.account] -= getattr(req, "_service_charged", 0.0)
        req._service_charged = 0.0
        self._dec_inflight(req.account)

    def on_requeue(self, req: Request, now: float):
        """A popped request failed admission (``canSchedule``/adaptive
        batching) and went back to the head of its queue — undo any
        pop-time charge so failed attempts are free."""
        pass

    def pop_next(self, now: float, exclude=None) -> Optional[Request]:
        """Next request to admit (policy order), or None.  ``exclude`` is
        a set of client names whose head request already failed
        ``canSchedule`` this iteration — the admission loop skips them so
        one client's big (e.g. preempted-and-regrown) head request cannot
        head-of-line-block every other client's small ones."""
        raise NotImplementedError

    # -- SLO-aware batch formation (DESIGN.md §12) ---------------------------
    def prefill_order(self, reqs):
        """Order PREFILLING requests for the per-iteration chunk budget
        fill.  The solved budget (``BatchCore.solve_prefill_budget``) is
        a scarce resource exactly like admission slots, so the same
        fairness signal decides who gets it: the base policy keeps
        admission order (FCFS/RPM have no counters), VTC/DLPM fill the
        smallest-counter client first, Equinox the smallest-HF.  Only
        consulted when ``BatchConfig.slo_budget == "auto"`` — the static
        path keeps the historical running order bit-for-bit."""
        return list(reqs)

    # -- preemption (DESIGN.md §10) ------------------------------------------
    @staticmethod
    def _youngest(reqs):
        return max(reqs, key=lambda r: (r.arrival, r.rid))

    def select_victim(self, running, now: float) -> Optional[Request]:
        """Preemption victim among ``running``.  Base policy (and the
        ``victim_policy="lifo"`` override): the youngest request — least
        recomputation lost, no client awareness (the vLLM-style default
        the fair policies are benchmarked against)."""
        if not running:
            return None
        return self._youngest(running)

    # -- introspection -----------------------------------------------------------
    def fairness_scores(self) -> Dict[str, float]:
        """Per-client scores for Jain's index (HF where defined, else
        accumulated weighted service)."""
        return dict(self.service)


class FCFS(SchedulerBase):
    """Strict arrival order — no client isolation (production default)."""
    name = "fcfs"

    def pop_next(self, now, exclude=None):
        best, best_c = None, None
        for c in self.queued_clients():
            if exclude and c in exclude:
                continue
            q = self.queues[c]
            if best is None or q[0].arrival < best.arrival:
                best, best_c = q[0], c
        if best is not None:
            self.queues[best_c].popleft()
        return best


class RPM(SchedulerBase):
    """Static requests-per-minute quota + FCFS inside the allowance.
    Wastes capacity off-peak (the paper's §1 critique) — kept as the
    production-baseline reference."""
    name = "rpm"

    def __init__(self, quota_per_min: float = 60.0):
        if quota_per_min <= 0:
            raise ValueError(f"RPM quota_per_min must be > 0, got "
                             f"{quota_per_min}")
        super().__init__()
        self.quota = quota_per_min
        self.windows: Dict[str, collections.deque] = collections.defaultdict(
            collections.deque)

    def _allowed(self, client: str, now: float) -> bool:
        w = self.windows[client]
        while w and w[0] <= now - 60.0:
            w.popleft()
        return len(w) < self.quota

    def pop_next(self, now, exclude=None):
        best, best_c = None, None
        for c in self.queued_clients():
            if exclude and c in exclude:
                continue
            if self._allowed(c, now):
                q = self.queues[c]
                if best is None or q[0].arrival < best.arrival:
                    best, best_c = q[0], c
        if best is not None:
            self.queues[best_c].popleft()
            self.windows[best_c].append(now)
            best._rpm_window_t = now     # so a refund hits THIS entry
        return best

    def _refund_window(self, req):
        """Remove the quota entry this request's pop charged.  Matched
        by timestamp, not position: by preemption time the victim's
        entry may no longer be the newest (or may have rolled out of
        the window already), and popping someone else's valid entry
        would transiently over-admit the client."""
        try:
            self.windows[req.account].remove(getattr(req, "_rpm_window_t",
                                                     None))
        except ValueError:
            pass                          # entry already rolled out

    def on_requeue(self, req, now):
        # refund the quota entry charged at pop time
        self._refund_window(req)

    def on_preempt(self, req, now):
        # the preempted request goes back to the queue head and will be
        # popped (and quota-charged) again — refund this admission's entry
        super().on_preempt(req, now)
        self._refund_window(req)


class VTC(SchedulerBase):
    """Virtual Token Counter [Sheng et al., OSDI'24].

    Counter = accumulated weighted tokens; admit from the client with the
    smallest counter; counter lifted to the active minimum when an idle
    client returns (the VTC no-gaming lift).  ``predictor`` is optional:
    plain VTC charges output tokens as they are generated; VTC+predictor
    (Table 1 ablations) charges predicted output up front and reconciles
    on completion.
    """
    name = "vtc"

    def __init__(self, predictor=None, out_weight: float = C.OUT_TOKEN_WEIGHT):
        super().__init__()
        self.counter: Dict[str, float] = {}
        self.predictor = predictor
        self.w = out_weight

    def _lift(self, client):
        """No-gaming lift over *active* clients only (queued or running
        work): idle clients' stale-low counters must not let a returning
        client catch up beyond what VTC permits."""
        active = self.active_clients() - {client}
        vals = [self.counter[c] for c in active if c in self.counter]
        lift = min(vals) if vals else 0.0
        self.counter[client] = max(self.counter.get(client, 0.0), lift)

    def _on_new_client(self, client):
        self._lift(client)

    def _on_client_return(self, client):
        self._lift(client)

    def pop_next(self, now, exclude=None):
        cands = self.queued_clients()
        if exclude:
            cands = [c for c in cands if c not in exclude]
        if not cands:
            return None
        c = min(cands, key=lambda c: self.counter[c])
        return self.queues[c].popleft()

    def on_admit(self, req, now):
        super().on_admit(req, now)
        inc = req.weight * self.billable_input(req)
        if self.predictor is not None:
            self.predictor.predict(req)
            inc += req.weight * self.w * req.pred_output_len
        self.counter[req.account] += inc
        req._vtc_charged = inc

    def on_token(self, req, now, n=1):
        super().on_token(req, now, n)
        if self.predictor is None:
            inc = req.weight * self.w * n
            self.counter[req.account] += inc
            req._vtc_charged = getattr(req, "_vtc_charged", 0.0) + inc

    def on_tokens(self, req, t_list):
        super().on_tokens(req, t_list)
        if self.predictor is None:
            inc = req.weight * self.w * 1
            acc = self.counter[req.account]
            charged = getattr(req, "_vtc_charged", 0.0)
            for _ in t_list:
                acc += inc
                charged += inc
            self.counter[req.account] = acc
            req._vtc_charged = charged

    def on_complete(self, req, now, *, latency, tps, util):
        super().on_complete(req, now, latency=latency, tps=tps, util=util)
        if self.predictor is not None:
            # reconcile predicted vs actual output tokens
            err = req.output_len - (req.pred_output_len or 0.0)
            self.counter[req.account] += req.weight * self.w * err
            self.predictor.observe(req, latency=latency, tps=tps, util=util)

    def on_preempt(self, req, now):
        super().on_preempt(req, now)
        self.counter[req.account] -= getattr(req, "_vtc_charged", 0.0)
        req._vtc_charged = 0.0

    def prefill_order(self, reqs):
        """Fill the chunk budget for the least-served account first
        (DESIGN.md §12): under a binding SLO budget the tail of the
        order may get nothing this iteration, and that starvation must
        land on whoever is furthest ahead on service.  Stable sort,
        rid tie-break — deterministic on both frontends."""
        return sorted(reqs, key=lambda r: (self.counter.get(r.account, 0.0),
                                           r.rid))

    def select_victim(self, running, now):
        """Largest-counter account's youngest request — the VTC framing
        of FairBatching's rule: the account furthest ahead on service
        gives work back first."""
        if not running or self.victim_policy != "fair":
            return super().select_victim(running, now)
        worst = max({r.account for r in running},
                    key=lambda c: (self.counter.get(c, 0.0), c))
        return self._youngest([r for r in running if r.account == worst])

    def fairness_scores(self):
        return dict(self.counter)


class DLPM(VTC):
    """Deficit Longest-Prefix-Match (Locality-aware Fair Scheduling,
    Cao et al., arXiv:2501.14312; DESIGN.md §11).

    VTC's per-client counters double as *deficit* counters.  Each
    ``pop_next`` builds the fairness-feasible set — every queued client
    whose counter is within ``quantum`` weighted tokens of the
    least-served candidate — and, inside that set, admits the client
    whose head request has the longest cached-prefix match (the
    side-effect-free probe ``BatchCore`` threads in when a prefix cache
    is attached).  Ties fall back to the smallest counter, i.e. plain
    VTC, which is also the exact behavior without a cache.

    ``quantum`` is the locality-vs-fairness bound: locality can advance
    a warm client at most ``quantum`` weighted tokens past the coldest
    backlogged client before that client becomes the only feasible pick,
    so the pairwise backlogged service gap stays <= quantum + one
    maximal request (the DLPM analogue of VTC's 2·max-request bound).

    Deficits are charged through ``billable_input`` exactly like VTC's
    counters — the uncached suffix at full weight, the cached prefix at
    ``omega_cached`` (default 1.0: deficit accounting stays paper-
    consistent and cache-blind, so locality changes *order*, never what
    a request costs its client).  Lowering ``omega_cached`` additionally
    lets cache hits consume less of a client's quantum — the
    actually-computed-tokens accounting of the locality paper's cost
    function (see DESIGN.md §9 for why 0 invites self-history farming).
    """
    name = "dlpm"

    def __init__(self, predictor=None, quantum: float = 512.0,
                 out_weight: float = C.OUT_TOKEN_WEIGHT):
        if quantum <= 0:
            raise ValueError(f"DLPM quantum must be > 0, got {quantum}")
        super().__init__(predictor=predictor, out_weight=out_weight)
        self.quantum = float(quantum)

    def pop_next(self, now, exclude=None):
        cands = self.queued_clients()
        if exclude:
            cands = [c for c in cands if c not in exclude]
        if not cands:
            return None
        floor = min(self.counter[c] for c in cands)
        feasible = [c for c in cands
                    if self.counter[c] <= floor + self.quantum]
        # longest cached prefix wins; ties (incl. the cache-less case,
        # where every score is 0) revert to smallest-counter VTC order —
        # min() keeps the first minimal candidate in queue-dict insertion
        # order, exactly like VTC.pop_next, so quantum→0 and probe-less
        # DLPM are bit-identical to VTC down to exact-counter ties
        c = min(feasible,
                key=lambda c: (-self.head_locality(c), self.counter[c]))
        return self.queues[c].popleft()

    def select_victim(self, running, now):
        """Prefer evicting the *lowest-locality* request (DESIGN.md §11)
        of the largest-counter client: a high-locality victim's pages
        are mostly shared and pinned in the radix tree, so evicting it
        frees little memory while discarding exactly the admission the
        LPM order prioritized; the lowest-locality request holds the
        most private, actually-reclaimable pages.  Ties (same cached
        prefix) preempt the youngest, as everywhere else."""
        if not running or self.victim_policy != "fair":
            return super(VTC, self).select_victim(running, now)
        worst = max({r.account for r in running},
                    key=lambda c: (self.counter.get(c, 0.0), c))
        mine = [r for r in running if r.account == worst]
        low = min(r.cached_prefix for r in mine)
        return self._youngest([r for r in mine if r.cached_prefix == low])


class Equinox(SchedulerBase):
    """Holistic fair scheduling (paper Algorithm 1).

    Keeps per-client UFC and RFC; admits from the argmin-HF client.  The
    predictor supplies (T_out, latency, TPS, util) pre-execution; actual
    metrics recalibrate ``P.map`` on completion.
    """
    name = "equinox"

    def __init__(self, predictor, params: C.HFParams = C.HFParams()):
        super().__init__()
        self.p = params
        self.omega_cached = params.omega_cached
        self.predictor = predictor
        self.ufc: Dict[str, float] = {}
        self.rfc: Dict[str, float] = {}
        self._lat_ema: float = 0.0            # running mean of wait+predict

    def _norm_latency(self, lat: float) -> float:
        """Scale-free latency term (HFParams.wait_norm, DESIGN.md §8)."""
        if self.p.wait_norm != "relative":
            return lat
        self._lat_ema = (0.98 * self._lat_ema + 0.02 * lat
                         if self._lat_ema else lat)
        return min(lat / max(self._lat_ema, 1e-9), self.p.tilt_cap)

    def _lift(self, client):
        """UFC/RFC no-gaming lift over *active* clients only (mirrors the
        VTC rule): long-idle clients' stale-low counters are excluded."""
        active = self.active_clients() - {client}
        for tbl in (self.ufc, self.rfc):
            vals = [tbl[c] for c in active if c in tbl]
            lift = min(vals) if vals else 0.0
            tbl[client] = max(tbl.get(client, 0.0), lift)

    def _on_new_client(self, client):
        self._lift(client)

    def _on_client_return(self, client):
        self._lift(client)

    def _hf(self):
        clients = list(self.ufc)
        ufc = np.array([self.ufc[c] for c in clients])
        rfc = np.array([self.rfc[c] for c in clients])
        hf = C.hf_scores(ufc, rfc, self.p.alpha, self.p.beta)
        return dict(zip(clients, hf))

    def pop_next(self, now, exclude=None):
        cands = self.queued_clients()
        if exclude:
            cands = [c for c in cands if c not in exclude]
        if not cands:
            return None
        hf = self._hf()
        bonus = getattr(self.p, "locality_bonus", 0.0)
        if bonus and self.locality_probe is not None:
            # locality-tilted HF (DESIGN.md §11): a cached prefix lowers
            # the effective score by up to ``locality_bonus`` (HF is
            # normalized to ~[0, 1], so the bonus is directly the HF
            # headroom locality may override).  bonus=0 is paper-exact.
            def eff(c):
                frac = (self.head_locality(c)
                        / max(self.queues[c][0].prompt_len, 1))
                return hf[c] - bonus * frac
            c = min(cands, key=eff)
        else:
            c = min(cands, key=lambda c: hf[c])
        req = self.queues[c][0]
        if req.pred_output_len is None:
            self.predictor.predict(req)       # Algorithm 1 lines 4-5
        return self.queues[c].popleft()

    def on_admit(self, req, now):
        super().on_admit(req, now)
        if req.pred_output_len is None:
            self.predictor.predict(req)
        wait = max(now - req.arrival, 0.0)
        lat = self._norm_latency(wait + (req.pred_latency or 0.0))
        tilt = 1.0 + self.p.delta * lat       # UFC denominator (§3.1)
        rfc_inc = C.rfc_increment(req.pred_tps or 0.0, req.pred_util or 0.0,
                                  req.weight)
        self.rfc[req.account] = self.rfc.get(req.account, 0.0) + rfc_inc
        req._rfc_charged = rfc_inc
        req._admit_wait = wait
        req._tilt = tilt
        self.ufc.setdefault(req.account, 0.0)
        if self.p.charging == "upfront":
            ufc_inc = (req.weight * (self.billable_input(req)
                                     + C.OUT_TOKEN_WEIGHT
                                     * req.pred_output_len) / tilt)
            self.ufc[req.account] += ufc_inc
            req._ufc_charged = ufc_inc
        else:
            # incremental: charge the prompt now, outputs as produced
            inc = req.weight * self.billable_input(req) / tilt
            self.ufc[req.account] += inc
            req._ufc_charged = inc

    def _macro_inc_key(self, req):
        # incremental UFC charging divides by the admission-time latency
        # tilt, so same-account folds only commute at equal tilt
        return (req.weight, getattr(req, "_tilt", 1.0))

    def on_token(self, req, now, n=1):
        super().on_token(req, now, n)
        if self.p.charging == "incremental":
            inc = (req.weight * C.OUT_TOKEN_WEIGHT * n
                   / getattr(req, "_tilt", 1.0))
            self.ufc[req.account] += inc
            req._ufc_charged = getattr(req, "_ufc_charged", 0.0) + inc

    def on_tokens(self, req, t_list):
        super().on_tokens(req, t_list)
        if self.p.charging == "incremental":
            inc = (req.weight * C.OUT_TOKEN_WEIGHT * 1
                   / getattr(req, "_tilt", 1.0))
            acc = self.ufc[req.account]
            charged = getattr(req, "_ufc_charged", 0.0)
            for _ in t_list:
                acc += inc
                charged += inc
            self.ufc[req.account] = acc
            req._ufc_charged = charged

    def on_preempt(self, req, now):
        """Refund this admission's UFC/RFC increments (tracked in
        ``_ufc_charged``/``_rfc_charged``): the recomputed run re-charges
        them, so a preempt/readmit cycle bills like an uninterrupted run
        modulo the latency-tilt term (which legitimately reflects the
        extra wait the preemption caused)."""
        super().on_preempt(req, now)
        self.ufc[req.account] -= getattr(req, "_ufc_charged", 0.0)
        self.rfc[req.account] -= getattr(req, "_rfc_charged", 0.0)
        req._ufc_charged = 0.0
        req._rfc_charged = 0.0

    def prefill_order(self, reqs):
        """Smallest-HF account's chunks first (DESIGN.md §12) — the same
        holistic order ``pop_next`` admits by decides who consumes the
        SLO-solved budget when it cannot cover everyone."""
        hf = self._hf()
        return sorted(reqs, key=lambda r: (hf.get(r.account, 0.0), r.rid))

    def select_victim(self, running, now):
        """Highest-HF account's youngest request (DESIGN.md §10): the
        most holistically over-served account gives capacity back first,
        and within that account the youngest request loses the least
        work."""
        if not running or self.victim_policy != "fair":
            return super().select_victim(running, now)
        hf = self._hf()
        worst = max({r.account for r in running},
                    key=lambda c: (hf.get(c, 0.0), c))
        return self._youngest([r for r in running if r.account == worst])

    def on_complete(self, req, now, *, latency, tps, util):
        """Algorithm 1 line 20: refresh HF_c with *actual* metrics — replace
        the prediction-based increments with observed ones, recalibrate
        P.map."""
        super().on_complete(req, now, latency=latency, tps=tps, util=util)
        if self.p.charging == "upfront":
            lat = self._norm_latency(getattr(req, "_admit_wait", 0.0)
                                     + latency)
            actual = C.ufc_increment(req.prompt_len, req.generated, lat, 0.0,
                                     req.weight, self.p.delta,
                                     t_in_cached=req.cached_prefix,
                                     omega_cached=self.omega_cached)
            self.ufc[req.account] += actual - getattr(req, "_ufc_charged",
                                                      actual)
        actual_rfc = C.rfc_increment(tps, util, req.weight)
        self.rfc[req.account] += actual_rfc - getattr(req, "_rfc_charged",
                                                      actual_rfc)
        self.predictor.observe(req, latency=latency, tps=tps, util=util)

    def fairness_scores(self):
        return self._hf()


SCHEDULERS = ("fcfs", "rpm", "vtc", "equinox", "dlpm")


def make_scheduler(name: str, predictor=None, omega_cached: float = None,
                   victim_policy: str = None, locality_bonus: float = None,
                   **kw):
    """Construct a scheduling policy by name.

    All user-input validation raises ``ValueError`` (never ``assert`` —
    asserts vanish under ``python -O``, silently accepting a typo'd
    ``victim_policy`` and running the wrong preemption policy)."""
    name = name.lower()
    if name not in SCHEDULERS:
        raise ValueError(f"unknown scheduler {name!r}; "
                         f"choose from {SCHEDULERS}")
    if locality_bonus is not None:
        if name != "equinox":
            raise ValueError("locality_bonus is an Equinox knob (DLPM is "
                             f"locality-first by construction); got {name!r}")
        if not 0.0 <= locality_bonus <= 1.0:
            raise ValueError(f"locality_bonus must be in [0, 1] (it is HF "
                             f"headroom), got {locality_bonus}")
    if name == "fcfs":
        sched = FCFS()
    elif name == "rpm":
        sched = RPM(**kw)
    elif name == "vtc":
        sched = VTC(predictor=predictor, **kw)
    elif name == "dlpm":
        sched = DLPM(predictor=predictor, **kw)
    else:
        if predictor is None:
            raise ValueError("Equinox requires a predictor (its HF "
                             "counters price predicted latency/TPS/util)")
        if omega_cached is not None or locality_bonus is not None:
            kw["params"] = dataclasses.replace(
                kw.get("params", C.HFParams()),
                **({} if omega_cached is None
                   else {"omega_cached": omega_cached}),
                **({} if locality_bonus is None
                   else {"locality_bonus": locality_bonus}))
        sched = Equinox(predictor, **kw)
    if omega_cached is not None:
        if not 0.0 <= omega_cached <= 1.0:
            raise ValueError(f"omega_cached must be in [0, 1], got "
                             f"{omega_cached}")
        sched.omega_cached = omega_cached
    if victim_policy is not None:
        if victim_policy not in ("fair", "lifo"):
            raise ValueError(f"victim_policy must be 'fair' or 'lifo', "
                             f"got {victim_policy!r}")
        sched.victim_policy = victim_policy
    return sched
