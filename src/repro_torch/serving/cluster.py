"""Multi-replica fairness-aware cluster serving (DESIGN.md §7).

Copy of ``repro/serving/cluster.py`` (numpy only): a fix there must be
copied here by hand, so routing stays identical to the reference.

Extends the paper's single-GPU Algorithm 1 to N replicas the way VTC
[Sheng et al., OSDI'24] and Locality-aware Fair Scheduling
(arXiv:2501.14312) frame fair scheduling as a multi-worker dispatch
problem:

- **Replicas** are anything implementing the replica protocol —
  ``submit(req)`` / ``step()`` / ``clock`` / ``advance_to(t)`` /
  ``has_work()`` / ``n_finished`` / ``kv_load()`` /
  ``queued_prompt_tokens()``.  Both ``repro_torch.core.simulator.Simulator``
  (analytic timing, possibly heterogeneous ``Hardware`` specs) and
  ``repro_torch.serving.engine.ServingEngine`` (a PyTorch model on the
  card) qualify, so
  cluster experiments run on either frontend of the shared ``BatchCore``.

- **Global fairness state**: ``share_fairness_state`` re-binds the
  per-client counter containers (weighted service, VTC counters,
  Equinox UFC/RFC, RPM quota windows) so all replicas read and charge
  the *same* per-client state.  A client spraying requests across
  replicas accrues its counter globally and cannot dodge fair
  scheduling by fanning out — each replica's argmin pick sees the
  client's full cluster-wide consumption.

- **Routing policies** (pluggable, ``ROUTING_POLICIES``; third parties
  add their own via ``register_routing_policy``): which replica a
  request lands on is a load-balancing decision, *not* a fairness
  decision — fairness is enforced by the shared counters at every
  replica's admission loop.  Provided: ``round_robin``,
  ``least_kv`` (lowest KV-budget utilisation), ``min_ttft`` (lowest
  predicted time-to-first-token from the replica's clock, queue backlog
  and roofline prefill cost), ``prefix_affinity`` (DESIGN.md §9:
  route to the replica whose shared-prefix radix cache holds the longest
  match for this prompt — KV reuse is replica-local, so conversation
  turns must land where their history's pages live; falls back to
  ``least_kv`` on a cold prompt), and ``d2lpm`` (DESIGN.md §11: the
  distributed half of Deficit Longest-Prefix-Match — prefix-affinity
  probe with a minimum-match threshold below which it load-balances via
  ``least_kv``, paired with DLPM replica schedulers whose deficit
  counters are cluster-global).

The cluster event loop is a discrete-event merge: requests are routed
when the *minimum* replica clock passes their arrival, and the
furthest-behind replica steps next, so no replica consumes events from
another replica's future.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core import counters as C
from repro_torch.core.metrics import delivered_jain, jain
from repro_torch.core.request import FINISHED, THROTTLED, Request
from repro_torch.core.schedulers import SchedulerBase, make_scheduler
from repro_torch.core.simulator import SimConfig, Simulator
from repro_torch.serving.admission import as_controller, share_admission_state
from repro_torch.serving.costmodel import CostModel
from repro_torch.serving.telemetry import Observer

# Per-client fairness containers that must be cluster-global.  Queues are
# deliberately NOT shared — they are the per-replica dispatch outcome.
_SHARED_ATTRS = ("service", "arrived_clients",   # SchedulerBase
                 "inflight",                     # active-client set for the
                 #                                 returning-client lift
                 "counter",                      # VTC
                 "ufc", "rfc",                   # Equinox
                 "windows")                      # RPM quota windows


def share_fairness_state(scheds: Sequence[SchedulerBase]):
    """Re-bind per-client counter containers so every scheduler reads and
    charges the same global state.  (The Equinox latency-normalization
    EMA stays replica-local by design — it normalizes against the load
    the *local* batch produces; see DESIGN.md §8.)"""
    if not scheds:
        return scheds
    head = scheds[0]
    for s in scheds[1:]:
        if type(s) is not type(head):
            raise TypeError("replicas must run the same scheduling policy "
                            f"({type(head).__name__} vs {type(s).__name__})")
        for attr in _SHARED_ATTRS:
            if hasattr(head, attr):
                setattr(s, attr, getattr(head, attr))
    for s in scheds:
        # queues stay replica-local, but the returning-client lift must
        # see queued work cluster-wide (SchedulerBase.active_clients)
        s.peers = list(scheds)
    return scheds


# ---------------------------------------------------------------------------
# routing policies
# ---------------------------------------------------------------------------
def route_round_robin(cluster: "Cluster", req: Request) -> int:
    idx = cluster._rr % len(cluster.replicas)
    cluster._rr += 1
    return idx


def route_least_kv(cluster: "Cluster", req: Request) -> int:
    """Lowest KV-budget utilisation, ties broken by queued prefill work."""
    return int(min(range(len(cluster.replicas)),
                   key=lambda i: (cluster.replicas[i].kv_load(),
                                  cluster.replicas[i].queued_prompt_tokens(),
                                  i)))


def route_min_ttft(cluster: "Cluster", req: Request) -> int:
    """Lowest predicted TTFT: replica clock + roofline prefill time of the
    queued prompt backlog plus this request's own prompt."""
    def score(i):
        rep = cluster.replicas[i]
        backlog = rep.queued_prompt_tokens() + req.prompt_len
        return rep.clock + rep.cm.prefill_time(backlog)
    return int(min(range(len(cluster.replicas)), key=lambda i: (score(i), i)))


def _best_prefix_replica(cluster: "Cluster", req: Request):
    """(replica index, match length in tokens) of the longest cached
    prefix for ``req`` across the cluster — the shared side-effect-free
    probe behind ``prefix_affinity`` and ``d2lpm`` (one implementation,
    so cap/tie-break rules cannot drift between the two policies).
    (-1, 0) when no replica holds a match or the request has no tokens."""
    toks = req.prompt_tokens
    if toks is None or req.prompt_len <= 0:
        return -1, 0
    best_i, best_len = -1, 0
    for i, rep in enumerate(cluster.replicas):
        m = rep.core.prefix_match_len(toks)
        if m > best_len:
            best_i, best_len = i, m
    return best_i, best_len


# D²LPM fallback threshold (DESIGN.md §11): the affinity pick only wins
# when the best replica's cached match covers at least this fraction of
# the prompt — a sliver of locality doesn't justify skipping load
# balancing.  Override per cluster by setting ``cluster.d2lpm_min_match``.
D2LPM_MIN_MATCH = 0.125


def route_d2lpm(cluster: "Cluster", req: Request) -> int:
    """D²LPM — the router half of distributed Deficit Longest-Prefix-Match
    (Cao et al., arXiv:2501.14312; DESIGN.md §11).  Each replica's radix
    tree is probed side-effect-free (``BatchCore.prefix_match_len``) and
    the request follows the longest cached prefix, *provided* the match
    covers at least ``d2lpm_min_match`` of the prompt; colder prompts
    fall back to ``least_kv`` so locality never degrades load balancing.

    Fairness is deliberately not the router's job: run DLPM schedulers
    on the replicas with ``share_counters=True`` and the deficit
    counters are cluster-global (``share_fairness_state`` re-binds
    DLPM's ``counter`` table), so every replica's quantum-bounded
    admission sees the client's whole-cluster consumption no matter
    where its requests land — spraying turns across replicas cannot
    dodge the deficit bound, it only loses locality."""
    best_i, best_len = _best_prefix_replica(cluster, req)
    thresh = getattr(cluster, "d2lpm_min_match", D2LPM_MIN_MATCH)
    if best_len < max(thresh * req.prompt_len, 1.0):
        return route_least_kv(cluster, req)
    return best_i


def route_prefix_affinity(cluster: "Cluster", req: Request) -> int:
    """Longest cached-prefix match wins (DESIGN.md §9): each replica's
    radix tree is probed side-effect-free (``BatchCore.prefix_match_len``
    — every replica exposes its core as ``.core``) for the request's
    prompt tokens; a conversation's turn k+1 therefore follows turn k's
    pages.  Cold prompts (no tokens, or no replica holds a match) fall
    back to ``least_kv`` so affinity never degrades load balancing."""
    best_i, best_len = _best_prefix_replica(cluster, req)
    if best_len == 0:
        return route_least_kv(cluster, req)
    return best_i


ROUTING_POLICIES: Dict[str, Callable[["Cluster", Request], int]] = {}


def register_routing_policy(name: str,
                            fn: Callable[["Cluster", Request], int]):
    """Add a routing policy under ``name`` so ``Cluster(policy=name)``
    and ``make_sim_cluster(policy=name)`` resolve it — the same
    registration path the built-ins use."""
    ROUTING_POLICIES[name] = fn
    return fn


register_routing_policy("round_robin", route_round_robin)
register_routing_policy("least_kv", route_least_kv)
register_routing_policy("min_ttft", route_min_ttft)
register_routing_policy("prefix_affinity", route_prefix_affinity)
register_routing_policy("d2lpm", route_d2lpm)


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ClusterResult:
    requests: List[Request]
    replicas: list
    scheduler: SchedulerBase          # replica 0's
    sim_time: float
    routed_to: Dict[int, int]         # rid -> replica index
    counters_shared: bool = True      # whether scheduler state is global

    def _merged(self, per_sched) -> Dict[str, float]:
        """One table per client: replica 0's when counters are shared
        (all replicas alias it), summed across replicas otherwise."""
        if self.counters_shared:
            return dict(per_sched(self.scheduler))
        out: Dict[str, float] = {}
        for rep in self.replicas:
            for c, v in per_sched(rep.sched).items():
                out[c] = out.get(c, 0.0) + v
        return out

    def ttfts(self, client=None):
        return np.array([r.ttft() for r in self.requests
                         if r.ttft() is not None
                         and (client is None or r.client == client)])

    def latencies(self, client=None):
        return np.array([r.e2e_latency() for r in self.requests
                         if r.e2e_latency() is not None
                         and (client is None or r.client == client)])

    def throughput_tokens_per_s(self) -> float:
        tot = sum(r.prompt_len + r.generated for r in self.requests
                  if r.state == FINISHED)
        return tot / max(self.sim_time, 1e-9)

    def per_client_service(self) -> Dict[str, float]:
        return self._merged(lambda s: s.service)

    def jain_index(self) -> float:
        return jain(list(self._merged(
            lambda s: s.fairness_scores()).values()))

    # -- admission-control accounting (DESIGN.md §13) ----------------------
    def goodput_tokens_per_s(self) -> float:
        """Delivered weighted tokens per second across the cluster."""
        tot = sum(r.prompt_len + C.OUT_TOKEN_WEIGHT * r.generated
                  for r in self.requests if r.state == FINISHED)
        return tot / max(self.sim_time, 1e-9)

    def wasted_tokens(self) -> float:
        """Recompute waste from preemptions on every replica plus the
        computed-but-undelivered tokens of horizon-unfinished requests."""
        pre = sum(getattr(getattr(rep, "core", None), "wasted_tokens", 0.0)
                  for rep in self.replicas)
        partial = sum(max(r.prefill_done - r.cached_prefix, 0) + r.generated
                      for r in self.requests if r.state != FINISHED)
        return pre + partial

    @property
    def n_throttled(self) -> int:
        return sum(r.state == THROTTLED for r in self.requests)

    def replica_finished(self) -> List[int]:
        return [rep.n_finished for rep in self.replicas]

    def replica_preemptions(self) -> List[int]:
        """Preemption events per replica (DESIGN.md §10)."""
        return [getattr(rep, "n_preemptions", 0) for rep in self.replicas]

    def preemption_rate(self) -> List[float]:
        """Per-replica preemptions per finished request — the signal a
        dispatcher watches for replicas thrashing on KV recompute (a
        persistently hot replica indicates misprediction pressure the
        router should steer long-output work away from)."""
        return [p / max(f, 1) for p, f in zip(self.replica_preemptions(),
                                              self.replica_finished())]

    def cache_hit_rate(self) -> Optional[float]:
        """Cluster-wide token-level prefix-cache hit rate (None when no
        replica runs a prefix cache)."""
        hit = seen = 0
        for rep in self.replicas:
            cache = getattr(getattr(rep, "core", None), "prefix_cache", None)
            if cache is not None:
                hit += cache.stats.hit_tokens
                seen += cache.stats.lookup_tokens
        return hit / max(seen, 1) if seen else None

    def summary(self) -> dict:
        from repro_torch.core.metrics import percentile_or_none
        ttfts = self.ttfts()
        lats = self.latencies()
        return {
            "throughput_tok_s": self.throughput_tokens_per_s(),
            "p50_ttft": percentile_or_none(ttfts, 50),
            "p90_ttft": percentile_or_none(ttfts, 90),
            "p99_ttft": percentile_or_none(ttfts, 99),
            "mean_latency": float(lats.mean()) if len(lats) else None,
            "jain": self.jain_index(),
            "finished": sum(r.state == FINISHED for r in self.requests),
            "total": len(self.requests),
            "per_replica": self.replica_finished(),
            "preemptions_per_replica": self.replica_preemptions(),
            "preemption_rate": self.preemption_rate(),
            "goodput_tok_s": self.goodput_tokens_per_s(),
            "wasted_tokens": self.wasted_tokens(),
            "n_throttled": self.n_throttled,
            "jain_delivered": delivered_jain(self.requests),
        }


# ---------------------------------------------------------------------------
# cluster
# ---------------------------------------------------------------------------
class Cluster:
    """N replicas + a global fairness-aware dispatcher."""

    def __init__(self, replicas: list,
                 policy: Union[str, Callable] = "least_kv",
                 share_counters: bool = True):
        if not replicas:
            raise ValueError("need at least one replica")
        self.replicas = replicas
        if isinstance(policy, str):
            if policy not in ROUTING_POLICIES:
                raise ValueError(f"unknown routing policy {policy!r}; "
                                 f"choose from {sorted(ROUTING_POLICIES)}")
            policy = ROUTING_POLICIES[policy]
        self.policy = policy
        self._rr = 0
        self.routed_to: Dict[int, int] = {}
        # telemetry (DESIGN.md §14): stamp each replica's observer with
        # its index so per-replica flight-recorder traces can be merged
        # on the shared modeled clock (one Perfetto process per replica)
        for i, rep in enumerate(replicas):
            obs = getattr(getattr(rep, "core", None), "observer", None)
            if obs is not None:
                obs.set_replica(i)
        # interaction -> replica pin (DESIGN.md §13): later turns must
        # land where their history's radix pages live, whatever the
        # load-balancing policy would prefer
        self.interaction_replica: Dict[int, int] = {}
        self.counters_shared = share_counters
        if share_counters:
            share_fairness_state([rep.sched for rep in replicas])
            # the admission windows are cluster-global too: spraying
            # interaction starts across replicas must hit ONE window
            share_admission_state(
                [rep.core.admission for rep in replicas
                 if getattr(rep, "core", None) is not None
                 and rep.core.admission is not None])

    def dispatch(self, req: Request) -> int:
        """Route one request to a replica (records the decision).  Turns
        of a known interaction stick to their interaction's replica —
        KV/prefix reuse is replica-local, so affinity beats whatever the
        load balancer would pick for turn k>0."""
        iid = req.interaction_id
        if iid is not None and iid in self.interaction_replica:
            idx = self.interaction_replica[iid]
        else:
            idx = self.policy(self, req)
            if iid is not None:
                self.interaction_replica[iid] = idx
        self.routed_to[req.rid] = idx
        self.replicas[idx].submit(req)
        return idx

    def run(self, requests: List[Request] = None, max_time: float = 1e9,
            interactions=None) -> ClusterResult:
        heap: List[tuple] = []        # (arrival, seq, req)
        seq = 0
        all_reqs: List[Request] = []

        def push(req):
            nonlocal seq
            heapq.heappush(heap, (req.arrival, seq, req))
            all_reqs.append(req)
            seq += 1

        for r in sorted(requests or [], key=lambda r: r.arrival):
            push(r)
        # one cluster-wide interaction registry, aliased into every
        # replica core: the replica that completes turn k releases turn
        # k+1 into the *cluster's* arrival heap (dispatch then pins it
        # back to the same replica via interaction_replica)
        registry: Dict[int, object] = {}
        for inter in interactions or []:
            registry[inter.interaction_id] = inter
            first = inter.next_request()  # keeps its stamped arrival
            if first is not None:
                push(first)
        for rep in self.replicas:
            core = getattr(rep, "core", None)
            if core is not None:
                core.interactions = registry
                core.on_turn_release = lambda nxt, now: push(nxt)

        # Global event heap (DESIGN.md §15): one live (clock, index)
        # entry per *busy* replica.  A replica's clock only moves when it
        # steps (or takes the no-progress tick), and both happen while
        # its entry is popped, so entries are never stale — no lazy
        # deletion.  Keying by (clock, index) reproduces the legacy
        # "first replica with the minimum clock" tie-break exactly (list
        # order == index order), so the lockstep `min()` scan and the
        # O(all-requests) termination scan are gone: idle replicas cost
        # nothing per event, and an open request always keeps its
        # replica busy, so `heap or busy` is the termination condition.
        # (One semantic refinement over the old scan: work left over in
        # a reused cluster from an earlier max_time-cut run now drains
        # too instead of being abandoned mid-flight; it still does not
        # appear in this run's result set.)
        busy: List[tuple] = []            # (clock, replica index)
        in_heap = [False] * len(self.replicas)

        def repush(i):
            if self.replicas[i].has_work():
                in_heap[i] = True
                heapq.heappush(busy, (self.replicas[i].clock, i))
            else:
                in_heap[i] = False

        def advance_idle(t_now):
            # idle replicas keep pace with the frontier so routing reads
            # (min_ttft's replica clock) see "now", exactly as the
            # lockstep loop kept them advanced — done lazily, only when
            # a dispatch is about to read them
            for i, rep in enumerate(self.replicas):
                if not in_heap[i]:
                    rep.advance_to(t_now)

        def route(req):
            idx = self.dispatch(req)
            if not in_heap[idx]:
                repush(idx)

        for i in range(len(self.replicas)):
            repush(i)

        while True:
            if not busy:
                # whole cluster idle: jump to the next arrival
                if not heap:
                    break
                t_now = heap[0][0]
                if t_now >= max_time:
                    break
                advance_idle(t_now)
                route(heapq.heappop(heap)[2])
                continue
            # event frontier = slowest busy replica
            t_now = busy[0][0]
            if t_now >= max_time:
                break
            if heap and heap[0][0] <= t_now:
                advance_idle(t_now)
                # route every arrival the frontier has reached
                while heap and heap[0][0] <= t_now:
                    route(heapq.heappop(heap)[2])
            _, i = heapq.heappop(busy)
            rep = self.replicas[i]
            before = rep.clock
            if (getattr(getattr(rep, "cfg", None), "macro_step", False)
                    and hasattr(rep, "macro_or_step")):
                # macro burst window: stop strictly before the next
                # arrival, the next busy peer's clock (shared fairness
                # counters must be charged in the legacy replica
                # interleaving), and the horizon cut
                stop = max_time
                if heap:
                    stop = min(stop, heap[0][0])
                if busy:
                    stop = min(stop, busy[0][0])
                rep.macro_or_step(stop)
            else:
                rep.step()
            if rep.clock <= before:
                # no progress (e.g. RPM quota starvation on the engine):
                # model a host polling tick so the event loop advances
                rep.advance_to(before + rep.cm.hw.batch_overhead)
            repush(i)

        # surface the denied work: turns a throttled (or horizon-cut)
        # interaction never released still belong to this run's metrics
        for inter in interactions or []:
            all_reqs.extend(inter.turns[inter.released:])
        all_reqs.sort(key=lambda r: (r.arrival, r.rid))
        sim_time = max(rep.clock for rep in self.replicas)
        return ClusterResult(requests=all_reqs, replicas=self.replicas,
                             scheduler=self.replicas[0].sched,
                             sim_time=sim_time, routed_to=dict(self.routed_to),
                             counters_shared=self.counters_shared)


def make_sim_cluster(n_replicas: int, cost_model: CostModel = None, *,
                     cost_models: Optional[Sequence[CostModel]] = None,
                     scheduler: str = "vtc", predictor=None,
                     sim_cfg: SimConfig = None,
                     policy: Union[str, Callable] = "least_kv",
                     share_counters: bool = True, observer=None,
                     admission=None, **sched_kw) -> Cluster:
    """Cluster of simulated replicas.  Pass ``cost_models`` (one per
    replica) for a heterogeneous fleet — e.g. mixing ``A100_80G`` and
    TPU-v5e ``Hardware`` presets; the predictor (shared by all replicas,
    so recalibration is global too) and fairness counters span the
    cluster.  ``admission`` (an ``AdmissionConfig`` or a ready
    controller, DESIGN.md §13) is normalized to ONE controller handed to
    every replica, so the sliding windows are cluster-global regardless
    of ``share_counters``.

    ``observer`` is either one ``telemetry.Observer`` shared by every
    replica (e.g. an ``HFObserver`` accumulating cluster-wide UFC/RFC)
    or a callable ``replica_index -> Observer`` factory — the flight-
    recorder path (DESIGN.md §14): each replica gets its own recorder,
    ``Cluster`` stamps the indices, ``merge_traces`` joins the streams."""
    cms = list(cost_models) if cost_models is not None \
        else [cost_model] * n_replicas
    if len(cms) != n_replicas or any(c is None for c in cms):
        raise ValueError("provide cost_model or n_replicas cost_models")
    ctrl = as_controller(admission)
    reps = []
    for i, cm in enumerate(cms):
        sched = make_scheduler(scheduler, predictor=predictor, **sched_kw)
        obs = observer(i) if callable(observer) \
            and not isinstance(observer, Observer) else observer
        reps.append(Simulator(cm, sched, sim_cfg or SimConfig(),
                              observer=obs, admission=ctrl))
    return Cluster(reps, policy=policy, share_counters=share_counters)
