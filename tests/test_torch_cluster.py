"""The port's cluster layer (``repro_torch.serving.cluster``, a numpy
copy) against ``repro.serving.cluster``:

- simulated clusters (``make_sim_cluster``) give EQUAL results on the
  same traces, for every routing policy: where each request was routed,
  every request's lifecycle, the merged service table and the summary;
  also without shared counters, on a heterogeneous fleet and under
  admission control;
- a two-replica ``Cluster`` of the port's engines (bridged smoke
  weights, CPU) against the reference's cluster of JAX engines, as in
  ``tests/test_cluster.py::test_engine_cluster_end_to_end``: the same
  routing, the same finished requests at the same modeled times, one
  shared service table, first-token logits to 1e-4."""
import dataclasses

import jax
import numpy as np
import pytest

import repro.core as J
import repro.predictor as JP
import repro.serving.admission as JA
import repro.serving.cluster as JCL
import repro.serving.costmodel as JC
import repro.workloads as JW
import repro_torch.core as T
import repro_torch.predictor as TP
import repro_torch.serving.admission as TA
import repro_torch.serving.cluster as TCL
import repro_torch.serving.costmodel as TC
import repro_torch.workloads as TW
from repro.configs import SMOKE_FACTORIES, get_config as j_get_config
from repro.models import init_params
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import SMOKE_FACTORIES as T_SMOKE
from repro_torch.configs import get_config as t_get_config
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.weights import params_from_numpy

SIDES = {"jax": (J, JP, JA, JCL, JC, JW, j_get_config),
         "torch": (T, TP, TA, TCL, TC, TW, t_get_config)}
REQ_FIELDS = ("rid", "client", "state", "admit_time", "first_token_time",
              "finish_time", "generated", "cached_prefix", "n_preempted")


def request_view(reqs):
    return sorted(tuple(getattr(r, f) for f in REQ_FIELDS) for r in reqs)


def flood_trace(core, duration=6.0, flood_rate=30.0, fair_rate=2.0):
    """client ``flood`` sprays far more requests than client ``fair``
    (tests/test_cluster.py's trace)."""
    reqs, rid = [], 0
    for client, rate in (("flood", flood_rate), ("fair", fair_rate)):
        t = 0.0
        while t < duration:
            t += 1.0 / rate
            reqs.append(core.Request(rid=rid, client=client, arrival=t,
                                     prompt_len=50, output_len=100,
                                     keywords=("chat",)))
            rid += 1
    return sorted(reqs, key=lambda r: r.arrival)


def sim_cluster(side, policy, variant):
    core, pred, adm, cluster, costmodel, wl, get_config = SIDES[side]
    cm = costmodel.CostModel(get_config("llama2-7b"), costmodel.A100_80G)
    scheduler = "dlpm" if policy == "d2lpm" else "vtc"
    kw = dict(scheduler=scheduler, policy=policy)
    sim_cfg = dict(max_batch=8, kv_budget_tokens=30_000)
    trace = None
    if policy in ("prefix_affinity", "d2lpm"):
        sim_cfg["prefix_cache"] = True
        trace = wl.multiturn_sharegpt_like(n_clients=6, n_conversations=2,
                                           seed=3)
    if variant == "unshared":
        kw["share_counters"] = False
    elif variant == "hetero":
        # the port's H100 preset; the reference has none, so it gets the
        # same fields
        h100 = costmodel.Hardware(**dataclasses.asdict(TC.H100_SXM))
        kw["cost_models"] = [cm, costmodel.CostModel(
            get_config("llama2-7b"), h100), cm]
        cm = None
    elif variant == "admission":
        kw.update(scheduler="equinox", predictor=pred.Oracle(cm),
                  admission=adm.AdmissionConfig(window_s=5.0, user_rate=8,
                                                queue_thresh=0.2))
        sim_cfg["kv_budget_tokens"] = 4000
    n = 2 if variant == "admission" else 3
    cl = cluster.make_sim_cluster(n, cm, sim_cfg=core.SimConfig(**sim_cfg),
                                  **kw)
    res = cl.run(trace if trace is not None else flood_trace(core),
                 max_time=8.0 if variant == "admission" else 1e9)
    return {"routed_to": res.routed_to,
            "requests": request_view(res.requests),
            "service": res.per_client_service(),
            "summary": res.summary(), "hit_rate": res.cache_hit_rate()}


CASES = [(p, "shared") for p in ("round_robin", "least_kv", "min_ttft",
                                 "prefix_affinity", "d2lpm")] \
    + [("least_kv", "unshared"), ("min_ttft", "hetero"),
       ("least_kv", "admission")]


@pytest.mark.parametrize("policy,variant", CASES,
                         ids=[f"{p}-{v}" for p, v in CASES])
def test_sim_cluster_equals_reference(policy, variant):
    ref = sim_cluster("jax", policy, variant)
    port = sim_cluster("torch", policy, variant)
    np.testing.assert_equal(port, ref)
    s = port["summary"]
    assert s["finished"] > 0
    assert len(set(port["routed_to"].values())) > 1     # routing spread
    if variant == "admission":
        assert s["n_throttled"] > 0
    elif variant != "hetero":
        assert s["finished"] == s["total"]
    if policy in ("prefix_affinity", "d2lpm"):
        assert port["hit_rate"] > 0


@pytest.fixture(scope="module")
def weights():
    cfg = SMOKE_FACTORIES["llama2-7b"]()
    params = init_params(jax.random.key(3), cfg)
    return params, params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def engine_cluster(side, params, policy):
    torch_side = side == "torch"
    core = T if torch_side else J
    cfg = (T_SMOKE if torch_side else SMOKE_FACTORIES)["llama2-7b"]()
    kw = {"device": "cpu"} if torch_side else {}
    reps = [(TEngine if torch_side else JEngine)(
        cfg, core.make_scheduler("vtc"), params=params, max_slots=2,
        max_len=64, seed=i, backend="paged", keep_first_logits=True, **kw)
        for i in range(2)]
    cl = (TCL if torch_side else JCL).Cluster(reps, policy=policy)
    rng = np.random.default_rng(0)
    reqs = [core.Request(rid=i, client=f"client{i % 2}", arrival=0.001 * i,
                         prompt_len=int(rng.integers(8, 16)),
                         output_len=int(rng.integers(3, 6)),
                         keywords=("chat",)) for i in range(8)]
    res = cl.run(reqs, max_time=1e9)
    assert reps[0].sched.service is reps[1].sched.service
    return res


@pytest.mark.parametrize("policy", ["round_robin", "least_kv"])
def test_engine_cluster_matches_reference(weights, policy):
    jp, tp = weights
    ref = engine_cluster("jax", jp, policy)
    port = engine_cluster("torch", tp, policy)
    s = port.summary()
    assert s["finished"] == 8 and all(n > 0 for n in s["per_replica"])
    assert port.routed_to == ref.routed_to
    assert request_view(port.requests) == request_view(ref.requests)
    assert port.per_client_service() == ref.per_client_service()
    rows = {r.rid: r._first_row for r in ref.requests}
    for r in port.requests:
        np.testing.assert_allclose(r._first_row, rows[r.rid], atol=1e-4,
                                   rtol=1e-4)
