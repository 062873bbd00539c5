"""The port's flight recorder (``repro_torch.serving.telemetry``, a numpy
copy) against ``repro.serving.telemetry`` (DESIGN.md §14):

- counter replay: ``replay_counters`` of the port's traces equals the
  live counters, on the port's simulator under preemption and admission
  control (every policy) and on the port's engine (CPU, bridged smoke
  weights, on the cost-model clock);
- the port's simulator records the SAME trace as the reference's, and
  the consumers (Chrome-trace export, ``merge_traces``,
  ``windowed_fairness``, ``prediction_accuracy``) give the same output
  as the reference's on it; the JSON round trip keeps it;
- the port's engine records the same event sequence as the reference
  engine on the same requests and weights;
- ``chip_smoke.py``'s cluster replay (run J) at smoke size: two engines
  sharing Equinox's tables replay to the live counters."""
import json

import jax
import numpy as np
import pytest

import repro.core as J
import repro.predictor as JP
import repro.serving.admission as JA
import repro.serving.costmodel as JC
import repro.serving.telemetry as JT
import repro.workloads as JW
import repro_torch.core as T
import repro_torch.predictor as TP
import repro_torch.serving.admission as TA
import repro_torch.serving.costmodel as TC
import repro_torch.serving.telemetry as TT
import repro_torch.workloads as TW
from repro.configs import SMOKE_FACTORIES, get_config as j_get_config
from repro.models import init_params
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import SMOKE_FACTORIES as T_SMOKE
from repro_torch.configs import get_config as t_get_config
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.weights import params_from_numpy

SIDES = {"jax": (J, JP, JA, JC, JT, JW, j_get_config),
         "torch": (T, TP, TA, TC, TT, TW, t_get_config)}


def stress_run(side, policy, *, factor=0.2, sample_every=16,
               max_time=100.0, replica=None):
    """tests/test_telemetry.py's saturated closed-loop run: admission
    control on, output lengths under-predicted 5x so preemption fires,
    multiturn interactions so turn releases fire."""
    core, pred, adm, costmodel, tel, wl, get_config = SIDES[side]
    cm = costmodel.CostModel(get_config("llama2-7b"), costmodel.A100_80G)
    p = None if policy == "fcfs" else pred.ScaledOracle(cm, factor=factor)
    sched = core.make_scheduler(policy, predictor=p)
    rec = tel.FlightRecorder(sample_every=sample_every)
    if replica is not None:
        rec.set_replica(replica)
    sim = core.Simulator(
        cm, sched, core.SimConfig(max_batch=8, kv_budget_tokens=6_000,
                                  default_reserve=64, max_time=max_time),
        observer=tel.MultiObserver(core.HFObserver(), rec),
        admission=adm.AdmissionConfig(window_s=30.0, user_rate=3.0,
                                      app_rate=12.0, kv_thresh=0.7,
                                      queue_thresh=0.3))
    res = sim.run(interactions=wl.multiturn_interactions(
        n_users=8, n_apps=2, sessions_per_user=(2, 10), session_gap=0.5,
        think_time=0.5, seed=7))
    return res, sim, sched, rec


@pytest.mark.parametrize("policy", ["vtc", "dlpm", "equinox", "fcfs"])
def test_sim_replay_and_trace_equal_reference(policy):
    _, _, j_sched, j_rec = stress_run("jax", policy)
    res, sim, sched, rec = stress_run("torch", policy)
    assert sim.n_preemptions > 0, "stress config must exercise preemption"
    assert res.n_throttled > 0, "stress config must exercise admission"
    trace = rec.trace()
    assert {e["type"] for e in trace["events"]} == set(TT.EVENT_TYPES)
    assert TT.replay_counters(trace) == TT.scheduler_counters(sched)
    np.testing.assert_equal(trace, j_rec.trace())
    assert TT.scheduler_counters(sched) == JT.scheduler_counters(j_sched)


def test_trace_json_round_trip(tmp_path):
    _, _, sched, rec = stress_run("torch", "vtc", max_time=60.0)
    path = TT.save_trace(rec.trace(), str(tmp_path / "t.json"))
    loaded = TT.load_trace(path)
    assert loaded["meta"]["policy"] == "vtc"
    assert TT.replay_counters(loaded) == TT.scheduler_counters(sched)
    # the reference reads the port's file alike
    assert JT.replay_counters(JT.load_trace(path)) == \
        TT.replay_counters(loaded)


def test_chrome_trace_structure_equals_reference():
    _, _, _, rec = stress_run("torch", "vtc", max_time=60.0)
    trace = rec.trace()
    chrome = TT.to_chrome_trace(trace)
    assert chrome == JT.to_chrome_trace(trace)
    evs = chrome["traceEvents"]
    assert evs and chrome["displayTimeUnit"] == "ms"
    assert all("ph" in e and "ts" in e and "pid" in e for e in evs)
    opens = {}
    for e in evs:
        if e["ph"] == "b":
            opens[e["id"]] = opens.get(e["id"], 0) + 1
        elif e["ph"] == "e":
            opens[e["id"]] = opens.get(e["id"], 0) - 1
            assert opens[e["id"]] >= 0, "end before begin"
    for ph, name in (("M", "process_name"), ("M", "thread_name"),
                     ("C", "kv"), ("C", "service")):
        assert any(e["ph"] == ph and e["name"] == name for e in evs)
    json.dumps(chrome)


def test_merge_traces_equals_reference():
    traces = [stress_run("torch", "vtc", max_time=40.0, replica=i)[3].trace()
              for i in range(2)]
    merged = TT.merge_traces(traces)
    np.testing.assert_equal(merged, JT.merge_traces(traces))
    ts = [e["t"] for e in merged["events"]]
    assert ts == sorted(ts)
    assert {e["pid"] for e in TT.to_chrome_trace(merged)["traceEvents"]} \
        == {0, 1}


def test_windowed_fairness_bounds_and_prediction_accuracy():
    _, _, _, rec = stress_run("torch", "equinox", sample_every=4)
    trace = rec.trace()
    wf = TT.windowed_fairness(trace)
    np.testing.assert_equal(wf, JT.windowed_fairness(trace))
    assert wf["n_windows"] > 0 and wf["max_discrepancy"] >= 0.0
    a, b = wf["worst_pair"]
    assert a != b
    t0, t1 = wf["worst_window"]
    assert t0 <= t1
    assert all(0.0 <= j <= 1.0 + 1e-9 for j in wf["rolling_jain"])
    assert 0.0 <= wf["min_jain"] <= 1.0 + 1e-9
    acc = TT.prediction_accuracy(trace)
    assert acc == JT.prediction_accuracy(trace)
    # ScaledOracle(0.2) under-predicts 5x -> |0.2x - x|/x = 0.8
    assert max(v["rel_err"] for v in acc.values()) == pytest.approx(
        0.8, abs=0.05)


@pytest.fixture(scope="module")
def weights():
    cfg = SMOKE_FACTORIES["llama2-7b"]()
    params = init_params(jax.random.key(5), cfg)
    return params, params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def engine_trace(side, params, policy, prefix_cache):
    torch_side = side == "torch"
    core, pred, _, costmodel, tel, wl, _ = SIDES[side]
    cfg = (T_SMOKE if torch_side else SMOKE_FACTORIES)["llama2-7b"]()
    cm = costmodel.CostModel(cfg)
    p = pred.Oracle(cm) if policy == "equinox" else None
    sched = core.make_scheduler(policy, predictor=p)
    rec = tel.FlightRecorder(sample_every=2)
    kw = {"device": "cpu"} if torch_side else {}
    eng = (TEngine if torch_side else JEngine)(
        cfg, sched, params=params, max_slots=4, max_len=96, cost_model=cm,
        backend="paged", prefill_chunk_tokens=16, prefix_cache=prefix_cache,
        kv_budget_tokens=1200, observer=rec, **kw)
    reqs = wl.multiturn_sharegpt_like(n_clients=2, n_conversations=2,
                                      turns=(2, 3), system_pool=1,
                                      system_len=32, seed=1)
    for r in reqs:               # short turns: every prompt fits max_len
        r.prompt_len = min(r.prompt_len, 60)
        r.output_len = min(r.output_len, 6)
    done = eng.run(reqs)
    assert len(done) == len(reqs)
    return rec.trace(), sched


@pytest.mark.parametrize("policy,prefix_cache",
                         [("vtc", False), ("equinox", True)])
def test_engine_trace_and_replay_equal_reference(weights, policy,
                                                 prefix_cache):
    jp, tp = weights
    j_trace, _ = engine_trace("jax", jp, policy, prefix_cache)
    trace, sched = engine_trace("torch", tp, policy, prefix_cache)
    assert TT.replay_counters(trace) == TT.scheduler_counters(sched)
    seq = [(e["type"], e.get("rid"), e["t"]) for e in trace["events"]]
    assert seq == [(e["type"], e.get("rid"), e["t"])
                   for e in j_trace["events"]]
    np.testing.assert_equal(trace, j_trace)
    kinds = {k for k, _, _ in seq}
    assert {"admit", "prefill_chunk", "first_token", "complete",
            "iteration"} <= kinds


def test_cluster_replay_of_engines_equals_live(weights):
    """chip_smoke.py's run J at smoke size on the CPU: two of the port's
    engines behind a ``Cluster`` with Equinox schedulers sharing their
    fairness state.  Replaying the events in the order the cluster fired
    them, each into its replica's rebuilt scheduler (``replay_cluster``),
    gives the live counters exactly.  (``replay_counters`` replays one
    replica: each Equinox replica keeps its own latency average, and the
    reference's ``merge_traces`` orders events by timestamp, not in the
    order the shared tables were charged.)"""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import replay_cluster
    from repro_torch.serving.cluster import Cluster

    _, tp = weights
    cfg = T_SMOKE["llama2-7b"]()
    cm = TC.CostModel(cfg)
    recs = [TT.FlightRecorder(sample_every=4) for _ in range(2)]
    order = TT.FlightRecorder()
    engines = [TEngine(cfg, T.make_scheduler("equinox",
                                             predictor=TP.Oracle(cm)),
                       params=tp, max_slots=2, max_len=64, cost_model=cm,
                       backend="paged", device="cpu",
                       observer=TT.MultiObserver(recs[i], order))
               for i in range(2)]
    cluster = Cluster(engines, policy="least_kv")
    rng = np.random.default_rng(0)
    reqs = [T.Request(rid=i, client=f"client{i % 3}", arrival=0.002 * i,
                      prompt_len=int(rng.integers(8, 40)),
                      output_len=int(rng.integers(3, 9)),
                      keywords=("chat",)) for i in range(10)]
    res = cluster.run(reqs, max_time=1e9)
    assert res.summary()["finished"] == 10
    assert all(n > 0 for n in res.summary()["per_replica"])
    live = TT.scheduler_counters(engines[0].sched)
    assert replay_cluster(order.trace(), [r.trace()["meta"] for r in recs],
                          cluster.routed_to) == live
    merged = TT.merge_traces([r.trace() for r in recs])
    wf = TT.windowed_fairness(merged)
    assert wf["n_windows"] > 0 and 0.0 <= wf["min_jain"] <= 1.0 + 1e-9
