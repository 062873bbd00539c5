"""The port's discrete-event simulator (``repro_torch.core.simulator``, a
numpy copy) against ``repro.core.simulator`` on the same traces: every
request's lifecycle, the timeline, the scheduler's counters, the waste
and throttle accounting and the summary are EQUAL, for every scheduler,
with stall-free chunked prefill, the prefix cache, preemption under
under-prediction, admission control over closed-loop interactions,
macro-stepping and the SLO budget solver.  Both sides build their trace
with their own copy of ``workloads``, so the copies are held too."""
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
from repro.configs import get_config as j_get_config
from repro_torch.configs import get_config as t_get_config

# one namespace per package: (core, predictor, admission, costmodel,
# telemetry, workloads, get_config)
SIDES = {"jax": (J, JP, JA, JC, JT, JW, j_get_config),
         "torch": (T, TP, TA, TC, TT, TW, t_get_config)}
SCHEDULERS = ("fcfs", "rpm", "vtc", "equinox", "dlpm")
REQ_FIELDS = ("rid", "client", "arrival", "prompt_len", "output_len", "state",
              "admit_time", "first_token_time", "finish_time", "generated",
              "prefill_done", "cached_prefix", "n_preempted", "preempt_time",
              "generated_peak", "pred_output_len", "slo_class",
              "interaction_id", "turn_index", "user", "app")


def request_view(reqs):
    """Every lifecycle field of every request, ordered by rid."""
    return sorted(tuple(getattr(r, f) for f in REQ_FIELDS) for r in reqs)


def scenario(side, name, sched_name):
    """Build the scenario ``name`` with one package and run it; returns
    everything the comparison reads."""
    core, pred, adm, costmodel, tel, wl, get_config = SIDES[side]
    cm = costmodel.CostModel(get_config("llama2-7b"), costmodel.A100_80G)
    predictor = None
    if sched_name == "equinox":
        predictor = pred.Oracle(cm)
    kw, run_kw = {}, {}
    if name == "stress":
        # 5x under-prediction (preemption), admission control and
        # closed-loop turns (the telemetry stress configuration)
        if sched_name != "fcfs":
            predictor = pred.ScaledOracle(cm, factor=0.2)
        cfg = core.SimConfig(max_batch=8, kv_budget_tokens=6_000,
                             default_reserve=64, max_time=60.0)
        kw["admission"] = adm.AdmissionConfig(
            window_s=30.0, user_rate=3.0, app_rate=12.0, kv_thresh=0.7,
            queue_thresh=0.3)
        run_kw["interactions"] = wl.multiturn_interactions(
            n_users=6, n_apps=2, sessions_per_user=(2, 6), session_gap=0.5,
            think_time=0.5, seed=7)
    elif name == "chunked":
        cfg = core.SimConfig(max_batch=16, prefill_chunk=256)
        run_kw["requests"] = wl.overload(duration=8.0)
    elif name == "prefix_cache":
        cfg = core.SimConfig(max_batch=8, kv_budget_tokens=30_000,
                             prefix_cache=True)
        run_kw["requests"] = wl.multiturn_sharegpt_like(
            n_clients=4, n_conversations=2, seed=0)
    elif name == "macro":
        cfg = core.SimConfig(max_batch=32, macro_step=True)
        run_kw["requests"] = wl.balanced(duration=6.0)
    elif name == "slo_auto":
        cfg = core.SimConfig(max_batch=16, prefill_chunk=256,
                             slo_budget="auto")
        run_kw["requests"] = wl.diurnal(duration=20.0, seed=1)
    else:
        raise ValueError(name)
    sched = core.make_scheduler(sched_name, predictor=predictor)
    sim = core.Simulator(cm, sched, cfg, **kw)
    res = sim.run(**run_kw)
    tl = res.timeline
    return {"requests": request_view(res.requests),
            "timeline": (tl.t, tl.util, tl.batch, tl.tokens, tl.service,
                         tl.budget),
            "sim_time": res.sim_time, "wasted": res.wasted_preempt,
            "throttled": res.n_throttled,
            "preemptions": sim.n_preemptions,
            "counters": tel.scheduler_counters(sched),
            "summary": core.summarize(res)}


CASES = ([("chunked", s) for s in SCHEDULERS]
         + [("prefix_cache", s) for s in SCHEDULERS]
         + [("stress", s) for s in ("fcfs", "vtc", "equinox", "dlpm")]
         + [("macro", s) for s in ("vtc", "equinox")]
         + [("slo_auto", "vtc")])


@pytest.mark.parametrize("name,sched", CASES,
                         ids=[f"{n}-{s}" for n, s in CASES])
def test_simulator_equals_reference(name, sched):
    ref, port = scenario("jax", name, sched), scenario("torch", name, sched)
    assert port["requests"], "the scenario produced no requests"
    np.testing.assert_equal(port, ref)
    # the scenarios reach what they are meant to
    if name == "stress":
        assert port["throttled"] > 0
        if sched != "fcfs":
            assert port["preemptions"] > 0
    if name == "prefix_cache":
        assert sum(r[REQ_FIELDS.index("cached_prefix")]
                   for r in port["requests"]) > 0
    assert any(r[REQ_FIELDS.index("state")] == "finished"
               for r in port["requests"])
