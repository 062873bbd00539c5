"""The PyTorch port's serving engine against ``repro.serving.engine`` on
bridged smoke weights (f32, CPU): first-token logits, greedy tokens,
admissions, chunk plans and modeled TTFT under ``fcfs`` and ``equinox``
(Oracle predictor), on both sides of the split-K threshold, with fp and
int8 KV pages."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_FACTORIES
from repro.core import Request as JRequest
from repro.core import make_scheduler as j_make_scheduler
from repro.models import init_params
from repro.predictor import Oracle as JOracle
from repro.serving.costmodel import CostModel as JCM
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.telemetry import Observer as JObserver
from repro_torch.configs import SMOKE_FACTORIES as T_SMOKE
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import Request as TRequest
from repro_torch.core import make_scheduler as t_make_scheduler
from repro_torch.kernels import ops
from repro_torch.predictor import Oracle as TOracle
from repro_torch.serving.costmodel import CostModel as TCM
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.telemetry import Observer as TObserver
from repro_torch.weights import params_from_numpy

CFG, T_CFG = SMOKE_FACTORIES["llama2-7b"](), T_SMOKE["llama2-7b"]()


def spy_class(base):
    class Spy(base):
        """Admission order, chunk plans and every produced token."""

        def __init__(self):
            self.order, self.chunks, self.tokens = [], [], {}

        def on_admit(self, req, now):
            self.order.append(req.rid)

        def on_prefill_chunk(self, req, chunk):
            self.chunks.append((req.rid, chunk))

        def on_iteration(self, now, *, t_iter, util, fresh, running,
                         produced, first):
            for r in produced:
                self.tokens.setdefault(r.rid, []).append(int(r._next_token))
    return Spy


JSpy, TSpy = spy_class(JObserver), spy_class(TObserver)


@pytest.fixture(scope="module")
def weights():
    params = init_params(jax.random.key(7), CFG)
    return params, params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def mk_reqs(cls, n=5, seed=11):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, client=f"client{i % 2}", arrival=0.01 * i,
                prompt_len=int(rng.integers(6, 30)),
                output_len=int(rng.integers(3, 8)), keywords=("chat",))
            for i in range(n)]


def serve(side, params, sched, max_len, kv_quant):
    jax_side = side == "jax"
    spy = (JSpy if jax_side else TSpy)()
    if sched == "equinox":
        pred = JOracle(JCM(CFG)) if jax_side else TOracle(TCM(T_CFG))
        scheduler = (j_make_scheduler if jax_side else t_make_scheduler)(
            "equinox", predictor=pred)
    else:
        scheduler = (j_make_scheduler if jax_side else t_make_scheduler)(
            sched)
    kw = dict(params=params, max_slots=3, max_len=max_len, backend="paged",
              chunked=True, kv_quant=kv_quant, kv_budget_tokens=512,
              prefill_chunk_tokens=16, keep_first_logits=True, observer=spy)
    if jax_side:
        eng = JEngine(CFG, scheduler, **kw)
    else:
        eng = TEngine(T_CFG, scheduler, device="cpu", **kw)
    done = eng.run(mk_reqs(JRequest if jax_side else TRequest))
    return {r.rid: r for r in done}, spy, eng


# max_len 64 -> table width 4 (serial kernel); 256 -> width 16 (split-K)
@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("sched", ["fcfs", "equinox"])
@pytest.mark.parametrize("max_len", [64, 256])
def test_engine_matches_reference(weights, max_len, sched, kv_quant,
                                  monkeypatch):
    jp, tp = weights
    used = []
    for name in ("paged_attention_kernel", "paged_attention_splitk_kernel"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _fn=fn, _n=name, **k:
                            used.append(_n) or _fn(*a, **k))
    j_done, j_spy, _ = serve("jax", jp, sched, max_len, kv_quant)
    t_done, t_spy, t_eng = serve("torch", tp, sched, max_len, kv_quant)
    assert set(used) == {"paged_attention_kernel" if max_len == 64
                         else "paged_attention_splitk_kernel"}
    assert len(t_done) == len(j_done) == 5
    assert t_spy.order == j_spy.order              # admissions
    assert t_spy.chunks == j_spy.chunks            # chunk plans
    assert max(n for _, n in t_spy.chunks) < max(
        r.prompt_len for r in t_done.values())    # prompts were chunked
    assert t_spy.tokens == j_spy.tokens            # greedy tokens
    for rid, jr in j_done.items():
        tr = t_done[rid]
        assert tr.generated == jr.generated == jr.output_len
        assert tr.ttft() == pytest.approx(jr.ttft(), abs=1e-9)
        assert tr.e2e_latency() == pytest.approx(jr.e2e_latency(),
                                                 abs=1e-9)
        # int8 pages: a k/v element may round to the neighbouring code
        # when the two frameworks' f32 projections differ in the last bit
        tol = 5e-3 if kv_quant else 1e-4
        np.testing.assert_allclose(tr._first_row, jr._first_row, atol=tol,
                                   rtol=tol)
    assert t_eng.iterations == len(t_eng.iter_log)


def test_int8_greedy_tokens_match_fp(weights):
    _, tp = weights
    toks = {}
    for kv_quant in (False, True):
        done, spy, _ = serve("torch", tp, "fcfs", 64, kv_quant)
        toks[kv_quant] = spy.tokens
    assert toks[True] == toks[False]


@pytest.mark.parametrize("kw", [{"backend": "slots"}, {"chunked": False},
                                {"prefix_cache": True}])
def test_options_outside_the_slice_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A"):
        TEngine(T_CFG, t_make_scheduler("fcfs"), device="cpu", **kw)


def test_moe_stack_raises():
    cfg = SMOKE_FACTORIES["mixtral-8x7b"]()
    t_cfg = ModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(ModelConfig)
                           if f.name != "moe"},
                        moe=MoEConfig(**dataclasses.asdict(cfg.moe)))
    with pytest.raises(NotImplementedError, match="MoE"):
        TEngine(t_cfg, t_make_scheduler("fcfs"), device="cpu")


def test_engine_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TEngine(T_CFG, t_make_scheduler("fcfs"))


def test_replica_protocol_drives_the_engine(weights):
    """submit/step/has_work/clock/advance_to, as the cluster layer drives
    a replica, serve the same tokens as ``run``."""
    _, tp = weights
    done, spy, _ = serve("torch", tp, "fcfs", 64, False)
    eng = TEngine(T_CFG, t_make_scheduler("fcfs"), params=tp, max_slots=3,
                  max_len=64, kv_budget_tokens=512, prefill_chunk_tokens=16,
                  observer=TSpy(), device="cpu")
    eng.advance_to(0.5)
    assert eng.clock == 0.5
    for r in mk_reqs(TRequest):
        r.arrival = 0.0
        eng.submit(r)
    while eng.has_work():
        eng.step()
    assert eng.n_finished == len(done)
    assert eng.core.observer.tokens == spy.tokens


def test_temperature_sampling_is_seeded(weights):
    _, tp = weights
    runs = []
    for seed in (3, 3, 4):
        spy = TSpy()
        eng = TEngine(T_CFG, t_make_scheduler("fcfs"), params=tp,
                      max_slots=3, max_len=64, kv_budget_tokens=512,
                      sample_temp=1.0, seed=seed, observer=spy,
                      device="cpu")
        eng.run(mk_reqs(TRequest))
        runs.append(spy.tokens)
    assert runs[0] == runs[1] and runs[0] != runs[2]
    assert all(0 <= t < T_CFG.vocab_size
               for toks in runs[0].values() for t in toks)
