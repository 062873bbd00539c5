"""The PyTorch port's serving engine against ``repro.serving.engine`` on
bridged smoke weights (f32, CPU): first-token logits, greedy tokens,
admissions, chunk plans and modeled TTFT under ``fcfs`` and ``equinox``
(Oracle predictor), on both sides of the split-K threshold, with fp and
int8 KV pages; the same for the dense GQA configs DeepSeek-7B,
Granite-3-2B and StarCoder2-7B and a single-stage full-attention MoE stack
(the paged step's MoE branch); and the stacks the paged backend
refuses."""
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


def serve(side, params, sched, max_len, kv_quant, cfgs=(CFG, T_CFG)):
    jax_side = side == "jax"
    j_cfg, t_cfg = cfgs
    spy = (JSpy if jax_side else TSpy)()
    if sched == "equinox":
        pred = JOracle(JCM(j_cfg)) if jax_side else TOracle(TCM(t_cfg))
        scheduler = (j_make_scheduler if jax_side else t_make_scheduler)(
            "equinox", predictor=pred)
    else:
        scheduler = (j_make_scheduler if jax_side else t_make_scheduler)(
            sched)
    kw = dict(params=params, max_slots=3, max_len=max_len, backend="paged",
              chunked=True, kv_quant=kv_quant, kv_budget_tokens=512,
              prefill_chunk_tokens=16, keep_first_logits=True, observer=spy)
    if jax_side:
        eng = JEngine(j_cfg, scheduler, **kw)
    else:
        eng = TEngine(t_cfg, scheduler, device="cpu", **kw)
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


@pytest.mark.parametrize("kw", [
    # a windowed stack serves on slots; the paged backend refuses it with
    # the reference's assertion
    pytest.param({"backend": "paged",
                  "cfg": dict(attn_kind="attn_local", window=16),
                  "raises": (AssertionError, "paged backend supports")},
                 id="kw1"),
    # int8 slot caches (cfg.kv_quant) are ported: the stack serves on
    # slots with whole-prompt prefill, as the reference's does
    pytest.param({"cfg": dict(kv_quant=True), "raises": None}, id="kw2"),
])
def test_options_outside_the_slice_raise(kw):
    """Options and stacks not ported yet raise, naming the ROADMAP item,
    and the paged backend refuses what the reference's paged step cannot
    serve (the slots backend and whole-prompt prefill are ported and have
    their own tests in tests/test_torch_engine_slots.py); a case whose
    option is ported since (``raises`` None) serves its requests."""
    kw = dict(kw)
    cfg = dataclasses.replace(T_CFG, **kw.pop("cfg", {}))
    raises = kw.pop("raises", (NotImplementedError, "ROADMAP.md Queue A"))
    if raises is None:
        eng = TEngine(cfg, t_make_scheduler("fcfs"), max_slots=2, max_len=48,
                      device="cpu", **kw)
        assert eng.backend == "slots" and not eng.chunked
        assert eng.cache["stages"]["stage_0"]["k"].dtype == torch.int8
        done = eng.run(mk_reqs(TRequest, n=3))
        assert sorted(r.rid for r in done) == [0, 1, 2]
        assert all(r.generated == r.output_len for r in done)
        return
    with pytest.raises(raises[0], match=raises[1]):
        TEngine(cfg, t_make_scheduler("fcfs"), device="cpu", **kw)


def test_moe_stack_raises():
    """DeepSeek-MoE-16B's dense first layer makes two stages; the
    reference's paged step reads ``stage_0`` only (it fails such a stack
    in its scan), so the port refuses it on the paged backend at
    construction and serves it on slots."""
    t_cfg = T_SMOKE["deepseek-moe-16b"]()
    with pytest.raises(NotImplementedError,
                       match="stage_0 only.*DeepSeek-MoE-16B"):
        TEngine(t_cfg, t_make_scheduler("fcfs"), backend="paged",
                device="cpu")
    assert TEngine(t_cfg, t_make_scheduler("fcfs"), max_slots=2,
                   max_len=32, device="cpu").backend == "slots"


MOE_CFG = dataclasses.replace(
    SMOKE_FACTORIES["mixtral-8x7b"](), attn_kind="attn", window=0,
    moe_impl="dispatch")
T_MOE_CFG = dataclasses.replace(
    T_SMOKE["mixtral-8x7b"](), attn_kind="attn", window=0,
    moe_impl="dispatch")


@pytest.mark.parametrize("kv_quant", [False, True])
def test_moe_engine_matches_reference(kv_quant):
    """The paged step's MoE branch on a single-stage full-attention MoE
    stack (Mixtral's smoke config without its window): every layer runs
    ``moe_ffn`` over all of the launch's rows, padding rows included."""
    jp = init_params(jax.random.key(9), MOE_CFG)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    cfgs = (MOE_CFG, T_MOE_CFG)
    j_done, j_spy, _ = serve("jax", jp, "equinox", 64, kv_quant, cfgs)
    t_done, t_spy, t_eng = serve("torch", tp, "equinox", 64, kv_quant,
                                 cfgs)
    assert t_eng.backend == "paged" and t_eng.chunked
    assert len(t_done) == len(j_done) == 5
    assert t_spy.order == j_spy.order              # admissions
    assert t_spy.chunks == j_spy.chunks            # chunk plans
    assert t_spy.tokens == j_spy.tokens            # greedy tokens
    for rid, jr in j_done.items():
        tr = t_done[rid]
        assert tr.generated == jr.generated == jr.output_len
        assert tr.ttft() == pytest.approx(jr.ttft(), abs=1e-9)
        tol = 5e-3 if kv_quant else 1e-4
        np.testing.assert_allclose(tr._first_row, jr._first_row, atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("arch", ["deepseek-7b", "granite-3-2b",
                                  "starcoder2-7b"])
def test_dense_configs_match_reference(arch):
    """The paged chunked engine on the three dense GQA configs: MHA with a
    102 400-token vocabulary (DeepSeek-7B), tied embeddings and G = 4
    (Granite-3-2B), the GELU MLP and G = 3 (StarCoder2-7B; G = 9 at full
    width); split-K tables (max_len 256)."""
    cfgs = (SMOKE_FACTORIES[arch](), T_SMOKE[arch]())
    jp = init_params(jax.random.key(11), cfgs[0])
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    j_done, j_spy, _ = serve("jax", jp, "equinox", 256, False, cfgs)
    t_done, t_spy, _ = serve("torch", tp, "equinox", 256, False, cfgs)
    assert len(t_done) == len(j_done) == 5
    assert t_spy.order == j_spy.order              # admissions
    assert t_spy.chunks == j_spy.chunks            # chunk plans
    assert t_spy.tokens == j_spy.tokens            # greedy tokens
    for rid, jr in j_done.items():
        tr = t_done[rid]
        assert tr.ttft() == pytest.approx(jr.ttft(), abs=1e-9)
        np.testing.assert_allclose(tr._first_row, jr._first_row, atol=1e-4,
                                   rtol=1e-4)


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
