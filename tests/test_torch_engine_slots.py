"""The port's slots backend and whole-prompt prefill against
``repro.serving.engine`` on bridged smoke weights (f32, CPU): greedy
tokens, admission order, prefill plans and modeled TTFT for Llama-2 on
``backend="slots"`` (whole-prompt and chunked) and on ``backend="paged",
chunked=False``, for DeepSeek-MoE (whole-prompt and chunked) and Mixtral
(whole-prompt, sliding-window ring caches) on ``backend="slots"`` under
``moe_impl`` ``dense`` and ``dispatch``, for the dense GQA stacks
DeepSeek-7B, Granite-3-2B and StarCoder2-7B, for MiniCPM3-4B (MLA: the
latent caches installed into the slots, absorbed decode), for Llama-2
with int8 slot caches (``cfg.kv_quant``: whole-prompt prefill, caches
and scales installed into the slots), for RecurrentGemma-2B (RG-LRU
states and local-attention rings installed into the slots, whole-prompt
prefill by default) and for Mamba-2 on ``backend="slots"``; the engine's defaults resolve as the reference's
do, and the paged backend refuses MLA with the reference's assertion."""
import dataclasses
import importlib

import jax
import numpy as np
import pytest

from repro.configs import SMOKE_FACTORIES
from repro.configs import get_config as j_get_config
from repro.core import Request as JRequest
from repro.core import make_scheduler as j_make_scheduler
from repro.models import init_params
from repro.predictor import Oracle as JOracle
from repro.serving.costmodel import A100_80G as J_A100
from repro.serving.costmodel import CostModel as JCM
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.telemetry import Observer as JObserver
from repro_torch.configs import SMOKE_FACTORIES as T_SMOKE
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import Request as TRequest
from repro_torch.core import make_scheduler as t_make_scheduler
from repro_torch.predictor import Oracle as TOracle
from repro_torch.serving.costmodel import A100_80G as T_A100
from repro_torch.serving.costmodel import CostModel as TCM
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.telemetry import Observer as TObserver
from repro_torch.weights import params_from_numpy

fa = importlib.import_module("repro_torch.kernels.flash_attention")
ss = importlib.import_module("repro_torch.kernels.ssd_scan")


def spy_class(base):
    class Spy(base):
        """Admission order, prefill plans and every produced token."""

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


def configs(arch):
    """``arch``, ``arch/moe_impl`` or ``arch+kv_quant`` (int8 slot
    caches)."""
    arch, _, option = arch.partition("+")
    name, _, impl = arch.partition("/")
    jcfg = SMOKE_FACTORIES[name]()
    tcfg = T_SMOKE[name]()
    if option == "kv_quant":
        jcfg = dataclasses.replace(jcfg, kv_quant=True)
        tcfg = dataclasses.replace(tcfg, kv_quant=True)
    if name != "mamba2-2.7b":      # the flash kernel's plain version runs
        jcfg = dataclasses.replace(jcfg, attn_impl="flash")
        tcfg = dataclasses.replace(tcfg, attn_impl="flash")
    if impl:
        jcfg = dataclasses.replace(jcfg, moe_impl=impl)
        tcfg = dataclasses.replace(tcfg, moe_impl=impl)
    return jcfg, tcfg


_WEIGHTS = {}


def weights(arch):
    if arch not in _WEIGHTS:
        jcfg, _ = configs(arch)
        jp = init_params(jax.random.key(7), jcfg)
        _WEIGHTS[arch] = (jp, params_from_numpy(
            jax.tree.map(np.asarray, jp), "cpu"))
    return _WEIGHTS[arch]


def mk_reqs(cls, n=5, seed=11):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, client=f"client{i % 2}", arrival=0.01 * i,
                prompt_len=int(rng.integers(6, 30)),
                output_len=int(rng.integers(3, 8)), keywords=("chat",))
            for i in range(n)]


def serve(side, arch, **kw):
    jax_side = side == "jax"
    jcfg, tcfg = configs(arch)
    jp, tp = weights(arch)
    spy = (JSpy if jax_side else TSpy)()
    pred = JOracle(JCM(jcfg)) if jax_side else TOracle(TCM(tcfg))
    scheduler = (j_make_scheduler if jax_side else t_make_scheduler)(
        "equinox", predictor=pred)
    kw = dict(dict(params=jp if jax_side else tp, max_slots=3, max_len=64,
                   kv_budget_tokens=512, prefill_chunk_tokens=16,
                   keep_first_logits=True, observer=spy), **kw)
    if jax_side:
        eng = JEngine(jcfg, scheduler, **kw)
    else:
        eng = TEngine(tcfg, scheduler, device="cpu", **kw)
    done = eng.run(mk_reqs(JRequest if jax_side else TRequest))
    return {r.rid: r for r in done}, spy, eng


@pytest.mark.parametrize("arch,kw,kernel", [
    ("llama2-7b", dict(backend="slots", chunked=False), "flash"),
    ("llama2-7b", dict(backend="slots", chunked=True), None),
    ("llama2-7b", dict(backend="paged", chunked=False), "flash"),
    ("mamba2-2.7b", dict(backend="slots"), "ssd"),
    ("deepseek-moe-16b/dense", dict(backend="slots"), None),
    ("deepseek-moe-16b/dispatch", dict(backend="slots"), None),
    ("deepseek-moe-16b/dispatch", dict(backend="slots", chunked=False),
     "flash"),
    ("mixtral-8x7b/dense", dict(backend="slots"), "flash"),
    ("mixtral-8x7b/dispatch", dict(backend="slots"), "flash"),
    ("deepseek-7b", dict(backend="slots", chunked=False), "flash"),
    ("granite-3-2b", dict(backend="slots"), None),
    ("starcoder2-7b", dict(backend="slots", chunked=False), "flash"),
    ("minicpm3-4b", dict(backend="slots"), "flash"),
    ("llama2-7b+kv_quant", dict(backend="slots"), "flash"),
    ("recurrentgemma-2b", dict(backend="slots"), "flash"),
])
def test_engine_matches_reference(arch, kw, kernel, monkeypatch):
    calls = []
    for mod, name in ((fa, "flash_attention_plain"), (ss, "ssd_scan_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k:
                            calls.append(_n) or _fn(*a, **k))
    j_done, j_spy, j_eng = serve("jax", arch, **kw)
    t_done, t_spy, t_eng = serve("torch", arch, **kw)
    assert t_eng.chunked == j_eng.chunked
    assert t_eng.backend == j_eng.backend == kw["backend"]
    assert len(t_done) == len(j_done) == 5
    assert t_spy.order == j_spy.order              # admissions
    assert t_spy.chunks == j_spy.chunks            # prefill plans
    if not t_eng.chunked:                          # whole prompts
        assert all(n == t_done[rid].prompt_len for rid, n in t_spy.chunks)
    assert t_spy.tokens == j_spy.tokens            # greedy tokens
    for rid, jr in j_done.items():
        tr = t_done[rid]
        assert tr.generated == jr.generated == jr.output_len
        assert tr.ttft() == pytest.approx(jr.ttft(), abs=1e-9)
        assert tr.e2e_latency() == pytest.approx(jr.e2e_latency(), abs=1e-9)
        np.testing.assert_allclose(tr._first_row, jr._first_row, atol=1e-4,
                                   rtol=1e-4)
    # whole-prompt prefill goes through the kernel's plain version on the
    # CPU, one call per layer of the kernel's kind and prompt
    kinds = configs(arch)[1].layer_kinds()
    n_layers = sum(k == "mamba2" if kernel == "ssd" else k.startswith("attn")
                   for k in kinds)
    want = {"flash": ["flash_attention_plain"],
            "ssd": ["ssd_scan_plain"], None: []}[kernel]
    assert sorted(set(calls)) == want
    if kernel is not None:
        assert len(calls) == n_layers * len(t_spy.chunks)
    assert t_eng.iterations == len(t_eng.iter_log)


def test_defaults_resolve_as_the_reference():
    """Mamba-2 cannot chunk: whole-prompt prefill by default, and
    ``chunked=True`` fails with the reference's assertion; Llama-2
    chunks by default; both default to the slots backend
    (tests/test_engine.py's fallback test, on the port)."""
    for arch in ("mamba2-2.7b", "llama2-7b"):
        jcfg, tcfg = configs(arch)
        j = JEngine(jcfg, j_make_scheduler("fcfs"), max_slots=2, max_len=32)
        t = TEngine(tcfg, t_make_scheduler("fcfs"), max_slots=2, max_len=32,
                    device="cpu")
        assert t.backend == j.backend == "slots"
        assert t.chunked == j.chunked == (arch == "llama2-7b")
        assert t.core.cfg.stall_free == j.core.cfg.stall_free
        assert t.core.cfg.kv_page_size == j.core.cfg.kv_page_size
    _, mcfg = configs("mamba2-2.7b")
    with pytest.raises(AssertionError, match="no incremental-prefill"):
        TEngine(mcfg, t_make_scheduler("fcfs"), chunked=True, device="cpu")
    _, lcfg = configs("llama2-7b")
    with pytest.raises(AssertionError, match="kv_quant requires"):
        TEngine(lcfg, t_make_scheduler("fcfs"), kv_quant=True, device="cpu")
    with pytest.raises(AssertionError, match="kv_quant requires"):
        TEngine(lcfg, t_make_scheduler("fcfs"), backend="paged",
                chunked=False, kv_quant=True, device="cpu")
    with pytest.raises(AssertionError, match="prefix_cache requires"):
        TEngine(lcfg, t_make_scheduler("fcfs"), prefix_cache=True,
                device="cpu")
    with pytest.raises(AssertionError, match="paged backend supports"):
        TEngine(mcfg, t_make_scheduler("fcfs"), backend="paged",
                device="cpu")


def test_paged_backend_refuses_mla():
    """MiniCPM3-4B serves on slots (whole-prompt prefill: MLA cannot
    chunk); on paged both engines refuse it with the reference's
    assertion (``src/repro/serving/engine.py:144``)."""
    jcfg, tcfg = configs("minicpm3-4b")
    j = JEngine(jcfg, j_make_scheduler("fcfs"), max_slots=2, max_len=32)
    t = TEngine(tcfg, t_make_scheduler("fcfs"), max_slots=2, max_len=32,
                device="cpu")
    assert t.backend == j.backend == "slots"
    assert t.chunked is j.chunked is False
    assert t.cache["stages"]["stage_0"].keys() == {"c", "k_rope"}
    for make, cfg, kw in ((JEngine, jcfg, {}),
                          (TEngine, tcfg, {"device": "cpu"})):
        with pytest.raises(AssertionError, match="paged backend supports"):
            make(cfg, (j_make_scheduler if make is JEngine
                       else t_make_scheduler)("fcfs"), backend="paged",
                 chunked=False, **kw)


def test_preempted_slots_request_recomputes():
    """Output under-predicted 5x on a tight KV budget (the trace of
    tests/test_preemption.py::test_slots_backend_survives_pool_pressure):
    the slots backend preempts, victims drop their partial prefill cache
    and recompute, and the port matches the reference's preemptions and
    tokens."""
    def trace(cls):
        rng = np.random.default_rng(4)
        reqs = []
        for i in range(6):
            o = int(rng.integers(25, 45))
            r = cls(rid=i, client=f"client{i % 2}", arrival=0.05 * i,
                    prompt_len=16, output_len=o, keywords=("chat",))
            r.pred_output_len = max(1.0, o / 5)
            reqs.append(r)
        return reqs

    jcfg, tcfg = configs("llama2-7b")
    jp, tp = weights("llama2-7b")
    kw = dict(max_slots=4, max_len=64, kv_budget_tokens=160, chunked=True,
              prefill_chunk_tokens=16)
    jspy, tspy = JSpy(), TSpy()
    j_eng = JEngine(jcfg, j_make_scheduler("fcfs"), params=jp,
                    observer=jspy, cost_model=JCM(
                        j_get_config("llama2-7b"), J_A100), **kw)
    t_eng = TEngine(tcfg, t_make_scheduler("fcfs"), params=tp,
                    observer=tspy, device="cpu", cost_model=TCM(
                        t_get_config("llama2-7b"), T_A100), **kw)
    j_done = j_eng.run(trace(JRequest))
    t_done = t_eng.run(trace(TRequest))
    assert len(t_done) == len(j_done) == 6
    assert t_eng.n_preemptions == j_eng.n_preemptions > 0
    assert tspy.order == jspy.order and tspy.chunks == jspy.chunks
    assert tspy.tokens == jspy.tokens
    assert all(r.generated == r.output_len for r in t_done)
