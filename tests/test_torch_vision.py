"""InternVL2's vision prefix in the port against ``repro`` on bridged smoke
weights (f32, CPU): ``prefill`` (the patches first, positions over
patches and tokens) and ``decode_step`` logits within 1e-4 and caches
within 1e-5, with ``attn_impl`` flash (the kernel's plain version) and
naive; and the slots engine's patch path (flash), whose patches are drawn with
numpy from the request id as the reference's are, serving to completion
with the reference engine's admissions, greedy tokens and first-token
logits, decode positions starting at prompt_len + the patches.  The
paged backend refuses the stack by name."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_FACTORIES
from repro.core import Request as JRequest
from repro.core import make_scheduler as j_make_scheduler
from repro.models import decode_step as j_decode
from repro.models import forward_hidden as j_forward_hidden
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro.predictor import Oracle as JOracle
from repro.serving.costmodel import CostModel as JCM
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.telemetry import Observer as JObserver
from repro_torch.configs import SMOKE_FACTORIES as T_SMOKE
from repro_torch.core import Request as TRequest
from repro_torch.core import make_scheduler as t_make_scheduler
from repro_torch.models import model as tm
from repro_torch.predictor import Oracle as TOracle
from repro_torch.serving.costmodel import CostModel as TCM
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.telemetry import Observer as TObserver
from repro_torch.weights import params_from_numpy

LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5
ARCH = "internvl2-76b"


@functools.lru_cache(maxsize=None)
def weights(impl):
    jcfg = dataclasses.replace(SMOKE_FACTORIES[ARCH](), attn_impl=impl)
    tcfg = dataclasses.replace(T_SMOKE[ARCH](), attn_impl=impl)
    jp = j_init_params(jax.random.key(3), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             "cpu")


@pytest.fixture(scope="module", params=["flash", "naive"])
def model(request):
    return weights(request.param)


def batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    patches = rng.standard_normal(
        (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(patches)},
            {"tokens": torch.from_numpy(toks),
             "patch_embeds": torch.from_numpy(patches)})


def test_forward_hidden_counts_the_prefix(model):
    jcfg, tcfg, jp, tp = model
    jb, tb = batch(jcfg, 2, 12)
    jh, _, _, jn = j_forward_hidden(jp, jb, jcfg, mode="prefill")
    th, aux, _, tn = tm.forward_hidden(tp, tb, tcfg, mode="prefill")
    assert tn == jn == tcfg.n_frontend_tokens
    assert th.shape == (2, 12 + tn, tcfg.d_model)
    assert float(aux) == 0.0
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_prefill_and_decode_match_reference(model):
    jcfg, tcfg, jp, tp = model
    S, B, P = 10, 2, tcfg.n_frontend_tokens
    jb, tb = batch(jcfg, B, S, seed=1)
    max_len = P + S + 4
    jl, jc = j_prefill(jp, jb, jcfg, max_len)
    tl, tc = tm.prefill(tp, tb, tcfg, max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    # positions count the patches: decode starts at P + S
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [P + S] * B
    for name, t in tc["stages"]["stage_0"].items():
        assert t.shape == (tcfg.n_layers, B, max_len, tcfg.n_kv_heads,
                           tcfg.resolved_head_dim())
        np.testing.assert_allclose(
            t.numpy(), np.asarray(jc["stages"]["stage_0"][name]),
            atol=CACHE_TOL, rtol=CACHE_TOL)
    nxt = np.array([3, 7], np.int32)
    jl2, jc2 = j_decode(jp, jnp.asarray(nxt), jc, jcfg)
    tl2, tc2 = tm.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    for name, t in tc2["stages"]["stage_0"].items():
        np.testing.assert_allclose(
            t.numpy(), np.asarray(jc2["stages"]["stage_0"][name]),
            atol=CACHE_TOL, rtol=CACHE_TOL)


def mk_reqs(cls, n=5, seed=11):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, client=f"client{i % 2}", arrival=0.01 * i,
                prompt_len=int(rng.integers(6, 30)),
                output_len=int(rng.integers(3, 8)), keywords=("chat",))
            for i in range(n)]


def spy_class(base):
    class Spy(base):
        """Admission order and every produced token."""

        def __init__(self):
            self.order, self.tokens = [], {}

        def on_admit(self, req, now):
            self.order.append(req.rid)

        def on_iteration(self, now, *, t_iter, util, fresh, running,
                         produced, first):
            for r in produced:
                self.tokens.setdefault(r.rid, []).append(int(r._next_token))
    return Spy


def serve(side, jcfg, tcfg, jp, tp):
    jax_side = side == "jax"
    cfg = jcfg if jax_side else tcfg
    obs = spy_class(JObserver if jax_side else TObserver)()
    pred = (JOracle(JCM(jcfg)) if jax_side else TOracle(TCM(tcfg)))
    sched = (j_make_scheduler if jax_side else t_make_scheduler)(
        "equinox", predictor=pred)
    kw = dict(params=jp if jax_side else tp, max_slots=3, max_len=64,
              kv_budget_tokens=512, keep_first_logits=True, observer=obs)
    eng = JEngine(cfg, sched, **kw) if jax_side else \
        TEngine(cfg, sched, device="cpu", **kw)
    installed = {}
    install = eng._install_prefill

    def spy(req, row):                   # the decode position it starts at
        install(req, row)
        installed[req.rid] = (req._pos, int(eng.cache["pos"][req._slot]))

    eng._install_prefill = spy
    done = eng.run(mk_reqs(JRequest if jax_side else TRequest))
    return {r.rid: r for r in done}, installed, eng, obs


def test_engine_serves_the_patch_path_as_the_reference():
    jcfg, tcfg, jp, tp = weights("flash")
    j_done, j_pos, j_eng, j_obs = serve("jax", jcfg, tcfg, jp, tp)
    t_done, t_pos, t_eng, t_obs = serve("torch", jcfg, tcfg, jp, tp)
    assert t_obs.order == j_obs.order               # admissions
    assert t_obs.tokens == j_obs.tokens             # greedy tokens
    assert t_eng.backend == "slots" and not t_eng.chunked and \
        not j_eng.chunked
    assert len(t_done) == len(j_done) == 5
    P = tcfg.n_frontend_tokens
    assert t_pos == j_pos == {rid: (r.prompt_len + P, r.prompt_len + P)
                              for rid, r in t_done.items()}
    for rid, jr in j_done.items():
        tr = t_done[rid]
        assert tr.generated == jr.generated == jr.output_len
        assert tr._vlm_prefix == jr._vlm_prefix == P
        np.testing.assert_allclose(tr._first_row, jr._first_row,
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        assert tr.ttft() == pytest.approx(jr.ttft(), abs=1e-9)


def test_paged_backend_refuses_the_vision_prefix():
    cfg = T_SMOKE[ARCH]()
    with pytest.raises(NotImplementedError, match="vision prefix"):
        TEngine(cfg, t_make_scheduler("fcfs"), backend="paged",
                device="cpu")
