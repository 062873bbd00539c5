"""MoPE in the PyTorch port against ``repro.predictor``: the copied
router draws the same regime boundaries; with the JAX-trained experts
carried over by the weight bridge the port predicts what ``repro``
predicts; and experts trained by the port reach a held-out L1 error
within 15% of the JAX-trained ones."""
import jax
import numpy as np
import pytest

from repro.configs import get_config
from repro.core import Request as JRequest
from repro.predictor import MoPE as JMoPE
from repro.predictor import train_router as j_train_router
from repro.predictor.mope import l1_error as j_l1
from repro.serving.costmodel import A100_80G as J_A100, CostModel as JCM
from repro.workloads import corpus
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import Request as TRequest
from repro_torch.predictor import MoPE as TMoPE
from repro_torch.predictor import train_router as t_train_router
from repro_torch.predictor.mope import l1_error as t_l1
from repro_torch.serving.costmodel import A100_80G as T_A100
from repro_torch.serving.costmodel import CostModel as TCM
from repro_torch.weights import params_from_numpy

TRAIN, HELD_OUT = corpus(8000, seed=0), corpus(600, seed=1)


@pytest.fixture(scope="module")
def jax_mope():
    return JMoPE(JCM(get_config("llama2-7b"), J_A100), TRAIN, epochs=20)


def torch_mope(epochs):
    return TMoPE(TCM(t_get_config("llama2-7b"), T_A100), TRAIN,
                 epochs=epochs)


def test_router_boundaries_equal():
    for n in (2, 3):
        j = j_train_router(TRAIN, n, 0)
        t = t_train_router(TRAIN, n, 0)
        np.testing.assert_array_equal(np.asarray(t.boundaries),
                                      np.asarray(j.boundaries))


def test_bridged_experts_predict_identically(jax_mope):
    j, t = jax_mope, torch_mope(epochs=1)
    t.experts = [params_from_numpy(jax.tree.map(np.asarray, e), "cpu")
                 for e in j.experts]
    for i, (kw, pl, o) in enumerate(HELD_OUT[:24]):
        rj = j.predict(JRequest(rid=i, client="c", arrival=0.0,
                                prompt_len=pl, output_len=o, keywords=kw))
        rt = t.predict(TRequest(rid=i, client="c", arrival=0.0,
                                prompt_len=pl, output_len=o, keywords=kw))
        assert rt._pred_regime == rj._pred_regime
        for f in ("pred_output_len", "pred_latency", "pred_tps",
                  "pred_util"):
            np.testing.assert_allclose(getattr(rt, f), getattr(rj, f),
                                       rtol=1e-5, err_msg=f)


def test_torch_trained_experts_reach_jax_error(jax_mope):
    err_j = j_l1(jax_mope, HELD_OUT)
    err_t = t_l1(torch_mope(epochs=20), HELD_OUT)
    assert err_t <= 1.15 * err_j, (err_t, err_j)
