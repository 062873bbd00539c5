"""Shared checks of the port's training against ``repro``'s (CPU, f32,
weights bridged from the reference's): ``loss_fn`` value and gradients
against ``jax.value_and_grad``, and ``train`` step for step.  Used by the
``tests/test_torch_train_*.py`` files, one per stack family."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.training as J
import repro_torch.configs.base as tbase
import repro_torch.training as T
from repro.configs import SMOKE_FACTORIES
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro_torch.models import model as tm
from repro_torch.training.optim import tree_leaves
from repro_torch.weights import params_from_numpy

LOSS_REL, GRAD_REL = 1e-5, 1e-4


def port_config(cfg):
    """The same ModelConfig, built from the port's copy of the classes."""
    def conv(v):
        if dataclasses.is_dataclass(v):
            cls = getattr(tbase, type(v).__name__)
            return cls(**{f.name: conv(getattr(v, f.name))
                          for f in dataclasses.fields(v)})
        return v
    return conv(cfg)


def smoke(arch, **kw):
    """The reference's smoke config of ``arch`` with ``kw`` replaced;
    ``capacity_factor`` goes into its MoE config."""
    cfg = SMOKE_FACTORIES[arch]()
    cf = kw.pop("capacity_factor", None)
    if cf is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, capacity_factor=cf)
    return dataclasses.replace(cfg, **kw)


def bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def paths(tree, prefix=""):
    """The leaves' paths in ``tree_leaves`` order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += paths(v, f"{prefix}{k}/")
        else:
            out.append(f"{prefix}{k}")
    return out


def make_batch(jcfg, B, S, seed=3):
    """Tokens and labels of ``S`` positions, plus the frontend stub's
    embeddings (``frames`` or ``patch_embeds``), numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    stub = T.trainer.STUB_INPUTS.get(jcfg.frontend)
    if stub:
        batch[stub] = rng.standard_normal(
            (B, jcfg.n_frontend_tokens, jcfg.d_model)).astype(np.float32)
    return batch


def init_params(jcfg, seed):
    """The reference's ``init_params`` under ``jit`` (one compile in
    place of many small ones)."""
    return jax.jit(j_init_params, static_argnums=1)(jax.random.key(seed),
                                                    jcfg)


def check_loss_and_grads(jcfg, batch, seed=4):
    """``loss_fn`` of the port on the reference's weights: the value
    within LOSS_REL relative, every gradient leaf within GRAD_REL of its
    largest element, against ``jax.value_and_grad``."""
    jp = init_params(jcfg, seed)
    jl, jg = jax.jit(jax.value_and_grad(j_loss_fn), static_argnums=2)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    tp = bridge(jp)
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tl = tm.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                    port_config(jcfg))
    grads = torch.autograd.grad(tl, leaves)
    assert float(tl.detach()) == pytest.approx(float(jl), rel=LOSS_REL)
    want = jax.tree_util.tree_flatten_with_path(jg)[0]
    got = dict(zip(paths(tp), grads))
    assert len(got) == len(want)
    for path, w in want:
        key = "/".join(p.key for p in path)
        assert rel_err(got[key].numpy(), w) <= GRAD_REL, key


def check_train(jcfg, **tc_kw):
    """``train`` over 3 steps from the reference's initial weights: the
    losses within LOSS_REL relative step for step, the final parameters
    within 1e-5 absolute (Adam moves an element whose gradient sits at
    rounding level by a few 1e-6 either way)."""
    tc = {**dict(batch=2, seq_len=32, steps=3, log_every=1, warmup=1,
                 seed=5), **tc_kw}
    jparams, jl = J.train(jcfg, J.TrainConfig(**tc), log=lambda s: None)
    tp = bridge(j_init_params(jax.random.key(tc["seed"]), jcfg))
    tparams, tl = T.train(port_config(jcfg), T.TrainConfig(**tc), params=tp,
                          device="cpu", log=lambda s: None)
    assert [s for s, _ in tl] == [s for s, _ in jl] == [0, 1, 2]
    for (_, a), (_, b) in zip(jl, tl):
        assert b == pytest.approx(a, rel=LOSS_REL)
    for path, want in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        node = tparams
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node.detach().numpy(), want, rtol=0,
                                   atol=1e-5)
