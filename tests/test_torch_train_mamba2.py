"""Training Mamba-2 stacks in the port (Mamba-2-2.7B's smoke config: two
layers, d_model 128, 8 heads of 32, state 16, chunk 16) against
``repro``'s, on the CPU in f32 with the reference's weights:

- ``mamba2_prefill``'s gradient (in_proj, the depthwise conv, the gates,
  the SSD scan through its autograd Function and ``ssd_scan_bwd_plain``,
  the gated norm, out_proj) against ``jax.grad`` of the reference's, with
  a ragged last chunk and from an initial state: every gradient within
  1e-4 of its largest element;
- ``loss_fn`` and its gradient with remat on and off;
- ``train`` over 3 steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_parity import (GRAD_REL, bridge, check_loss_and_grads,
                                 check_train, make_batch, paths,
                                 port_config, rel_err, smoke)
from repro.models import ssm as jssm
from repro_torch.models import ssm as tssm
from repro_torch.training.optim import tree_leaves


@pytest.mark.parametrize("S,with_state", [(40, False), (48, True)])
def test_mamba2_prefill_grad_matches_reference(S, with_state):
    jcfg = smoke("mamba2-2.7b")
    jp = jssm.mamba2_init(jax.random.key(2), jcfg, jnp.float32)
    _, nh, _ = jssm.mamba2_dims(jcfg)
    s = jcfg.ssm
    rng = np.random.default_rng(S)
    x, dy = (rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
             for _ in range(2))
    shape = (2, nh, s.head_dim, s.d_state)
    ds = rng.standard_normal(shape).astype(np.float32)
    s0 = rng.standard_normal(shape).astype(np.float32) if with_state \
        else None

    def j_fn(p, x, s0):
        init = None if s0 is None else {"ssm_state": s0}
        y, cache = jssm.mamba2_prefill(p, x, jcfg, initial=init)
        return (y * dy).sum() + (cache["ssm_state"] * ds).sum()

    argnums = (0, 1, 2) if with_state else (0, 1)
    jg = jax.jit(jax.grad(j_fn, argnums=argnums))(
        jp, jnp.asarray(x), None if s0 is None else jnp.asarray(s0))
    tp = bridge(jp)
    leaves = [leaf.requires_grad_() for leaf in tree_leaves(tp)]
    tx = torch.from_numpy(x).requires_grad_()
    ts0 = None if s0 is None else torch.from_numpy(s0).requires_grad_()
    y, cache = tssm.mamba2_prefill(
        tp, tx, port_config(jcfg),
        initial=None if ts0 is None else {"ssm_state": ts0})
    loss = (y * torch.from_numpy(dy)).sum() \
        + (cache["ssm_state"] * torch.from_numpy(ds)).sum()
    wrt = [tx] + ([ts0] if with_state else []) + leaves
    got = torch.autograd.grad(loss, wrt)
    assert rel_err(got[0].numpy(), jg[1]) <= GRAD_REL
    if with_state:
        assert rel_err(got[1].numpy(), jg[2]) <= GRAD_REL
    for key, g in zip(paths(tp), got[len(wrt) - len(leaves):]):
        want = jg[0]
        for part in key.split("/"):
            want = want[part]
        assert rel_err(g.numpy(), want) <= GRAD_REL, key


@pytest.mark.parametrize("remat", [True, False])
def test_loss_fn_value_and_grad_match_reference(remat):
    jcfg = smoke("mamba2-2.7b", remat=remat)
    check_loss_and_grads(jcfg, make_batch(jcfg, 2, 40))


def test_train_three_steps_match_reference():
    check_train(smoke("mamba2-2.7b", remat=True), seq_len=40)
