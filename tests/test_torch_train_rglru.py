"""Training RG-LRU stacks in the port (RecurrentGemma-2B's smoke config:
two RG-LRU layers and one local-attention layer of window 32) against
``repro``'s, on the CPU in f32 with the reference's weights:

- ``rglru_prefill``'s gradient (the gates, ``sqrt(max(1 - a^2, 1e-9))``,
  the tiled Hillis-Steele scan and the boundary states carried from tile
  to tile) against ``jax.grad`` of the reference's (an associative scan
  within tiles, a ``lax.scan`` across them), over several tiles with a
  ragged last one and over one tile: every gradient within 1e-4 of its
  largest element (``1 / (2 sqrt(x))`` magnifies f32 differences where
  ``log a`` is near 0, so elementwise bounds would judge rounding);
- ``loss_fn`` and its gradient at 48 positions, past the window, with
  ``attn_impl`` flash (remat on) and naive;
- ``train`` over 3 steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_parity import (GRAD_REL, bridge, check_loss_and_grads,
                                 check_train, make_batch, paths,
                                 port_config, rel_err, smoke)
from repro.models import rglru as jr
from repro_torch.models import rglru as tr
from repro_torch.training.optim import tree_leaves


@pytest.mark.parametrize("S,chunk", [(40, 16), (48, 256)])
def test_rglru_prefill_grad_matches_reference(S, chunk):
    jcfg = smoke("recurrentgemma-2b")
    jp = jr.rglru_init(jax.random.key(2), jcfg, jnp.float32)
    rng = np.random.default_rng(S)
    x, dy = (rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
             for _ in range(2))
    dh = rng.standard_normal((2, jcfg.rglru.d_rnn)).astype(np.float32)

    def j_fn(p, x):
        y, cache = jr.rglru_prefill(p, x, jcfg, chunk=chunk)
        return (y * dy).sum() + (cache["h"] * dh).sum()

    jg, jgx = jax.jit(jax.grad(j_fn, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = bridge(jp)
    leaves = [leaf.requires_grad_() for leaf in tree_leaves(tp)]
    tx = torch.from_numpy(x).requires_grad_()
    y, cache = tr.rglru_prefill(tp, tx, port_config(jcfg), chunk=chunk)
    loss = (y * torch.from_numpy(dy)).sum() \
        + (cache["h"] * torch.from_numpy(dh)).sum()
    gx, *grads = torch.autograd.grad(loss, [tx] + leaves)
    assert rel_err(gx.numpy(), jgx) <= GRAD_REL
    for key, got in zip(paths(tp), grads):
        assert rel_err(got.numpy(), jg[key]) <= GRAD_REL, key


@pytest.mark.parametrize("impl", ["flash", "naive"])
def test_loss_fn_value_and_grad_match_reference(impl):
    jcfg = smoke("recurrentgemma-2b", attn_impl=impl, remat=impl == "flash")
    assert jcfg.window < 48
    check_loss_and_grads(jcfg, make_batch(jcfg, 2, 48))


def test_train_three_steps_match_reference():
    check_train(smoke("recurrentgemma-2b", attn_impl="flash", remat=True),
                seq_len=48)
