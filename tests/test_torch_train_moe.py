"""Training MoE stacks in the port (DeepSeek-MoE-16B's and Mixtral-8x7B's
smoke configs) against ``repro``'s, on the CPU in f32 with the
reference's weights:

- ``loss_fn`` (the NLL plus ``router_aux_coef`` times the load-balance
  loss) and its gradient through the router's softmax, the top-k weights
  and the experts, under ``moe_impl`` dense (the ``scatter_add_`` gate)
  and dispatch (the sort, the gathers and the ordered combine) at a
  capacity factor that drops assignments, with ``attn_impl`` flash
  (remat on: the dispatch is recomputed in the backward) and naive;
- the aux loss ``forward_hidden`` returns in training, summed over the
  MoE layers, and zero in the serving modes;
- ``train`` over 3 steps."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_parity import (bridge, check_loss_and_grads, check_train,
                                 init_params, make_batch, port_config, smoke)
from repro.models import forward_hidden as j_forward_hidden
from repro_torch.models import model as tm

# dispatch capacity min(max(int(n k / E cf), 1), n): at cf 0.5 half the
# assignments have a slot, so some are dropped whatever the routing
DROP_CF = 0.5

CASES = [(arch, moe, impl) for arch in ("deepseek-moe-16b", "mixtral-8x7b")
         for moe in ("dense", "dispatch") for impl in ("flash", "naive")]


def moe_config(arch, moe, impl, **kw):
    return smoke(arch, moe_impl=moe, attn_impl=impl, remat=impl == "flash",
                 capacity_factor=DROP_CF, **kw)


@pytest.mark.parametrize("arch,moe,impl", CASES,
                         ids=["-".join(c) for c in CASES])
def test_loss_fn_value_and_grad_match_reference(arch, moe, impl):
    jcfg = moe_config(arch, moe, impl)
    # Mixtral's smoke window is 32: 40 positions cross it
    check_loss_and_grads(jcfg, make_batch(jcfg, 2, 40))


def test_dispatch_drops_assignments_at_the_test_capacity():
    """The gate's dispatch cases run with dropped assignments: fewer
    slots than the (token, expert) pairs routed."""
    for arch in ("deepseek-moe-16b", "mixtral-8x7b"):
        m = moe_config(arch, "dispatch", "naive").moe
        n = 2 * 40
        assert min(max(int(n * m.top_k / m.n_experts * DROP_CF), 1), n) \
            * m.n_experts < n * m.top_k


@pytest.mark.parametrize("arch,moe", [("deepseek-moe-16b", "dispatch"),
                                      ("mixtral-8x7b", "dense")])
def test_forward_hidden_aux_matches_reference(arch, moe):
    # three layers: two MoE layers in DeepSeek's (its first is dense),
    # three in Mixtral's, so the sum has terms to add
    jcfg = moe_config(arch, moe, "naive", n_layers=3)
    jp = init_params(jcfg, 6)
    batch = make_batch(jcfg, 2, 24, seed=7)
    _, j_aux, _, _ = jax.jit(functools.partial(
        j_forward_hidden, mode="train"), static_argnums=2)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    tcfg = port_config(jcfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, t_aux, _, _ = tm.forward_hidden(bridge(jp), tb, tcfg, mode="train")
    assert t_aux.dtype == torch.float32 and t_aux.shape == ()
    np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=1e-6)
    assert float(t_aux) > 0
    # serving reads no aux and computes none
    with torch.no_grad():
        _, s_aux, _, _ = tm.forward_hidden(bridge(jp), tb, tcfg,
                                           mode="prefill")
    assert float(s_aux) == 0.0


def test_train_three_steps_match_reference():
    """DeepSeek-MoE-16B's smoke config on the dispatch with drops, flash
    and remat: the reference's step and the port's draw the same batches
    and route them alike."""
    check_train(moe_config("deepseek-moe-16b", "dispatch", "flash"))
