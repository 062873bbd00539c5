"""Training multi-head latent attention in the port (MiniCPM3-4B's smoke
config) against ``repro``'s, on the CPU in f32 with the reference's
weights: ``loss_fn`` and its gradient through the expanded prefill (q
and k of D = dn + dr, v of Dv through the flash kernel's autograd
Function, whose backward takes D != Dv), the low-rank projections and
their norms, with ``attn_impl`` flash (remat on) and naive, and with the
window ``long_context_variant`` gives MLA stacks; ``train`` over 3
steps."""
import pytest

from _torch_train_parity import (check_loss_and_grads, check_train,
                                 make_batch, smoke)

CASES = [("flash", 0), ("naive", 0), ("flash", 16)]


@pytest.mark.parametrize("impl,window", CASES,
                         ids=[f"{i}-window{w}" for i, w in CASES])
def test_loss_fn_value_and_grad_match_reference(impl, window):
    jcfg = smoke("minicpm3-4b", attn_impl=impl, remat=impl == "flash",
                 window=window)
    check_loss_and_grads(jcfg, make_batch(jcfg, 2, 40))


def test_train_three_steps_match_reference():
    check_train(smoke("minicpm3-4b", attn_impl="flash", remat=True))
