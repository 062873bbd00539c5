"""Training Whisper's encoder-decoder in the port (Whisper large-v3's
smoke config) against ``repro``'s, on the CPU in f32 with the
reference's weights:

- ``loss_fn`` over the same stubbed frames: its value and its gradient
  through the decoder, the cross-attention (flash at Sq != Skv, not
  causal) and the encoder (non-causal flash, no remat, as the
  reference's), with ``attn_impl`` flash (remat on) and naive;
- ``train``'s batches carry frames (the reference's ``train`` feeds
  none, so it cannot train this stack): step 0's loss equals the
  reference's ``loss_fn`` on the frames the port drew, and the
  encoder's weights move."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.training as T
from _torch_train_parity import (LOSS_REL, bridge, check_loss_and_grads,
                                 init_params, make_batch, port_config, smoke)
from repro.models import loss_fn as j_loss_fn
from repro.training.data import batches as j_batches


@pytest.mark.parametrize("impl", ["flash", "naive"])
def test_loss_fn_value_and_grad_match_reference(impl):
    jcfg = smoke("whisper-large-v3", attn_impl=impl, remat=impl == "flash")
    batch = make_batch(jcfg, 2, 24)
    assert batch["frames"].shape == (2, jcfg.n_frontend_tokens,
                                     jcfg.d_model)
    check_loss_and_grads(jcfg, batch)


def test_train_feeds_frames_and_trains_the_encoder():
    jcfg = smoke("whisper-large-v3", attn_impl="flash", remat=True)
    tc = T.TrainConfig(batch=2, seq_len=32, steps=2, log_every=1, warmup=1,
                       seed=5)
    jp = init_params(jcfg, 5)
    b0 = next(j_batches(jcfg.vocab_size, tc.batch, tc.seq_len, 1, tc.seed))
    frames = T.trainer.stub_embeddings(jcfg, tc, 0)
    assert frames.shape == (2, jcfg.n_frontend_tokens, jcfg.d_model)
    want = float(j_loss_fn(jp, {"frames": jnp.asarray(frames),
                                **{k: jnp.asarray(v) for k, v in b0.items()}},
                           jcfg))
    enc_before = np.asarray(jp["enc"]["stages"]["stage_0"]["attn"]["wq"])
    tparams, losses = T.train(port_config(jcfg), tc, params=bridge(jp),
                              device="cpu", log=lambda s: None)
    assert [s for s, _ in losses] == [0, 1]
    assert losses[0][1] == pytest.approx(want, rel=LOSS_REL)
    enc_after = tparams["enc"]["stages"]["stage_0"]["attn"]["wq"]
    assert not np.array_equal(enc_after.detach().numpy(), enc_before)
    # step 1 draws other frames from its own seed
    assert not np.array_equal(T.trainer.stub_embeddings(jcfg, tc, 1),
                              frames)
    assert torch.isfinite(torch.tensor(losses[1][1]))
