"""The two public entry points the port adds beside the reference's:

- ``models.long_context_variant``, the sliding-window rewrite of
  full-attention stacks, equal to ``repro.models.long_context_variant``
  field for field for every registered architecture (and the config
  itself where the stack supports long contexts natively);
- ``kernels.ops.paged_attention_splitk``, split-K whatever the table
  width: below ``SPLIT_K_THRESHOLD_PAGES`` it still calls the split-K
  kernel (on CPU tensors its plain version) and equals the reference's
  ``ops.paged_attention_splitk`` (Pallas in interpret mode) within 1e-5,
  over f32 pages and over int8 pages with bf16 scales."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jk
import repro_torch.kernels as tk
from _torch_train_parity import port_config
from repro.configs import get_config as j_get_config
from repro.configs import list_archs
from repro.models import long_context_variant as j_lcv
from repro.models.attention import quantize_kv as j_quantize_kv
from repro_torch.kernels import ops
from repro_torch.models import long_context_variant as t_lcv
from repro_torch.weights import params_from_numpy

ATOL = 1e-5


@pytest.mark.parametrize("arch", list_archs())
def test_long_context_variant_matches_reference(arch):
    jcfg = j_get_config(arch)
    tcfg = port_config(jcfg)
    want, got = j_lcv(jcfg), t_lcv(tcfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got is tcfg) == (want is jcfg)


def test_long_context_variant_rewrites_full_attention():
    got = t_lcv(port_config(j_get_config("llama2-7b")))
    assert got.attn_kind == "attn_local"
    assert got.window == got.long_context_window


@pytest.mark.parametrize("pages", ["f32", "int8"])
@pytest.mark.parametrize("pages_per_split", [2, ops.DEFAULT_PAGES_PER_SPLIT])
def test_paged_attention_splitk_below_threshold_matches_reference(
        pages, pages_per_split, monkeypatch):
    width = 5
    assert width < ops.SPLIT_K_THRESHOLD_PAGES
    rng = np.random.default_rng(11)
    B, Hq, Hkv, D, page, npool = 4, 8, 2, 16, 8, 24
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((npool, page, Hkv, D)).astype(np.float32)
              for _ in range(2))
    bt = rng.integers(0, npool, (B, width)).astype(np.int32)
    cl = np.asarray([1, page + 1, page * width, page * width - 3], np.int32)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, bt, cl)]
    jkw = {}
    if pages == "int8":
        kq, ks = j_quantize_kv(jargs[1])
        vq, vs = j_quantize_kv(jargs[2])
        jargs[1:3] = kq, vq
        jkw = dict(k_scale=ks, v_scale=vs)
    targs = [params_from_numpy(np.asarray(a), "cpu") for a in jargs]
    tkw = {k: params_from_numpy(np.asarray(v), "cpu") for k, v in jkw.items()}
    called = []
    kernel = ops.paged_attention_splitk_kernel
    monkeypatch.setattr(ops, "paged_attention_splitk_kernel",
                        lambda *a, **k: called.append(k["pages_per_split"])
                        or kernel(*a, **k))
    got = tk.paged_attention_splitk(*targs, pages_per_split=pages_per_split,
                                    **tkw)
    assert called == [pages_per_split]
    want = jk.paged_attention_splitk(*jargs, pages_per_split=pages_per_split,
                                     **jkw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
