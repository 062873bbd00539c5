"""The weight bridge and the port's own initialiser: JAX parameter trees
cross into torch bit for bit (f32 and bf16), and ``init_params`` draws
the reference's layout."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_FACTORIES
from repro.models import init_params as jax_init_params
from repro.predictor.experts import expert_init as jax_expert_init
from repro_torch.configs import SMOKE_FACTORIES as TORCH_SMOKE
from repro_torch.weights import (init_params, params_from_numpy,
                                 resolve_device)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_is_exact(dtype):
    cfg = dataclasses.replace(SMOKE_FACTORIES["llama2-7b"](), dtype=dtype)
    np_tree = jax.tree.map(np.asarray, jax_init_params(jax.random.key(3),
                                                       cfg))
    t_tree = params_from_numpy(np_tree, "cpu")
    want, got = flat(np_tree), flat(t_tree)
    assert want.keys() == got.keys()
    tdt = getattr(torch, dtype)
    udt = np.uint16 if dtype == "bfloat16" else np.uint32
    for k in want:
        assert got[k].dtype == tdt, k
        assert tuple(got[k].shape) == want[k].shape, k
        bits = got[k].view(torch.int16 if dtype == "bfloat16"
                           else torch.int32).numpy().view(udt)
        np.testing.assert_array_equal(bits, want[k].view(udt), err_msg=k)


def test_bridge_carries_expert_params():
    np_tree = jax.tree.map(np.asarray, jax_expert_init(jax.random.key(0)))
    t_tree = params_from_numpy(np_tree, "cpu")
    for k, v in np_tree.items():
        np.testing.assert_array_equal(t_tree[k].numpy(), v)


def test_init_params_matches_reference_layout():
    cfg = SMOKE_FACTORIES["llama2-7b"]()
    want = flat(jax.tree.map(np.asarray,
                             jax_init_params(jax.random.key(0), cfg)))
    got = flat(init_params(TORCH_SMOKE["llama2-7b"](),
                           torch.Generator().manual_seed(0), "cpu"))
    assert want.keys() == got.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == torch.float32, k
        # same scale per leaf: norms are ones, weights have matching std
        np.testing.assert_allclose(got[k].float().std().item(),
                                   want[k].std(), rtol=0.2, atol=1e-6,
                                   err_msg=k)


def test_entry_points_default_to_cuda(monkeypatch):
    """No device given and no GPU: raise, never a quiet move to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(TORCH_SMOKE["llama2-7b"]())
    assert resolve_device("cpu") == torch.device("cpu")
