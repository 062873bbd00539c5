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


MOE_ARCHS = ["deepseek-moe-16b", "mixtral-8x7b"]


@pytest.mark.parametrize("arch", ["llama2-7b", "mamba2-2.7b", "minicpm3-4b",
                                  "recurrentgemma-2b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_is_exact(dtype, arch):
    check_bridge(dtype, arch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_bridge_is_exact(dtype, arch):
    """Expert stacks (E, d, f), the router, shared experts, and a dense
    first stage beside the MoE stage."""
    check_bridge(dtype, arch)


def check_bridge(dtype, arch):
    cfg = dataclasses.replace(SMOKE_FACTORIES[arch](), dtype=dtype)
    np_tree = jax.tree.map(np.asarray, jax_init_params(jax.random.key(3),
                                                       cfg))
    t_tree = params_from_numpy(np_tree, "cpu")
    want, got = flat(np_tree), flat(t_tree)
    assert want.keys() == got.keys()
    tdt = getattr(torch, dtype)
    udt = np.uint16 if dtype == "bfloat16" else np.uint32
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        if want[k].dtype == np.float32:   # Mamba-2's A_log, dt_bias, D; lam
            assert got[k].dtype == torch.float32, k
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
            continue
        assert got[k].dtype == tdt, k
        bits = got[k].view(torch.int16 if dtype == "bfloat16"
                           else torch.int32).numpy().view(udt)
        np.testing.assert_array_equal(bits, want[k].view(udt), err_msg=k)


def test_bridge_carries_expert_params():
    np_tree = jax.tree.map(np.asarray, jax_expert_init(jax.random.key(0)))
    t_tree = params_from_numpy(np_tree, "cpu")
    for k, v in np_tree.items():
        np.testing.assert_array_equal(t_tree[k].numpy(), v)


@pytest.mark.parametrize("arch", ["llama2-7b", "mamba2-2.7b", "minicpm3-4b",
                                  "recurrentgemma-2b"])
def test_init_params_matches_reference_layout(arch):
    check_init_layout(arch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_init_params_matches_reference_layout(arch):
    """MoE layers draw ``moe_init``'s leaves with its fan-ins; DeepSeek's
    dense first layer is a stage of its own."""
    check_init_layout(arch)
    stages = init_params(TORCH_SMOKE[arch](), torch.Generator().manual_seed(
        0), "cpu")["stages"]
    assert ("router" in stages["stage_0"]["ffn"]) == (arch == "mixtral-8x7b")


def check_init_layout(arch):
    cfg = SMOKE_FACTORIES[arch]()
    want = flat(jax.tree.map(np.asarray,
                             jax_init_params(jax.random.key(0), cfg)))
    got = flat(init_params(TORCH_SMOKE[arch](),
                           torch.Generator().manual_seed(0), "cpu"))
    assert want.keys() == got.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == torch.float32, k
        if k.endswith(("A_log", "D", "conv_b")):   # deterministic leaves
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6,
                                       err_msg=k)
            continue
        if k.endswith("dt_bias"):   # a few draws: the range, not the std
            # inverse softplus of [1e-3, 1e-1] is [-6.9073, -2.2522]
            assert -6.91 < got[k].min() and got[k].max() < -2.25, k
            continue
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


def test_mamba2_bf16_keeps_f32_leaves_and_draws_dt_bias():
    """In a bf16 Mamba-2 the SSM parameters A_log, dt_bias and D stay f32,
    as in the reference, and softplus(dt_bias) lies in [1e-3, 1e-1]."""
    cfg = dataclasses.replace(TORCH_SMOKE["mamba2-2.7b"](), dtype="bfloat16")
    attn = init_params(cfg, torch.Generator().manual_seed(1),
                       "cpu")["stages"]["stage_0"]["attn"]
    for name in ("A_log", "dt_bias", "D"):
        assert attn[name].dtype == torch.float32, name
    for name in ("in_proj", "conv_w", "conv_b", "out_proj"):
        assert attn[name].dtype == torch.bfloat16, name
    dt = torch.nn.functional.softplus(attn["dt_bias"])
    assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 0.1 * (1 + 1e-5)
