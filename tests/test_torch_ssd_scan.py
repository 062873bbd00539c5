"""The port's SSD scan against the JAX package's.

The plain version (what the port's wrapper runs on CPU tensors, and what
the CUDA kernel is held to on the card) against ``ssd_scan_pallas`` in
interpret mode and against ``repro.models.ssm.ssd_chunked``, with and
without an initial state, on the grid of
``tests/test_kernels.py::test_ssd_kernel``, within 5e-4; and the port's
``mamba2_prefill`` with and without an initial state against the
reference's."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_FACTORIES as J_SMOKE
from repro.kernels.ops import ssd_scan as jax_ssd_pallas
from repro.models.ssm import mamba2_init as jax_mamba2_init
from repro.models.ssm import mamba2_prefill as jax_mamba2_prefill
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro.models.ssm import ssd_step as jax_ssd_step
from repro_torch.configs import SMOKE_FACTORIES as T_SMOKE
from repro_torch.kernels import ops
from repro_torch.models import ssm as tssm
from repro_torch.weights import params_from_numpy

ss = importlib.import_module("repro_torch.kernels.ssd_scan")

ATOL = 5e-4
GRID = [
    (96, 4, 32, 2, 16, 32),
    (100, 2, 16, 1, 8, 32),      # ragged
    (64, 8, 64, 2, 32, 16),
]


def inputs(S, H, P, G, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, H, P)).astype(np.float32)
    la = (-np.abs(rng.standard_normal((2, S, H))) * 0.1).astype(np.float32)
    Bm = rng.standard_normal((2, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((2, S, G, N)).astype(np.float32)
    s0 = rng.standard_normal((2, H, P, N)).astype(np.float32)
    return (x, la, Bm, Cm, s0)


def max_err(got, want):
    return float(np.abs(got.numpy() - np.asarray(want)).max())


@pytest.mark.parametrize("S,H,P,G,N,chunk", GRID)
def test_plain_matches_pallas_kernel(S, H, P, G, N, chunk):
    x, la, Bm, Cm, _ = inputs(S, H, P, G, N)
    jy, jst = jax_ssd_pallas(*map(jnp.asarray, (x, la, Bm, Cm)), chunk=chunk)
    y, st = ops.ssd_scan(*map(torch.from_numpy, (x, la, Bm, Cm)),
                         chunk=chunk)
    errs = max_err(y, jy), max_err(st, jst)
    print(f"ssd plain vs Pallas S={S}: max |dy| {errs[0]:.3g}, "
          f"max |dstate| {errs[1]:.3g}")
    assert max(errs) < ATOL


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S,H,P,G,N,chunk", GRID)
def test_model_ssd_chunked_matches_reference(S, H, P, G, N, chunk,
                                             with_state):
    x, la, Bm, Cm, s0 = inputs(S, H, P, G, N, seed=1)
    init = s0 if with_state else None
    jy, jst = jax_ssd_chunked(*map(jnp.asarray, (x, la, Bm, Cm)), chunk,
                              None if init is None else jnp.asarray(init))
    y, st = tssm.ssd_chunked(*map(torch.from_numpy, (x, la, Bm, Cm)), chunk,
                             None if init is None else torch.from_numpy(init))
    errs = max_err(y, jy), max_err(st, jst)
    print(f"ssd_chunked vs reference S={S} state={with_state}: max |dy| "
          f"{errs[0]:.3g}, max |dstate| {errs[1]:.3g}")
    assert max(errs) < ATOL


def test_chunks_then_steps_match_one_scan():
    """The final state of a scan, carried on by ``ssd_step``, equals the
    scan of the longer sequence: the kernel's state is the recurrence's."""
    x, la, Bm, Cm, _ = inputs(40, 2, 16, 1, 8, seed=2)
    t = [torch.from_numpy(a) for a in (x, la, Bm, Cm)]
    y_all, st_all = tssm.ssd_chunked(*t, 16)
    _, st = tssm.ssd_chunked(*(a[:, :39] for a in t), 16)
    y1, st1 = tssm.ssd_step(t[0][:, 39], t[1][:, 39], t[2][:, 39],
                            t[3][:, 39], st)
    torch.testing.assert_close(y1, y_all[:, 39], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(st1, st_all, rtol=1e-5, atol=1e-5)
    jy1, jst1 = jax_ssd_step(*(jnp.asarray(a[:, 39]) for a in
                               (x, la, Bm, Cm)), jnp.asarray(st.numpy()))
    assert max_err(y1, jy1) < 1e-5 and max_err(st1, jst1) < 1e-5


def test_wrapper_validates_and_counts_nothing_on_cpu():
    x, la, Bm, Cm, _ = inputs(32, 2, 16, 1, 8)
    t = [torch.from_numpy(a) for a in (x, la, Bm, Cm)]
    before = dict(ss.LAUNCHES)
    ss.ssd_scan_kernel(*t, chunk=16)
    assert ss.LAUNCHES == before              # the plain version ran
    with pytest.raises(ValueError, match="group evenly"):
        ss.ssd_scan_kernel(t[0][:, :, :1].repeat(1, 1, 3, 1),
                           t[1][:, :, :1].repeat(1, 1, 3),
                           t[2].repeat(1, 1, 2, 1), t[3].repeat(1, 1, 2, 1))
    with pytest.raises(ValueError, match="initial_state"):
        ss.ssd_scan_kernel(*t, initial_state=torch.zeros(1))
    with pytest.raises(ValueError, match="no kernel"):
        ss.ssd_scan_kernel(*(a.to("meta") for a in t))


@pytest.mark.parametrize("with_initial", [False, True])
def test_mamba2_prefill_initial_state_matches_reference(with_initial):
    """``mamba2_prefill(..., initial=cache)`` starts the scan from the
    cache's ``ssm_state``, as the reference does: outputs within 1e-4 and
    the cache (conv tail, final state) within 1e-5 on bridged weights of
    the smoke config (chunk 16; 37 tokens, three chunks, the last
    ragged)."""
    jcfg, tcfg = J_SMOKE["mamba2-2.7b"](), T_SMOKE["mamba2-2.7b"]()
    jp = jax_mamba2_init(jax.random.key(3), jcfg, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 37, jcfg.d_model)).astype(np.float32)
    jinit = tinit = None
    if with_initial:
        H = jp["A_log"].shape[0]
        s0 = rng.standard_normal((2, H, jcfg.ssm.head_dim,
                                  jcfg.ssm.d_state)).astype(np.float32)
        jinit = {"ssm_state": jnp.asarray(s0)}
        tinit = {"ssm_state": torch.from_numpy(s0)}
    jy, jcache = jax_mamba2_prefill(jp, jnp.asarray(x), jcfg, jinit)
    ty, tcache = tssm.mamba2_prefill(tp, torch.from_numpy(x), tcfg, tinit)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
    assert tcache.keys() == jcache.keys()
    for name, want in jcache.items():
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    if with_initial:                  # the state was not ignored
        y0, _ = tssm.mamba2_prefill(tp, torch.from_numpy(x), tcfg)
        assert (y0 - ty).abs().max().item() > 1e-3
