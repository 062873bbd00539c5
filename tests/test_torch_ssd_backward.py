"""The gradient of the port's SSD scan against the JAX package's, on the
CPU in f32.

``ssd_scan_bwd_plain`` (what the SSD scan's autograd Function runs on CPU
tensors, and what the backward kernel is held to on the card) against
``torch.autograd`` through ``ssd_scan_plain`` and against ``jax.grad`` of
the reference's ``ssd_chunked`` (``src/repro/models/ssm.py``, a
``lax.scan`` over chunks), for dx, d(log decay), dB, dC and d(initial
state), at a loss ``sum(y dy) + sum(final_state dstate)``: a ragged tail,
a chunk longer than the sequence, 2 groups over 4 heads, an initial
state and a nonzero dstate.  Every gradient within 1e-4 of its largest
element (``_torch_train_parity.GRAD_REL``).  Also the autograd Function
itself (``ssd_scan_train``) and the forward's chunk states."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_parity import GRAD_REL, rel_err
from repro.models.ssm import ssd_chunked as jax_ssd_chunked

ss = importlib.import_module("repro_torch.kernels.ssd_scan")
NAMES = ("dx", "dla", "dB", "dC", "dinit")

# (B, S, H, P, G, N, chunk, initial state, dstate)
CASES = {
    "ragged_tail": (2, 37, 4, 8, 1, 8, 16, False, False),
    "chunk_past_S": (1, 20, 2, 8, 1, 8, 32, False, True),
    "groups_2_over_4": (2, 48, 4, 8, 2, 8, 16, False, False),
    "initial_state": (2, 40, 4, 8, 2, 8, 16, True, False),
    "all_at_once": (2, 45, 4, 16, 2, 8, 16, True, True),
}


def draw(B, S, H, P, G, N, with_state, with_dstate, seed):
    """numpy f32 inputs as the model makes them: la = -dt A with dt
    log-uniform on [1e-3, 1e-1] and A = 1 .. H; B and C at 0.3."""
    rng = np.random.default_rng(seed)
    f = np.float32
    dt = np.exp(rng.random((B, S, H)) * np.log(100.0) + np.log(1e-3))
    arrs = {"x": rng.standard_normal((B, S, H, P)).astype(f),
            "la": (-dt * np.arange(1, H + 1)).astype(f),
            "Bm": (0.3 * rng.standard_normal((B, S, G, N))).astype(f),
            "Cm": (0.3 * rng.standard_normal((B, S, G, N))).astype(f),
            "dy": rng.standard_normal((B, S, H, P)).astype(f)}
    arrs["init"] = rng.standard_normal((B, H, P, N)).astype(f) \
        if with_state else None
    arrs["dstate"] = rng.standard_normal((B, H, P, N)).astype(f) \
        if with_dstate else None
    return arrs


def jax_grads(a, chunk):
    """jax.grad of the reference's ssd_chunked at the same loss, the
    initial state's included (zeros where the case has none)."""
    def loss(x, la, Bm, Cm, init):
        y, st = jax_ssd_chunked(x, la, Bm, Cm, chunk, initial_state=init)
        out = jnp.sum(y * a["dy"])
        if a["dstate"] is not None:
            out = out + jnp.sum(st * a["dstate"])
        return out

    init = a["init"]
    if init is None:
        init = np.zeros((*a["x"].shape[:1], *a["x"].shape[2:],
                         a["Bm"].shape[-1]), np.float32)
    g = jax.grad(loss, (0, 1, 2, 3, 4))(*(jnp.asarray(a[k]) for k in
                                          ("x", "la", "Bm", "Cm")),
                                        jnp.asarray(init))
    return [np.asarray(t) for t in g]


def torch_inputs(a, grad=False):
    t = {k: None if v is None else torch.from_numpy(v) for k, v in a.items()}
    if grad:
        for k in ("x", "la", "Bm", "Cm", "init"):
            if t[k] is not None:
                t[k].requires_grad_(True)
    return t


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_autograd_and_reference(case):
    B, S, H, P, G, N, chunk, with_state, with_ds = CASES[case]
    a = draw(B, S, H, P, G, N, with_state, with_ds, seed=S + P)
    want = jax_grads(a, chunk)
    t = torch_inputs(a)
    got = ss.ssd_scan_bwd_plain(t["x"], t["la"], t["Bm"], t["Cm"], t["dy"],
                                t["dstate"], chunk=chunk,
                                initial_state=t["init"])
    assert all(g.dtype == torch.float32 for g in got)
    assert got[4].shape == (B, H, P, N)
    # autograd through the plain forward
    ta = torch_inputs(a, grad=True)
    y, st = ss.ssd_scan_plain(ta["x"], ta["la"], ta["Bm"], ta["Cm"],
                              chunk=chunk, initial_state=ta["init"])
    loss = (y * ta["dy"]).sum()
    if ta["dstate"] is not None:
        loss = loss + (st * ta["dstate"]).sum()
    leaves = [ta[k] for k in ("x", "la", "Bm", "Cm", "init")
              if ta[k] is not None]
    auto = torch.autograd.grad(loss, leaves)
    for name, g, w in zip(NAMES, got, want):     # d(initial state) too,
        assert rel_err(g.numpy(), w) <= GRAD_REL, name   # zeros or not
    for name, g, au, w in zip(NAMES, got, auto, want):
        assert rel_err(g.numpy(), au.numpy()) <= GRAD_REL, (name, "autograd")
        assert rel_err(au.numpy(), w) <= GRAD_REL, (name, "autograd vs ref")


@pytest.mark.parametrize("case", ["ragged_tail", "all_at_once"])
def test_autograd_function_runs_the_plain_backward(case):
    """``ssd_scan_train`` on CPU tensors: the forward is the plain scan's,
    the backward ``ssd_scan_bwd_plain``'s (the same numbers), and no
    kernel launch is counted."""
    B, S, H, P, G, N, chunk, with_state, with_ds = CASES[case]
    a = draw(B, S, H, P, G, N, with_state, with_ds, seed=7)
    t = torch_inputs(a, grad=True)
    before = dict(ss.LAUNCHES)
    y, st = ss.ssd_scan_train(t["x"], t["la"], t["Bm"], t["Cm"], chunk=chunk,
                              initial_state=t["init"])
    py, pst = ss.ssd_scan_plain(t["x"], t["la"], t["Bm"], t["Cm"],
                                chunk=chunk, initial_state=t["init"])
    assert torch.equal(y, py) and torch.equal(st, pst)
    loss = (y * t["dy"]).sum()
    if t["dstate"] is not None:
        loss = loss + (st * t["dstate"]).sum()
    leaves = [t[k] for k in ("x", "la", "Bm", "Cm", "init")
              if t[k] is not None]
    got = torch.autograd.grad(loss, leaves)
    want = ss.ssd_scan_bwd_plain(*(t[k].detach() for k in
                                   ("x", "la", "Bm", "Cm")), t["dy"],
                                 t["dstate"], chunk=chunk,
                                 initial_state=None if t["init"] is None
                                 else t["init"].detach())
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ss.LAUNCHES == before


def test_forward_returns_the_states_entering_each_chunk():
    """``return_chunk_states``: chunk 0 enters with the initial state,
    chunk c with the final state of a scan over the first c chunks."""
    B, S, H, P, G, N, chunk = 2, 40, 4, 8, 2, 8, 16
    a = draw(B, S, H, P, G, N, True, False, seed=3)
    t = torch_inputs(a)
    _, _, cs = ss.ssd_scan_kernel(t["x"], t["la"], t["Bm"], t["Cm"],
                                  chunk=chunk, initial_state=t["init"],
                                  return_chunk_states=True)
    assert cs.shape == (B, 3, H, P, N) and cs.dtype == torch.float32
    assert torch.equal(cs[:, 0], t["init"])
    for c in (1, 2):
        _, head = ss.ssd_scan_plain(*(t[k][:, :c * chunk] for k in
                                      ("x", "la", "Bm", "Cm")), chunk=chunk,
                                    initial_state=t["init"])
        np.testing.assert_allclose(cs[:, c].numpy(), head.numpy(), rtol=0,
                                   atol=1e-5)
