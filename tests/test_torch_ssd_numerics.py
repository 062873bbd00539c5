"""The order and the roundings of the tensor-core SSD scan
(``ssd_scan_mma_kernel`` in ``csrc/ssd_scan.cu``), emulated in torch on the
CPU, against the plain version the kernel is held to and against the JAX
package's Pallas kernel in interpret mode.

This file documents the numerics of the design: no code of the kernel
runs here.  The ``cuda``-marked tests of ``test_torch_kernels_cuda.py``
and ``chip_smoke.py`` hold the kernel itself to its plain version.

The kernel computes every chunk at once: its intra-chunk term
``(C B^T o L) x`` and its own state contribution ``U = (x o w)^T B`` need
no carried state.  Only the hand-off is serial: chunk c reads S_{c-1}
from one of two slots per head, writes S_c = exp(la_tot) S_{c-1} + U to
the other, and adds ``exp(la_cum) o (C S_{c-1}^T)`` to its y.  On the
tensor cores x, B and C are bf16 already and their products are exact,
but three f32 operands have to enter a bf16 product too: M = C B^T o L,
x o w and S_{c-1}.  Each goes in as two bf16 terms, ``hi = bf16(v)`` and
``lo = bf16(v - hi)``, into one f32 accumulator, which keeps 16
significant bits; as one bf16 term each of them alone puts y or the state
past the bounds ``chip_smoke.py`` holds the kernel to
(``test_one_bf16_term_misses`` prints by how much).  Not emulated, as
far below those roundings: the kernel's decays by ``ex2.approx``
(relative error ~2**-22) and its compensated (hi + lo) la_cum, which
makes the decay exponents more exact than the plain version's f32
cumulative sum.

Shapes: Mamba-2-2.7B's head (P = 64) and state (N = 128) dims and chunk
128, four heads, S = 1024 (eight chunks); decays as the model makes them
(``la = -dt A``, dt log-uniform on [1e-3, 1e-1]) with A from 1 to 64, so
the heads range from slow to fast decay; x at unit scale, B and C at 0.3
(as in ``chip_smoke.py``).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import ssd_scan as jax_ssd_pallas

ss = importlib.import_module("repro_torch.kernels.ssd_scan")

S, H, P, N, CHUNK = 1024, 4, 64, 128, 128
A = (1.0, 4.0, 16.0, 64.0)
Y_TOL = (2 ** -7, 1e-4)        # (rtol, atol): chip_smoke.py's SSD_BF16_TOL
STATE_ATOL = 5e-4              # chip_smoke.py's bound on the final state
F32_ATOL = 5e-4                # tests/test_kernels.py::test_ssd_kernel


def inputs(seed=0, with_state=False):
    """(x, la, Bm, Cm, initial_state) as f32 numpy arrays; x, B and C hold
    bf16-exact values."""
    rng = np.random.default_rng(seed)

    def bf16_exact(a):
        return torch.from_numpy(a.astype(np.float32)).to(
            torch.bfloat16).float().numpy()

    x = bf16_exact(rng.standard_normal((1, S, H, P)))
    dt = np.exp(rng.random((1, S, H)) * np.log(100.0) + np.log(1e-3))
    la = (-dt * np.array(A)).astype(np.float32)
    Bm = bf16_exact(0.3 * rng.standard_normal((1, S, 1, N)))
    Cm = bf16_exact(0.3 * rng.standard_normal((1, S, 1, N)))
    s0 = rng.standard_normal((1, H, P, N)).astype(np.float32) \
        if with_state else None
    return x, la, Bm, Cm, s0


def rounded(v, mode):
    """v as it enters a bf16 product: ``none`` (f32), ``one`` bf16 term, or
    ``hilo``: hi + lo bf16 terms, whose products sum exactly in f32."""
    if mode == "none":
        return v
    hi = v.to(torch.bfloat16).float()
    if mode == "one":
        return hi
    return hi + (v - hi).to(torch.bfloat16).float()


def emulate(x, la, Bm, Cm, s0=None, *, M="hilo", xw="hilo", state="hilo",
            out_dtype=torch.bfloat16):
    """The kernel's order: every chunk's intra term and U at once, then the
    hand-off through two slots per head.  (1, S, H, P) in, G = 1.
    Returns (y, final state)."""
    nc = S // CHUNK
    xs = torch.from_numpy(x).reshape(nc, CHUNK, H, P).permute(2, 0, 1, 3)
    las = torch.from_numpy(la).reshape(nc, CHUNK, H).permute(2, 0, 1)
    Bc = torch.from_numpy(Bm).reshape(nc, CHUNK, N)
    Cc = torch.from_numpy(Cm).reshape(nc, CHUNK, N)
    cum = las.cumsum(-1)                                 # (H, nc, Q)
    tot = cum[..., -1]                                   # (H, nc)
    # (c) intra: M = C B^T o L, L selected to 0 above the diagonal
    scores = Cc @ Bc.transpose(1, 2)                     # (nc, Q, Q)
    tri = torch.ones(CHUNK, CHUNK, dtype=torch.bool).tril()
    L = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]),
                    torch.zeros(()))
    y = rounded(scores * L, M) @ xs                      # (H, nc, Q, P)
    # (d) each chunk's own state contribution
    w = torch.exp(tot[..., None] - cum)                  # (H, nc, Q)
    U = rounded(xs * w[..., None], xw).transpose(-1, -2) @ Bc  # (H, nc, P, N)
    # (e) and (f): the chained hand-off through two slots
    slots = [None, None]
    prev = torch.zeros(H, P, N) if s0 is None else torch.from_numpy(s0[0])
    for c in range(nc):
        if c > 0:
            prev = slots[(c - 1) % 2]
        slots[c % 2] = torch.exp(tot[:, c])[:, None, None] * prev + U[:, c]
        y[:, c] += torch.exp(cum[:, c])[..., None] * (
            Cc[c] @ rounded(prev, state).transpose(-1, -2))
    y = y.permute(1, 2, 0, 3).reshape(1, S, H, P)
    return y.to(out_dtype), slots[(nc - 1) % 2][None]


def plain(x, la, Bm, Cm, s0=None, dtype=torch.bfloat16):
    t = [torch.from_numpy(a).to(dtype) for a in (x, Bm, Cm)]
    return ss.ssd_scan_plain(
        t[0], torch.from_numpy(la), t[1], t[2], chunk=CHUNK,
        initial_state=None if s0 is None else torch.from_numpy(s0))


def ratios(y, st, ref_y, ref_st):
    """(y's ratio to Y_TOL, the state's to STATE_ATOL): at most 1 when
    every element is within its bound."""
    d = (y.float() - ref_y.float()).abs()
    ry = (d / (Y_TOL[1] + Y_TOL[0] * ref_y.float().abs())).max().item()
    return ry, (st - ref_st).abs().max().item() / STATE_ATOL


@pytest.mark.parametrize("with_state", [False, True])
def test_chunk_parallel_order_matches_plain_and_pallas(with_state):
    """(i) The order alone, in f32: the chained hand-off through two slots
    gives the plain version's y and state, and the Pallas kernel's (which
    takes no initial state)."""
    x, la, Bm, Cm, s0 = inputs(with_state=with_state)
    y, st = emulate(x, la, Bm, Cm, s0, M="none", xw="none", state="none",
                    out_dtype=torch.float32)
    py, pst = plain(x, la, Bm, Cm, s0, dtype=torch.float32)
    errs = [(y - py).abs().max().item(), (st - pst).abs().max().item()]
    if not with_state:
        jy, jst = jax_ssd_pallas(*map(jnp.asarray, (x, la, Bm, Cm)),
                                 chunk=CHUNK)
        errs += [float(np.abs(y.numpy() - np.asarray(jy)).max()),
                 float(np.abs(st.numpy() - np.asarray(jst)).max())]
    print(f"chunk-parallel order, state={with_state}: max |dy|, |dstate| "
          f"vs plain (and Pallas) {errs}")
    assert max(errs) < F32_ATOL


@pytest.mark.parametrize("with_state", [False, True])
def test_tensor_core_roundings_within_bound(with_state):
    """(ii) bf16 operands, and M, x o w and S_{c-1} each as hi + lo: y
    within one bf16 step of the plain version, the state within 5e-4."""
    x, la, Bm, Cm, s0 = inputs(with_state=with_state)
    y, st = emulate(x, la, Bm, Cm, s0)
    ry, rs = ratios(y, st, *plain(x, la, Bm, Cm, s0))
    print(f"hi + lo, state={with_state}: y at {ry:.3g} of its bound, "
          f"state at {rs:.3g}")
    assert ry <= 1 and rs <= 1


@pytest.mark.parametrize("operand", ["M", "xw", "state"])
def test_one_bf16_term_misses(operand):
    """(iii) The trap the hi/lo split avoids: any one of the three f32
    operands as a single bf16 term puts y or the state past its bound."""
    x, la, Bm, Cm, s0 = inputs(with_state=True)
    y, st = emulate(x, la, Bm, Cm, s0, **{operand: "one"})
    ry, rs = ratios(y, st, *plain(x, la, Bm, Cm, s0))
    print(f"{operand} as one bf16 term: y at {ry:.3g} of its bound, state "
          f"at {rs:.3g}")
    assert max(ry, rs) > 1
