"""The order and the roundings of the SSD scan's tensor-core backward
(``ssd_bwd_mma`` in ``csrc/ssd_scan_bwd.cu``), emulated in torch on the
CPU, against the plain backward the kernel is held to (which
``test_torch_ssd_backward.py`` holds to ``jax.grad`` of the JAX package's
``ssd_chunked``).

This file documents the numerics of the design: no code of the kernel
runs here.  The ``cuda``-marked tests of ``test_torch_kernels_cuda.py``
and ``chip_smoke.py`` hold the kernel itself to its plain version.

The kernel's order: an inject kernel makes every chunk's U_c =
(dy o exp(lc))^T C at once, a chain walks dS_{c-1} = exp(lt) dS_c + U_c
last chunk first, and a chunk kernel builds M = (C B^T) o L, dM = dy x^T
and D = dM o L and forms

    dC = D B + exp(lc) o (dy S_{c-1})       dx = M^T dy + w o (B dS_c^T)
    dB = D^T C + w o (x dS_c)               dlc = T's row sums - its
    column sums + exp(lc) C.(dy S_{c-1}) - w x.(B dS_c^T), T = M o dM,

with <dS_c, S_c> = exp(lt) <dS_c, S_{c-1}> + sum_j w_j x_j.(dS_c B_j) at
the last row, dla the reverse cumulative sum of dlc, dB and dC summed
over the heads of a group.  On the tensor cores x, dy, B and C are bf16
already, so C B^T, dy x^T and every product with their bf16 sides are
exact with f32 sums; five f32 operands enter a bf16 product too: M, D,
S_{c-1}, dS_c and the inject's dy o exp(lc).  Each goes in as two bf16
terms, ``hi = bf16(v)`` and ``lo = bf16(v - hi)``, into one f32
accumulator (16 significant bits).  w and exp(lc) scale in f32 after the
products.  Not emulated, as in ``test_torch_ssd_numerics.py``: the
decays by ``ex2.approx`` and the compensated la_cum.

Each gradient's error below is max |emulation - plain f32 backward| over
2**-7 (``chip_smoke.py``'s ``SSD_BWD_REL["bfloat16"]``) of its largest
|plain|, at S 1024, H 4 (A = 1, 4, 16, 64), P 64, N 128, chunk 128, no
initial state and no dstate (with both, within 15% of these):

    operand as one bf16 term   dx      dla     dB      dC      dinit
    none (hi + lo everywhere)  4.0e-4  2.7e-4  3.6e-4  4.1e-4  4.2e-4
    M                          0.219   -       -       -       -
    D                          -       -       0.214   0.212   -
    S_{c-1}                    -       0.086   -       0.156   -
    dS_c                       0.211   0.093   0.176   -       -
    dy o exp(lc) (inject)      0.180   0.137   0.193   -       0.245

("-": as with hi + lo.)  So hi + lo spends under 1e-3 of the gate; one
bf16 term spends a fifth of it in every gradient it feeds, before the
outputs' own rounding to bf16 (up to one more bf16 step).
"""
import importlib

import numpy as np
import pytest
import torch

ss = importlib.import_module("repro_torch.kernels.ssd_scan")

S, H, P, N, CHUNK = 1024, 4, 64, 128, 128
A = (1.0, 4.0, 16.0, 64.0)
BF16_REL = 2 ** -7             # chip_smoke.py's SSD_BWD_REL["bfloat16"]
F32_REL = 1e-4                 # and its SSD_BWD_REL["float32"]
NAMES = ("dx", "dla", "dB", "dC", "dinit")
OPERANDS = ("M", "D", "S_prev", "dS", "inject")


def inputs(seed=0, with_state=False):
    """(x, la, Bm, Cm, dy, initial_state, dstate) as f32 numpy arrays; x,
    dy, B and C hold bf16-exact values; with_state gives both an initial
    state and a dstate."""
    rng = np.random.default_rng(seed)

    def bf16_exact(a):
        return torch.from_numpy(a.astype(np.float32)).to(
            torch.bfloat16).float().numpy()

    x = bf16_exact(rng.standard_normal((1, S, H, P)))
    dy = bf16_exact(rng.standard_normal((1, S, H, P)))
    dt = np.exp(rng.random((1, S, H)) * np.log(100.0) + np.log(1e-3))
    la = (-dt * np.array(A)).astype(np.float32)
    Bm = bf16_exact(0.3 * rng.standard_normal((1, S, 1, N)))
    Cm = bf16_exact(0.3 * rng.standard_normal((1, S, 1, N)))
    s0, ds = (rng.standard_normal((1, H, P, N)).astype(np.float32)
              if with_state else None for _ in range(2))
    return x, la, Bm, Cm, dy, s0, ds


def rounded(v, mode):
    """v as it enters a bf16 product: ``none`` (f32), ``one`` bf16 term, or
    ``hilo``: hi + lo bf16 terms, whose products sum exactly in f32."""
    if mode == "none":
        return v
    hi = v.to(torch.bfloat16).float()
    if mode == "one":
        return hi
    return hi + (v - hi).to(torch.bfloat16).float()


def emulate(x, la, Bm, Cm, dy, s0, dstate, **modes):
    """The kernels' order, each split operand as ``modes`` says (default
    ``hilo``; keys OPERANDS), G = 1.  The chunk states are the plain
    forward's (the kernel is fed the forward kernel's).  Returns (dx,
    dla, dB, dC, d_initial_state) in f32."""
    mode = {k: modes.get(k, "hilo") for k in OPERANDS}
    nc = S // CHUNK
    t = torch.from_numpy
    X = t(x).reshape(nc, CHUNK, H, P).permute(2, 0, 1, 3)     # (H, nc, Q, P)
    DY = t(dy).reshape(nc, CHUNK, H, P).permute(2, 0, 1, 3)
    cum = t(la).reshape(nc, CHUNK, H).permute(2, 0, 1).cumsum(-1)
    tot = cum[..., -1]                                        # (H, nc)
    ecum, w = torch.exp(cum), torch.exp(tot[..., None] - cum)
    Bc, Cc = t(Bm).reshape(nc, CHUNK, N), t(Cm).reshape(nc, CHUNK, N)
    _, final, s_prev = ss.ssd_scan_plain(
        t(x), t(la), t(Bm), t(Cm), chunk=CHUNK,
        initial_state=None if s0 is None else t(s0), return_chunk_states=True)
    s_prev = s_prev[0].permute(1, 0, 2, 3)                    # (H, nc, P, N)
    # inject, then the chain, last chunk first
    U = rounded(DY * ecum[..., None], mode["inject"]).transpose(-1, -2) @ Cc
    dS = torch.zeros(H, P, N) if dstate is None else t(dstate)[0]
    leaving = [None] * nc
    for c in reversed(range(nc)):
        leaving[c] = dS
        dS = torch.exp(tot[:, c])[:, None, None] * dS + U[:, c]
    dS_c = torch.stack(leaving, 1)
    # the chunk kernel
    tri = torch.ones(CHUNK, CHUNK, dtype=torch.bool).tril()
    L = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]),
                    torch.zeros(()))
    dM = DY @ X.transpose(-1, -2)
    M, D = (Cc @ Bc.transpose(-1, -2)) * L, dM * L
    v = DY @ rounded(s_prev, mode["S_prev"])                  # S^T dy_i
    u = Bc @ rounded(dS_c, mode["dS"]).transpose(-1, -2)      # dS B_j
    dC = rounded(D, mode["D"]) @ Bc + ecum[..., None] * v
    dx = rounded(M, mode["M"]).transpose(-1, -2) @ DY + w[..., None] * u
    dB = rounded(D, mode["D"]).transpose(-1, -2) @ Cc \
        + w[..., None] * (X @ rounded(dS_c, mode["dS"]))
    T = M * dM
    wt = w * (X * u).sum(-1)
    dlc = T.sum(-1) - T.sum(-2) + ecum * (Cc * v).sum(-1) - wt
    dlc[..., -1] += torch.exp(tot) * (dS_c * s_prev).sum((-2, -1)) \
        + wt.sum(-1)
    dla = dlc.flip(-1).cumsum(-1).flip(-1)

    def back(a):                                              # (1, S, H, ...)
        return a.permute(1, 2, 0, *range(3, a.dim())).reshape(
            1, S, H, *a.shape[3:])

    return (back(dx), back(dla[..., None])[..., 0],
            back(dB).sum(2, keepdim=True), back(dC).sum(2, keepdim=True),
            dS[None])


def plain(x, la, Bm, Cm, dy, s0, dstate):
    """``ssd_scan_bwd_plain`` in f32 on the same (bf16-exact) inputs."""
    def t(a):
        return None if a is None else torch.from_numpy(a)
    return ss.ssd_scan_bwd_plain(t(x), t(la), t(Bm), t(Cm), t(dy),
                                 t(dstate), chunk=CHUNK, initial_state=t(s0))


def ratios(got, want, rel):
    """Each gradient's max |got - want| over ``rel`` of its largest |want|."""
    return [float((g - w).abs().max() / (rel * w.abs().max()))
            for g, w in zip(got, want)]


@pytest.mark.parametrize("with_state", [False, True])
def test_kernel_order_matches_plain(with_state):
    """(i) The order alone, in f32: inject, chain and chunk kernel give the
    plain backward's gradients within the f32 gate (1e-4 of each
    gradient's largest element)."""
    ins = inputs(with_state=with_state)
    got = emulate(*ins, **{k: "none" for k in OPERANDS})
    r = ratios(got, plain(*ins), F32_REL)
    print(f"order, state={with_state}: {[f'{v:.3g}' for v in r]} of 1e-4")
    assert all(v <= 1 for v in r)


@pytest.mark.parametrize("with_state", [False, True])
def test_tensor_core_roundings_within_half_the_gate(with_state):
    """(ii) bf16 operands and M, D, S_{c-1}, dS_c and the inject's operand
    each as hi + lo: every gradient within half of chip_smoke.py's bf16
    gate (2**-7 of its largest element) of the plain f32 backward."""
    ins = inputs(with_state=with_state)
    r = ratios(emulate(*ins), plain(*ins), BF16_REL)
    print(f"hi + lo, state={with_state}: "
          f"{dict(zip(NAMES, (f'{v:.3g}' for v in r)))}")
    assert all(v <= 0.5 for v in r)


@pytest.mark.parametrize("operand", OPERANDS)
def test_one_bf16_term_spends_the_gate(operand):
    """(iii) What the split buys: any one of the five operands as a single
    bf16 term costs the gradients it feeds over 100 times the error of hi
    + lo (a fifth of the gate or more, the docstring's table); at these
    draws they stay under the gate."""
    ins = inputs(with_state=True)
    want = plain(*ins)
    base = max(ratios(emulate(*ins), want, BF16_REL))
    r = ratios(emulate(*ins, **{operand: "one"}), want, BF16_REL)
    print(f"{operand} as one bf16 term: "
          f"{dict(zip(NAMES, (f'{v:.3g}' for v in r)))} (hi + lo {base:.3g})")
    assert all(v < 1 for v in r) and max(r) > 100 * base
