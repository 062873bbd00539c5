"""Chunked SSD scan: Mamba-2 prefill's hot spot.

Port of ``repro/kernels/ssd_scan.py``.  One kernel, written by hand in
CUDA C++ for Hopper (``csrc/ssd_scan.cu``), replaces ``ssd_scan_pallas``;
beside it is a plain PyTorch version of the same function, the chunked
dual form of ``repro/models/ssm.py::ssd_chunked``.  The kernel has two
variants, chosen by dtype (both always built): ``mma`` for bf16, one
block per (chunk, head, batch row) on the tensor cores with the state
handed from chunk to chunk inside the launch, and ``fma`` for f32, one
block per (head, batch row) walking its chunks on the f32 FMA units
(TF32 would miss the f32 tolerance).

Inputs, as in the reference:
    x   (B, S, H, P)   f32 or bf16
    la  (B, S, H)      f32 log decay (<= 0)
    Bm  (B, S, G, N)   x's dtype; head h reads group h // (H / G)
    Cm  (B, S, G, N)   x's dtype
    initial_state (B, H, P, N) f32 or None (zeros)
Returns y (B, S, H, P) in x's dtype and the final state (B, H, P, N) f32.

Per (b, h) the chunks are walked in order with the f32 state carried
across them: within a chunk ``y = (C B^T * L) x + exp(la_cum) * (C
state^T)`` with ``L[i, j] = exp(la_cum[i] - la_cum[j])`` for i >= j and 0
otherwise (selected, never multiplied: for i < j the exponent is positive
and may overflow), then ``state = exp(la_tot) state + (x * exp(la_tot -
la_cum))^T B``.  The tail is padded with ``la = 0`` and ``x = 0``, which
leaves the state unchanged.

Training differentiates it (``SSDScanFunction``; the reference gets the
gradient by autodiff of the jnp ``ssd_chunked``): the forward also writes
the state entering each chunk, (B, n_chunks, H, P, N) f32
(``return_chunk_states``), and the backward is a second hand-written
kernel (``csrc/ssd_scan_bwd.cu``): the chunks' state-gradient injections
in parallel, the state gradient's chain walked last chunk first, then
every chunk's dx, dla, dB, dC in parallel, dB and dC summed over the heads
of a group in order; no atomics.  Its variants, chosen by dtype: ``mma``
for bf16, the inject and chunk kernels on the tensor cores (bf16 tiles by
cp.async, ``mma.sync`` products, the f32 operands as hi + lo bf16 terms,
two blocks an SM: ``bwd_mma_attrs``), and ``fma_f32`` for f32, on the
FMA units.  Its plain version is ``ssd_scan_bwd_plain``.

A wrapper runs the plain version only when its tensors lie on the CPU
(the tests).  On CUDA tensors it launches the kernel or raises; there is
no fallback.  ``LAUNCHES`` counts kernel launches, in all and per variant
(``ssd_scan:mma``; a backward call, its four kernels, once as
``ssd_scan_bwd`` and once by variant, ``ssd_scan_bwd:mma`` or
``ssd_scan_bwd:fma_f32``).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# what the CUDA kernel's shared-memory tiles hold
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128

VARIANTS = {torch.bfloat16: "mma", torch.float32: "fma"}
# the backward: bf16 on the tensor cores, f32 on the FMA units
BWD_VARIANTS = {torch.bfloat16: "mma", torch.float32: "fma_f32"}
LAUNCHES: Dict[str, int] = {"ssd_scan": 0, "ssd_scan:mma": 0,
                            "ssd_scan:fma": 0, "ssd_scan_bwd": 0,
                            "ssd_scan_bwd:mma": 0,
                            "ssd_scan_bwd:fma_f32": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _validate(x, la, Bm, Cm, chunk, initial_state):
    xs, ls, bs, cs = x.shape, la.shape, Bm.shape, Cm.shape
    if len(xs) != 4 or len(ls) != 3 or len(bs) != 4 or len(cs) != 4:
        raise ValueError(f"ssd scan: x (B,S,H,P), la (B,S,H), Bm/Cm "
                         f"(B,S,G,N); got {tuple(xs)}, {tuple(ls)}, "
                         f"{tuple(bs)}, {tuple(cs)}")
    Bsz, S, H, P = xs
    _, _, G, N = bs
    if ls != (Bsz, S, H) or bs[0] != Bsz or bs[1] != S or cs != bs:
        raise ValueError(f"ssd scan: x {tuple(xs)}, la {tuple(ls)}, Bm "
                         f"{tuple(bs)}, Cm {tuple(cs)} do not agree")
    if G == 0 or H % G:
        raise ValueError(f"ssd scan: H={H} heads do not group evenly over "
                         f"G={G} groups")
    if chunk < 1:
        raise ValueError(f"ssd scan: chunk must be >= 1, got {chunk}")
    if initial_state is not None and \
            initial_state.shape != (Bsz, H, P, N):
        raise ValueError(f"ssd scan: initial_state must be "
                         f"{(Bsz, H, P, N)}, got "
                         f"{tuple(initial_state.shape)}")
    dev = x.device
    if la.device != dev or Bm.device != dev or Cm.device != dev or (
            initial_state is not None and initial_state.device != dev):
        devices = {t.device for t in (x, la, Bm, Cm, initial_state)
                   if t is not None}
        raise ValueError(f"ssd scan: tensors on mixed devices "
                         f"{sorted(map(str, devices))}")


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------
def ssd_scan_plain(x, la, Bm, Cm, *, chunk=128, initial_state=None,
                   return_chunk_states=False):
    """The SSD dual form of the reference's ``ssd_chunked``: every chunk's
    intra-chunk term and state at once, then the inter-chunk recurrence as
    a loop over chunks, all in f32.  ``return_chunk_states``: also the
    state entering each chunk, (B, n_chunks, H, P, N) f32."""
    _validate(x, la, Bm, Cm, chunk, initial_state)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        la = F.pad(la, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = (S + pad) // chunk
    rep = H // G
    xs = x.reshape(Bsz, nc, chunk, H, P).float()
    las = la.reshape(Bsz, nc, chunk, H).float()
    Bh = Bm.reshape(Bsz, nc, chunk, G, N).float().repeat_interleave(rep, 3)
    Ch = Cm.reshape(Bsz, nc, chunk, G, N).float().repeat_interleave(rep, 3)

    la_cum = las.cumsum(2)                           # (B, nc, Q, H)
    la_tot = la_cum[:, :, -1]                        # (B, nc, H)

    # intra-chunk: masked-decay scores
    scores = torch.einsum("bcihn,bcjhn->bchij", Ch, Bh)
    lc = la_cum.transpose(2, 3)                      # (B, nc, H, Q)
    decay = lc[..., :, None] - lc[..., None, :]      # [i, j] = cum_i - cum_j
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    L = torch.where(tri, torch.exp(decay), torch.zeros_like(decay))
    y = torch.einsum("bchij,bcjhp->bcihp", scores * L, xs)

    # chunk states, then the inter-chunk recurrence
    w = torch.exp(la_tot[:, :, None] - la_cum)       # (B, nc, Q, H)
    states = torch.einsum("bcjhn,bcjhp,bcjh->bchpn", Bh, xs, w)
    state = (torch.zeros((Bsz, H, P, N), device=x.device)
             if initial_state is None else initial_state.float())
    y_inter, entering = [], []
    for c in range(nc):
        entering.append(state)
        y_inter.append(torch.einsum("bihn,bhpn,bih->bihp", Ch[:, c], state,
                                    torch.exp(la_cum[:, c])))
        state = torch.exp(la_tot[:, c])[:, :, None, None] * state \
            + states[:, c]
    y = y + torch.stack(y_inter, 1)
    y = y.reshape(Bsz, nc * chunk, H, P)[:, :S]
    if return_chunk_states:
        return y.to(x.dtype), state, torch.stack(entering, 1)
    return y.to(x.dtype), state


def _validate_bwd(x, dy, dstate, state_shape):
    if tuple(dy.shape) != tuple(x.shape) or dy.device != x.device:
        raise ValueError(f"ssd scan backward: dy {tuple(dy.shape)} on "
                         f"{dy.device} must be x's {tuple(x.shape)} on "
                         f"{x.device}")
    if dstate is not None and (tuple(dstate.shape) != state_shape
                               or dstate.device != x.device):
        raise ValueError(f"ssd scan backward: dstate {tuple(dstate.shape)} "
                         f"on {dstate.device} must be {state_shape} on "
                         f"{x.device}")


def ssd_scan_bwd_plain(x, la, Bm, Cm, dy, dstate, *, chunk=128,
                       initial_state=None):
    """(dx, dla, dB, dC, d_initial_state) of ``ssd_scan_plain`` at (dy,
    dstate), all in f32 as the reference's autodiff of ``ssd_chunked``;
    ``dstate`` None counts as zeros.  The states entering each chunk are
    recomputed, then the chunks are walked in reverse with the (P, N)
    state gradient ``dS`` carried: chunk c, with ``lc = cumsum(la)``, ``lt
    = lc[Q-1]``, ``M = (C B^T) o L`` and ``dM[i, j] = dy_i . x_j``, takes

        dS_{c-1} = exp(lt) dS_c + sum_i exp(lc_i) dy_i (x) C_i
        dx_j     = sum_i M_ij dy_i + w_j dS_c B_j
        dC_i     = sum_j dM_ij L_ij B_j + exp(lc_i) S_{c-1}^T dy_i
        dB_j     = sum_i dM_ij L_ij C_i + w_j dS_c^T x_j

    (w_j = exp(lt - lc_j)); ``dlc`` collects the row sums less the column
    sums of T = M o dM, dy_i . y_inter_i, -w_j x_j^T dS_c B_j and <dS_c,
    S_c> at the last row, and dla is its reverse cumulative sum within
    the chunk.  dB and dC are summed over the heads of each group, the
    padded tail is dropped, and d_initial_state is the dS left after
    chunk 0.  dx, dB, dC come back in their inputs' dtypes, dla and
    d_initial_state in f32."""
    _validate(x, la, Bm, Cm, chunk, initial_state)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    _validate_bwd(x, dy, dstate, (Bsz, H, P, N))
    pad = (-S) % chunk
    xp, lap, Bp, Cp, dyp = x, la, Bm, Cm, dy
    if pad:
        xp, dyp = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, dy))
        lap = F.pad(la, (0, 0, 0, pad))
        Bp, Cp = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (Bm, Cm))
    nc = (S + pad) // chunk
    rep = H // G
    xs = xp.reshape(Bsz, nc, chunk, H, P).float()
    dys = dyp.reshape(Bsz, nc, chunk, H, P).float()
    las = lap.reshape(Bsz, nc, chunk, H).float()
    Bh = Bp.reshape(Bsz, nc, chunk, G, N).float().repeat_interleave(rep, 3)
    Ch = Cp.reshape(Bsz, nc, chunk, G, N).float().repeat_interleave(rep, 3)

    la_cum = las.cumsum(2)                           # (B, nc, Q, H)
    la_tot = la_cum[:, :, -1]                        # (B, nc, H)
    ecum = torch.exp(la_cum)
    w = torch.exp(la_tot[:, :, None] - la_cum)
    lc = la_cum.transpose(2, 3)                      # (B, nc, H, Q)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    L = torch.where(tri, torch.exp(lc[..., :, None] - lc[..., None, :]),
                    torch.zeros((), device=x.device))

    # the states entering (S_prev) and leaving (S_out) each chunk
    _, final, S_prev = ssd_scan_plain(x, la, Bm, Cm, chunk=chunk,
                                      initial_state=initial_state,
                                      return_chunk_states=True)
    S_out = torch.cat([S_prev[:, 1:], final[:, None]], 1)

    # the state gradient leaving each chunk, carried in reverse
    inj = torch.einsum("bcihp,bcihn,bcih->bchpn", dys, Ch, ecum)
    dS = (torch.zeros((Bsz, H, P, N), device=x.device)
          if dstate is None else dstate.float())
    d_out = [None] * nc
    for c in reversed(range(nc)):
        d_out[c] = dS
        dS = torch.exp(la_tot[:, c])[:, :, None, None] * dS + inj[:, c]
    dS_out = torch.stack(d_out, 1)                   # (B, nc, H, P, N)

    M = torch.einsum("bcihn,bcjhn->bchij", Ch, Bh) * L
    dM = torch.einsum("bcihp,bcjhp->bchij", dys, xs)
    D = dM * L
    T = M * dM
    u = torch.einsum("bchpn,bcjhn->bcjhp", dS_out, Bh)     # dS_c B_j
    v = torch.einsum("bchpn,bcihp->bcihn", S_prev, dys)    # S_{c-1}^T dy_i
    dx = torch.einsum("bchij,bcihp->bcjhp", M, dys) + w[..., None] * u
    dC = torch.einsum("bchij,bcjhn->bcihn", D, Bh) + ecum[..., None] * v
    dB = torch.einsum("bchij,bcihn->bcjhn", D, Ch) \
        + w[..., None] * torch.einsum("bchpn,bcjhp->bcjhn", dS_out, xs)
    dlc = (T.sum(-1) - T.sum(-2)).transpose(2, 3)          # (B, nc, Q, H)
    dlc = dlc + ecum * (Ch * v).sum(-1) - w * (xs * u).sum(-1)
    dlc[:, :, -1] += (dS_out * S_out).sum((-2, -1))
    dla = dlc.flip(2).cumsum(2).flip(2)

    Sp = nc * chunk
    dx = dx.reshape(Bsz, Sp, H, P)[:, :S]
    dla = dla.reshape(Bsz, Sp, H)[:, :S]
    dB = dB.reshape(Bsz, Sp, G, rep, N).sum(3)[:, :S]
    dC = dC.reshape(Bsz, Sp, G, rep, N).sum(3)[:, :S]
    return (dx.to(x.dtype), dla.contiguous(), dB.to(Bm.dtype),
            dC.to(Cm.dtype), dS)


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/ssd_scan.cu)
# ---------------------------------------------------------------------------
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    if lib.ssd_scan_fwd.argtypes is None:
        lib.ssd_scan_fwd.argtypes = [_P] * 8 + [_I] * 8 + [_P]
        lib.ssd_scan_fwd.restype = _I
        lib.ssd_scan_mma_fwd.argtypes = [_P] * 9 + [
            ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint] + [_I] * 7 + [_P]
        lib.ssd_scan_mma_fwd.restype = _I
        lib.ssd_scan_mma_attrs.argtypes = [ctypes.POINTER(_I)]
        lib.ssd_scan_mma_attrs.restype = _I
    return lib


def mma_attrs() -> Dict[str, int]:
    """The ``mma`` kernel's registers per thread, dynamic shared memory per
    block, resident blocks per SM and spill bytes per thread, as the
    driver reports them for the current card."""
    out = (_I * 4)()
    rc = _lib().ssd_scan_mma_attrs(out)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_mma_attrs: CUDA error {rc}")
    return dict(zip(("registers", "smem_bytes", "blocks_per_sm",
                     "spill_bytes"), out))


def grid_blocks(x, chunk) -> int:
    """Blocks of the launch the wrapper makes for ``x`` (B, S, H, P): one
    per (chunk, head, batch row) for bf16, one per (head, batch row) for
    f32."""
    Bsz, S, H, _ = x.shape
    chunks = -(-S // chunk) if x.dtype == torch.bfloat16 else 1
    return chunks * H * Bsz


class _Workspace:
    """The ``mma`` variant's workspace for one (device, stream), zeroed
    once and reused: int32 words [0, 64) hold the ticket, then one flag
    per (b, h), then from ``slots_at`` the two f32 state slots per (b, h).
    A call takes tickets [ticket, ticket + grid) and sequence numbers from
    ``seq`` (chunk c publishes seq + c + 1); both only grow, so a flag an
    earlier call left is never taken for this call's and nothing is
    cleared per call.  (A fresh allocation per call would hold arbitrary
    bytes: its ticket and flags would need a memset launch.)"""

    FLAGS_AT = 64
    SEQ_LIMIT = 1 << 30

    def __init__(self, device, bh, slot_floats):
        self.bh, self.slot_floats = bh, slot_floats
        self.slots_at = self.FLAGS_AT + -(-bh // 16) * 16   # 64-byte aligned
        self.buf = torch.zeros(self.slots_at + slot_floats,
                               dtype=torch.int32, device=device)
        self.ticket = self.seq = 0

    def fits(self, bh, slot_floats, n_chunks):
        return bh <= self.bh and slot_floats <= self.slot_floats \
            and self.seq + n_chunks < self.SEQ_LIMIT

    def take(self, n_blocks, n_chunks):
        """(ticket, seq) for one call, advanced past it."""
        ticket, seq = self.ticket, self.seq
        self.ticket = (ticket + n_blocks) & 0xFFFFFFFF
        self.seq = seq + n_chunks
        return ticket, seq


_workspaces: Dict[tuple, _Workspace] = {}


def _workspace(key, bh, slot_floats, n_chunks) -> _Workspace:
    """The workspace of ``key`` (device, stream); a larger call, or a
    sequence about to wrap, takes a fresh zeroed one."""
    ws = _workspaces.get(key)
    if ws is None or not ws.fits(bh, slot_floats, n_chunks):
        old = (0, 0) if ws is None else (ws.bh, ws.slot_floats)
        ws = _workspaces[key] = _Workspace(
            key[0], max(bh, old[0]), max(slot_floats, old[1]))
    return ws


def _check_cuda(x, la, Bm, Cm, chunk, initial_state):
    """Refuse anything the CUDA kernel does not take."""
    for name, t in (("x", x), ("la", la), ("Bm", Bm), ("Cm", Cm),
                    ("initial_state", initial_state)):
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"ssd scan: {name} must be contiguous")
        if t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"ssd scan: {name} must start on a 4-element "
                             "boundary (vector loads)")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"ssd scan: x dtype {x.dtype} not in (float32, "
                         "bfloat16)")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"ssd scan: Bm {Bm.dtype} and Cm {Cm.dtype} must "
                         f"have x's dtype {x.dtype}")
    if la.dtype != torch.float32:
        raise ValueError(f"ssd scan: la must be float32, got {la.dtype}")
    if initial_state is not None and initial_state.dtype != torch.float32:
        raise ValueError(f"ssd scan: initial_state must be float32, got "
                         f"{initial_state.dtype}")
    Bsz, S, H, P = x.shape
    N = Bm.shape[3]
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd scan: chunk {chunk} not in [1, {MAX_CHUNK}]")
    if P % 4 or not 4 <= P <= MAX_HEAD_DIM:
        raise ValueError(f"ssd scan: head dim P={P} must be a multiple of 4 "
                         f"in [4, {MAX_HEAD_DIM}]")
    if N % 4 or not 4 <= N <= MAX_STATE:
        raise ValueError(f"ssd scan: state dim N={N} must be a multiple of "
                         f"4 in [4, {MAX_STATE}]")
    if Bsz < 1 or S < 1 or Bsz > 65535:
        raise ValueError(f"ssd scan: batch {Bsz}, length {S}")


def _ssd_cuda(x, la, Bm, Cm, chunk, initial_state, chunk_states=False):
    _check_cuda(x, la, Bm, Cm, chunk, initial_state)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    variant = VARIANTS[x.dtype]
    y = torch.empty_like(x)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    init = None if initial_state is None else initial_state.data_ptr()
    cs = torch.empty((Bsz, -(-S // chunk), H, P, N), dtype=torch.float32,
                     device=x.device) if chunk_states else None
    cs_ptr = None if cs is None else cs.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if variant == "mma":
            n_chunks = -(-S // chunk)
            key = (x.device, stream)
            ws = _workspace(key, Bsz * H, 2 * Bsz * H * P * N, n_chunks)
            ticket, seq = ws.take(n_chunks * Bsz * H, n_chunks)
            rc = _lib().ssd_scan_mma_fwd(
                x.data_ptr(), la.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                init, y.data_ptr(), state.data_ptr(), cs_ptr,
                ws.buf.data_ptr(),
                ws.slots_at, ticket, seq, Bsz, S, H, P, G, N, chunk, stream)
            if rc != 0:                  # its ticket and flags are unknown
                _workspaces.pop(key, None)
        else:
            rc = _lib().ssd_scan_fwd(
                x.data_ptr(), la.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                init, y.data_ptr(), state.data_ptr(), cs_ptr,
                Bsz, S, H, P, G, N, chunk, _DTYPE_CODE[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan ({variant}): CUDA error {rc} "
                           f"({torch.cuda.get_device_name(x.device)})")
    LAUNCHES["ssd_scan"] += 1
    LAUNCHES[f"ssd_scan:{variant}"] += 1
    return (y, state, cs) if chunk_states else (y, state)


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan_bwd")
    if lib.ssd_scan_bwd.argtypes is None:
        lib.ssd_scan_bwd.argtypes = [_P] * 16 + [_I] * 8 + [_P]
        lib.ssd_scan_bwd.restype = _I
        lib.ssd_scan_bwd_smem_bytes.argtypes = []
        lib.ssd_scan_bwd_smem_bytes.restype = ctypes.c_size_t
        lib.ssd_scan_bwd_mma_attrs.argtypes = [ctypes.POINTER(_I)]
        lib.ssd_scan_bwd_mma_attrs.restype = _I
    return lib


def bwd_smem_bytes() -> int:
    """Dynamic shared memory of one block of the f32 backward's chunk
    kernel."""
    return int(_bwd_lib().ssd_scan_bwd_smem_bytes())


def bwd_mma_attrs() -> Dict[str, int]:
    """The bf16 backward's chunk kernel's registers per thread, dynamic
    shared memory per block, resident blocks per SM and spill bytes per
    thread, and the same of its inject kernel (``inject_*``), as the
    CUDA runtime reports them for the current card."""
    out = (_I * 8)()
    rc = _bwd_lib().ssd_scan_bwd_mma_attrs(out)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_bwd_mma_attrs: CUDA error {rc}")
    keys = ("registers", "smem_bytes", "blocks_per_sm", "spill_bytes")
    return {**dict(zip(keys, out[:4])),
            **{f"inject_{k}": v for k, v in zip(keys, out[4:])}}


def _ssd_bwd_cuda(x, la, Bm, Cm, dy, dstate, chunk, chunk_states):
    _check_cuda(x, la, Bm, Cm, chunk, None)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = -(-S // chunk)
    if Bsz * H > 65535:
        raise ValueError(f"ssd scan backward: batch x heads {Bsz * H} above "
                         "65535 (the chain kernel's grid)")
    if dy.dtype != x.dtype or not dy.is_contiguous() \
            or dy.data_ptr() % (4 * dy.element_size()):
        raise ValueError(f"ssd scan backward: dy must be x's dtype {x.dtype}, "
                         f"contiguous and 4-element aligned; got {dy.dtype}")
    for name, t, shape in (("dstate", dstate, (Bsz, H, P, N)),
                           ("chunk_states", chunk_states,
                            (Bsz, nc, H, P, N))):
        ok = t is not None and t.dtype == torch.float32 \
            and t.is_contiguous() and tuple(t.shape) == shape \
            and t.device == x.device
        if not ok and (t is not None or name == "chunk_states"):
            raise ValueError(f"ssd scan backward: {name} must be a "
                             f"contiguous f32 {shape} on {x.device} (the "
                             "forward's return_chunk_states for chunk_states)")
    dev, f32 = x.device, torch.float32
    dx = torch.empty_like(x)
    dla = torch.empty((Bsz, S, H), dtype=f32, device=dev)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dinit = torch.empty((Bsz, H, P, N), dtype=f32, device=dev)
    ds = torch.empty((Bsz, nc, H, P, N), dtype=f32, device=dev)
    decay = torch.empty((Bsz, nc, H), dtype=f32, device=dev)
    dBp = torch.empty((Bsz, S, H, N), dtype=f32, device=dev)
    dCp = torch.empty((Bsz, S, H, N), dtype=f32, device=dev)
    variant = BWD_VARIANTS[x.dtype]
    with torch.cuda.device(dev):
        rc = _bwd_lib().ssd_scan_bwd(
            x.data_ptr(), la.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            dy.data_ptr(), None if dstate is None else dstate.data_ptr(),
            chunk_states.data_ptr(), dx.data_ptr(), dla.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), dinit.data_ptr(), ds.data_ptr(),
            decay.data_ptr(), dBp.data_ptr(), dCp.data_ptr(),
            Bsz, S, H, P, G, N, chunk, _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_bwd ({variant}): CUDA error {rc} "
                           f"({torch.cuda.get_device_name(dev)})")
    LAUNCHES["ssd_scan_bwd"] += 1
    LAUNCHES[f"ssd_scan_bwd:{variant}"] += 1
    return dx, dla, dB, dC, dinit


# ---------------------------------------------------------------------------
# public wrapper
# ---------------------------------------------------------------------------
def ssd_scan_kernel(x, la, Bm, Cm, *, chunk=128, initial_state=None,
                    return_chunk_states=False):
    """Chunked SSD scan.  CPU tensors run ``ssd_scan_plain``; CUDA tensors
    the kernel (``mma`` for bf16, ``fma`` for f32).  Returns (y,
    final_state), and the states entering the chunks with
    ``return_chunk_states``."""
    _validate(x, la, Bm, Cm, chunk, initial_state)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, la, Bm, Cm, chunk=chunk,
                              initial_state=initial_state,
                              return_chunk_states=return_chunk_states)
    if x.device.type != "cuda":
        raise ValueError(f"ssd scan: no kernel for {x.device}")
    return _ssd_cuda(x, la, Bm, Cm, chunk, initial_state,
                     return_chunk_states)


def ssd_scan_bwd_kernel(x, la, Bm, Cm, dy, dstate, *, chunk=128,
                        initial_state=None, chunk_states=None):
    """(dx, dla, dB, dC, d_initial_state) of the scan at (dy, dstate;
    dstate None counts as zeros).  CPU tensors run ``ssd_scan_bwd_plain``
    (which recomputes the chunk states from ``initial_state``); CUDA
    tensors the backward kernels, which read the forward's
    ``chunk_states`` (the initial state is chunk 0's)."""
    _validate(x, la, Bm, Cm, chunk, initial_state)
    _validate_bwd(x, dy, dstate, (x.shape[0], x.shape[2], x.shape[3],
                                  Bm.shape[3]))
    if x.device.type == "cpu":
        return ssd_scan_bwd_plain(x, la, Bm, Cm, dy, dstate, chunk=chunk,
                                  initial_state=initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd scan backward: no kernel for {x.device}")
    return _ssd_bwd_cuda(x, la, Bm, Cm, dy, dstate, chunk, chunk_states)


class SSDScanFunction(torch.autograd.Function):
    """The SSD scan with its gradient: on CUDA tensors the forward kernel
    also writes the states entering the chunks, which the backward kernels
    read; CPU tensors run the plain versions both ways."""

    @staticmethod
    def forward(ctx, x, la, Bm, Cm, initial_state, chunk):
        on_card = x.device.type == "cuda"
        out = ssd_scan_kernel(x, la, Bm, Cm, chunk=chunk,
                              initial_state=initial_state,
                              return_chunk_states=on_card)
        y, state = out[:2]
        ctx.save_for_backward(x, la, Bm, Cm, initial_state,
                              out[2] if on_card else None)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, la, Bm, Cm, initial_state, chunk_states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dstate = None if dstate is None else dstate.contiguous()
        dx, dla, dB, dC, dinit = ssd_scan_bwd_kernel(
            x, la, Bm, Cm, dy, dstate, chunk=ctx.chunk,
            initial_state=initial_state, chunk_states=chunk_states)
        return (dx, dla, dB, dC,
                dinit if ctx.needs_input_grad[4] else None, None)


def ssd_scan_train(x, la, Bm, Cm, *, chunk=128, initial_state=None):
    """``ssd_scan_kernel`` with a gradient (``SSDScanFunction``)."""
    return SSDScanFunction.apply(x, la, Bm, Cm, initial_state, chunk)
