// The gradient of the Mamba-2 chunked SSD scan, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference trains Mamba-2 by autodiff of
// the jnp ssd_chunked (src/repro/models/ssm.py:88, a lax.scan over
// chunks), which XLA compiles; the port's forward is the hand-written scan
// (ssd_scan.cu), so its gradient is a kernel too.
//
// What it computes (per (b, h); chunks of Q positions, head h reads group
// g = h / (H / G)): with lc = cumsum(la) within a chunk, lt = lc[Q - 1],
// w_j = exp(lt - lc_j), L_ij = exp(lc_i - lc_j) for i >= j (selected to 0
// above the diagonal, never multiplied), M = (C B^T) o L, dM_ij = dy_i . x_j,
// S_{c-1} the state entering chunk c and dS_c the gradient of the state
// leaving it (dstate, or zeros, for the last chunk):
//   dS_{c-1} = exp(lt) dS_c + sum_i exp(lc_i) dy_i (x) C_i
//   dx_j     = sum_{i>=j} M_ij dy_i + w_j dS_c B_j
//   dC_i     = sum_{j<=i} dM_ij L_ij B_j + exp(lc_i) S_{c-1}^T dy_i
//   dB_j     = sum_{i>=j} dM_ij L_ij C_i + w_j dS_c^T x_j
//   dlc_i    = sum_j T_ij - sum_j T_ji + exp(lc_i) C_i . (S_{c-1}^T dy_i)
//              - w_i x_i . (dS_c B_i)  (+ <dS_c, S_c> at the last row),
//              T = M o dM;  dla = the reverse cumulative sum of dlc;
// dB and dC summed over the heads of a group; d(initial state) = dS_{-1}.
// Positions at or past S read as zeros and their gradients are dropped.
//
// Bound: at Mamba-2-2.7B's training shape (B 4, S 2048, H 80, P 64, G 1,
// N 128, chunk 128) the call must do about 97 GFLOP (the multiply-adds of
// the equations above, the chunk states recomputed) and move about 265 MB:
// operations bound it, 0.098 ms at the bf16 tensor-core peak (1.45 ms on
// the f32 FMA units).
//
// Shared by both types: the state gradient's chain is the only serial
// part, and it is cheap (P N multiply-adds a chunk), so it runs as its own
// small kernel between two chunk-parallel ones, and nothing hands a state
// from block to block inside a launch:
//   1. inject: one block per (chunk, head, row): U_c = sum_i exp(lc_i)
//      dy_i (x) C_i into a (B, n_chunks, H, P, N) f32 buffer, and the
//      chunk's decay exp(lt);
//   2. chain: one thread per (b, h, p, n) walks the chunks last-first,
//      replacing U_c by dS_c in place (dS_{c-1} = exp(lt) dS_c + U_c) and
//      writing d(initial state);
//   3. chunk: one block per (chunk, head, row): dx, dla, and dB and dC per
//      head in f32; dlc stays in shared memory, and one warp takes its
//      reverse cumulative sum;
//   4. group sum: dB and dC summed over the heads of each group in head
//      order, rounded once to the inputs' type.
// No atomics anywhere: two gradients of one batch are equal bit for bit.
// la_cum is built as the forward's tensor-core kernel builds it, as
// compensated hi + lo sums (dla sums terms of exponentials of differences
// of la_cum that cancel).
//
// bf16 (namespace ssd_bwd_mma): the inject and chunk kernels on the tensor
// cores, after ssd_scan.cu's ssd_mma.  4 warps a block; x, dy, B and C as
// bf16 by cp.async at padded strides (x and dy 128 x 72, B and C 128 x
// 136: ldmatrix rows on distinct bank groups), zeros past the chunk and
// past P and N (8-byte copies where P or N is not a multiple of 8); every
// product on mma.sync m16n8k16 with f32 sums.  The bf16 sides (C B^T, dy
// x^T, and B, x, dy and C against anything) are exact; the f32 operands M
// = (C B^T) o L and D = dM o L (from the accumulators into A fragments),
// S_{c-1}, dS_c and the inject's dy o exp(lc) go in as hi + lo bf16 terms
// into one accumulator (16 bits; one term alone spends a fifth of the
// 2**-7 gate, tests/test_torch_ssd_bwd_numerics.py); w_j and exp(lc_i)
// scale in f32 after the products; L is 2^((lc_i - lc_j) log2 e) by
// ex2.approx of the compensated la_cum, selected to 0 above the diagonal.
// The chunk kernel's warp w owns row tiles w and 7 - w (16 rows: dC, T's
// row sums, the y_inter term) and key tiles 7 - w and w (dx, dB, T's
// column sums, the w terms), so the causal work is even; the states take
// the tile of the operand they replace, as the forward's S_{c-1} does:
//   R1  tile w: scores and dM 16 keys at a time, D B into dC [x dy B C]
//   R2  S_{c-1} (hi + lo) into B's tile; tile w's dC += exp(lc) o (dy
//       S_{c-1}), written; tile 7 - w's begun                [x dy S C]
//   R3  B again (from L2: every head of a group reads it); tile 7 - w's D
//       B, written; then C1: key tile 7 - w, M^T dy into dx and D^T C
//       into dB, 16 rows at a time                           [x dy B C]
//   C2  dS_c (hi + lo) into C's tile, <dS_c, S_{c-1}> on the way; key
//       tile 7 - w's w_j (B dS^T) and w_j (x dS), written; key tile w's
//       begun                                                [x dy B dS]
//   C3  C again; key tile w's M^T dy and D^T C, written      [x dy B C]
// Each side builds the score and dM strips of its own tiles: about 37%
// more in-chunk products than building them once, but staging M and D
// (128 x 128, hi + lo: 64 KB) beside the 104 KB of tiles would leave one
// block an SM.  Shared memory 110 096 B a block, 255 registers, no spills
// (ptxas), 2 blocks (8 warps) an SM; the inject kernel 55 296 B, 94
// registers, 4 blocks an SM.
//
// f32 (the anonymous namespace): the FMA kernels, which took bf16 too
// before the tensor-core path (TF32 would miss the 1e-4 gate).  The chunk
// kernel: 256 threads, 198 KB of f32 tiles, one block an SM, a row pass
// (dC, T's row sums, the y_inter term) and a column pass (dx, dB, T's
// column sums, the w term) of 32-wide tiles, each building its own scores
// and dM; 1.38 ms at S 1000 with a state and dstate.
//
// What holds it back (NVIDIA H100 80GB HBM3, 700.00 W; the shape above,
// bf16): 1.39 ms (on the FMA kernels: 10.5): chunk 0.83, group sum 0.23,
// chain 0.12, inject 0.12.  The design moves ~2.5 GB of device memory (U
// and dS through the chain, the chunk states, the f32 per-head dB and dC
// partials, 0.67 GB written and read again by the group sum): 0.75 ms at
// 3.35 TB/s, 8x the operations' bound.  The chunk kernel runs at ~45% of
// the memory rate and a third of mma.sync's: its five phases wait at
// barriers for loads from L2 (S_{c-1} and dS_c as f32, B and C again),
// with two blocks an SM to hide them.

// Plain C interface (loaded with ctypes); the launches are on the caller's
// stream, allocate nothing and return the first cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

constexpr int kMaxQ = 128;             // chunk length
constexpr int kMaxP = 64;              // head dim
constexpr int kMaxN = 128;             // state dim
constexpr int kThreads = 256;          // 16 x 16: tx = threadIdx.x % 16, ty = / 16
constexpr int kTile = 32;              // rows (row pass) or columns (column pass) a tile
constexpr int kNS = kMaxN + 4;         // f32 row strides (float4 rows on distinct banks)
constexpr int kPS = kMaxP + 4;
constexpr int kQS = kMaxQ + 4;

static_assert(kThreads == 256 && kTile == 2 * 16, "each thread owns two rows of a tile");
static_assert(kMaxQ == 16 * 8 && kMaxP == 16 * 4 && kMaxN == 16 * 8, "thread tiles");

// kernel 3's shared memory, in floats
constexpr int kOffFa = 0;                          // kMaxQ x kNS: B, then C
constexpr int kOffXa = kOffFa + kMaxQ * kNS;       // kMaxQ x kPS: x, then dy
constexpr int kOffFt = kOffXa + kMaxQ * kPS;       // kTile x kNS: C rows, then B rows
constexpr int kOffXt = kOffFt + kTile * kNS;       // kTile x kPS: dy rows, then x rows
constexpr int kOffSt = kOffXt + kTile * kPS;       // kMaxP x kNS: S_{c-1}, then dS_c
constexpr int kOffM1 = kOffSt + kMaxP * kNS;       // kTile x kQS: dM o L rows, then M^T
constexpr int kOffM2 = kOffM1 + kTile * kQS;       // kTile x kQS: (dM o L)^T
constexpr int kOffVec = kOffM2 + kTile * kQS;      // cum, cuml, ecum, w, dlc, wt: 6 x kMaxQ
constexpr int kOffRed = kOffVec + 6 * kMaxQ;       // 8 warp partials, the <dS, S> sum
constexpr size_t kChunkSmem = size_t(kOffRed + 16) * sizeof(float);
// kernel 1's: dy (kMaxQ x kPS), C (kMaxQ x kNS), cum, cuml, ecum, w
constexpr size_t kInjectSmem = size_t(kMaxQ * kPS + kMaxQ * kNS + 4 * kMaxQ) * sizeof(float);
static_assert(kChunkSmem <= 232448, "a block's shared memory");

struct Shape {
  int B, S, H, P, G, N, Q, nc;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = __fmaf_rn(a.x, b.x, acc);
  acc = __fmaf_rn(a.y, b.y, acc);
  acc = __fmaf_rn(a.z, b.z, acc);
  return __fmaf_rn(a.w, b.w, acc);
}

// sum over the 16 threads of a half-warp (one ty, tx = 0..15)
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows [row0, row0 + ROWS) of head or group hx of a (B, S, Hx, width)
// tensor into an f32 tile of kMax columns (row stride `stride`): rows at or
// past n_valid, and columns at or past width, are zeros.
template <int ROWS, int KMAX, typename T>
__device__ __forceinline__ void load_rows(float* __restrict__ dst, int stride,
                                          const T* __restrict__ src, int64_t row0,
                                          int n_valid, int Hx, int hx, int width) {
  constexpr int kPer = KMAX / 4;
  for (int idx = threadIdx.x; idx < ROWS * kPer; idx += kThreads) {
    const int r = idx / kPer;
    const int c = (idx - r * kPer) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid && c < width)
      v = load4(src + ((row0 + r) * Hx + hx) * static_cast<int64_t>(width) + c);
    *reinterpret_cast<float4*>(dst + r * stride + c) = v;
  }
}

// a + b = s + e exactly (two-sum; explicit roundings, nothing contracted)
__device__ __forceinline__ float two_sum(float a, float b, float& e) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
  return s;
}

__device__ __forceinline__ void dd_add(float& ah, float& al, float bh, float bl) {
  float e;
  const float s = two_sum(ah, bh, e);
  e = __fadd_rn(e, __fadd_rn(al, bl));
  ah = __fadd_rn(s, e);
  al = __fsub_rn(e, __fsub_rn(ah, s));
}

// Warp 0: la_cum of the chunk's kMaxQ positions (zeros past `rows`) as
// hi + lo, exp(la_cum) and w = exp(la_tot - la_cum), as the forward's
// tensor-core kernel computes them (ssd_scan.cu, steps (b) and (e)).
// Returns the chunk's decay exp(la_tot) on every lane.
__device__ __forceinline__ float la_cum_warp(const float* __restrict__ la, int64_t row0,
                                             int rows, int H, int h, float* cum, float* cuml,
                                             float* ecum, float* w) {
  const int lane = threadIdx.x & 31;
  float lav[4], vh[4], vl[4], rh = 0.f, rl = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = lane * 4 + k;
    lav[k] = i < rows ? la[(row0 + i) * H + h] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    dd_add(rh, rl, lav[k], 0.f);
    vh[k] = rh;
    vl[k] = rl;
  }
  float ih = rh, il = rl;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    float oh = __shfl_up_sync(0xffffffffu, ih, off);
    float ol = __shfl_up_sync(0xffffffffu, il, off);
    if (lane >= off) {
      dd_add(oh, ol, ih, il);
      ih = oh;
      il = ol;
    }
  }
  float eh = __shfl_up_sync(0xffffffffu, ih, 1);
  float el = __shfl_up_sync(0xffffffffu, il, 1);
  if (lane == 0) eh = el = 0.f;
  const float th = __shfl_sync(0xffffffffu, ih, 31);
  const float tl = __shfl_sync(0xffffffffu, il, 31);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = lane * 4 + k;
    float sh = eh, sl = el;
    dd_add(sh, sl, vh[k], vl[k]);
    cum[i] = sh;
    cuml[i] = sl;
    ecum[i] = expf(sh + sl);
    w[i] = expf((th - sh) + (tl - sl));
  }
  __syncwarp();                            // the forward's decay: from la_cum[kMaxQ - 1]
  return expf(cum[kMaxQ - 1] + cuml[kMaxQ - 1]);
}

__device__ __forceinline__ int64_t chunk_off(const Shape& P, int b, int c, int h) {
  return ((static_cast<int64_t>(b) * P.nc + c) * P.H + h) * P.P * P.N;
}

// 1. U_c = sum_i exp(lc_i) dy_i (x) C_i and exp(lt), per (chunk, head, row)
__global__ void __launch_bounds__(kThreads)
ssd_bwd_inject_kernel(const float* __restrict__ la, const float* __restrict__ Cm,
                      const float* __restrict__ dy, float* __restrict__ inj,
                      float* __restrict__ decay, Shape P) {
  extern __shared__ float4 smem_raw[];
  float* dy_s = reinterpret_cast<float*>(smem_raw);
  float* C_s = dy_s + kMaxQ * kPS;
  float* cum = C_s + kMaxQ * kNS;
  float* cuml = cum + kMaxQ;
  float* ecum = cuml + kMaxQ;
  float* w = ecum + kMaxQ;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (P.H / P.G);
  const int rows = min(P.Q, P.S - c * P.Q);
  const int64_t row0 = static_cast<int64_t>(b) * P.S + static_cast<int64_t>(c) * P.Q;
  load_rows<kMaxQ, kMaxP>(dy_s, kPS, dy, row0, rows, P.H, h, P.P);
  load_rows<kMaxQ, kMaxN>(C_s, kNS, Cm, row0, rows, P.G, g, P.N);
  if (threadIdx.x < 32) {
    const float d = la_cum_warp(la, row0, rows, P.H, h, cum, cuml, ecum, w);
    if (threadIdx.x == 0) decay[(static_cast<int64_t>(b) * P.nc + c) * P.H + h] = d;
  }
  __syncthreads();
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) acc[a][cc] = 0.f;
  for (int i = 0; i < rows; ++i) {
    const float e = ecum[i];
    const float4 d = load4(dy_s + i * kPS + ty * 4);
    const float de[4] = {d.x * e, d.y * e, d.z * e, d.w * e};
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) {
      const float cv = C_s[i * kNS + tx + 16 * cc];
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[a][cc] = __fmaf_rn(de[a], cv, acc[a][cc]);
    }
  }
  float* dst = inj + chunk_off(P, b, c, h);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int p = ty * 4 + a;
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) {
      const int n = tx + 16 * cc;
      if (p < P.P && n < P.N) dst[p * P.N + n] = acc[a][cc];
    }
  }
}

// 2. the state gradient's chain, last chunk first; dS_c replaces U_c.  The
// loads of kAhead chunks are issued before their multiply-adds, so the
// chain waits on memory once per kAhead chunks, not once per chunk.
constexpr int kAhead = 8;

__global__ void __launch_bounds__(kThreads)
ssd_bwd_chain_kernel(float* __restrict__ ds, const float* __restrict__ decay,
                     const float* __restrict__ dstate, float* __restrict__ dinit, Shape P) {
  const int pn = P.P * P.N;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= pn) return;
  const int bh = blockIdx.y;
  const int b = bh / P.H, h = bh - b * P.H;
  float carry = dstate ? dstate[static_cast<int64_t>(bh) * pn + idx] : 0.f;
  for (int top = P.nc - 1; top >= 0; top -= kAhead) {
    float u[kAhead], d[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = top - k;
      u[k] = c >= 0 ? ds[chunk_off(P, b, c, h) + idx] : 0.f;
      d[k] = c >= 0 ? decay[(static_cast<int64_t>(b) * P.nc + c) * P.H + h] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = top - k;
      if (c < 0) break;
      ds[chunk_off(P, b, c, h) + idx] = carry;
      carry = __fmaf_rn(d[k], carry, u[k]);
    }
  }
  dinit[static_cast<int64_t>(bh) * pn + idx] = carry;
}

// 3. everything else of a chunk
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ la,
                     const float* __restrict__ Bm, const float* __restrict__ Cm,
                     const float* __restrict__ dy, const float* __restrict__ chunk_states,
                     const float* __restrict__ ds, float* __restrict__ dx,
                     float* __restrict__ dla, float* __restrict__ dBp,
                     float* __restrict__ dCp, Shape P) {
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* Fa = sm + kOffFa;
  float* Xa = sm + kOffXa;
  float* Ft = sm + kOffFt;
  float* Xt = sm + kOffXt;
  float* St = sm + kOffSt;
  float* M1 = sm + kOffM1;
  float* M2 = sm + kOffM2;
  float* cum = sm + kOffVec;
  float* cuml = cum + kMaxQ;
  float* ecum = cuml + kMaxQ;
  float* w = ecum + kMaxQ;
  float* dlc = w + kMaxQ;
  float* wt = dlc + kMaxQ;
  float* red = sm + kOffRed;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (P.H / P.G);
  const int rows = min(P.Q, P.S - c * P.Q);
  const int64_t row0 = static_cast<int64_t>(b) * P.S + static_cast<int64_t>(c) * P.Q;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t soff = chunk_off(P, b, c, h);

  // ---- row pass: B and x whole, S_{c-1} ---------------------------------
  load_rows<kMaxQ, kMaxN>(Fa, kNS, Bm, row0, rows, P.G, g, P.N);
  load_rows<kMaxQ, kMaxP>(Xa, kPS, x, row0, rows, P.H, h, P.P);
  for (int idx = threadIdx.x; idx < kMaxP * kMaxN; idx += kThreads) {
    const int p = idx / kMaxN, n = idx - p * kMaxN;
    St[p * kNS + n] = p < P.P && n < P.N ? chunk_states[soff + p * P.N + n] : 0.f;
  }
  for (int i = threadIdx.x; i < kMaxQ; i += kThreads) dlc[i] = wt[i] = 0.f;
  float decay = 0.f;
  if (warp == 0) decay = la_cum_warp(la, row0, rows, P.H, h, cum, cuml, ecum, w);

  for (int i0 = 0; i0 < rows; i0 += kTile) {
    load_rows<kTile, kMaxN>(Ft, kNS, Cm, row0 + i0, rows - i0, P.G, g, P.N);
    load_rows<kTile, kMaxP>(Xt, kPS, dy, row0 + i0, rows - i0, P.H, h, P.P);
    __syncthreads();
    const int jmax = min(rows, i0 + kTile);          // keys past it are masked
    // sc = C_i . B_j, dm = dy_i . x_j: rows i0 + 2 ty + a, keys tx + 16 cc
    float sc[2][8], dm[2][8];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) sc[a][cc] = dm[a][cc] = 0.f;
    for (int n = 0; n < P.N; n += 4) {
      const float4 c0 = load4(Ft + (2 * ty) * kNS + n);
      const float4 c1 = load4(Ft + (2 * ty + 1) * kNS + n);
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        if (tx + 16 * cc >= jmax) continue;
        const float4 bv = load4(Fa + (tx + 16 * cc) * kNS + n);
        sc[0][cc] = dot4(c0, bv, sc[0][cc]);
        sc[1][cc] = dot4(c1, bv, sc[1][cc]);
      }
    }
    for (int p = 0; p < P.P; p += 4) {
      const float4 d0 = load4(Xt + (2 * ty) * kPS + p);
      const float4 d1 = load4(Xt + (2 * ty + 1) * kPS + p);
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        if (tx + 16 * cc >= jmax) continue;
        const float4 xv = load4(Xa + (tx + 16 * cc) * kPS + p);
        dm[0][cc] = dot4(d0, xv, dm[0][cc]);
        dm[1][cc] = dot4(d1, xv, dm[1][cc]);
      }
    }
    // D = dM o L into M1's rows; T's row sums
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int i = i0 + 2 * ty + a;
      float trow = 0.f;
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int j = tx + 16 * cc;
        const bool keep = j <= i && i < rows;
        float d = 0.f;
        if (keep) {
          const float L = expf((cum[i] - cum[j]) + (cuml[i] - cuml[j]));
          d = dm[a][cc] * L;
          trow = __fmaf_rn(sc[a][cc], d, trow);
        }
        M1[(2 * ty + a) * kQS + j] = d;
      }
      trow = sum16(trow);
      if (tx == 0 && i < rows) dlc[i] += trow;
    }
    __syncthreads();
    // dC rows: (dM o L) B + exp(lc_i) S_{c-1}^T dy_i; rows 2 ty + a, n = tx + 16 cc
    float acc[2][8], v[2][8];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) acc[a][cc] = v[a][cc] = 0.f;
    for (int j = 0; j < jmax; ++j) {
      const float d0 = M1[(2 * ty) * kQS + j], d1 = M1[(2 * ty + 1) * kQS + j];
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const float bv = Fa[j * kNS + tx + 16 * cc];
        acc[0][cc] = __fmaf_rn(d0, bv, acc[0][cc]);
        acc[1][cc] = __fmaf_rn(d1, bv, acc[1][cc]);
      }
    }
    for (int p = 0; p < P.P; ++p) {
      const float y0 = Xt[(2 * ty) * kPS + p], y1 = Xt[(2 * ty + 1) * kPS + p];
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const float s = St[p * kNS + tx + 16 * cc];
        v[0][cc] = __fmaf_rn(y0, s, v[0][cc]);
        v[1][cc] = __fmaf_rn(y1, s, v[1][cc]);
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int i = i0 + 2 * ty + a;
      const float ec = i < rows ? ecum[i] : 0.f;
      float yint = 0.f;
      float* dst = dCp + ((row0 + i) * P.H + h) * static_cast<int64_t>(P.N);
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int n = tx + 16 * cc;
        yint = __fmaf_rn(Ft[(2 * ty + a) * kNS + n], v[a][cc], yint);
        if (i < rows && n < P.N) dst[n] = __fmaf_rn(ec, v[a][cc], acc[a][cc]);
      }
      yint = sum16(yint);
      if (tx == 0 && i < rows) dlc[i] = __fmaf_rn(ec, yint, dlc[i]);
    }
    __syncthreads();                       // before the next tile's loads
  }

  // ---- column pass: C and dy whole, dS_c ---------------------------------
  load_rows<kMaxQ, kMaxN>(Fa, kNS, Cm, row0, rows, P.G, g, P.N);
  load_rows<kMaxQ, kMaxP>(Xa, kPS, dy, row0, rows, P.H, h, P.P);
  float sdot = 0.f;                        // <dS_c, S_{c-1}>
  for (int idx = threadIdx.x; idx < kMaxP * kMaxN; idx += kThreads) {
    const int p = idx / kMaxN, n = idx - p * kMaxN;
    float d = 0.f;
    if (p < P.P && n < P.N) {
      d = ds[soff + p * P.N + n];
      sdot = __fmaf_rn(d, chunk_states[soff + p * P.N + n], sdot);
    }
    St[p * kNS + n] = d;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sdot += __shfl_xor_sync(0xffffffffu, sdot, off);
  if (lane == 0) red[warp] = sdot;

  for (int j0 = 0; j0 < rows; j0 += kTile) {
    load_rows<kTile, kMaxN>(Ft, kNS, Bm, row0 + j0, rows - j0, P.G, g, P.N);
    load_rows<kTile, kMaxP>(Xt, kPS, x, row0 + j0, rows - j0, P.H, h, P.P);
    __syncthreads();
    // keys j0 + 2 ty + a, rows i = tx + 16 cc at or past j0
    float sc[2][8], dm[2][8];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) sc[a][cc] = dm[a][cc] = 0.f;
    for (int n = 0; n < P.N; n += 4) {
      const float4 b0 = load4(Ft + (2 * ty) * kNS + n);
      const float4 b1 = load4(Ft + (2 * ty + 1) * kNS + n);
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int i = tx + 16 * cc;
        if (i < j0 || i >= rows) continue;
        const float4 cv = load4(Fa + i * kNS + n);
        sc[0][cc] = dot4(cv, b0, sc[0][cc]);
        sc[1][cc] = dot4(cv, b1, sc[1][cc]);
      }
    }
    for (int p = 0; p < P.P; p += 4) {
      const float4 x0 = load4(Xt + (2 * ty) * kPS + p);
      const float4 x1 = load4(Xt + (2 * ty + 1) * kPS + p);
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int i = tx + 16 * cc;
        if (i < j0 || i >= rows) continue;
        const float4 yv = load4(Xa + i * kPS + p);
        dm[0][cc] = dot4(yv, x0, dm[0][cc]);
        dm[1][cc] = dot4(yv, x1, dm[1][cc]);
      }
    }
    // M^T into M1, (dM o L)^T into M2; T's column sums
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int j = j0 + 2 * ty + a;
      float tcol = 0.f;
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int i = tx + 16 * cc;
        const bool keep = i >= j && i < rows;
        float m = 0.f, d = 0.f;
        if (keep) {
          const float L = expf((cum[i] - cum[j]) + (cuml[i] - cuml[j]));
          m = sc[a][cc] * L;
          d = dm[a][cc] * L;
          tcol = __fmaf_rn(m, dm[a][cc], tcol);
        }
        M1[(2 * ty + a) * kQS + i] = m;
        M2[(2 * ty + a) * kQS + i] = d;
      }
      tcol = sum16(tcol);
      if (tx == 0 && j < rows) dlc[j] -= tcol;
    }
    __syncthreads();
    // dx_j = sum_i M_ij dy_i + w_j dS_c B_j; keys 2 ty + a, p = tx + 16 e
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = 2 * ty + a, j = j0 + r;
      float acc[4] = {0.f, 0.f, 0.f, 0.f}, u[4] = {0.f, 0.f, 0.f, 0.f};
      for (int i = j0; i < rows; ++i) {
        const float m = M1[r * kQS + i];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] = __fmaf_rn(m, Xa[i * kPS + tx + 16 * e], acc[e]);
      }
      for (int n = 0; n < P.N; n += 4) {
        const float4 bv = load4(Ft + r * kNS + n);
#pragma unroll
        for (int e = 0; e < 4; ++e) u[e] = dot4(load4(St + (tx + 16 * e) * kNS + n), bv, u[e]);
      }
      const float wj = j < rows ? w[j] : 0.f;
      float wterm = 0.f;
      float* dst = dx + ((row0 + j) * P.H + h) * static_cast<int64_t>(P.P);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = tx + 16 * e;
        wterm = __fmaf_rn(Xt[r * kPS + p], u[e], wterm);
        if (j < rows && p < P.P) store1(dst + p, __fmaf_rn(wj, u[e], acc[e]));
      }
      wterm = sum16(wterm) * wj;
      if (tx == 0 && j < rows) {
        dlc[j] -= wterm;
        wt[j] = wterm;
      }
    }
    // dB_j = sum_i (dM o L)_ij C_i + w_j dS_c^T x_j; keys 2 ty + a, n = tx + 16 cc
    float acc[2][8], z[2][8];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) acc[a][cc] = z[a][cc] = 0.f;
    for (int i = j0; i < rows; ++i) {
      const float d0 = M2[(2 * ty) * kQS + i], d1 = M2[(2 * ty + 1) * kQS + i];
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const float cv = Fa[i * kNS + tx + 16 * cc];
        acc[0][cc] = __fmaf_rn(d0, cv, acc[0][cc]);
        acc[1][cc] = __fmaf_rn(d1, cv, acc[1][cc]);
      }
    }
    for (int p = 0; p < P.P; ++p) {
      const float x0 = Xt[(2 * ty) * kPS + p], x1 = Xt[(2 * ty + 1) * kPS + p];
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const float s = St[p * kNS + tx + 16 * cc];
        z[0][cc] = __fmaf_rn(x0, s, z[0][cc]);
        z[1][cc] = __fmaf_rn(x1, s, z[1][cc]);
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int j = j0 + 2 * ty + a;
      if (j >= rows) continue;
      const float wj = w[j];
      float* dst = dBp + ((row0 + j) * P.H + h) * static_cast<int64_t>(P.N);
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int n = tx + 16 * cc;
        if (n < P.N) dst[n] = __fmaf_rn(wj, z[a][cc], acc[a][cc]);
      }
    }
    __syncthreads();                       // before the next tile's loads
  }

  // ---- <dS_c, S_c> at the last row, then dla = reverse cumsum of dlc -----
  if (warp == 0) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) s += wt[lane * 4 + k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    float sd = lane < kThreads / 32 ? red[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sd += __shfl_xor_sync(0xffffffffu, sd, off);
    // lane 0 holds decay from la_cum_warp (every lane does)
    if (lane == 0) dlc[rows - 1] += __fmaf_rn(decay, sd, s);
    __syncwarp();
    float vv[4], tot = 0.f;
#pragma unroll
    for (int k = 3; k >= 0; --k) {
      const int i = lane * 4 + k;
      tot += i < rows ? dlc[i] : 0.f;
      vv[k] = tot;                         // suffix sum within the lane
    }
    float incl = tot;                      // suffix sum over lanes >= lane
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += o;
    }
    const float after = incl - tot;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = lane * 4 + k;
      if (i < rows) dla[(row0 + i) * P.H + h] = vv[k] + after;
    }
  }
}

// 4. dB and dC over the heads of each group, in head order
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_group_sum_kernel(const float* __restrict__ dBp, const float* __restrict__ dCp,
                         T* __restrict__ dB, T* __restrict__ dC, Shape P) {
  const int64_t total = static_cast<int64_t>(P.B) * P.S * P.G * P.N;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const float* src = blockIdx.y == 0 ? dBp : dCp;
  T* dst = blockIdx.y == 0 ? dB : dC;
  const int rep = P.H / P.G;
  const int n = static_cast<int>(idx % P.N);
  const int64_t sg = idx / P.N;                    // (b, s) * G + g
  const int g = static_cast<int>(sg % P.G);
  const int64_t bs = sg / P.G;
  const float* s = src + (bs * P.H + static_cast<int64_t>(g) * rep) * P.N + n;
  float acc = 0.f;
  for (int k = 0; k < rep; ++k) acc += s[static_cast<int64_t>(k) * P.N];
  store1(dst + idx, acc);
}

int configure() {
  static bool done = false;                // opt in to > 48 KiB once
  if (!done) {
    cudaError_t err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(kChunkSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(ssd_bwd_inject_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kInjectSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    done = true;
  }
  return 0;
}

int launch(const void* x, const float* la, const void* Bm, const void* Cm, const void* dy,
           const float* dstate, const float* chunk_states, void* dx, float* dla, void* dB,
           void* dC, float* dinit, float* ds, float* decay, float* dBp, float* dCp,
           const Shape& P, cudaStream_t st) {
  int rc = configure();
  if (rc) return rc;
  const float* xt = static_cast<const float*>(x);
  const float* bt = static_cast<const float*>(Bm);
  const float* ct = static_cast<const float*>(Cm);
  const float* dyt = static_cast<const float*>(dy);
  const dim3 chunks(P.nc, P.H, P.B);
  ssd_bwd_inject_kernel<<<chunks, kThreads, kInjectSmem, st>>>(la, ct, dyt, ds, decay, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 chain((P.P * P.N + kThreads - 1) / kThreads, P.B * P.H);
  ssd_bwd_chain_kernel<<<chain, kThreads, 0, st>>>(ds, decay, dstate, dinit, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk_kernel<<<chunks, kThreads, kChunkSmem, st>>>(
      xt, la, bt, ct, dyt, chunk_states, ds, static_cast<float*>(dx), dla, dBp, dCp, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(P.B) * P.S * P.G * P.N;
  const dim3 sums(static_cast<unsigned>((total + kThreads - 1) / kThreads), 2);
  ssd_bwd_group_sum_kernel<float><<<sums, kThreads, 0, st>>>(
      dBp, dCp, static_cast<float*>(dB), static_cast<float*>(dC), P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16: the inject and chunk kernels on the tensor cores
// ---------------------------------------------------------------------------
namespace ssd_bwd_mma {

using bf16 = __nv_bfloat16;
using attn_tile::ldmatrix_x4;
using attn_tile::ldmatrix_x4_trans;
using attn_tile::mma_bf16;
using attn_tile::split_pair;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kQ = 128;                    // chunk tile: rows and keys
constexpr int kP = 64;                     // head-dim tile
constexpr int kN = 128;                    // state-dim tile
constexpr int kXS = kP + 8;                // bf16 row strides (144 and 272 bytes:
constexpr int kBS = kN + 8;                // ldmatrix rows hit distinct bank groups)
constexpr size_t kXBytes = size_t(kQ) * kXS * sizeof(bf16);
constexpr size_t kBBytes = size_t(kQ) * kBS * sizeof(bf16);
// x, dy, B, C; then cum, cuml, ecum, w, the row side's and the column
// side's dlc parts, the w terms; then 4 warps' <dS_c, S_{c-1}>
constexpr int kVecs = 7;
constexpr size_t kChunkSmem = 2 * kXBytes + 2 * kBBytes + (kVecs * kQ + kWarps) * sizeof(float);
// dy, C; cum, cuml, ecum, w
constexpr size_t kInjectSmem = kXBytes + kBBytes + 4 * kQ * sizeof(float);
constexpr int kBatch = 8;                  // float4 loads a thread keeps in flight
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kQ == 16 * 2 * kWarps, "each warp owns two 16-row tiles a side");
static_assert(kP == 16 * kWarps, "inject: each warp owns 16 rows of P");
static_assert(2 * kP * kBS * sizeof(bf16) == kBBytes, "a state's hi + lo fill a B or C tile");
static_assert(kChunkSmem <= 113 * 1024, "two blocks an SM");

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   attn_tile::smem_u32(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

// Rows [row0, row0 + kQ) of head or group hx of a (rows, Hx, width) bf16
// tensor into a kQ x W tile of row stride `stride`, in copies of STEP
// elements (16 bytes need width % 8 == 0, 8 bytes width % 4 == 0); rows at
// or past `rows` and columns at or past `width` are zeros (ssd_scan.cu's,
// unrolled by 4: unrolled whole, the 32 copies a row of 8-byte ones took
// the registers that the chunk kernel's accumulators needed, and spilled).
template <int W, int STEP>
__device__ __forceinline__ void load_tile(bf16* dst, int stride, const bf16* src,
                                          int64_t row0, int rows, int Hx, int hx,
                                          int width) {
  constexpr int kPer = W / STEP;
  constexpr int kRowStep = kThreads / kPer;
  static_assert(kThreads % kPer == 0 && kQ % kRowStep == 0, "copy layout");
  const int col = (threadIdx.x % kPer) * STEP;
  const int r0 = threadIdx.x / kPer;
  const int64_t pitch = static_cast<int64_t>(Hx) * width;
  const bf16* s = src + (row0 + r0) * pitch + static_cast<int64_t>(hx) * width + col;
  bf16* d = dst + r0 * stride + col;
#pragma unroll 4
  for (int k = 0; k < kQ / kRowStep; ++k) {
    const bool ok = col < width && r0 + k * kRowStep < rows;
    if (STEP == 8)
      attn_tile::cp_async16(d, ok ? s : src, ok);
    else
      cp_async8(d, ok ? s : src, ok);
    s += kRowStep * pitch;
    d += kRowStep * stride;
  }
}

// The (P, N) f32 state at src as hi + lo bf16 tiles (kP x kN, row stride
// kBS, zeros past P and N).  With DOT, also this thread's part of <state,
// other>.  Each thread issues kBatch loads (of each) before their stores.
template <bool DOT>
__device__ __forceinline__ float load_state(bf16* hi, bf16* lo, const float* __restrict__ src,
                                            const float* __restrict__ other, int P, int N) {
  constexpr int kPerRow = kN / 4;
  constexpr int kPer = kP * kPerRow / kThreads;
  static_assert(kPer % kBatch == 0, "whole batches");
  float dot = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < kPer; k0 += kBatch) {
    float4 v[kBatch], o[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int idx = threadIdx.x + (k0 + k) * kThreads;
      const int p = idx / kPerRow, n = (idx - p * kPerRow) * 4;
      const bool ok = p < P && n < N;
      v[k] = o[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok) v[k] = __ldcg(reinterpret_cast<const float4*>(src + p * N + n));
      if (DOT && ok) o[k] = __ldcg(reinterpret_cast<const float4*>(other + p * N + n));
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int idx = threadIdx.x + (k0 + k) * kThreads;
      const int p = idx / kPerRow, n = (idx - p * kPerRow) * 4;
      uint2 h, l;
      split_pair(v[k].x, v[k].y, h.x, l.x);
      split_pair(v[k].z, v[k].w, h.y, l.y);
      *reinterpret_cast<uint2*>(hi + p * kBS + n) = h;
      *reinterpret_cast<uint2*>(lo + p * kBS + n) = l;
      if (DOT) {
        dot = __fmaf_rn(v[k].x, o[k].x, dot);
        dot = __fmaf_rn(v[k].y, o[k].y, dot);
        dot = __fmaf_rn(v[k].z, o[k].z, dot);
        dot = __fmaf_rn(v[k].w, o[k].w, dot);
      }
    }
  }
  return dot;
}

// The sum over the four lanes of a quad (the lanes that hold one row of an
// accumulator tile)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// two f32 accumulator tiles (16 x 8 each, keys 0-7 and 8-15) as the hi and
// lo A fragments of one k16 product (attention_tile.cuh's P.V reuse)
__device__ __forceinline__ void to_a(const float (&s)[2][4], uint32_t (&ah)[4], uint32_t (&al)[4]) {
  split_pair(s[0][0], s[0][1], ah[0], al[0]);     // row g,     keys 0-7
  split_pair(s[0][2], s[0][3], ah[1], al[1]);     // row g + 8, keys 0-7
  split_pair(s[1][0], s[1][1], ah[2], al[2]);     // row g,     keys 8-15
  split_pair(s[1][2], s[1][3], ah[3], al[3]);     // row g + 8, keys 8-15
}

__device__ __forceinline__ float2 bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// What every phase of a chunk block reads
struct Tiles {
  const bf16 *x, *dy, *B, *C;             // kQ x kXS, kQ x kXS, kQ x kBS, kQ x kBS
  const bf16 *Shi, *Slo;                  // a state (S_{c-1} or dS_c) in B's or C's tile
  const float *cum, *cuml, *ecum, *w;
  int rows;
};

// ---- the row side: rows i of tile rt -----------------------------------
// acc (dC rows, all of N) += (dM o L) B over the keys j <= i, M = (C B^T)
// o L and D = dM o L built 16 keys at a time; returns T = M o dM's row sums
// (this lane's part) in ta (row g) and tb (row g + 8).
__device__ __forceinline__ void row_strips(const Tiles& t, int rt, float (&acc)[kN / 8][4],
                                           float& ta, float& tb) {
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3, mi = lane >> 3, mr = lane & 7;
  uint32_t cf[kN / 16][4], df[kP / 16][4];          // C's and dy's rows: A fragments
  const int arow = rt * 16 + (mi & 1) * 8 + mr, acol = (mi >> 1) * 8;
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) ldmatrix_x4(cf[kk], t.C + arow * kBS + acol + kk * 16);
#pragma unroll
  for (int kk = 0; kk < kP / 16; ++kk) ldmatrix_x4(df[kk], t.dy + arow * kXS + acol + kk * 16);
  const int ia = rt * 16 + gq, ib = ia + 8;
  const float ca = t.cum[ia], cb = t.cum[ib], cla = t.cuml[ia], clb = t.cuml[ib];
  for (int kb = 0; kb <= rt; ++kb) {
    const int j0 = kb * 16;
    float s[2][4], d[2][4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jj][e] = d[jj][e] = 0.f;
    // keys as the B operand, [key][k]: C B^T over N, dy x^T over P
    const int brow = j0 + (mi >> 1) * 8 + mr, bcol = (mi & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      uint32_t bb[4];
      ldmatrix_x4(bb, t.B + brow * kBS + bcol + kk * 16);
      mma_bf16(s[0], cf[kk], bb[0], bb[1]);
      mma_bf16(s[1], cf[kk], bb[2], bb[3]);
    }
#pragma unroll
    for (int kk = 0; kk < kP / 16; ++kk) {
      uint32_t xx[4];
      ldmatrix_x4(xx, t.x + brow * kXS + bcol + kk * 16);
      mma_bf16(d[0], df[kk], xx[0], xx[1]);
      mma_bf16(d[1], df[kk], xx[2], xx[3]);
    }
    // L selected to 0 above the diagonal and past the chunk; M, D, T
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? ia : ib;
        const int j = j0 + jj * 8 + 2 * tq + (e & 1);
        const bool keep = j <= i && i < t.rows;
        const float ex = e < 2 ? (ca - t.cum[j]) + (cla - t.cuml[j])
                               : (cb - t.cum[j]) + (clb - t.cuml[j]);
        const float L = keep ? attn_tile::ex2(ex * kLog2e) : 0.f;
        const float m = s[jj][e] * L;
        if (e < 2)
          ta = __fmaf_rn(m, d[jj][e], ta);
        else
          tb = __fmaf_rn(m, d[jj][e], tb);
        d[jj][e] *= L;
      }
    // dC += D B: D from the accumulators as hi + lo, B as [key][n]
    uint32_t ah[4], al[4];
    to_a(d, ah, al);
    const int vrow = j0 + (mi & 1) * 8 + mr, vcol = (mi >> 1) * 8;
#pragma unroll
    for (int n = 0; n < kN / 8; n += 2) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, t.B + vrow * kBS + vcol + n * 8);
      mma_bf16(acc[n], al, bv[0], bv[1]);
      mma_bf16(acc[n + 1], al, bv[2], bv[3]);
      mma_bf16(acc[n], ah, bv[0], bv[1]);
      mma_bf16(acc[n + 1], ah, bv[2], bv[3]);
    }
  }
}

// acc += exp(lc_i) o (dy S_{c-1})_i for the rows of tile rt, S_{c-1] as hi
// + lo in t.Shi / t.Slo ([p][n]); returns C_i . (dy S_{c-1})_i (this
// lane's part) in ya and yb.
__device__ __forceinline__ void row_state(const Tiles& t, int rt, float (&acc)[kN / 8][4],
                                          float& ya, float& yb) {
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3, mi = lane >> 3, mr = lane & 7;
  uint32_t df[kP / 16][4];
  const int arow = rt * 16 + (mi & 1) * 8 + mr, acol = (mi >> 1) * 8;
#pragma unroll
  for (int kk = 0; kk < kP / 16; ++kk) ldmatrix_x4(df[kk], t.dy + arow * kXS + acol + kk * 16);
  const int ia = rt * 16 + gq, ib = ia + 8;
  const float ea = t.ecum[ia], eb = t.ecum[ib];
  const int srow = (mi & 1) * 8 + mr, scol = (mi >> 1) * 8;   // [p][n], transposed loads
#pragma unroll
  for (int n = 0; n < kN / 8; n += 2) {
    float v[2][4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[jj][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kP / 16; ++kk) {
      uint32_t sl[4], sh[4];
      const int off = (kk * 16 + srow) * kBS + scol + n * 8;
      ldmatrix_x4_trans(sl, t.Slo + off);
      ldmatrix_x4_trans(sh, t.Shi + off);
      mma_bf16(v[0], df[kk], sl[0], sl[1]);
      mma_bf16(v[1], df[kk], sl[2], sl[3]);
      mma_bf16(v[0], df[kk], sh[0], sh[1]);
      mma_bf16(v[1], df[kk], sh[2], sh[3]);
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int col = (n + jj) * 8 + 2 * tq;
      const float2 c0 = bf2(t.C + ia * kBS + col), c1 = bf2(t.C + ib * kBS + col);
      ya = __fmaf_rn(c0.x, v[jj][0], __fmaf_rn(c0.y, v[jj][1], ya));
      yb = __fmaf_rn(c1.x, v[jj][2], __fmaf_rn(c1.y, v[jj][3], yb));
      acc[n + jj][0] = __fmaf_rn(ea, v[jj][0], acc[n + jj][0]);
      acc[n + jj][1] = __fmaf_rn(ea, v[jj][1], acc[n + jj][1]);
      acc[n + jj][2] = __fmaf_rn(eb, v[jj][2], acc[n + jj][2]);
      acc[n + jj][3] = __fmaf_rn(eb, v[jj][3], acc[n + jj][3]);
    }
  }
}

// ---- the column side: keys j of tile kt --------------------------------
// dx (keys, all of P) += M^T dy and dB (keys, all of N) += D^T C over the
// rows i >= j, with M^T = (B C^T) o L^T and D^T = (x dy^T) o L^T built 16
// rows at a time; returns T's column sums (this lane's part) in ta, tb.
__device__ __forceinline__ void col_strips(const Tiles& t, int kt, float (&adx)[kP / 8][4],
                                           float (&adb)[kN / 8][4], float& ta, float& tb) {
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3, mi = lane >> 3, mr = lane & 7;
  const int n16 = (t.rows + 15) >> 4;
  uint32_t bf[kN / 16][4], xf[kP / 16][4];          // B's and x's rows: A fragments
  const int arow = kt * 16 + (mi & 1) * 8 + mr, acol = (mi >> 1) * 8;
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) ldmatrix_x4(bf[kk], t.B + arow * kBS + acol + kk * 16);
#pragma unroll
  for (int kk = 0; kk < kP / 16; ++kk) ldmatrix_x4(xf[kk], t.x + arow * kXS + acol + kk * 16);
  const int ja = kt * 16 + gq, jb = ja + 8;
  const float ca = t.cum[ja], cb = t.cum[jb], cla = t.cuml[ja], clb = t.cuml[jb];
  for (int ib = kt; ib < n16; ++ib) {
    const int i0 = ib * 16;
    float s[2][4], d[2][4];
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ii][e] = d[ii][e] = 0.f;
    const int brow = i0 + (mi >> 1) * 8 + mr, bcol = (mi & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      uint32_t cc[4];
      ldmatrix_x4(cc, t.C + brow * kBS + bcol + kk * 16);
      mma_bf16(s[0], bf[kk], cc[0], cc[1]);
      mma_bf16(s[1], bf[kk], cc[2], cc[3]);
    }
#pragma unroll
    for (int kk = 0; kk < kP / 16; ++kk) {
      uint32_t yy[4];
      ldmatrix_x4(yy, t.dy + brow * kXS + bcol + kk * 16);
      mma_bf16(d[0], xf[kk], yy[0], yy[1]);
      mma_bf16(d[1], xf[kk], yy[2], yy[3]);
    }
    // element (key j, row i): L_ij selected as on the row side
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = e < 2 ? ja : jb;
        const int i = i0 + ii * 8 + 2 * tq + (e & 1);
        const bool keep = j <= i && i < t.rows;
        const float ex = e < 2 ? (t.cum[i] - ca) + (t.cuml[i] - cla)
                               : (t.cum[i] - cb) + (t.cuml[i] - clb);
        const float L = keep ? attn_tile::ex2(ex * kLog2e) : 0.f;
        s[ii][e] *= L;
        if (e < 2)
          ta = __fmaf_rn(s[ii][e], d[ii][e], ta);
        else
          tb = __fmaf_rn(s[ii][e], d[ii][e], tb);
        d[ii][e] *= L;
      }
    uint32_t mh[4], ml[4], dh[4], dl[4];
    to_a(s, mh, ml);
    to_a(d, dh, dl);
    const int vrow = i0 + (mi & 1) * 8 + mr, vcol = (mi >> 1) * 8;   // [i][.], transposed
#pragma unroll
    for (int n = 0; n < kP / 8; n += 2) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, t.dy + vrow * kXS + vcol + n * 8);
      mma_bf16(adx[n], ml, bv[0], bv[1]);
      mma_bf16(adx[n + 1], ml, bv[2], bv[3]);
      mma_bf16(adx[n], mh, bv[0], bv[1]);
      mma_bf16(adx[n + 1], mh, bv[2], bv[3]);
    }
#pragma unroll
    for (int n = 0; n < kN / 8; n += 2) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, t.C + vrow * kBS + vcol + n * 8);
      mma_bf16(adb[n], dl, bv[0], bv[1]);
      mma_bf16(adb[n + 1], dl, bv[2], bv[3]);
      mma_bf16(adb[n], dh, bv[0], bv[1]);
      mma_bf16(adb[n + 1], dh, bv[2], bv[3]);
    }
  }
}

// adx += w_j (B dS_c^T)_j and adb += w_j (x dS_c)_j for the keys of tile
// kt, dS_c as hi + lo in t.Shi / t.Slo ([p][n]); returns x_j . (dS_c B_j)
// (this lane's part, before w_j) in ua and ub.
__device__ __forceinline__ void col_state(const Tiles& t, int kt, float (&adx)[kP / 8][4],
                                          float (&adb)[kN / 8][4], float& ua, float& ub) {
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3, mi = lane >> 3, mr = lane & 7;
  const int arow = kt * 16 + (mi & 1) * 8 + mr, acol = (mi >> 1) * 8;
  const int ja = kt * 16 + gq, jb = ja + 8;
  const float wa = t.w[ja], wb = t.w[jb];
  {
    uint32_t bf[kN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) ldmatrix_x4(bf[kk], t.B + arow * kBS + acol + kk * 16);
    const int srow = (mi >> 1) * 8 + mr, scol = (mi & 1) * 8;   // [p][n]: p is the n of B dS^T
#pragma unroll
    for (int pp = 0; pp < kP / 16; ++pp) {
      float u[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) u[jj][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        uint32_t sl[4], sh[4];
        const int off = (pp * 16 + srow) * kBS + scol + kk * 16;
        ldmatrix_x4(sl, t.Slo + off);
        ldmatrix_x4(sh, t.Shi + off);
        mma_bf16(u[0], bf[kk], sl[0], sl[1]);
        mma_bf16(u[1], bf[kk], sl[2], sl[3]);
        mma_bf16(u[0], bf[kk], sh[0], sh[1]);
        mma_bf16(u[1], bf[kk], sh[2], sh[3]);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int n = 2 * pp + jj, col = n * 8 + 2 * tq;
        const float2 x0 = bf2(t.x + ja * kXS + col), x1 = bf2(t.x + jb * kXS + col);
        ua = __fmaf_rn(x0.x, u[jj][0], __fmaf_rn(x0.y, u[jj][1], ua));
        ub = __fmaf_rn(x1.x, u[jj][2], __fmaf_rn(x1.y, u[jj][3], ub));
        adx[n][0] = __fmaf_rn(wa, u[jj][0], adx[n][0]);
        adx[n][1] = __fmaf_rn(wa, u[jj][1], adx[n][1]);
        adx[n][2] = __fmaf_rn(wb, u[jj][2], adx[n][2]);
        adx[n][3] = __fmaf_rn(wb, u[jj][3], adx[n][3]);
      }
    }
  }
  uint32_t xf[kP / 16][4];
#pragma unroll
  for (int kk = 0; kk < kP / 16; ++kk) ldmatrix_x4(xf[kk], t.x + arow * kXS + acol + kk * 16);
  const int srow = (mi & 1) * 8 + mr, scol = (mi >> 1) * 8;       // [p][n], transposed
#pragma unroll
  for (int n = 0; n < kN / 8; n += 2) {
    float z[2][4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) z[jj][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kP / 16; ++kk) {
      uint32_t sl[4], sh[4];
      const int off = (kk * 16 + srow) * kBS + scol + n * 8;
      ldmatrix_x4_trans(sl, t.Slo + off);
      ldmatrix_x4_trans(sh, t.Shi + off);
      mma_bf16(z[0], xf[kk], sl[0], sl[1]);
      mma_bf16(z[1], xf[kk], sl[2], sl[3]);
      mma_bf16(z[0], xf[kk], sh[0], sh[1]);
      mma_bf16(z[1], xf[kk], sh[2], sh[3]);
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      adb[n + jj][0] = __fmaf_rn(wa, z[jj][0], adb[n + jj][0]);
      adb[n + jj][1] = __fmaf_rn(wa, z[jj][1], adb[n + jj][1]);
      adb[n + jj][2] = __fmaf_rn(wb, z[jj][2], adb[n + jj][2]);
      adb[n + jj][3] = __fmaf_rn(wb, z[jj][3], adb[n + jj][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&a)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[n][e] = 0.f;
}

// rows r0 + g and r0 + g + 8 of an accumulator strip (NT tiles of 8
// columns) to a (rows, H, width) f32 or bf16 tensor, head h
template <int NT, typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, const float (&a)[NT][4], int r0,
                                           int rows, int64_t row0, int H, int h, int width) {
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = r0 + gq + 8 * half;
    if (i >= rows) continue;
    T* row = dst + ((row0 + i) * H + h) * static_cast<int64_t>(width);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * tq;
      if (col >= width) continue;
      if constexpr (sizeof(T) == 4)
        *reinterpret_cast<float2*>(row + col) = make_float2(a[n][2 * half], a[n][2 * half + 1]);
      else
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(a[n][2 * half], a[n][2 * half + 1]);
    }
  }
}

// one lane of each quad writes its rows' values (quad sums) at r0 + g and
// r0 + g + 8
__device__ __forceinline__ void put_rows(float* v, int r0, float a, float b) {
  const int lane = threadIdx.x & 31;
  if ((lane & 3) == 0) {
    v[r0 + (lane >> 2)] = a;
    v[r0 + (lane >> 2) + 8] = b;
  }
}

// 1. U_c = (dy o exp(lc))^T C per (chunk, head, batch row): each warp 16
// rows of P, all of N; and the chunk's decay exp(lt)
template <int STEP>
__global__ void __launch_bounds__(kThreads)
inject_kernel(const float* __restrict__ la, const bf16* __restrict__ Cm,
              const bf16* __restrict__ dy, float* __restrict__ inj, float* __restrict__ decay,
              Shape P) {
  extern __shared__ float4 smem_raw[];
  bf16* dy_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* C_s = dy_s + kQ * kXS;
  float* cum = reinterpret_cast<float*>(C_s + kQ * kBS);
  float* cuml = cum + kQ;
  float* ecum = cuml + kQ;
  float* w = ecum + kQ;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (P.H / P.G);
  const int rows = min(P.Q, P.S - c * P.Q);
  const int64_t row0 = static_cast<int64_t>(b) * P.S + static_cast<int64_t>(c) * P.Q;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  load_tile<kP, STEP>(dy_s, kXS, dy, row0, rows, P.H, h, P.P);
  load_tile<kN, STEP>(C_s, kBS, Cm, row0, rows, P.G, g, P.N);
  attn_tile::cp_async_commit();
  if (warp == 0) {
    const float d = la_cum_warp(la, row0, rows, P.H, h, cum, cuml, ecum, w);
    if (lane == 0) decay[(static_cast<int64_t>(b) * P.nc + c) * P.H + h] = d;
  }
  attn_tile::cp_async_wait<0>();
  __syncthreads();
  const int p0 = warp * 16;
  if (p0 >= P.P) return;
  const int tq = lane & 3, mi = lane >> 3, mr = lane & 7;
  const int n16 = (rows + 15) >> 4;
  float acc[kN / 8][4];
  zero(acc);
  const bf16* arow = dy_s + ((mi >> 1) * 8 + mr) * kXS + p0 + (mi & 1) * 8;
  const bf16* brow = C_s + ((mi & 1) * 8 + mr) * kBS + (mi >> 1) * 8;
  for (int kb = 0; kb < n16; ++kb) {
    uint32_t a[4], ah[4], al[4];
    ldmatrix_x4_trans(a, arow + kb * 16 * kXS);
#pragma unroll
    for (int i = 0; i < 4; ++i) {          // a[i]: rows kb*16 + 8 (i >> 1) + 2 tq, + 1
      const int j = kb * 16 + (i >> 1) * 8 + 2 * tq;
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[i]));
      split_pair(v.x * ecum[j], v.y * ecum[j + 1], ah[i], al[i]);
    }
#pragma unroll
    for (int n = 0; n < kN / 8; n += 2) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, brow + kb * 16 * kBS + n * 8);
      mma_bf16(acc[n], al, bv[0], bv[1]);
      mma_bf16(acc[n + 1], al, bv[2], bv[3]);
      mma_bf16(acc[n], ah, bv[0], bv[1]);
      mma_bf16(acc[n + 1], ah, bv[2], bv[3]);
    }
  }
  float* dst = inj + chunk_off(P, b, c, h);
  const int gq = lane >> 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = p0 + gq + 8 * half;
    if (p >= P.P) continue;
#pragma unroll
    for (int n = 0; n < kN / 8; ++n) {
      const int col = n * 8 + 2 * tq;
      if (col < P.N)
        *reinterpret_cast<float2*>(dst + p * P.N + col) =
            make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
}

// 3. everything else of a chunk, per (chunk, head, batch row).  Warp w owns
// row tiles w and 7 - w on the row side and key tiles 7 - w and w on the
// column side; the phases, each behind a barrier:
//   R1  dC rows of tile w: (dM o L) B                         [x, dy, B, C]
//   R2  S_{c-1} (hi + lo) into B's tile; dC of tile w += its state term,
//       written; tile 7 - w's state term begun                 [x, dy, S, C]
//   R3  B again (L2); tile 7 - w's (dM o L) B, written; then
//       C1  dx and dB of key tile 7 - w: M^T dy, D^T C          [x, dy, B, C]
//   C2  dS_c (hi + lo) into C's tile; key tile 7 - w's w terms, written;
//       key tile w's w terms begun                              [x, dy, B, dS]
//   C3  C again (L2); key tile w's M^T dy and D^T C, written    [x, dy, B, C]
//   then warp 0 sums dlc's parts and takes its reverse cumulative sum.
// Each warp's strips over R3 + C1 number 9 tiles of 16 x 16, as over R1 +
// C3 (from 5 to 11).
template <int STEP>
__global__ void __launch_bounds__(kThreads, 2)
chunk_kernel(const bf16* __restrict__ x, const float* __restrict__ la,
             const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
             const bf16* __restrict__ dy, const float* __restrict__ chunk_states,
             const float* __restrict__ ds, bf16* __restrict__ dx, float* __restrict__ dla,
             float* __restrict__ dBp, float* __restrict__ dCp, Shape P) {
  extern __shared__ float4 smem_raw[];
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* dy_s = x_s + kQ * kXS;
  bf16* B_s = dy_s + kQ * kXS;
  bf16* C_s = B_s + kQ * kBS;
  float* cum = reinterpret_cast<float*>(C_s + kQ * kBS);
  float* cuml = cum + kQ;
  float* ecum = cuml + kQ;
  float* w = ecum + kQ;
  float* dlr = w + kQ;                     // row side: T's row sums + exp(lc) C.(dy S)
  float* dlk = dlr + kQ;                   // column side: -T's column sums - the w terms
  float* wt = dlk + kQ;                    // the w terms, w_j x_j . (dS_c B_j)
  float* red = wt + kQ;                    // each warp's <dS_c, S_{c-1}>

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (P.H / P.G);
  const int rows = min(P.Q, P.S - c * P.Q);
  const int64_t row0 = static_cast<int64_t>(b) * P.S + static_cast<int64_t>(c) * P.Q;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n16 = (rows + 15) >> 4;
  const int64_t soff = chunk_off(P, b, c, h);

  load_tile<kP, STEP>(x_s, kXS, x, row0, rows, P.H, h, P.P);
  load_tile<kP, STEP>(dy_s, kXS, dy, row0, rows, P.H, h, P.P);
  load_tile<kN, STEP>(B_s, kBS, Bm, row0, rows, P.G, g, P.N);
  load_tile<kN, STEP>(C_s, kBS, Cm, row0, rows, P.G, g, P.N);
  attn_tile::cp_async_commit();
  float decay = 0.f;
  if (warp == 0) decay = la_cum_warp(la, row0, rows, P.H, h, cum, cuml, ecum, w);
  attn_tile::cp_async_wait<0>();
  __syncthreads();

  Tiles t{x_s, dy_s, B_s, C_s, B_s, B_s + kP * kBS, cum, cuml, ecum, w, rows};
  const int ta = warp, tb = 2 * kWarps - 1 - warp;  // this warp's tiles
  float acc[kN / 8][4];
  float r1a = 0.f, r1b = 0.f, y1a = 0.f, y1b = 0.f;

  // R1
  zero(acc);
  if (ta < n16) row_strips(t, ta, acc, r1a, r1b);
  __syncthreads();                         // B's tile is free
  load_state<false>(B_s, B_s + kP * kBS, chunk_states + soff, nullptr, P.P, P.N);
  __syncthreads();
  // R2
  if (ta < n16) {
    row_state(t, ta, acc, y1a, y1b);
    store_rows(dCp, acc, ta * 16, rows, row0, P.H, h, P.N);
    const int ia = ta * 16 + (lane >> 2);
    put_rows(dlr, ta * 16, __fmaf_rn(ecum[ia], quad_sum(y1a), quad_sum(r1a)),
             __fmaf_rn(ecum[ia + 8], quad_sum(y1b), quad_sum(r1b)));
  }
  float y2a = 0.f, y2b = 0.f, r2a = 0.f, r2b = 0.f;
  zero(acc);
  if (tb < n16) row_state(t, tb, acc, y2a, y2b);
  __syncthreads();                         // S_{c-1} is read
  load_tile<kN, STEP>(B_s, kBS, Bm, row0, rows, P.G, g, P.N);
  attn_tile::cp_async_commit();
  attn_tile::cp_async_wait<0>();
  __syncthreads();
  // R3
  if (tb < n16) {
    row_strips(t, tb, acc, r2a, r2b);
    store_rows(dCp, acc, tb * 16, rows, row0, P.H, h, P.N);
    const int ia = tb * 16 + (lane >> 2);
    put_rows(dlr, tb * 16, __fmaf_rn(ecum[ia], quad_sum(y2a), quad_sum(r2a)),
             __fmaf_rn(ecum[ia + 8], quad_sum(y2b), quad_sum(r2b)));
  }
  // C1: key tile tb
  float adx[kP / 8][4];
  float c1a = 0.f, c1b = 0.f, u1a = 0.f, u1b = 0.f;
  zero(adx);
  zero(acc);
  if (tb < n16) col_strips(t, tb, adx, acc, c1a, c1b);
  __syncthreads();                         // C's tile is free
  float sd = load_state<true>(C_s, C_s + kP * kBS, ds + soff, chunk_states + soff, P.P, P.N);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sd += __shfl_xor_sync(0xffffffffu, sd, off);
  if (lane == 0) red[warp] = sd;
  __syncthreads();
  // C2
  t.Shi = C_s;
  t.Slo = C_s + kP * kBS;
  if (tb < n16) {
    col_state(t, tb, adx, acc, u1a, u1b);
    store_rows(dx, adx, tb * 16, rows, row0, P.H, h, P.P);
    store_rows(dBp, acc, tb * 16, rows, row0, P.H, h, P.N);
    const int ja = tb * 16 + (lane >> 2);
    const float wa = w[ja] * quad_sum(u1a), wb = w[ja + 8] * quad_sum(u1b);
    put_rows(wt, tb * 16, wa, wb);
    put_rows(dlk, tb * 16, -quad_sum(c1a) - wa, -quad_sum(c1b) - wb);
  }
  float c2a = 0.f, c2b = 0.f, u2a = 0.f, u2b = 0.f;
  zero(adx);
  zero(acc);
  if (ta < n16) col_state(t, ta, adx, acc, u2a, u2b);
  __syncthreads();                         // dS_c is read
  load_tile<kN, STEP>(C_s, kBS, Cm, row0, rows, P.G, g, P.N);
  attn_tile::cp_async_commit();
  attn_tile::cp_async_wait<0>();
  __syncthreads();
  // C3: key tile ta
  t.Shi = B_s;
  t.Slo = B_s + kP * kBS;
  if (ta < n16) {
    col_strips(t, ta, adx, acc, c2a, c2b);
    store_rows(dx, adx, ta * 16, rows, row0, P.H, h, P.P);
    store_rows(dBp, acc, ta * 16, rows, row0, P.H, h, P.N);
    const int ja = ta * 16 + (lane >> 2);
    const float wa = w[ja] * quad_sum(u2a), wb = w[ja + 8] * quad_sum(u2b);
    put_rows(wt, ta * 16, wa, wb);
    put_rows(dlk, ta * 16, -quad_sum(c2a) - wa, -quad_sum(c2b) - wb);
  }
  __syncthreads();

  // <dS_c, S_c> at the last row, then dla = reverse cumsum of dlc
  if (warp == 0) {
    float s = 0.f, vv[4], tot = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) s += lane * 4 + k < rows ? wt[lane * 4 + k] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const float sdot = ((red[0] + red[1]) + red[2]) + red[3];
#pragma unroll
    for (int k = 3; k >= 0; --k) {
      const int i = lane * 4 + k;
      float v = i < rows ? dlr[i] + dlk[i] : 0.f;
      if (i == rows - 1) v += __fmaf_rn(decay, sdot, s);
      tot += v;
      vv[k] = tot;                         // suffix sum within the lane
    }
    float incl = tot;                      // suffix sum over lanes >= lane
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += o;
    }
    const float after = incl - tot;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = lane * 4 + k;
      if (i < rows) dla[(row0 + i) * P.H + h] = vv[k] + after;
    }
  }
}

template <int STEP>
int configure_step() {
  cudaError_t err = cudaFuncSetAttribute(chunk_kernel<STEP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kChunkSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(inject_kernel<STEP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kInjectSmem));
  return static_cast<int>(err);
}

int configure() {
  static bool done = false;                // opt in to > 48 KiB once
  if (!done) {
    int rc = configure_step<8>();
    if (rc == 0) rc = configure_step<4>();
    if (rc) return rc;
    done = true;
  }
  return 0;
}

template <int STEP>
int launch_step(const void* x, const float* la, const void* Bm, const void* Cm, const void* dy,
                const float* dstate, const float* chunk_states, void* dx, float* dla, void* dB,
                void* dC, float* dinit, float* ds, float* decay, float* dBp, float* dCp,
                const Shape& P, cudaStream_t st) {
  const dim3 chunks(P.nc, P.H, P.B);
  inject_kernel<STEP><<<chunks, kThreads, kInjectSmem, st>>>(
      la, static_cast<const bf16*>(Cm), static_cast<const bf16*>(dy), ds, decay, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 chain((P.P * P.N + ::kThreads - 1) / ::kThreads, P.B * P.H);
  ssd_bwd_chain_kernel<<<chain, ::kThreads, 0, st>>>(ds, decay, dstate, dinit, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_kernel<STEP><<<chunks, kThreads, kChunkSmem, st>>>(
      static_cast<const bf16*>(x), la, static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<const bf16*>(dy), chunk_states, ds,
      static_cast<bf16*>(dx), dla, dBp, dCp, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(P.B) * P.S * P.G * P.N;
  const dim3 sums(static_cast<unsigned>((total + ::kThreads - 1) / ::kThreads), 2);
  ssd_bwd_group_sum_kernel<bf16><<<sums, ::kThreads, 0, st>>>(
      dBp, dCp, static_cast<bf16*>(dB), static_cast<bf16*>(dC), P);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* x, const float* la, const void* Bm, const void* Cm, const void* dy,
           const float* dstate, const float* chunk_states, void* dx, float* dla, void* dB,
           void* dC, float* dinit, float* ds, float* decay, float* dBp, float* dCp,
           const Shape& P, cudaStream_t st) {
  const int rc = configure();
  if (rc) return rc;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bm) |
                         reinterpret_cast<uintptr_t>(Cm) | reinterpret_cast<uintptr_t>(dy);
  if (P.P % 8 == 0 && P.N % 8 == 0 && addr % 16 == 0)     // 16-byte copies
    return launch_step<8>(x, la, Bm, Cm, dy, dstate, chunk_states, dx, dla, dB, dC, dinit, ds,
                          decay, dBp, dCp, P, st);
  return launch_step<4>(x, la, Bm, Cm, dy, dstate, chunk_states, dx, dla, dB, dC, dinit, ds,
                        decay, dBp, dCp, P, st);         // 8-byte copies
}

template <typename K>
int kernel_attrs(K kernel, size_t smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(smem);
  out[2] = blocks;
  out[3] = static_cast<int>(a.localSizeBytes);
  return 0;
}

int attrs(int* out) {
  const int rc = configure();
  if (rc) return rc;
  const int r = kernel_attrs(chunk_kernel<8>, kChunkSmem, out);
  return r ? r : kernel_attrs(inject_kernel<8>, kInjectSmem, out + 4);
}

}  // namespace ssd_bwd_mma

extern "C" {

// x, Bm, Cm, dy, dx, dB, dC contiguous in one dtype (0 = f32, 1 = bf16),
// 8-byte aligned; la, dla f32 (B, S, H); dstate (may be null), dinit f32
// (B, H, P, N); chunk_states f32 (B, n_chunks, H, P, N), the forward's;
// workspaces: ds f32 (B, n_chunks, H, P, N), decay f32 (B, n_chunks, H),
// dBp and dCp f32 (B, S, H, N).
int ssd_scan_bwd(const void* x, const void* la, const void* Bm, const void* Cm,
                 const void* dy, const void* dstate, const void* chunk_states, void* dx,
                 void* dla, void* dB, void* dC, void* dinit, void* ds, void* decay,
                 void* dBp, void* dCp, int B, int S, int H, int P, int G, int N, int chunk,
                 int dtype, void* stream) {
  if (B < 1 || S < 1 || G < 1 || H < 1 || B * H > 65535 || H % G != 0 || P % 4 ||
      N % 4 || P < 4 || N < 4 || P > kMaxP || N > kMaxN || chunk < 1 || chunk > kMaxQ)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape shp{B, S, H, P, G, N, chunk, (S + chunk - 1) / chunk};
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* laf = static_cast<const float*>(la);
  const auto* dsf = static_cast<const float*>(dstate);
  const auto* csf = static_cast<const float*>(chunk_states);
  auto* dlaf = static_cast<float*>(dla);
  auto* dif = static_cast<float*>(dinit);
  auto* dsw = static_cast<float*>(ds);
  auto* dec = static_cast<float*>(decay);
  auto* bp = static_cast<float*>(dBp);
  auto* cp = static_cast<float*>(dCp);
  if (dtype == 0)                          // f32: the FMA kernels
    return launch(x, laf, Bm, Cm, dy, dsf, csf, dx, dlaf, dB, dC, dif, dsw, dec, bp, cp, shp,
                  st);
  if (dtype == 1)                          // bf16: the tensor-core kernels
    return ssd_bwd_mma::launch(x, laf, Bm, Cm, dy, dsf, csf, dx, dlaf, dB, dC, dif, dsw, dec, bp,
                               cp, shp, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of the f32 chunk kernel's block, in bytes.
size_t ssd_scan_bwd_smem_bytes() { return kChunkSmem; }

// The bf16 chunk kernel's registers per thread, dynamic shared memory per
// block, resident blocks per SM and local-memory (spill) bytes per thread
// into out[0..3], the inject kernel's into out[4..7].
int ssd_scan_bwd_mma_attrs(int* out) { return ssd_bwd_mma::attrs(out); }

}  // extern "C"
