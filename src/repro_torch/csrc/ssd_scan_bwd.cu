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
// operations bound it (0.098 ms at the bf16 tensor-core peak, 1.45 ms on
// the f32 FMA units, which this first kernel uses for both types).
//
// Design: the state gradient's chain is the only serial part, and it is
// cheap (P N multiply-adds a chunk), so it runs as its own small kernel
// between two chunk-parallel ones, and nothing hands a state from block to
// block inside a launch:
//   1. inject: one block per (chunk, head, row): U_c = sum_i exp(lc_i)
//      dy_i (x) C_i into a (B, n_chunks, H, P, N) f32 buffer, and the
//      chunk's decay exp(lt);
//   2. chain: one thread per (b, h, p, n) walks the chunks last-first,
//      replacing U_c by dS_c in place (dS_{c-1} = exp(lt) dS_c + U_c) and
//      writing d(initial state);
//   3. chunk: one block of 256 threads per (chunk, head, row), 198 KB of
//      dynamic shared memory, f32 FMA, in two passes of 32-wide tiles
//      (the causal half only): a row pass (B and x whole, C and dy rows:
//      dM o L rows, then dC and the row sums of T and the y_inter term)
//      and a column pass (C and dy whole, B and x rows: M and dM o L
//      columns, then dx, dB, the column sums of T and the w term); the
//      scores and dM are built twice, once per pass.  dlc stays in shared
//      memory, and one warp takes its reverse cumulative sum.  dB and dC
//      go out per head in f32;
//   4. group sum: dB and dC summed over the heads of each group in head
//      order, rounded once to the inputs' type.
// No atomics anywhere: two gradients of one batch are equal bit for bit.
// la_cum is built as the forward's tensor-core kernel builds it, as
// compensated hi + lo sums (dla sums terms of exponentials of differences
// of la_cum that cancel).
//
// What holds it back (H100 80GB HBM3 at 700 W, the shape above): 10.5 ms,
// 9.5 of them in the chunk kernel, which runs its ~100 GFLOP at about 11
// TFLOP/s on the FMA units: one 256-thread block per SM (198 KB of shared
// memory, 128 registers), inner loops that read shared memory about once
// per two multiply-adds, and the scores and dM built twice.  The bf16
// products belong on the tensor cores (mma.sync as in ssd_scan.cu) with
// the tiles kept in bf16, which would also let two blocks share an SM.
//
// Plain C interface (loaded with ctypes); the launches are on the caller's
// stream, allocate nothing and return the first cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
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
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_inject_kernel(const float* __restrict__ la, const T* __restrict__ Cm,
                      const T* __restrict__ dy, float* __restrict__ inj,
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
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ la,
                     const T* __restrict__ Bm, const T* __restrict__ Cm,
                     const T* __restrict__ dy, const float* __restrict__ chunk_states,
                     const float* __restrict__ ds, T* __restrict__ dx,
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
      T* dst = dx + ((row0 + j) * P.H + h) * static_cast<int64_t>(P.P);
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

template <typename T>
int configure() {
  static bool done = false;                // opt in to > 48 KiB once per type
  if (!done) {
    cudaError_t err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(kChunkSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(ssd_bwd_inject_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kInjectSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    done = true;
  }
  return 0;
}

template <typename T>
int launch(const void* x, const float* la, const void* Bm, const void* Cm, const void* dy,
           const float* dstate, const float* chunk_states, void* dx, float* dla, void* dB,
           void* dC, float* dinit, float* ds, float* decay, float* dBp, float* dCp,
           const Shape& P, cudaStream_t st) {
  int rc = configure<T>();
  if (rc) return rc;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  const T* dyt = static_cast<const T*>(dy);
  const dim3 chunks(P.nc, P.H, P.B);
  ssd_bwd_inject_kernel<T><<<chunks, kThreads, kInjectSmem, st>>>(la, ct, dyt, ds, decay, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 chain((P.P * P.N + kThreads - 1) / kThreads, P.B * P.H);
  ssd_bwd_chain_kernel<<<chain, kThreads, 0, st>>>(ds, decay, dstate, dinit, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk_kernel<T><<<chunks, kThreads, kChunkSmem, st>>>(
      xt, la, bt, ct, dyt, chunk_states, ds, static_cast<T*>(dx), dla, dBp, dCp, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(P.B) * P.S * P.G * P.N;
  const dim3 sums(static_cast<unsigned>((total + kThreads - 1) / kThreads), 2);
  ssd_bwd_group_sum_kernel<T><<<sums, kThreads, 0, st>>>(dBp, dCp, static_cast<T*>(dB),
                                                          static_cast<T*>(dC), P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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
  if (dtype == 0)
    return launch<float>(x, laf, Bm, Cm, dy, dsf, csf, dx, dlaf, dB, dC, dif, dsw, dec, bp, cp,
                         shp, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, laf, Bm, Cm, dy, dsf, csf, dx, dlaf, dB, dC, dif, dsw, dec,
                                 bp, cp, shp, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of the chunk kernel's block, in bytes.
size_t ssd_scan_bwd_smem_bytes() { return kChunkSmem; }

}  // extern "C"
