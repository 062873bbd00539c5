// Mamba-2 chunked SSD scan, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py
// (ssd_scan_pallas, _ssd_kernel).
//
// What it computes: x (B, S, H, P), la (B, S, H) f32 log decay, Bm and Cm
// (B, S, G, N); head h reads group h / (H / G).  For each (b, h) the
// chunks of Q positions are walked in order, the (P, N) state carried in
// f32 from one to the next (zeros, or the caller's initial state):
//   la_cum = cumsum(la) over the chunk, la_tot = la_cum[Q - 1];
//   y[i]   = sum_{j <= i} (C_i . B_j) exp(la_cum[i] - la_cum[j]) x[j]
//          + exp(la_cum[i]) (C_i . state^T);
//   state  = exp(la_tot) state + sum_j (x[j] exp(la_tot - la_cum[j]))^T B_j.
// The decay L[i][j] is selected to 0 for i < j, never multiplied: there
// the exponent is positive and may overflow, and inf * 0 is NaN.
// Positions at or past S read as x = 0, la = 0, B = C = 0, which leaves
// the state unchanged.  y is rounded once to x's type; the final state is
// f32.  Everything is computed in f32 with FMAs.
//
// Bound: per chunk and head about 2 Q^2 N + 2 Q^2 P + 4 Q P N operations
// (about 10 M at Q = 128, P = 64, N = 128) against Q (P + 2N) inputs:
// some hundreds of operations per byte, so bound by operations.  This first
// version runs them on the f32 FMA units: one thread block per (head,
// batch row), 256 threads, walking its chunks; the chunk's B, C and x and
// the state live in shared memory as f32 (about 215 KB, dynamic shared
// memory), and the Q x Q masked scores are built 32 rows at a time so they
// fit beside them.  At Mamba-2-2.7B's 80 heads and batch 1 the grid is 80
// blocks, under one wave of the H100's 132 SMs: splitting a head's work
// across blocks is later work, as are tensor cores, TMA and pipelining.
//
// Plain C interface (loaded with ctypes); the launch is on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxQ = 128;             // chunk length
constexpr int kMaxP = 64;              // head dim
constexpr int kMaxN = 128;             // state dim
constexpr int kThreads = 256;          // 16 x 16 threads
constexpr int kRowTile = 32;           // score rows built at a time
constexpr int kBStride = kMaxN + 4;    // f32 row stride of B, C and the state
constexpr int kXStride = kMaxP;        // f32 row stride of x
constexpr int kMStride = kMaxQ + 4;    // f32 row stride of the score tile
constexpr size_t kSmemFloats = 2 * kMaxQ * kBStride     // B, C
                               + kMaxQ * kXStride       // x
                               + kMaxP * kBStride       // state
                               + kRowTile * kMStride    // score tile
                               + 3 * kMaxQ;             // la_cum, exp(la_cum), w
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

static_assert(kThreads == 256, "the thread tiles below assume 16 x 16");
static_assert(kMaxQ == 16 * 8 && kMaxP == 16 * 4 && kMaxN == 16 * 8, "tile shapes");
static_assert(kRowTile == 2 * 16, "each thread owns two rows of a score tile");

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Shape {
  int B, S, H, P, G, N, Q;
};

// Copy rows [t0, t0 + kMaxQ) of one head or group of a (B, S, Hx, width)
// tensor into an f32 tile; rows at or past S, or at or past t0 + Q, are 0.
template <typename T>
__device__ __forceinline__ void load_rows(float* __restrict__ dst, int stride,
                                          const T* __restrict__ src, int b, int t0,
                                          int n_valid, int S, int Hx, int hx, int width) {
  const int per_row = width / 4;
  for (int idx = threadIdx.x; idx < kMaxQ * per_row; idx += kThreads) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * 4;
    const int s = t0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid && s < S)
      v = load4(src + ((static_cast<int64_t>(b) * S + s) * Hx + hx) * width + c);
    store4(dst + r * stride + c, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ la,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ init, T* __restrict__ y,
                float* __restrict__ state_out, Shape P) {
  extern __shared__ float4 smem_raw[];
  float* B_s = reinterpret_cast<float*>(smem_raw);
  float* C_s = B_s + kMaxQ * kBStride;
  float* x_s = C_s + kMaxQ * kBStride;
  float* st_s = x_s + kMaxQ * kXStride;
  float* M_s = st_s + kMaxP * kBStride;
  float* cum_s = M_s + kRowTile * kMStride;
  float* ecum_s = cum_s + kMaxQ;
  float* w_s = ecum_s + kMaxQ;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (P.H / P.G);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int Q = P.Q;

  // the carried state: zeros or the caller's
  for (int idx = threadIdx.x; idx < P.P * P.N; idx += kThreads) {
    const int p = idx / P.N, n = idx - p * P.N;
    st_s[p * kBStride + n] =
        init ? init[((static_cast<int64_t>(b) * P.H + h) * P.P + p) * P.N + n] : 0.f;
  }

  for (int t0 = 0; t0 < P.S; t0 += Q) {
    load_rows(x_s, kXStride, x, b, t0, Q, P.S, P.H, h, P.P);
    load_rows(B_s, kBStride, Bm, b, t0, Q, P.S, P.G, g, P.N);
    load_rows(C_s, kBStride, Cm, b, t0, Q, P.S, P.G, g, P.N);
    // la_cum: one warp, each lane a run of consecutive positions, then a
    // scan of the lanes' totals
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const int per = (Q + 31) / 32;
      const int lo = min(Q, lane * per), hi = min(Q, lo + per);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) {
        const int s = t0 + i;
        run += s < P.S ? la[(static_cast<int64_t>(b) * P.S + s) * P.H + h] : 0.f;
        cum_s[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      const float base = incl - run;
      for (int i = lo; i < hi; ++i) cum_s[i] += base;
    }
    __syncthreads();
    const float la_tot = cum_s[Q - 1];
    for (int i = threadIdx.x; i < Q; i += kThreads) {
      ecum_s[i] = expf(cum_s[i]);
      w_s[i] = expf(la_tot - cum_s[i]);
    }

    // y rows ty + 16 r, columns tx + 16 e; first exp(la_cum) (C . state^T)
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
    for (int n = 0; n < P.N; n += 4) {
      float4 sv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) sv[e] = load4(st_s + (tx + 16 * e) * kBStride + n);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 cv = load4(C_s + (ty + 16 * r) * kBStride + n);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[r][e] = __fmaf_rn(cv.x, sv[e].x, acc[r][e]);
          acc[r][e] = __fmaf_rn(cv.y, sv[e].y, acc[r][e]);
          acc[r][e] = __fmaf_rn(cv.z, sv[e].z, acc[r][e]);
          acc[r][e] = __fmaf_rn(cv.w, sv[e].w, acc[r][e]);
        }
      }
    }
    __syncthreads();                       // ecum_s is written
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float ec = ty + 16 * r < Q ? ecum_s[ty + 16 * r] : 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] *= ec;
    }

    // then the intra-chunk term, 32 score rows at a time (unrolled, so
    // that acc[] is indexed by constants and stays in registers)
#pragma unroll
    for (int t = 0; t < kMaxQ / kRowTile; ++t) {
      const int i0 = t * kRowTile;
      if (i0 >= Q) break;
      const int jmax = min(Q, i0 + kRowTile);      // keys past it are masked
      const int jmax4 = (jmax + 3) & ~3;
      // M[i][j] = (C_i . B_j) * exp(la_cum[i] - la_cum[j]) for j <= i, else 0;
      // this thread: rows i0 + 2 ty + a, keys tx + 16 c
      float dot[2][8];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) dot[a][c] = 0.f;
      for (int n = 0; n < P.N; n += 4) {
        const float4 c0 = load4(C_s + (i0 + 2 * ty) * kBStride + n);
        const float4 c1 = load4(C_s + (i0 + 2 * ty + 1) * kBStride + n);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (tx + 16 * c >= jmax4) continue;
          const float4 bv = load4(B_s + (tx + 16 * c) * kBStride + n);
          dot[0][c] = __fmaf_rn(c0.x, bv.x, dot[0][c]);
          dot[0][c] = __fmaf_rn(c0.y, bv.y, dot[0][c]);
          dot[0][c] = __fmaf_rn(c0.z, bv.z, dot[0][c]);
          dot[0][c] = __fmaf_rn(c0.w, bv.w, dot[0][c]);
          dot[1][c] = __fmaf_rn(c1.x, bv.x, dot[1][c]);
          dot[1][c] = __fmaf_rn(c1.y, bv.y, dot[1][c]);
          dot[1][c] = __fmaf_rn(c1.z, bv.z, dot[1][c]);
          dot[1][c] = __fmaf_rn(c1.w, bv.w, dot[1][c]);
        }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int i = i0 + 2 * ty + a;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int j = tx + 16 * c;
          if (j >= jmax4) continue;
          const bool ok = i < Q && j <= i;
          M_s[(2 * ty + a) * kMStride + j] =
              ok ? dot[a][c] * expf(cum_s[i] - cum_s[j]) : 0.f;
        }
      }
      __syncthreads();
      // acc += M x over the rows of this tile that the thread owns:
      // i = ty + 16 r with r = i0 / 16 and i0 / 16 + 1
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = 2 * t + rr;
        const float* m_row = M_s + (ty + 16 * rr) * kMStride;
        for (int j = 0; j < jmax4; j += 4) {
          const float4 mv = load4(m_row + j);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = tx + 16 * e;
            float a = acc[r][e];
            a = __fmaf_rn(mv.x, x_s[(j + 0) * kXStride + p], a);
            a = __fmaf_rn(mv.y, x_s[(j + 1) * kXStride + p], a);
            a = __fmaf_rn(mv.z, x_s[(j + 2) * kXStride + p], a);
            a = __fmaf_rn(mv.w, x_s[(j + 3) * kXStride + p], a);
            acc[r][e] = a;
          }
        }
      }
      __syncthreads();                     // before the next tile's scores
    }

    // y out
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      const int s = t0 + i;
      if (i >= Q || s >= P.S) continue;
      T* dst = y + ((static_cast<int64_t>(b) * P.S + s) * P.H + h) * P.P;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (tx + 16 * e < P.P) store1(dst + tx + 16 * e, acc[r][e]);
    }

    // state = exp(la_tot) state + sum_j (x_j w_j)^T B_j; rows ty*4 + a,
    // columns tx + 16 c
    const float decay = expf(la_tot);
    if (ty * 4 < P.P) {
      float upd[4][8];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) upd[a][c] = 0.f;
      for (int j = 0; j < Q; ++j) {
        const float4 xv = load4(x_s + j * kXStride + ty * 4);
        const float wj = w_s[j];
        const float xw[4] = {xv.x * wj, xv.y * wj, xv.z * wj, xv.w * wj};
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float bv = B_s[j * kBStride + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) upd[a][c] = __fmaf_rn(xw[a], bv, upd[a][c]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int n = tx + 16 * c;
          if (n < P.N) {
            float* sp = st_s + (ty * 4 + a) * kBStride + n;
            *sp = __fmaf_rn(decay, *sp, upd[a][c]);
          }
        }
    }
    __syncthreads();                       // before the next chunk's loads
  }

  for (int idx = threadIdx.x; idx < P.P * P.N; idx += kThreads) {
    const int p = idx / P.N, n = idx - p * P.N;
    state_out[((static_cast<int64_t>(b) * P.H + h) * P.P + p) * P.N + n] =
        st_s[p * kBStride + n];
  }
}

template <typename T>
int launch(const void* x, const float* la, const void* Bm, const void* Cm,
           const float* init, void* y, float* state, const Shape& P, cudaStream_t stream) {
  static bool configured = false;          // opt in to > 48 KiB once per type
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(P.H, P.B);
  ssd_scan_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), la, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      init, static_cast<T*>(y), state, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, Bm, Cm, y contiguous in one dtype (0 = f32, 1 = bf16); la, init (may
// be null) and state f32.
int ssd_scan_fwd(const void* x, const void* la, const void* Bm, const void* Cm,
                 const void* init, void* y, void* state, int B, int S, int H, int P,
                 int G, int N, int chunk, int dtype, void* stream) {
  if (B < 1 || S < 1 || G < 1 || H % G != 0 || P % 4 || N % 4 || P < 4 || N < 4 ||
      P > kMaxP || N > kMaxN || chunk < 1 || chunk > kMaxQ)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape shp{B, S, H, P, G, N, chunk};
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* laf = static_cast<const float*>(la);
  const auto* initf = static_cast<const float*>(init);
  auto* sf = static_cast<float*>(state);
  if (dtype == 0) return launch<float>(x, laf, Bm, Cm, initf, y, sf, shp, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, laf, Bm, Cm, initf, y, sf, shp, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
